"""Device ms per call of the port's GroupNorm kernels -- K1 (GroupNorm
statistics, then the conv) and K2 -- in a given checkout, read with this
checkout's chip_smoke.py (`_device_by_kernel`: torch.profiler, the mean of
each kernel's records times its launches per call), at the shapes of
PERF.md section 6, bf16, on one NVIDIA GPU.

  python tools/torch_gn_device_ms.py [TREE]

TREE is the root of a checkout of this repository (default: this one);
its sr3_tpu_torch is imported and its kernels built under
TREE/sr3_tpu_torch/_build. To compare two commits by one yardstick, unpack
both with `git archive` into a directory that .gitignore lists and run
parent, change, change, parent in one session on one card. Prints the
card's name and power limit, one line per shape, and last one JSON object
{shape: {"device_ms", "events_ms", "kernels": {name: [ms, launches]}}}.
Imports nothing of JAX.
"""

import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(tree):
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from sr3_tpu_torch.ops import conv_fused, groupnorm

    if not groupnorm.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {groupnorm.__file__}, not {tree}'s")
    cs = _chip_smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"port of {tree}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(17)
    dt, cl = torch.bfloat16, torch.channels_last
    cases = []
    args, kw = cs._k1_inputs(torch, g, 2, 64, 64, 512, dt, True)
    cases.append(("K1 2x64x512x512->64 +film+residual",
                  lambda: conv_fused.gn_silu_conv3x3(*args, **kw)))
    for b, c, hw, groups, swish in ((2, 512, 64, 16, False),
                                    (4, 64, 128, 32, True),
                                    (8, 512, 64, 16, False)):
        x = torch.randn(b, c, hw, hw, device="cuda", generator=g)
        x = x.to(dt).contiguous(memory_format=cl)
        gw = 1 + 0.2 * torch.randn(c, device="cuda", generator=g)
        gb = 0.1 * torch.randn(c, device="cuda", generator=g)
        cases.append((f"K2 {b}x{c}x{hw}x{hw} G={groups} swish "
                      + ("on" if swish else "off"),
                      lambda x=x, gw=gw, gb=gb, groups=groups, swish=swish:
                      groupnorm.group_norm(x, gw, gb, groups, swish=swish)))
    out = {}
    for label, fn in cases:
        by = cs._device_by_kernel(torch, fn)
        events = cs._time_ms(torch, fn, n=20)
        out[label] = {"device_ms": cs._call_ms(by), "events_ms": events,
                      "kernels": {cs._short(k): [ms, n]
                                  for k, (ms, n) in by.items()}}
        print(f"  {label} bf16: device {out[label]['device_ms']:.4f} ms a "
              f"call (" + ", ".join(f"{cs._short(k)} {ms:.4f} ms x{n}"
                                    for k, (ms, n) in by.items())
              + f"), events {events:.4f} ms", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else ROOT))
