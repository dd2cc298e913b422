"""Device ms per call of the port's GroupNorm kernels -- K1 (GroupNorm
statistics, then the conv) and K2 -- in a given checkout, read with this
checkout's chip_smoke.py (`_device_by_kernel`: torch.profiler, the mean of
each kernel's records times its launches per call), at the shapes of
PERF.md section 6, bf16, on one NVIDIA GPU; with --step N also the median
of N CUDA-event timings of the batch-8 512^2 serving step (`p_sample_step`
of the val-phase sr_sr3_64_512_attn trainer's bf16 sampling copy, T=2000
schedule).

  python tools/torch_gn_device_ms.py [TREE] [--step N]
  python tools/torch_gn_device_ms.py --pairs P [--step N] TREE_A TREE_B

TREE is the root of a checkout of this repository (default: this one);
its sr3_tpu_torch is imported and its kernels built under
TREE/sr3_tpu_torch/_build. To compare two commits by one yardstick, unpack
both with `git archive` into a directory that .gitignore lists and run
them in one session on one card: --pairs runs P alternating pairs of fresh
processes (A, B when the pair's index is even, B, A when it is odd) and
prints each run's K1 and step times and each pair's difference B - A.
One run prints the card's name and power limit, one line per shape, and
last one JSON object {shape: {"device_ms", "events_ms", "kernels": {name:
[ms, launches]}}, "step_512": {...} with --step}. Imports nothing of JAX.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K1 = "K1 2x64x512x512->64 +film+residual"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _step_512(torch, cs, g, steps):
    """Median, min and max CUDA-event ms of ``steps`` batch-8 512^2
    serving steps."""
    from sr3_tpu_torch.models.schedule import make_schedule

    trainer = cs._serving_trainer(cs.CONFIG_512)
    sched = make_schedule(dict(schedule="linear", n_timestep=2000,
                               linear_start=1e-6, linear_end=1e-2), "cuda")
    net, diff = trainer._eval_params(), trainer.diffusion
    cond = torch.rand(8, 3, 512, 512, device="cuda", generator=g) * 2 - 1
    img = torch.randn(8, 3, 512, 512, device="cuda", generator=g)
    ts = iter(range(1999, -1, -1))
    with torch.inference_mode():
        ms = cs._time_each(torch, lambda: diff.p_sample_step(
            net, sched, img, next(ts), cond, generator=g), steps)
    return {"median_ms": statistics.median(ms), "min_ms": min(ms),
            "max_ms": max(ms)}


def main(tree, steps):
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
    cases.append((K1, lambda: conv_fused.gn_silu_conv3x3(*args, **kw)))
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
    del args, kw, cases
    if steps:
        out["step_512"] = _step_512(torch, cs, g, steps)
        print(f"  batch-8 512^2 serving step: median "
              f"{out['step_512']['median_ms']:.3f} ms of {steps}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


def pairs(trees, n, steps, timeout):
    """n alternating pairs of fresh processes, one run of a tree each."""
    runs = {t: [] for t in trees}
    diffs = []
    for i in range(n):
        got = {}
        for tree in (trees if i % 2 == 0 else trees[::-1]):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), tree, "--step",
                 str(steps)], capture_output=True, text=True, timeout=timeout)
            if proc.returncode:
                print((proc.stdout + proc.stderr)[-4000:], flush=True)
                raise RuntimeError(f"run of {tree} failed ({proc.returncode})")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            got[tree] = (res[K1]["device_ms"],
                         res["step_512"]["median_ms"] if steps else None)
            runs[tree].append(got[tree])
            print(f"pair {i} {tree}: K1 device {got[tree][0]:.4f} ms, 512^2 "
                  f"step median {got[tree][1]} ms", flush=True)
        diffs.append([None if a is None else b - a
                      for a, b in zip(got[trees[0]], got[trees[1]])])
    for tree in trees:
        k1, step = zip(*runs[tree])
        print(f"{tree}: K1 device ms {list(k1)} (median "
              f"{statistics.median(k1):.4f}); 512^2 step ms {list(step)}",
              flush=True)
    print(f"B - A per pair (K1 ms, step ms): {diffs}", flush=True)
    return 0


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trees", nargs="*", help="TREE, or TREE_A TREE_B with "
                   "--pairs")
    p.add_argument("--step", type=int, default=0,
                   help="also time N batch-8 512^2 serving steps")
    p.add_argument("--pairs", type=int, default=0)
    p.add_argument("--timeout", type=float, default=300)
    a = p.parse_args()
    if a.pairs:
        if len(a.trees) != 2:
            p.error("--pairs takes two trees")
        sys.exit(pairs(a.trees, a.pairs, a.step, a.timeout))
    if len(a.trees) > 1:
        p.error("give one tree, or two with --pairs")
    sys.exit(main(a.trees[0] if a.trees else ROOT, a.step))
