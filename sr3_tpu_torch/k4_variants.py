"""Time K4's bf16 route (``csrc/attention.cu``) in variants of its design,
side by side on one NVIDIA GPU.

  python sr3_tpu_torch/k4_variants.py [variant ...]

Each variant is a copy of sr3_tpu_torch/csrc with textual replacements in
attention.cu (VARIANTS), compiled and bound as the port's own library is
(``ops/_build.py``: its nvcc flags, its ctypes signatures) into its own
library under _chipwork/k4_variants/ (ignored by git), and called through
``attention.attention_fwd`` with that library swapped in, on bf16 inputs at
the shapes of PERF.md section 6. Each output is held against the plain
version (o within 2e-2 of max|plain|, lse within 1e-4); the card ms a call
is this checkout's chip_smoke.py ``_device_ms`` (20 calls queued behind a
spin kernel), the least of ROUNDS rounds that alternate the variants'
order. Prints the card's name and power limit, a line a shape, and last
one JSON object {variant: {shape: ms}}. Needs CUDA and nvcc; imports
nothing of JAX.
"""

import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "_chipwork", "k4_variants")
ROUNDS = 2
# name: [(text, replacement)] in attention.cu
VARIANTS = {
    "base": [],
    # the D = 512 class computes the whole S in both warpgroups (1.5x the
    # operations), no exchange of partial S
    "recompute": [
        ("constexpr int kSteps = kSplitD ? DC / 32 : DC / 16;",
         "constexpr int kSteps = DC / 16;"),
        ("const int kk0 = kSplitD ? cw * kSteps : 0;", "const int kk0 = 0;"),
        ("      if constexpr (kSplitD) {\n        // barrier 1",
         "      if constexpr (false) {\n        // barrier 1"),
        ("kXBytes = kSplitD ? 2 * BK / 2 * 128 * 4 : 0;", "kXBytes = 0;")],
    # the D = 512 class with 32 keys a tile: two ring stages fit
    "bk32": [("launch_class<512, 64, true>", "launch_class<512, 32, true>"),
             ("kClassBK[kClasses] = {128, 128, 64, 64}",
              "kClassBK[kClasses] = {128, 128, 64, 32}")],
    # no key split: every grid under one wave runs its keys in one block
    "no_split": [("  if (2 * blocks <= sms) {", "  if (false) {")],
    # key splits of at least 1 / 2 key tiles (the plan's rule: 4)
    "split_per1": [("kMinSplitTiles = 4;", "kMinSplitTiles = 1;")],
    "split_per2": [("kMinSplitTiles = 4;", "kMinSplitTiles = 2;")],
}
SHAPES = [(8, 4096, 512), (2, 4096, 512), (1, 16384, 256), (2, 1024, 512),
          (8, 1024, 512), (8, 256, 512), (8, 256, 128), (8, 64, 512),
          (8, 16, 256)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build(name):
    """The bound library of one variant."""
    from sr3_tpu_torch.ops import _build

    src = os.path.join(ROOT, "sr3_tpu_torch", "csrc")
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d)
    path = os.path.join(d, "attention.cu")
    with open(path) as f:
        text = f.read()
    for a, b in VARIANTS[name]:
        if text.count(a) != 1:
            raise ValueError(f"variant {name}: {a!r} is not in attention.cu "
                             f"once")
        text = text.replace(a, b)
    with open(path, "w") as f:
        f.write(text)
    out = _build.compile_library(d, os.path.join(d, "lib.so"))
    return _build.bind(ctypes.CDLL(out))


def main(names):
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from sr3_tpu_torch.ops import _build, attention

    cs = _chip_smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = {name: build(name) for name in names}
    g = torch.Generator(device="cuda").manual_seed(12)
    res = {name: {} for name in names}
    for bh, seq, d in SHAPES:
        q, k, v = (torch.randn(bh, seq, d, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        ref_o, ref_lse = attention.attention_fwd_plain(q, k, v, scale)
        label = f"{bh}x{seq}x{d}"
        for rnd in range(ROUNDS):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                _build._lib = libs[name]
                o, lse = attention.attention_fwd(q, k, v, scale)
                for out, ref, tol in ((o, ref_o, 2e-2), (lse, ref_lse, 1e-4)):
                    err = ((out - ref).abs().max() / ref.abs().max()).item()
                    if not err <= tol:
                        raise AssertionError(f"{name} {label}: {err:.3e}")
                ms = cs._device_ms(torch, lambda: attention.attention_fwd(
                    q, k, v, scale), required=True)
                res[name][label] = min(res[name].get(label, ms), ms)
        print(f"  {label}: " + ", ".join(f"{name} {res[name][label]:.4f}"
                                         for name in names), flush=True)
        del q, k, v, ref_o, ref_lse
        torch.cuda.empty_cache()
    _build._lib = None
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT  # not this package's own directory
    names = sys.argv[1:] or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        sys.exit(f"unknown variants {sorted(unknown)}; "
                 f"known: {sorted(VARIANTS)}")
    sys.exit(main(["base"] + [n for n in names if n != "base"]))
