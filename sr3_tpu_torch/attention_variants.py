"""Time the port's attention kernels in variants of their design, side by
side on one NVIDIA GPU: K4's bf16 route (``csrc/attention.cu``) or K5's
and K6's (``csrc/attention_bwd.cu``).

  python sr3_tpu_torch/attention_variants.py k4 [variant ...]
  python sr3_tpu_torch/attention_variants.py bwd [variant ...]

Each variant is a copy of sr3_tpu_torch/csrc with textual replacements in
the family's source (its VARIANTS table), compiled and bound as the port's
own library is (``ops/_build.py``: its nvcc flags, its ctypes signatures)
into its own library under _chipwork/<family>_variants/ (ignored by
git). Each is called through the family's wrapper with its library
swapped in (``attention.attention_fwd``; K5 / K6:
``attention._bwd_kernel``), on bf16 inputs at the family's shapes of
PERF.md section 6 (``attention_device_ms.SHAPES`` / ``BWD_SHAPES``). Each
output is held against the plain version (K4: o within 2e-2 of max|plain|,
lse within 1e-4; K5 / K6: dq, dk, dv within 2e-2); the card ms a call is
this checkout's chip_smoke.py ``_device_ms`` (20 calls queued behind a
spin kernel), the least of ROUNDS rounds that alternate the variants'
order. Prints the card's name and power limit, a line a shape, and last
one JSON object {variant: {shape: [ms of each timed call]}} (K4: [ms];
bwd: [K5 ms, K6 ms]). Needs CUDA and nvcc; imports nothing of JAX.
"""

import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from typing import Callable, NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 2
# name: [(text, replacement)] in attention.cu
K4_VARIANTS = {
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
# name: [(text, replacement)] in attention_bwd.cu
BWD_VARIANTS = {
    "base": [],
    # the resident tiles' boxes always whole (zero-filled past S)
    "full_box": [("const int rbox = a.S < T::kRows ? (a.S + 7) / 8 * 8 : "
                  "T::kRows;", "const int rbox = T::kRows;")],
    # splits where the blocks fill at most half of the SMs, as K4's (the
    # plan's rule: a quarter)
    "half_wave": [("  if (4 * blocks <= sms) {", "  if (2 * blocks <= sms) {")],
    # splits of at least 2 streamed tiles (the plan's rule: 4)
    "split_per2": [("kMinSplitTiles = 4;", "kMinSplitTiles = 2;")],
    # no split: every grid runs its streamed tiles in one block
    "no_split": [("  if (4 * blocks <= sms) {", "  if (false) {")],
    # K5 at D = 256 streams 64 queries a tile (one ring stage fits; the
    # class's: 32 in four stages)
    "dkv256_bn64": [("kDkvBN[kClasses] = {64, 64, 32, 32}",
                     "kDkvBN[kClasses] = {64, 64, 64, 32}")],
    # K5 at D = 128 and K6 at D = 128: the two warpgroups share 64 rows and
    # split D (twice the blocks)
    "dkv128_split": [("kDkvRows[kClasses] = {128, 128, 64, 64}",
                      "kDkvRows[kClasses] = {128, 64, 64, 64}")],
    "dq128_split": [("kDqRows[kClasses] = {128, 128, 128, 64}",
                     "kDqRows[kClasses] = {128, 64, 128, 64}")],
    # K6 at D = 256 streams 32 keys a tile (three ring stages fit)
    "dq256_bn32": [("kDqBN[kClasses] = {128, 64, 64, 32}",
                    "kDqBN[kClasses] = {128, 64, 32, 32}")],
    # K6 at D = 256: the two warpgroups share 64 queries and split D
    "dq256_split": [("kDqRows[kClasses] = {128, 128, 128, 64}",
                     "kDqRows[kClasses] = {128, 128, 64, 64}")],
    # K6 at D = 128 streams 128 keys a tile
    "dq128_bn128": [("kDqBN[kClasses] = {128, 64, 64, 32}",
                     "kDqBN[kClasses] = {128, 128, 64, 32}")],
    # the register split 24 / 240 instead of 40 / 232
    "regs24": [("kProducerRegs = 40;", "kProducerRegs = 24;"),
               ("kConsumerRegs = 232;", "kConsumerRegs = 240;")],
}


def _bf16_inputs(torch, g, bh, seq, d):
    return [torch.randn(bh, seq, d, device="cuda", generator=g)
            .to(torch.bfloat16) for _ in range(3)]


def _k4_case(torch, attention, g, bh, seq, d):
    """K4 at one shape: its timed call, and a function that runs it and
    gives (out, plain, tolerance) for o and lse."""
    q, k, v = _bf16_inputs(torch, g, bh, seq, d)
    scale = d ** -0.5
    refs = attention.attention_fwd_plain(q, k, v, scale)

    def call():
        return attention.attention_fwd(q, k, v, scale)

    return [call], lambda: zip(call(), refs, (2e-2, 1e-4))


def _bwd_case(torch, attention, g, bh, seq, d):
    """K5 and K6 at one shape: their timed calls (dk / dv, then dq), and a
    function that runs both and gives (out, plain, tolerance) for dq, dk,
    dv. lse and o come from K4 with the current library."""
    q, k, v = _bf16_inputs(torch, g, bh, seq, d)
    gr = torch.randn(bh, seq, d, device="cuda", generator=g)
    scale = d ** -0.5
    o, lse = attention.attention_fwd(q, k, v, scale)
    dsum = (gr * o).sum(-1)
    g16 = gr.to(torch.bfloat16)
    refs = attention.attention_bwd_plain(q, k, v, gr, lse, dsum, scale)
    outs = [torch.empty_like(gr) for _ in range(3)]
    calls = [lambda: attention._bwd_kernel(
                 "sr3_flash_attention_bwd_dkv", attention.dkv_counter, q, k,
                 v, g16, lse, dsum, outs[1:], scale),
             lambda: attention._bwd_kernel(
                 "sr3_flash_attention_bwd_dq", attention.dq_counter, q, k, v,
                 g16, lse, dsum, outs[:1], scale)]

    def checks():
        for call in calls:
            call()
        return zip(outs, refs, (2e-2,) * 3)

    return calls, checks


class Family(NamedTuple):
    source: str        # the .cu file of csrc the variants edit
    variants: dict
    shapes: str        # the attention_device_ms list of (bh, seq, d)
    seed: int
    case: Callable
    labels: tuple      # the timed calls, in order


FAMILIES = {
    "k4": Family("attention.cu", K4_VARIANTS, "SHAPES", 12, _k4_case,
                 ("K4",)),
    "bwd": Family("attention_bwd.cu", BWD_VARIANTS, "BWD_SHAPES", 13,
                  _bwd_case, ("K5", "K6")),
}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build(family, name):
    """The bound library of one variant of a family."""
    from sr3_tpu_torch.ops import _build

    fam = FAMILIES[family]
    d = os.path.join(ROOT, "_chipwork", f"{family}_variants", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "sr3_tpu_torch", "csrc"), d)
    path = os.path.join(d, fam.source)
    with open(path) as f:
        text = f.read()
    for a, b in fam.variants[name]:
        if text.count(a) != 1:
            raise ValueError(f"variant {name}: {a!r} is not in "
                             f"{fam.source} once")
        text = text.replace(a, b)
    with open(path, "w") as f:
        f.write(text)
    out = _build.compile_library(d, os.path.join(d, "lib.so"))
    return _build.bind(ctypes.CDLL(out))


def main(family, names):
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from sr3_tpu_torch.ops import _build, attention

    fam = FAMILIES[family]
    cs = _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    shapes = getattr(_load("attention_device_ms", os.path.join(
        ROOT, "sr3_tpu_torch", "attention_device_ms.py")), fam.shapes)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = {name: build(family, name) for name in names}
    g = torch.Generator(device="cuda").manual_seed(fam.seed)
    res = {name: {} for name in names}
    for bh, seq, d in shapes:
        _build._lib = libs["base"]  # the plain references' inputs
        calls, checks = fam.case(torch, attention, g, bh, seq, d)
        label = f"{bh}x{seq}x{d}"
        for rnd in range(ROUNDS):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                _build._lib = libs[name]
                for out, ref, tol in checks():
                    err = ((out - ref).abs().max() / ref.abs().max()).item()
                    if not err <= tol:
                        raise AssertionError(f"{name} {label}: {err:.3e}")
                ms = [cs._device_ms(torch, call, required=True)
                      for call in calls]
                best = res[name].get(label, ms)
                res[name][label] = [min(a, b) for a, b in zip(best, ms)]
        print(f"  {label} {' / '.join(fam.labels)}: " + ", ".join(
            f"{name} " + " / ".join(f"{t:.4f}" for t in res[name][label])
            for name in names), flush=True)
        del calls, checks
        torch.cuda.empty_cache()
    _build._lib = None
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT  # not this package's own directory
    if len(sys.argv) < 2 or sys.argv[1] not in FAMILIES:
        sys.exit(f"usage: {sys.argv[0]} {{{','.join(FAMILIES)}}} "
                 "[variant ...]")
    family, names = sys.argv[1], sys.argv[2:]
    known = FAMILIES[family].variants
    names = names or list(known)
    unknown = set(names) - set(known)
    if unknown:
        sys.exit(f"unknown variants {sorted(unknown)}; "
                 f"known: {sorted(known)}")
    sys.exit(main(family, ["base"] + [n for n in names if n != "base"]))
