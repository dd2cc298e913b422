"""Time the port's GroupNorm kernels (csrc/groupnorm.cu: K2's cluster
kernel and K1's statistics launch) in variants of their tuning constants,
side by side on one NVIDIA GPU.

  python tools/torch_gn_variants.py [variant ...]

Each variant is a copy of sr3_tpu_torch/csrc with textual replacements of
constants in common.cuh / groupnorm.cu (VARIANTS), compiled and bound as
the port's own library is (sr3_tpu_torch/ops/_build.py: its nvcc flags,
its ctypes signatures) into its own library under _chipwork/gn_variants/
(ignored by git), and called through its C entries on bf16 inputs at the
shapes of the SR3 paths; BUILD_WORKERS variants compile at a time. Prints, per shape and variant, the device time per launch of
the kernel (torch.profiler, mean over REPEATS launches) beside the least
time the card could take (bytes over 3.35 TB/s), and whether the output
matches the first variant's bit for bit. Needs CUDA and nvcc; imports
nothing of JAX.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sr3_tpu_torch.ops import _build  # noqa: E402

OUT = os.path.join(ROOT, "_chipwork", "gn_variants")
BUILD_WORKERS = 4
PEAK_BYTES = 3.35e12
REPEATS = 10
CH, GN = "common.cuh", "groupnorm.cu"
# name: [(file, text, replacement)]
VARIANTS = {
    "base": [],
    # K2's cluster plan
    "k2_chunk32k": [(CH, "kGnChunkBytes = 64 << 10", "kGnChunkBytes = 32 << 10")],
    "k2_chunk128k": [(CH, "kGnChunkBytes = 64 << 10", "kGnChunkBytes = 128 << 10")],
    "k2_fill2": [(CH, "const long long fill = (sms", "const long long fill = (2LL * sms")],
    "k2_fill4": [(CH, "const long long fill = (sms", "const long long fill = (4LL * sms")],
    "k2_row128": [(CH, "kGnClusterRowBytes = 64;", "kGnClusterRowBytes = 128;")],
    # K1's statistics plan
    "st_blocks3": [(CH, "kGnStatsBlocksPerSm = 4;", "kGnStatsBlocksPerSm = 3;")],
    "st_blocks8": [(CH, "kGnStatsBlocksPerSm = 4;", "kGnStatsBlocksPerSm = 8;"),
                   (CH, "kGnMinBlocksPerSm = 3;", "kGnMinBlocksPerSm = 4;")],
    "st_registers": [(GN, "constexpr bool kRing = V * sizeof(T) == 16;",
                      "constexpr bool kRing = false;")],
    "st_no_fold": [(GN, "    if (!last) return;", "    return;")],
}
# (B, C, H, G, swish) of K2 calls and (B, C, H, G) of K1 statistics calls
K2_SHAPES = [(2, 512, 64, 16, False), (4, 64, 128, 32, True),
             (8, 512, 64, 16, False), (2, 256, 128, 16, True),
             (8, 512, 16, 32, False), (2, 512, 8, 32, False)]
K1_SHAPES = [(2, 64, 512, 16), (8, 64, 512, 16), (8, 128, 256, 16),
             (8, 256, 128, 16), (8, 512, 64, 16)]


def build(name, reps):
    """The variant's library: a copy of csrc with ``reps`` applied,
    compiled by _build.compile_library and bound to _build._SIGNATURES."""
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, d)
    for f, old, new in reps:
        p = os.path.join(d, f)
        s = open(p).read()
        if s.count(old) != 1:
            raise ValueError(f"{name}: {old!r} not found once in {f}")
        with open(p, "w") as fh:
            fh.write(s.replace(old, new))
    so = _build.compile_library(d, os.path.join(d, "lib.so"))
    return _build.bind(ctypes.CDLL(so))


def device_us(fn, kernel):
    """Mean device microseconds of the launches of `kernel` in REPEATS
    calls of fn."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPEATS):
            fn()
        torch.cuda.synchronize()
    ts = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and kernel in e.name]
    return sum(ts) / max(1, len(ts)), len(ts)


def main(names):
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.time()
    with ThreadPoolExecutor(BUILD_WORKERS) as pool:
        libs = dict(zip(names, pool.map(lambda n: build(n, VARIANTS[n]),
                                        names)))
    print(f"built {len(libs)} variants in {time.time() - t0:.1f} s",
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    cl, dt = torch.channels_last, torch.bfloat16
    st = torch.cuda.current_stream().cuda_stream
    tickets = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
    for b, c, h, groups, swish in K2_SHAPES:
        x = torch.randn(b, c, h, h, device="cuda", generator=g)
        x = (3 * x + 1).to(dt).contiguous(memory_format=cl)
        gw = 1 + 0.2 * torch.randn(c, device="cuda", generator=g)
        gb = 0.1 * torch.randn(c, device="cuda", generator=g)
        first = None
        for n, lib in libs.items():
            y = torch.empty_like(x)
            fn = lambda: lib.sr3_group_norm(
                x.data_ptr(), gw.data_ptr(), gb.data_ptr(), y.data_ptr(), b,
                h * h, c, groups, 1e-5, int(swish), 1, st)
            if fn():
                print(f"  K2 {b}x{c}x{h}x{h} {n}: launch error", flush=True)
                continue
            us, k = device_us(fn, "gn_cluster_kernel")
            first = y.clone() if first is None else first
            same = torch.equal(y.view(torch.int16), first.view(torch.int16))
            print(f"  K2 {b}x{c}x{h}x{h} G={groups} swish {int(swish)} {n}: "
                  f"{us:.2f} us ({k} launches; bound "
                  f"{2 * x.numel() * 2 / PEAK_BYTES * 1e6:.2f} us); "
                  f"bits as base {same}", flush=True)
    for b, c, h, groups in K1_SHAPES:
        x = torch.randn(b, c, h, h, device="cuda", generator=g)
        x = x.to(dt).contiguous(memory_format=cl)
        w = torch.randn(64, c, 3, 3, device="cuda", generator=g) / (3 * c)
        w = w.to(dt).contiguous(memory_format=cl)
        gw, gb = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
        ps = 1 + 0.3 * torch.randn(b, c, device="cuda", generator=g)
        pb = 0.5 * torch.randn(b, c, device="cuda", generator=g)
        y = torch.empty(b, 64, h, h, device="cuda", dtype=dt,
                        memory_format=cl)
        first = None
        for n, lib in libs.items():
            ws = torch.empty(lib.sr3_gn_workspace_floats(b, h * h, c, groups,
                                                         1), device="cuda")
            fn = lambda: lib.sr3_gn_silu_conv3x3(
                x.data_ptr(), ps.data_ptr(), pb.data_ptr(), None, None,
                gw.data_ptr(), gb.data_ptr(), w.data_ptr(), None, None,
                y.data_ptr(), ws.data_ptr(), tickets.data_ptr(), b, h, h, c,
                64, groups, 1e-5, 1, st)
            if fn():
                print(f"  K1 {b}x{c}x{h}x{h} {n}: launch error", flush=True)
                continue
            us, k = device_us(fn, "gn_stats_kernel")
            mult = ws[:2 * b * c].clone()
            first = mult if first is None else first
            same = torch.equal(mult, first)
            print(f"  K1 statistics {b}x{c}x{h}x{h} G={groups} {n}: "
                  f"{us:.2f} us ({k} launches; bound "
                  f"{x.numel() * 2 / PEAK_BYTES * 1e6:.2f} us); mult/add as "
                  f"base {same}; tickets 0: "
                  f"{int(torch.count_nonzero(tickets)) == 0}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
