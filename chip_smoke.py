#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (sr3_tpu_torch) once on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each printing its own line and its seconds; any failure exits 1.
The SR3 16->128 paths (configs/sr_sr3_16_128.json):
  1. device: name and power limit from nvidia-smi, torch and CUDA versions;
     TF32 off for the float32 phases;
  2. build: compile sr3_tpu_torch/csrc with nvcc (one process per source);
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at every shape the SR3 16->128 sampling path gives it (batch
     2), in float32 and bfloat16 (each kernel's route by dtype: KERNELS),
     error relative to max|plain| (TOL); K1 also at every shape of the
     64->512 UNet (batch 2; both shape lists checked against the models'
     Blocks) and at two of its serving-batch shapes, each bf16 check
     labelled with the tile it launched; K4's logsumexp and the backward
     kernels K5 / K6 at the training shapes and a ragged one; the autograd
     Functions of K1, K2 and K4 against autograd of their plain versions,
     every input gradient;
  4. full-width model: the 97.8M-parameter SR3 16->128 UNet (random seeded
     weights), one float32 forward on the card (kernels) against the same
     weights on the CPU (plain versions), and the bf16 sampling copy of the
     serving trainer against the same CPU forward;
  5. serving path: GroupedEvaluator.run_sr (what infer_sr runs) in bf16,
     group of 2, T=10 val schedule (the -debug shrink), seeded 16->128
     inputs; launch counters are zeroed just before and every forward
     kernel must have launched; frames must be finite and 1 + n_snap per
     image;
  6. timing (printed, not gated): ms per UNet step of the T=2000 chain at
     batch 8 in bf16 and the 2000-step images/s extrapolated from it; ms per
     call of K1, K2 and K4 against their plain versions;
  7. training path: the train-phase Trainer (batch 4, bf16 compute, float32
     parameters, dropout 0.2, Adam 1e-4) through train_loop for TRAIN_STEPS
     steps on seeded synthetic (HR, SR) batches; counters zeroed just
     before, and K1, K2, K4, K5 and K6 must all have launched; every loss
     finite, every parameter with a finite gradient, every parameter moved;
  8. training gradients: one float32 batch-1 loss and backward of the
     full-width UNet with injected noise, sqrt-gamma and the same dropout
     draws, kernels against the plain ops swapped into the UNet module;
     loss and every parameter's gradient within GRAD_TOL;
  9. training timing: ms per train step at batch 4 (median of TIME_STEPS)
     and train images/s; K4 with its logsumexp, K5 and K6 against the plain
     versions.
The SR3 64->512 training path (configs/sr_sr3_64_512_attn.json, remat on):
 10. K3 statistics: K3 against float64 sums and gn_stats_plain (K3_TOL) at
     the path's 512^2 and 256^2 maps and a ragged one, float32 and bf16; the
     statistics route of group_norm against group_norm_plain, forward and
     input gradients;
 11. long-sequence attention: K4 with its logsumexp, K5 and K6 against the
     plain versions at 4096 and 1024 tokens (head_dim 512) and at 16384
     tokens (head_dim 256); the bf16 K4 autograd Function at 4096 and 16384
     tokens;
 12. 64->512 training path: the full-width train-phase Trainer (70.0M
     parameters, batch 2, bf16, dropout 0.2, remat) through train_loop for
     TRAIN_STEPS_512 steps; counters zeroed just before; K1-K6 launched, K3
     and K4-K6 exactly as often as the model's sites say (twice per
     forward with remat); finite losses, every parameter with a finite
     gradient that moved;
 13. 64->512 training gradients: float32 batch 1, kernels against the plain
     ops (GRAD_TOL), and remat on against remat off (REMAT_TOL);
 14. 64->512 bf16 attention gradients: bf16 batch 1, the loss and every
     attention parameter's gradient with K4-K6 against attention_plain
     swapped into the same model (FORWARD_TOL_BF16);
 15. 64->512 training timing: median train step (CUDA events), train
     images/s, peak memory, and a torch.profiler window (device time by op,
     device busy share);
 16. 64->512 serving path: GroupedEvaluator.run_sr on 2 images, T=10, 512^2
     bf16, frames finite, K1, K2 and K4 launched; median ms of a batch-8
     p_sample_step at 512^2 (the config's val batch) and a torch.profiler
     window over it (device time by op, device busy share);
 17. 64->512 kernel timing: each kernel at the path's shapes (bf16, batch
     2; K4-K6 also at 16384 tokens) beside its plain version and the one
     PyTorch call that computes the same function where there is one
     (library_ms; the port never calls it), each as CUDA-event ms per call
     and as the profiler's device ms per call; and the least time the card
     could take (bound_ms: the larger of bytes over 3.35 TB/s and operations
     over 989 TFLOP/s). Beside K1, cuDNN's conv3x3 alone at its shape (not
     the same function, so not library_ms). The JSON line carries the first
     shape of each.
After phase 17 the bf16 K1 tiles launched since phase 3 (the main paths and
the timing) must all be tiles that phase 3 checked.

Then one JSON line with every kernel's route, source, the TPU kernel it
replaces, launches in phase 12 (and on the other paths), max error and
times, and last the line {"ok": true, "device": {...}}. Without a CUDA
device, or without the rest of the repository beside it, it exits non-zero
and prints no result.
"""

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "sr_sr3_16_128.json")
BATCH_CHECK = 2
BATCH_TIME = 8
TRAIN_STEPS = 6
TIME_STEPS = 12
# bf16: K4's o, K5's dk, dv and K6's dq round P (K4), dO, P, dS (K5) and
# dO, dS (K6) to bf16 before their products on the tensor-core routes
# (attention.cu, attention_bwd.cu headers), where the plain versions keep
# them in float32; K4's logsumexp ("flash_attention_lse") computes in
# float32 from the same inputs as the plain version; the autograd
# Functions: each side rounds its input gradients to bf16 once
TOL = {"float32": {"gn_silu_conv3x3": 1e-4, "group_norm": 1e-5,
                   "flash_attention_fwd": 1e-4, "flash_attention_lse": 1e-4,
                   "flash_attention_bwd_dkv": 1e-4,
                   "flash_attention_bwd_dq": 1e-4, "function": 1e-4},
       "bfloat16": {"gn_silu_conv3x3": 2e-2, "group_norm": 2e-2,
                    "flash_attention_fwd": 2e-2, "flash_attention_lse": 1e-4,
                    "flash_attention_bwd_dkv": 2e-2,
                    "flash_attention_bwd_dq": 2e-2, "function": 2e-2}}
# float32 loss and gradients of the full-width UNet, kernels vs plain ops
GRAD_TOL = 1e-3
FORWARD_TOL = 1e-3
# bf16 activations and weights (2^-9 relative rounding per op) through ~30
# layers; measured ~1.2e-2 of max|out| on an H100
FORWARD_TOL_BF16 = 5e-2

# (Cin, Cout, H=W) of every K1 call of the 16->128 UNet, in the order of
# the forward; phase 3 checks the list against the model's Blocks (k1_sites)
K1_SHAPES = [
    (64, 64, 128), (64, 128, 64), (128, 128, 64), (128, 256, 32),
    (256, 256, 32), (256, 512, 16), (512, 512, 16), (512, 512, 8),
    (1024, 512, 8), (1024, 512, 16), (768, 512, 16), (768, 256, 32),
    (512, 256, 32), (384, 256, 32), (384, 128, 64), (256, 128, 64),
    (192, 128, 64), (192, 64, 128), (128, 64, 128), (64, 3, 128),
]
K2_SHAPES = [(512, 16), (512, 8)]          # (C, H=W), swish off
K4_SHAPES = [(256, 512), (64, 512)]        # (seq, head_dim)
# (batch*heads, seq, head_dim) of K4-with-lse, K5 and K6 in the train step
# at batch 4, and a ragged shape
BWD_SHAPES = [(4, 256, 512), (4, 64, 512), (3, 100, 64)]

# The SR3 64->512 training path (configs/sr_sr3_64_512_attn.json: 70.0M
# parameters, 16 norm groups, attention at 64x64 and 32x32, remat, dropout
# 0.2), batch 2, and its val batch 8
CONFIG_512 = os.path.join(ROOT, "configs", "sr_sr3_64_512_attn.json")
# (Cin, Cout, H=W) of every K1 call of the 64->512 UNet (checked as
# K1_SHAPES is); phase 3 runs them at the train batch, in float32 and bf16
K1_SHAPES_512 = [
    (64, 64, 512), (64, 128, 256), (128, 128, 256), (128, 256, 128),
    (256, 256, 128), (256, 512, 64), (512, 512, 64), (512, 512, 32),
    (1024, 512, 32), (1024, 512, 64), (768, 512, 64), (768, 256, 128),
    (384, 256, 128), (384, 128, 256), (192, 128, 256), (192, 64, 512),
    (128, 64, 512), (64, 3, 512),
]
BATCH_CHECK_512 = 2
# (B, Cin, Cout, H=W): K1 calls of the batch-8 512^2 serving step on which
# the bf16 route takes 128 output channels a block, over 4 and 2 blocks of
# them; phase 3 checks these too
K1_SERVING_512 = [(8, 512, 512, 64), (8, 128, 256, 128)]
TRAIN_STEPS_512 = 3
TIME_STEPS_512 = 10
PROFILE_STEPS_512 = 2
# (B, C, H, W) of K3: the dropout Blocks at 512^2 and 256^2, and a ragged
# map whose 90,000 pixels do not divide into the kernel's pixel slices
K3_SHAPES = [(2, 64, 512, 512), (2, 128, 256, 256), (2, 96, 300, 300)]
# K3's sums against float64 sums: s1 within K3_TOL of sum|x|, s2 within
# K3_TOL of s2 (float32 partial sums of a few thousand terms, in a tree)
K3_TOL = 1e-5
# (batch*heads, seq, head_dim): the 64->512 path's 64x64 and 32x32
# attention, and 16384 tokens (attention at 128x128 on that model)
LONG_SHAPES = [(2, 4096, 512), (2, 1024, 512), (1, 16384, 256)]
# remat on against remat off, float32, same seed and dropout draws, cuDNN's
# deterministic algorithms: the same operations on the same values
REMAT_TOL = 1e-5
# H100 SXM peaks (NVIDIA's data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# name: (source, the TPU kernel it replaces, route by input dtype)
FMA, MMA = "float32 FMA", "bf16 mma.sync tensor cores, float32 accumulate"
WGMMA = ("bf16 wgmma tensor cores (A by ldmatrix from registers, B by "
         "shared-memory descriptor), float32 accumulate, cp.async weight "
         "ring and halo")
KERNELS = {
    "gn_silu_conv3x3": ("sr3_tpu_torch/csrc/conv_fused.cu",
                        "sr3_tpu/ops/conv_fused.py:117",
                        {"float32": FMA, "bfloat16": WGMMA}),
    "group_norm": ("sr3_tpu_torch/csrc/groupnorm.cu",
                   "sr3_tpu/ops/groupnorm.py:237",
                   {"float32": FMA, "bfloat16": FMA}),
    "flash_attention_fwd": ("sr3_tpu_torch/csrc/attention.cu",
                            "sr3_tpu/ops/attention.py:58",
                            {"float32": FMA, "bfloat16": MMA + ", cp.async"}),
    "flash_attention_bwd_dkv": ("sr3_tpu_torch/csrc/attention_bwd.cu",
                                "sr3_tpu/ops/attention.py:163",
                                {"float32": FMA,
                                 "bfloat16": MMA + ", cp.async"}),
    "flash_attention_bwd_dq": ("sr3_tpu_torch/csrc/attention_bwd.cu",
                               "sr3_tpu/ops/attention.py:203",
                               {"float32": FMA,
                                "bfloat16": MMA + ", cp.async"}),
    "gn_stats": ("sr3_tpu_torch/csrc/gn_stats.cu",
                 "sr3_tpu/ops/groupnorm.py:66",
                 {"float32": FMA, "bfloat16": FMA}),
}
FORWARD_KERNELS = ("gn_silu_conv3x3", "group_norm", "flash_attention_fwd")
KERNELS_16_128 = FORWARD_KERNELS + ("flash_attention_bwd_dkv",
                                    "flash_attention_bwd_dq")


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            print(f"[{name}] done in {time.perf_counter() - t0:.2f} s",
                  flush=True)
            return out
        return run
    return wrap


def rel_err(out, ref):
    d = (out.float() - ref.float()).abs().max().item()
    return d / max(ref.float().abs().max().item(), 1e-30), d


def check(torch, errs, failures, kernel, dtype, label, out, ref, tol=None):
    """Hold one kernel output against its plain version: error relative to
    max|ref| within TOL (or ``tol``); recorded in ``errs[kernel]``."""
    torch.cuda.synchronize()
    rel, absd = rel_err(out, ref)
    tol = TOL[dtype][kernel] if tol is None else tol
    ok = rel <= tol
    e = errs.setdefault(kernel, {"max_abs_err": 0.0, "max_rel_err": 0.0,
                                 "checks": 0})
    e["max_abs_err"] = max(e["max_abs_err"], absd)
    e["max_rel_err"] = max(e["max_rel_err"], rel)
    e["checks"] += 1
    print(f"  {kernel} {dtype} {label}: rel {rel:.3e} abs {absd:.3e} "
          f"tol {tol:g} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"{kernel} {dtype} {label}")


def check_grad(torch, failures, name, dtype, i, got, ref):
    """An autograd Function's input gradient against autograd of the plain
    version."""
    torch.cuda.synchronize()
    rel, absd = rel_err(got, ref)
    tol = TOL[dtype]["function"]
    ok = rel <= tol and got.dtype == ref.dtype
    print(f"  autograd {name} {dtype} input {i} gradient: rel {rel:.3e} "
          f"abs {absd:.3e} tol {tol:g} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"autograd {name} {dtype} input {i}")


def function_grads(torch, call, wrapper, plain, inputs):
    """Input gradients of (wrapper, plain) for one seeded output weighting."""
    grads = []
    for f in (wrapper, plain):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = call(f, leaves)
        w = torch.randn(out.shape, device="cuda", generator=torch
                        .Generator(device="cuda").manual_seed(1))
        (out.float() * w).sum().backward()
        grads.append([t.grad for t in leaves])
    return grads


@phase("device")
def device_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@phase("build")
def build_phase():
    from sr3_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    print(f"built {os.path.relpath(path, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    with open(path + ".log") as f:
        print_ptxas(f.read())


def print_ptxas(log):
    """Registers and spill stores of each kernel, from ptxas -v output."""
    import re

    name, spill = None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(f"  ptxas {name}: {m.group(1)} registers, {spill} bytes "
                  f"spill stores", flush=True)
            name, spill = None, 0


def _kernel_name(mangled):
    """`flash_fwd_kernel<float>` or `..._wgmma_kernel<16,1,128>` from a
    mangled kernel name: the length-prefixed identifier that ends in
    `_kernel`, and its dtype or integer template arguments."""
    import re

    for run in re.finditer(r"\d+", mangled):
        for i in range(len(run.group())):
            n, at = int(run.group()[i:]), run.end()
            ident = mangled[at:at + n]
            if len(ident) == n and ident.endswith("_kernel"):
                rest = mangled[at + n:]
                ints = re.match(r"I((?:Li\d+E)+)E", rest)
                if ints:
                    args = re.findall(r"Li(\d+)E", ints.group(1))
                    return ident + "<" + ",".join(args) + ">"
                return ident + ("<float>" if rest.startswith("If") else
                                "<bf16>" if rest.startswith("I13__nv_bf")
                                else "")
    return mangled


def _k1_inputs(torch, g, b, cin, cout, hw, dtype, film):
    dev, cl = "cuda", torch.channels_last
    x = torch.randn(b, cin, hw, hw, device=dev, generator=g)
    x = x.to(dtype).contiguous(memory_format=cl)
    gw = 1 + 0.2 * torch.randn(cin, device=dev, generator=g)
    gb = 0.1 * torch.randn(cin, device=dev, generator=g)
    w = torch.randn(cout, cin, 3, 3, device=dev, generator=g) / (3 * cin ** .5)
    w = w.to(dtype).contiguous(memory_format=cl)
    bias = 0.1 * torch.randn(cout, device=dev, generator=g)
    kw = {}
    if film:
        kw["pre_scale"] = 1 + 0.3 * torch.randn(b, cin, device=dev, generator=g)
        kw["pre_bias"] = 0.5 * torch.randn(b, cin, device=dev, generator=g)
        r = torch.randn(b, cout, hw, hw, device=dev, generator=g)
        kw["residual"] = r.to(dtype).contiguous(memory_format=cl)
    return (x, gw, gb, w, bias, 32), kw


@phase("kernels")
def kernel_phase(torch, errs):
    from sr3_tpu_torch.ops import attention, conv_fused, groupnorm

    g = torch.Generator(device="cuda").manual_seed(0)
    failures = []

    def record_fn(name, dtype, i, got, ref):
        check_grad(torch, failures, name, dtype, i, got, ref)

    def record(kernel, dtype, label, out, ref):
        check(torch, errs, failures, kernel, dtype, label, out, ref)

    for config, shapes in ((CONFIG, K1_SHAPES), (CONFIG_512, K1_SHAPES_512)):
        sites = k1_sites(torch, config)
        if sorted(set(sites)) != sorted(shapes):
            failures.append(f"K1 shapes of {os.path.basename(config)}: the "
                            f"model's {sorted(set(sites))}")
    k1_cases = ([(BATCH_CHECK, *s) for s in K1_SHAPES]
                + [(BATCH_CHECK_512, *s) for s in K1_SHAPES_512]
                + K1_SERVING_512)
    checked_tiles = set()
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for b, cin, cout, hw in k1_cases:
            for film in ((False,) if cout == 3 else (False, True)):
                args, kw = _k1_inputs(torch, g, b, cin, cout, hw, dtype, film)
                label = (f"{b}x{cin}x{hw}x{hw}->{cout}"
                         + (" +film+residual" if film else ""))
                conv_fused.bf16_tile_launches(reset=True)
                out = conv_fused.gn_silu_conv3x3(*args, **kw)
                tiles = [t for t, n in conv_fused.bf16_tile_launches().items()
                         if n]
                if dtype == torch.bfloat16:
                    label += " tile " + ",".join(tiles)
                    checked_tiles.update(tiles)
                record("gn_silu_conv3x3", dn, label, out,
                       conv_fused.gn_silu_conv3x3_plain(*args, **kw))
                del args, kw, out
        for c, hw in K2_SHAPES:
            x = torch.randn(BATCH_CHECK, c, hw, hw, device="cuda", generator=g)
            x = (3 * x + 1).to(dtype).contiguous(memory_format=torch.channels_last)
            gw = 1 + 0.2 * torch.randn(c, device="cuda", generator=g)
            gb = 0.1 * torch.randn(c, device="cuda", generator=g)
            record("group_norm", dn, f"{BATCH_CHECK}x{c}x{hw}x{hw}",
                   groupnorm.group_norm(x, gw, gb, 32, swish=False),
                   groupnorm.group_norm_plain(x, gw, gb, 32, swish=False))
        for seq, d in K4_SHAPES:
            q, k, v = (torch.randn(BATCH_CHECK, seq, d, device="cuda",
                                   generator=g).to(dtype) for _ in range(3))
            record("flash_attention_fwd", dn, f"{BATCH_CHECK}x{seq}x{d}",
                   attention.attention(q, k, v, d ** -0.5),
                   attention.attention_plain(q, k, v, d ** -0.5))
        for bh, seq, d in BWD_SHAPES:
            q, k, v = (torch.randn(bh, seq, d, device="cuda",
                                   generator=g).to(dtype) for _ in range(3))
            gr = torch.randn(bh, seq, d, device="cuda", generator=g)
            label = f"{bh}x{seq}x{d}"
            o, lse = attention.attention_fwd(q, k, v, d ** -0.5)
            ref_o, ref_lse = attention.attention_fwd_plain(q, k, v, d ** -0.5)
            record("flash_attention_fwd", dn, label + " with lse: o", o, ref_o)
            check(torch, errs, failures, "flash_attention_fwd", dn,
                  label + " with lse: lse", lse, ref_lse,
                  tol=TOL[dn]["flash_attention_lse"])
            dsum = (gr * o).sum(-1)
            dq, dk, dv = attention.attention_bwd(q, k, v, gr, lse, dsum,
                                                 d ** -0.5)
            rq, rk, rv = attention.attention_bwd_plain(q, k, v, gr, lse, dsum,
                                                       d ** -0.5)
            record("flash_attention_bwd_dkv", dn, label + ": dk", dk, rk)
            record("flash_attention_bwd_dkv", dn, label + ": dv", dv, rv)
            record("flash_attention_bwd_dq", dn, label + ": dq", dq, rq)
        for name, call, wrapper, plain, inputs in _function_cases(
                torch, g, dtype):
            grads = function_grads(torch, call, wrapper, plain, inputs)
            for i, (got, ref) in enumerate(zip(*grads)):
                record_fn(name, dn, i, got, ref)
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failures}")
    conv_fused.bf16_tile_launches(reset=True)
    return checked_tiles


@phase("K1 tiles")
def k1_tile_phase(checked):
    """Fail if a bf16 K1 tile launched since phase 3 went unchecked."""
    from sr3_tpu_torch.ops import conv_fused

    taken = {t: n for t, n in conv_fused.bf16_tile_launches().items() if n}
    print(f"  bf16 K1 launches by tile since phase 3: {taken}; checked in "
          f"phase 3: {sorted(checked)}", flush=True)
    if not taken or set(taken) - checked:
        raise AssertionError(f"bf16 K1 tiles launched but not checked: "
                             f"{sorted(set(taken) - checked)}")


def k1_sites(torch, config):
    """(Cin, Cout, H) of each K1 call of one UNet forward of ``config``'s
    model, in order, read off its Blocks (a meta-device copy): both Blocks
    of every ResnetBlock, then final_conv. In training the dropout Blocks
    run K2 and a plain conv instead."""
    from sr3_tpu_torch.models.networks import define_G
    from sr3_tpu_torch.models.unet import Downsample, Upsample

    net = define_G(_load_opt(config=config), device="meta").denoise_fn
    res, out = net.image_size, []

    def conv(block):
        return (*block.block[3].weight.shape[1::-1], res)

    for layer in (*net.downs[1:], *net.mid, *net.ups):
        if isinstance(layer, Downsample):
            res //= 2
        elif isinstance(layer, Upsample):
            res *= 2
        else:
            out += [conv(layer.res_block.block1), conv(layer.res_block.block2)]
    return out + [conv(net.final_conv)]


def _function_cases(torch, g, dtype):
    """(name, call, wrapper, plain, inputs) of the K1, K2 and K4 autograd
    Functions at main-path shapes (batch 2)."""
    from sr3_tpu_torch.ops import attention, conv_fused, groupnorm

    r = lambda *s: torch.randn(*s, device="cuda", generator=g)
    args, kw = _k1_inputs(torch, g, BATCH_CHECK, 512, 512, 16, dtype, True)
    k1 = [*args[:5], kw["pre_bias"], kw["residual"]]
    x = (3 * r(BATCH_CHECK, 512, 16, 16) + 1).to(dtype)
    k2 = [x.contiguous(memory_format=torch.channels_last), 1 + 0.2 * r(512),
          0.1 * r(512)]
    k4 = [r(BATCH_CHECK, 256, 512).to(dtype) for _ in range(3)]
    return [
        ("gn_silu_conv3x3", lambda f, t: f(*t[:5], 32, pre_bias=t[5],
                                           residual=t[6]),
         conv_fused.gn_silu_conv3x3, conv_fused.gn_silu_conv3x3_plain, k1),
        ("group_norm", lambda f, t: f(*t, 32, swish=True),
         groupnorm.group_norm, groupnorm.group_norm_plain, k2),
        ("attention", lambda f, t: f(*t, 512 ** -0.5),
         attention.attention, attention.attention_plain, k4),
    ]


def _load_opt(dtype=None, val_steps=None, phase="val", config=CONFIG):
    from sr3_tpu_torch.utils.config import load_config

    opt = load_config(config)
    opt["phase"] = phase
    opt["path"]["resume_state"] = None
    if dtype:
        opt["model"]["dtype"] = dtype
    if val_steps:
        opt["model"]["beta_schedule"]["val"]["n_timestep"] = val_steps
    return opt


def counters():
    from sr3_tpu_torch.ops import attention, conv_fused, groupnorm

    return [conv_fused.counter, groupnorm.counter, groupnorm.stats_counter,
            attention.counter, attention.dkv_counter, attention.dq_counter]


def launches_of(names):
    return {c.name: c.n for c in counters() if c.name in names}


def forward_launches():
    return {c.name: c.n for c in counters() if c.name in FORWARD_KERNELS}


@phase("full-width model")
def model_phase(torch):
    from sr3_tpu_torch.models.networks import count_params, define_G
    from sr3_tpu_torch.training.trainer import create_model

    opt = _load_opt(dtype="float32")
    gpu = define_G(opt, device="cuda", seed=0).denoise_fn
    n = count_params(gpu)
    print(f"  SR3 16->128 UNet: {n:,d} parameters ({n / 1e6:.1f}M)", flush=True)
    if abs(n / 1e6 - 97.8) > 0.05:
        raise AssertionError(f"expected 97.8M parameters, got {n}")
    cpu = define_G(opt, device="cpu", seed=0).denoise_fn
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 6, 128, 128, generator=g)
    lvl = torch.tensor([0.5])
    for c in counters():
        c.n = 0
    with torch.inference_mode():
        out_gpu = gpu(x.cuda(), lvl.cuda()).cpu()
        out_cpu = cpu(x, lvl)
    rel, absd = rel_err(out_gpu, out_cpu)
    launches = forward_launches()
    print(f"  forward B=1 float32, card vs CPU: rel {rel:.3e} abs {absd:.3e} "
          f"tol {FORWARD_TOL:g}; launches {launches}", flush=True)
    if not (rel <= FORWARD_TOL and torch.isfinite(out_gpu).all()):
        raise AssertionError(f"full-width forward: rel {rel} > {FORWARD_TOL}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")

    trainer = create_model(_load_opt(val_steps=10))  # the serving model
    trainer.netG.load_state_dict(gpu.state_dict())
    with torch.inference_mode():
        out16 = trainer._eval_params()(x.cuda(), lvl.cuda()).cpu()
    rel, absd = rel_err(out16, out_cpu)
    print(f"  forward B=1 {trainer.netG.dtype} sampling copy, card vs CPU "
          f"float32: rel {rel:.3e} abs {absd:.3e} tol {FORWARD_TOL_BF16:g}",
          flush=True)
    if not (rel <= FORWARD_TOL_BF16 and torch.isfinite(out16).all()):
        raise AssertionError(f"bf16 forward: rel {rel} > {FORWARD_TOL_BF16}")
    return trainer


@phase("serving path")
def serving_phase(torch, trainer):
    import numpy as np
    import torch.nn.functional as F

    from sr3_tpu_torch.models.diffusion import _snapshot_count
    from sr3_tpu_torch.training.evaluation import GroupedEvaluator

    opt = trainer.opt
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"],
                                   schedule_phase="val")
    g = torch.Generator().manual_seed(2)
    lr = torch.rand(2, 3, 16, 16, generator=g) * 2 - 1
    sr = F.interpolate(lr, size=(128, 128), mode="bicubic",
                       align_corners=False).clamp(-1, 1)
    items = [{"SR": sr[i].permute(1, 2, 0).numpy(), "Index": i}
             for i in range(2)]
    ev = GroupedEvaluator(trainer, group_size=2)
    for c in counters():
        c.n = 0
    t0 = time.perf_counter()
    outs = list(ev.run_sr(iter(items), continous=True))
    dt = time.perf_counter() - t0
    launches = forward_launches()
    n_snap, _ = _snapshot_count(trainer.sched.num_timesteps)
    for item, frames in outs:
        if frames.shape != (1 + n_snap, 128, 128, 3):
            raise AssertionError(f"frames shape {frames.shape}")
        if not np.isfinite(frames).all():
            raise AssertionError("non-finite frames")
    print(f"  run_sr(continous=True) {trainer.netG.dtype}: {len(outs)} images, "
          f"frames {outs[0][1].shape}, T={trainer.sched.num_timesteps}, "
          f"{dt:.2f} s; launches {launches}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch on the main path: "
                             f"{launches}")
    return launches


def _synthetic_batches(np, n, b, seed, lr_size=16, scale=8):
    """n seeded (HR, SR) host batches, NHWC float32 in [-1, 1]: the SR image
    is the upsampled low-resolution image and HR that plus noise, as the
    dataset's pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lr = rng.uniform(-1, 1, (b, lr_size, lr_size, 3)).astype(np.float32)
        sr = np.repeat(np.repeat(lr, scale, axis=1), scale, axis=2)
        hr = np.clip(sr + 0.1 * rng.standard_normal(sr.shape), -1, 1)
        out.append({"HR": hr.astype(np.float32), "SR": sr})
    return out


def _train_loop_checked(torch, trainer, opt, loader, names):
    """``train_loop`` over host batches with the launch counters zeroed just
    before; fails unless every loss is finite, every kernel of ``names``
    launched, and every parameter got a finite gradient and moved. Returns
    the launches."""
    import numpy as np

    from sr3_tpu_torch.training.loops import train_loop

    net = trainer.netG
    before = [p.detach().clone() for p in net.parameters()]
    losses = []
    step = trainer.optimize_parameters

    def logged_step():
        step()
        losses.append(trainer.log_dict["l_pix"])

    trainer.optimize_parameters = logged_step
    for c in counters():
        c.n = 0
    t0 = time.perf_counter()
    try:
        train_loop(trainer, loader, opt, lambda s, e: None)
        torch.cuda.synchronize()
    finally:
        del trainer.optimize_parameters
    dt = time.perf_counter() - t0
    launches = launches_of(names)
    losses = [float(x) for x in losses]
    print(f"  train_loop {len(losses)} steps in {dt:.2f} s; losses "
          f"{[round(x, 5) for x in losses]}; launches {launches}", flush=True)
    if len(losses) != len(loader) or not all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch in training: "
                             f"{launches}")
    bad = [n for n, p in net.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all()]
    still = [n for (n, p), p0 in zip(net.named_parameters(), before)
             if torch.equal(p.detach(), p0)]
    print(f"  parameters without a finite gradient: {len(bad)}; "
          f"parameters that did not move: {len(still)} of {len(before)}",
          flush=True)
    if bad or still:
        raise AssertionError(f"no finite gradient: {bad[:5]}; "
                             f"not moved: {still[:5]}")
    return launches


def _train_trainer(torch, config, steps):
    """The train-phase Trainer of ``config`` for ``steps`` steps through
    train_loop (print every step, no validation or checkpoint)."""
    from sr3_tpu_torch.training.trainer import create_model

    opt = _load_opt(phase="train", config=config)
    opt["train"].update(n_iter=steps, print_freq=1, val_freq=10 ** 9,
                        save_checkpoint_freq=10 ** 9)
    trainer = create_model(opt)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"],
                                   schedule_phase="train")
    return trainer, opt


@phase("training path")
def training_phase(torch):
    import numpy as np

    from sr3_tpu_torch.models.networks import count_params

    trainer, opt = _train_trainer(torch, CONFIG, TRAIN_STEPS)
    b = opt["datasets"]["train"]["batch_size"]
    unet = opt["model"]["unet"]
    print(f"  train-phase Trainer: {count_params(trainer.netG):,d} params "
          f"float32, compute {trainer.netG.dtype}, batch {b}, dropout "
          f"{unet['dropout']}, Adam lr {opt['train']['optimizer']['lr']}",
          flush=True)
    if trainer.netG.dtype != torch.bfloat16 or b != 4 or unet["dropout"] != 0.2:
        raise AssertionError("the training path runs at batch 4, bf16, "
                             "dropout 0.2")
    loader = _synthetic_batches(np, TRAIN_STEPS, b, seed=4)
    launches = _train_loop_checked(torch, trainer, opt, loader, KERNELS_16_128)
    return trainer, launches


def _train_case(torch, config, size, seed, dtype="float32"):
    """A train-mode diffusion of ``config`` computing in ``dtype`` on the
    card and a seeded batch-1 loss with injected noise and sqrt-gamma:
    ``loss_and_grads()`` runs it with a fresh dropout generator of one seed
    and returns (loss, {name: grad})."""
    from sr3_tpu_torch.models.networks import define_G
    from sr3_tpu_torch.models.schedule import make_schedule

    opt = _load_opt(dtype=dtype, phase="train", config=config)
    diffusion = define_G(opt, device="cuda", seed=0)
    net = diffusion.denoise_fn.train()
    sched = make_schedule(opt["model"]["beta_schedule"]["train"], "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    cl = torch.channels_last
    batch = {k: (torch.rand(1, 3, size, size, device="cuda", generator=g) * 2
                 - 1).contiguous(memory_format=cl) for k in ("HR", "SR")}
    injected = {"noise": torch.randn(1, 3, size, size, device="cuda",
                                     generator=g),
                "sqrt_gamma": torch.full((1, 1), 0.7, device="cuda")}

    def loss_and_grads():
        net.zero_grad(set_to_none=True)
        masks = torch.Generator(device="cuda").manual_seed(seed + 1)
        loss = diffusion.p_losses(net, sched, batch, masks, injected)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in net.named_parameters()}

    return net, loss_and_grads


def _compare_grads(a, b):
    """(relative loss difference, worst parameter, its relative error) of
    two (loss, grads) results."""
    (loss_a, grads_a), (loss_b, grads_b) = a, b
    worst, worst_rel = None, 0.0
    for n, gb in grads_b.items():
        rel, _ = rel_err(grads_a[n], gb)
        if worst is None or not rel <= worst_rel:
            worst, worst_rel = n, rel
    return abs(loss_a - loss_b) / abs(loss_b), worst, worst_rel


def _kernels_vs_plain(torch, loss_and_grads, names, label):
    """The loss and gradients with the kernels (counters zeroed just before;
    every kernel of ``names`` must launch) against the plain ops swapped
    into the UNet module, within GRAD_TOL. Returns the kernels' result."""
    from sr3_tpu_torch.models import unet as unet_module
    from sr3_tpu_torch.ops import attention, conv_fused, groupnorm

    for c in counters():
        c.n = 0
    kernels = loss_and_grads()
    launches = launches_of(names)
    plain = {"gn_silu_conv3x3": conv_fused.gn_silu_conv3x3_plain,
             "group_norm": groupnorm.group_norm_plain,
             "attention": attention.attention_plain}
    saved = {k: getattr(unet_module, k) for k in plain}
    try:
        for k, f in plain.items():
            setattr(unet_module, k, f)
        plain_ops = loss_and_grads()
    finally:
        for k, f in saved.items():
            setattr(unet_module, k, f)
    loss_rel, worst, worst_rel = _compare_grads(kernels, plain_ops)
    print(f"  float32 batch 1{label}, kernels {launches} vs plain ops: loss "
          f"{kernels[0]:.6f} vs {plain_ops[0]:.6f} (rel {loss_rel:.3e}); worst "
          f"of {len(plain_ops[1])} gradients {worst}: rel {worst_rel:.3e}; tol "
          f"{GRAD_TOL:g}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")
    if not (loss_rel <= GRAD_TOL and worst_rel <= GRAD_TOL):
        raise AssertionError(f"gradients disagree: loss {loss_rel}, {worst} "
                             f"{worst_rel}")
    return kernels


@phase("training gradients")
def grad_check_phase(torch):
    _, loss_and_grads = _train_case(torch, CONFIG, 128, seed=5)
    _kernels_vs_plain(torch, loss_and_grads, KERNELS_16_128, "")


@phase("training timing")
def train_timing_phase(torch, trainer):
    import numpy as np

    from sr3_tpu_torch.ops import attention

    b = trainer.opt["datasets"]["train"]["batch_size"]
    trainer.feed_data(_synthetic_batches(np, 1, b, seed=7)[0])
    for _ in range(3):
        trainer.optimize_parameters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(TIME_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        trainer.optimize_parameters()
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
    step_ms = float(np.median(ms))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  train step B={b} {trainer.netG.dtype}: median {step_ms:.3f} "
          f"ms/step over {TIME_STEPS} steps (min {min(ms):.3f}, max "
          f"{max(ms):.3f}); {b / (step_ms / 1000):.3f} train img/s; peak "
          f"device memory {peak:.2f} GiB", flush=True)

    g = torch.Generator(device="cuda").manual_seed(8)
    times = {}
    for bh, seq, d in BWD_SHAPES[:2]:
        q, k, v = (torch.randn(bh, seq, d, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(3))
        gr = torch.randn(bh, seq, d, device="cuda", generator=g)
        scale = d ** -0.5
        o, lse = attention.attention_fwd(q, k, v, scale)
        dsum = (gr * o).sum(-1)
        gr16 = gr.to(torch.bfloat16)  # K5's and K6's dO, as attention_bwd
        out = [torch.empty_like(gr) for _ in range(3)]
        plain_bwd = _time_ms(torch, lambda: attention.attention_bwd_plain(
            q, k, v, gr, lse, dsum, scale))
        pairs = {
            "flash_attention_fwd (lse)": (
                lambda: attention.attention_fwd(q, k, v, scale),
                _time_ms(torch, lambda: attention.attention_fwd_plain(
                    q, k, v, scale))),
            "flash_attention_bwd_dkv": (lambda: attention._bwd_kernel(
                "sr3_flash_attention_bwd_dkv", attention.dkv_counter, q, k,
                v, gr16, lse, dsum, out[1:], scale), plain_bwd),
            "flash_attention_bwd_dq": (lambda: attention._bwd_kernel(
                "sr3_flash_attention_bwd_dq", attention.dq_counter, q, k, v,
                gr16, lse, dsum, out[:1], scale), plain_bwd),
        }
        for name, (fn, plain_ms) in pairs.items():
            kms = _time_ms(torch, fn)
            times.setdefault(name, (kms, plain_ms))
            print(f"  {name} {bh}x{seq}x{d} bf16: kernel {kms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms" + (" (the whole plain backward)"
                                          if "bwd" in name else ""),
                  flush=True)
    return step_ms, times


def _time_ms(torch, fn, n=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


@phase("timing")
def timing_phase(torch, trainer):
    from sr3_tpu_torch.models.schedule import make_schedule
    from sr3_tpu_torch.ops import attention, conv_fused, groupnorm

    sched = make_schedule(dict(schedule="linear", n_timestep=2000,
                               linear_start=1e-6, linear_end=1e-2), "cuda")
    net = trainer._eval_params()
    diff = trainer.diffusion
    g = torch.Generator(device="cuda").manual_seed(3)
    cond = torch.rand(BATCH_TIME, 3, 128, 128, device="cuda", generator=g) * 2 - 1
    img = torch.randn(BATCH_TIME, 3, 128, 128, device="cuda", generator=g)
    steps = iter(range(1999, -1, -1))
    with torch.inference_mode():
        step_ms = _time_ms(torch, lambda: diff.p_sample_step(
            net, sched, img, next(steps), cond, generator=g))
    ips = BATCH_TIME / (2000 * step_ms / 1000)
    print(f"  UNet step (p_sample_step) B={BATCH_TIME} {net.dtype}: "
          f"{step_ms:.3f} ms/step (mean of 20 steps of the T=2000 chain); "
          f"2000-step throughput extrapolated {ips:.4f} img/s", flush=True)

    dt, cl = torch.bfloat16, torch.channels_last
    times = {}

    def pair(kernel, label, fn, plain):
        ms, pms = _time_ms(torch, fn), _time_ms(torch, plain)
        times.setdefault(kernel, (ms, pms))
        print(f"  {kernel} {label} bf16: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms", flush=True)

    for cin, cout, hw in [(64, 64, 128), (256, 256, 32), (1024, 512, 8)]:
        args, kw = _k1_inputs(torch, g, BATCH_TIME, cin, cout, hw, dt, True)
        pair("gn_silu_conv3x3", f"{BATCH_TIME}x{cin}x{hw}x{hw}->{cout}",
             lambda: conv_fused.gn_silu_conv3x3(*args, **kw),
             lambda: conv_fused.gn_silu_conv3x3_plain(*args, **kw))
    for c, hw in K2_SHAPES:
        x = torch.randn(BATCH_TIME, c, hw, hw, device="cuda", generator=g)
        x = x.to(dt).contiguous(memory_format=cl)
        gw, gb = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
        pair("group_norm", f"{BATCH_TIME}x{c}x{hw}x{hw}",
             lambda: groupnorm.group_norm(x, gw, gb, 32, swish=False),
             lambda: groupnorm.group_norm_plain(x, gw, gb, 32, swish=False))
    for seq, d in K4_SHAPES:
        q, k, v = (torch.randn(BATCH_TIME, seq, d, device="cuda",
                               generator=g).to(dt) for _ in range(3))
        pair("flash_attention_fwd", f"{BATCH_TIME}x{seq}x{d}",
             lambda: attention.attention(q, k, v, d ** -0.5),
             lambda: attention.attention_plain(q, k, v, d ** -0.5))
    return times

# ------------------------------------------------------- the 64->512 slice


@phase("K3 statistics")
def k3_phase(torch, errs):
    """K3 against float64 sums and gn_stats_plain; the statistics route of
    group_norm against group_norm_plain, forward and input gradients."""
    from sr3_tpu_torch.ops import groupnorm

    g = torch.Generator(device="cuda").manual_seed(10)
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for b, c, h, w in K3_SHAPES:
            label = f"{b}x{c}x{h}x{w}"
            x = 3 * torch.randn(b, c, h, w, device="cuda", generator=g) + 1
            x = x.to(dtype).contiguous(memory_format=torch.channels_last)
            n = groupnorm.stats_counter.n
            s1, s2 = groupnorm.gn_stats(x)
            p1, p2 = groupnorm.gn_stats_plain(x)
            torch.cuda.synchronize()
            if groupnorm.stats_counter.n != n + 1:
                failures.append(f"gn_stats {label} did not launch once")
            xd = x.double()
            r1, r2 = xd.sum(dim=(2, 3)), xd.square().sum(dim=(2, 3))
            scales = (xd.abs().sum(dim=(2, 3)), r2)
            e = errs.setdefault("gn_stats", {"max_abs_err": 0.0,
                                             "max_rel_err": 0.0, "checks": 0})
            for name, got, plain, ref, sc in (("s1", s1, p1, r1, scales[0]),
                                              ("s2", s2, p2, r2, scales[1])):
                absd = (got.double() - ref).abs()
                rel = (absd / sc).max().item()
                rel_plain = ((got.double() - plain.double()).abs()
                             / sc).max().item()
                e["max_abs_err"] = max(e["max_abs_err"], absd.max().item())
                e["max_rel_err"] = max(e["max_rel_err"], rel)
                e["checks"] += 1
                ok = rel <= K3_TOL and rel_plain <= K3_TOL
                print(f"  gn_stats {dn} {label} {name}: vs float64 rel {rel:.3e}"
                      f" (abs {absd.max().item():.3e}), vs plain rel "
                      f"{rel_plain:.3e} tol {K3_TOL:g} {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    failures.append(f"gn_stats {dn} {label} {name}")
            wt = 1 + 0.2 * torch.randn(c, device="cuda", generator=g)
            bs = 0.1 * torch.randn(c, device="cuda", generator=g)
            n = groupnorm.stats_counter.n
            check(torch, {}, failures, "group_norm", dn,
                  f"{label} statistics route (G=16)",
                  groupnorm.group_norm(x, wt, bs, 16, swish=True),
                  groupnorm.group_norm_plain(x, wt, bs, 16, swish=True))
            if groupnorm.stats_counter.n != n + 1:
                failures.append(f"group_norm {label} did not take the "
                                f"statistics route")
            grads = function_grads(
                torch, lambda f, t: f(*t, 16, swish=True),
                groupnorm.group_norm, groupnorm.group_norm_plain, [x, wt, bs])
            for i, (got, ref) in enumerate(zip(*grads)):
                check_grad(torch, failures, f"group_norm route {label}", dn, i,
                           got, ref)
    if failures:
        raise AssertionError(f"K3 disagrees with its plain version: "
                             f"{failures}")


@phase("long-sequence attention")
def long_attention_phase(torch, errs):
    """K4 with its logsumexp, K5 and K6 against the plain versions at the
    64->512 path's sequence lengths and at 16384 tokens."""
    from sr3_tpu_torch.ops import attention

    g = torch.Generator(device="cuda").manual_seed(11)
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for bh, seq, d in LONG_SHAPES:
            q, k, v = (torch.randn(bh, seq, d, device="cuda", generator=g)
                       .to(dtype) for _ in range(3))
            gr = torch.randn(bh, seq, d, device="cuda", generator=g)
            label, scale = f"{bh}x{seq}x{d}", d ** -0.5
            o, lse = attention.attention_fwd(q, k, v, scale)
            ref_o, ref_lse = attention.attention_fwd_plain(q, k, v, scale)
            check(torch, errs, failures, "flash_attention_fwd", dn,
                  label + " with lse: o", o, ref_o)
            check(torch, errs, failures, "flash_attention_fwd", dn,
                  label + " with lse: lse", lse, ref_lse,
                  tol=TOL[dn]["flash_attention_lse"])
            del ref_o, ref_lse
            dsum = (gr * o).sum(-1)
            dq, dk, dv = attention.attention_bwd(q, k, v, gr, lse, dsum, scale)
            rq, rk, rv = attention.attention_bwd_plain(q, k, v, gr, lse, dsum,
                                                       scale)
            check(torch, errs, failures, "flash_attention_bwd_dkv", dn,
                  label + ": dk", dk, rk)
            check(torch, errs, failures, "flash_attention_bwd_dkv", dn,
                  label + ": dv", dv, rv)
            check(torch, errs, failures, "flash_attention_bwd_dq", dn,
                  label + ": dq", dq, rq)
            del rq, rk, rv
            torch.cuda.empty_cache()
    # the K4 autograd Function (K4 with lse, then K5 and K6) in bf16 at the
    # long shapes, against autograd of the plain version
    for bh, seq, d in (LONG_SHAPES[0], LONG_SHAPES[2]):
        inputs = [torch.randn(bh, seq, d, device="cuda", generator=g)
                  .to(torch.bfloat16) for _ in range(3)]
        grads = function_grads(torch, lambda f, t: f(*t, d ** -0.5),
                               attention.attention, attention.attention_plain,
                               inputs)
        for i, (got, ref) in enumerate(zip(*grads)):
            check_grad(torch, failures, f"attention {bh}x{seq}x{d}",
                       "bfloat16", i, got, ref)
        del inputs, grads
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"long-sequence attention disagrees with the "
                             f"plain versions: {failures}")


def k3_sites(opt):
    """Blocks of one UNet forward whose GroupNorm takes the statistics
    route: the dropout Block (block2) of every ResnetBlock on a map of
    STATS_MIN_HW pixels or more -- res_blocks per level on the way down,
    res_blocks + 1 on the way up."""
    from sr3_tpu_torch.ops.groupnorm import STATS_MIN_HW

    unet = opt["model"]["unet"]
    res, n = opt["model"]["diffusion"]["image_size"], 0
    for _ in unet["channel_multiplier"]:
        if res * res >= STATS_MIN_HW:
            n += 2 * unet["res_blocks"] + 1
        res //= 2
    return n


@phase("64->512 training path")
def training_512_phase(torch):
    """TRAIN_STEPS_512 full-width steps through train_loop at the config's
    batch 2, bf16, remat on; every kernel launched, K3 and K4-K6 as often
    as the model says."""
    import numpy as np

    from sr3_tpu_torch.models.networks import count_params
    from sr3_tpu_torch.models.unet import SelfAttention

    trainer, opt = _train_trainer(torch, CONFIG_512, TRAIN_STEPS_512)
    b = opt["datasets"]["train"]["batch_size"]
    unet = opt["model"]["unet"]
    net = trainer.netG
    n_attn = sum(isinstance(m, SelfAttention) for m in net.modules())
    sites = k3_sites(opt)
    print(f"  train-phase Trainer: {count_params(net):,d} params float32, "
          f"compute {net.dtype}, batch {b}, dropout {unet['dropout']}, remat "
          f"{net.remat}, {n_attn} attention calls and {sites} statistics-"
          f"route GroupNorms per forward", flush=True)
    if net.dtype != torch.bfloat16 or b != 2 or not net.remat \
            or unet["dropout"] != 0.2:
        raise AssertionError("the 64->512 path trains at batch 2, bf16, "
                             "dropout 0.2, remat on")
    loader = _synthetic_batches(np, TRAIN_STEPS_512, b, seed=12, lr_size=64)
    launches = _train_loop_checked(torch, trainer, opt, loader, KERNELS)
    # remat runs every block's forward twice (once more in the backward)
    steps = TRAIN_STEPS_512
    expect = {"gn_stats": 2 * sites * steps,
              "flash_attention_fwd": 2 * n_attn * steps,
              "flash_attention_bwd_dkv": n_attn * steps,
              "flash_attention_bwd_dq": n_attn * steps}
    wrong = {k: (launches[k], v) for k, v in expect.items()
             if launches[k] != v}
    print(f"  expected launches {expect}", flush=True)
    if wrong:
        raise AssertionError(f"launches (got, expected): {wrong}")
    return trainer, launches


@phase("64->512 training gradients")
def grad_check_512_phase(torch):
    """Float32, batch 1, remat on: kernels against the plain ops swapped
    into the UNet (GRAD_TOL); then remat on against remat off with the same
    draws (REMAT_TOL)."""
    net, loss_and_grads = _train_case(torch, CONFIG_512, 512, seed=13)
    _kernels_vs_plain(torch, loss_and_grads, KERNELS, " remat on")
    # cuDNN's default conv backward sums with atomics, in an order that
    # changes from run to run; its deterministic algorithms keep the two
    # runs comparable
    torch.backends.cudnn.deterministic = True
    try:
        kernels = loss_and_grads()
        net.remat = False
        no_remat = loss_and_grads()
    finally:
        net.remat = True
        torch.backends.cudnn.deterministic = False
    loss_rel, worst, worst_rel = _compare_grads(kernels, no_remat)
    print(f"  float32 batch 1, kernels, deterministic cuDNN, remat on vs off: loss "
          f"{kernels[0]:.6f} vs {no_remat[0]:.6f} (rel {loss_rel:.3e}); worst "
          f"gradient {worst}: rel {worst_rel:.3e}; tol {REMAT_TOL:g}",
          flush=True)
    if not (loss_rel <= REMAT_TOL and worst_rel <= REMAT_TOL):
        raise AssertionError(f"remat changes the gradients: loss {loss_rel}, "
                             f"{worst} {worst_rel}")


@phase("64->512 bf16 attention gradients")
def bf16_attention_grad_phase(torch):
    """bf16, batch 1, remat on: the loss and the gradient of every attention
    parameter with K4-K6 (the tensor-core routes of K4 and K5) against the
    same bf16 model with attention_plain swapped into the UNet module; the
    other kernels run on both sides, under cuDNN's deterministic algorithms.
    Within FORWARD_TOL_BF16."""
    from sr3_tpu_torch.models import unet as unet_module
    from sr3_tpu_torch.ops import attention

    _, loss_and_grads = _train_case(torch, CONFIG_512, 512, seed=18,
                                    dtype="bfloat16")
    names = ("flash_attention_fwd", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dq")
    torch.backends.cudnn.deterministic = True
    try:
        for c in counters():
            c.n = 0
        kernels = loss_and_grads()
        launches = launches_of(names)
        unet_module.attention = attention.attention_plain
        try:
            plain = loss_and_grads()
        finally:
            unet_module.attention = attention.attention
    finally:
        torch.backends.cudnn.deterministic = False
    attn = lambda r: (r[0], {n: gr for n, gr in r[1].items() if ".attn." in n})
    kernels, plain = attn(kernels), attn(plain)
    loss_rel, worst, worst_rel = _compare_grads(kernels, plain)
    print(f"  bf16 batch 1 remat on, kernels {launches} vs attention_plain: "
          f"loss {kernels[0]:.6f} vs {plain[0]:.6f} (rel {loss_rel:.3e}); "
          f"worst of {len(plain[1])} attention-parameter gradients {worst}: "
          f"rel {worst_rel:.3e}; tol {FORWARD_TOL_BF16:g}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"an attention kernel did not launch: {launches}")
    if not (loss_rel <= FORWARD_TOL_BF16 and worst_rel <= FORWARD_TOL_BF16):
        raise AssertionError(f"bf16 attention gradients disagree: loss "
                             f"{loss_rel}, {worst} {worst_rel}")


@phase("64->512 serving path")
def serving_512_phase(torch):
    """GroupedEvaluator.run_sr on 2 images, T=10 val schedule, 512^2 bf16;
    then the median ms of one batch-8 p_sample_step (the config's val
    batch) and a torch.profiler window over it."""
    import numpy as np
    import torch.nn.functional as F

    from sr3_tpu_torch.models.diffusion import _snapshot_count
    from sr3_tpu_torch.training.evaluation import GroupedEvaluator
    from sr3_tpu_torch.training.trainer import create_model

    opt = _load_opt(val_steps=10, config=CONFIG_512)
    trainer = create_model(opt)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"],
                                   schedule_phase="val")
    g = torch.Generator().manual_seed(14)
    lr = torch.rand(2, 3, 64, 64, generator=g) * 2 - 1
    sr = F.interpolate(lr, size=(512, 512), mode="bicubic",
                       align_corners=False).clamp(-1, 1)
    items = [{"SR": sr[i].permute(1, 2, 0).numpy(), "Index": i}
             for i in range(2)]
    ev = GroupedEvaluator(trainer, group_size=2)
    for c in counters():
        c.n = 0
    t0 = time.perf_counter()
    outs = list(ev.run_sr(iter(items), continous=True))
    dt = time.perf_counter() - t0
    launches = forward_launches()
    n_snap, _ = _snapshot_count(trainer.sched.num_timesteps)
    for item, frames in outs:
        if frames.shape != (1 + n_snap, 512, 512, 3):
            raise AssertionError(f"frames shape {frames.shape}")
        if not np.isfinite(frames).all():
            raise AssertionError("non-finite frames")
    print(f"  run_sr(continous=True) {trainer.netG.dtype}: {len(outs)} images, "
          f"frames {outs[0][1].shape}, T={trainer.sched.num_timesteps}, "
          f"{dt:.2f} s; launches {launches}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")

    from sr3_tpu_torch.models.schedule import make_schedule

    bt = opt["datasets"]["val"]["batch_size"]
    sched = make_schedule(opt["model"]["beta_schedule"]["val"] | {
        "n_timestep": 2000}, "cuda")
    net = trainer._eval_params()
    gd = torch.Generator(device="cuda").manual_seed(15)
    cond = torch.rand(bt, 3, 512, 512, device="cuda", generator=gd) * 2 - 1
    img = torch.randn(bt, 3, 512, 512, device="cuda", generator=gd)
    steps = iter(range(1999, -1, -1))
    step = lambda: trainer.diffusion.p_sample_step(
        net, sched, img, next(steps), cond, generator=gd)
    with torch.inference_mode():
        ms = _time_each(torch, step, 10)
        step_ms = float(np.median(ms))
        print(f"  UNet step (p_sample_step) B={bt} 512^2 {net.dtype}: median "
              f"{step_ms:.3f} ms/step over {len(ms)} steps (min "
              f"{min(ms):.3f}, max {max(ms):.3f}); 2000-step throughput "
              f"extrapolated {bt / (2000 * step_ms / 1000):.5f} img/s",
              flush=True)
        _profile_steps(torch, step, PROFILE_STEPS_512)
    return launches


def _time_each(torch, fn, n, warmup=2):
    """CUDA-event milliseconds of each of n calls, after warm-up calls."""
    for _ in range(warmup):
        fn()
    ms = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
    return ms


def _device_events(torch, prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _device_busy(torch, prof):
    """Union of the profiled device intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in _device_events(torch, prof))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1000


def _profile_steps(torch, step, n):
    """A torch.profiler window over n calls of ``step``: wall and device
    busy ms per step (union of device intervals) and device time by kernel,
    printed."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000 / n
    busy = _device_busy(torch, prof) / n
    by_kernel = {}
    for e in _device_events(torch, prof):
        t, k = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (t + e.time_range.elapsed_us(), k + 1)
    n_dev = sum(k for _, k in by_kernel.values())
    print(f"  profiled {n} steps: wall {wall:.1f} ms/step, device busy "
          f"{busy:.1f} ms/step ({100 * busy / wall:.1f}%), {n_dev / n:.0f} "
          f"device ops/step; device time per step by kernel:", flush=True)
    rows = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (t, k) in rows[:16]:
        print(f"    {t / 1000 / n:9.3f} ms  {k / n:7.1f}/step  {name[:90]}",
              flush=True)
    rest = sum(t for _, (t, _) in rows[16:]) / 1000 / n
    print(f"    {rest:9.3f} ms  the other {len(rows) - 16} kernels",
          flush=True)


@phase("64->512 training timing")
def train_timing_512_phase(torch, trainer):
    """Median train step (CUDA events), train img/s and peak memory at
    batch 2; then a torch.profiler window: device time by op, launches and
    the device busy share of the step."""
    import numpy as np

    b = trainer.opt["datasets"]["train"]["batch_size"]
    trainer.feed_data(_synthetic_batches(np, 1, b, seed=16, lr_size=64)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = _time_each(torch, trainer.optimize_parameters, TIME_STEPS_512)
    step_ms = float(np.median(ms))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  train step B={b} {trainer.netG.dtype} remat: median "
          f"{step_ms:.3f} ms/step over {TIME_STEPS_512} steps (min "
          f"{min(ms):.3f}, max {max(ms):.3f}); {b / (step_ms / 1000):.4f} "
          f"train img/s; peak device memory {peak:.2f} GiB", flush=True)

    _profile_steps(torch, trainer.optimize_parameters, PROFILE_STEPS_512)
    return step_ms


def _sdpa_backend(torch, fn):
    """The aten op that one SDPA call dispatches to (its backend)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.name.startswith("aten::_scaled_dot_product")})


def _device_ms(torch, fn, n=5):
    """Device time per call of ``fn`` (the sum of its kernels' durations in
    a torch.profiler window over n calls, after one warm-up): without the
    host's launch gaps that CUDA events around a call include."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us()
               for e in _device_events(torch, prof)) / 1000 / n


@phase("64->512 kernel timing")
def kernel_timing_512_phase(torch):
    """One round of each kernel at a 64->512 training shape (bf16, batch 2)
    beside its plain version and, where one PyTorch call computes the same
    function, that call (library_ms, never called by the port); and the
    least time the card could take for the same work (bound_ms)."""
    import torch.nn.functional as F

    from sr3_tpu_torch.ops import conv_fused, groupnorm

    g = torch.Generator(device="cuda").manual_seed(17)
    dt, cl = torch.bfloat16, torch.channels_last
    out = {}

    def entry(name, shape, fn, plain, library, flops, nbytes):
        fns = {"": fn, "plain_": plain, "library_": library}
        t = {}
        for key, f in fns.items():
            t[key + "ms"] = None if f is None else _time_ms(torch, f, n=5)
            t[key + "device_ms"] = None if f is None else _device_ms(torch, f)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        bound_ms = 1000 * max(t_ops, t_bytes)
        by = "operations" if t_ops > t_bytes else "bytes"
        out.setdefault(name, {**t, "bound_ms": bound_ms, "bound_by": by,
                              "shape": shape})
        show = lambda k: "none" if t[k] is None else f"{t[k]:.4f}"
        print(f"  {name} {shape} bf16, ms (events / device): kernel "
              f"{show('ms')} / {show('device_ms')}, plain {show('plain_ms')} / "
              f"{show('plain_device_ms')}, library {show('library_ms')} / "
              f"{show('library_device_ms')}; bound {bound_ms:.4f} ({by}; "
              f"kernel device time {t['device_ms'] / bound_ms:.1f}x)",
              flush=True)

    b = 2
    args, kw = _k1_inputs(torch, g, b, 64, 64, 512, dt, True)
    hw = 512 * 512
    entry("gn_silu_conv3x3", f"{b}x64x512x512->64 +film+residual",
          lambda: conv_fused.gn_silu_conv3x3(*args, **kw),
          lambda: conv_fused.gn_silu_conv3x3_plain(*args, **kw), None,
          2 * b * hw * 64 * 64 * 9, 2 * (3 * b * hw * 64 + 64 * 64 * 9))
    # cuDNN's conv3x3 alone on the same map and weight: not the same
    # function (no GroupNorm, SiLU, FiLM or residual), so not library_ms
    x, w, cb = args[0], args[3], args[4].to(dt)
    conv = lambda: F.conv2d(x, w, cb, padding=1)
    alone = {"cudnn_conv_alone_ms": _time_ms(torch, conv, n=5),
             "cudnn_conv_alone_device_ms": _device_ms(torch, conv)}
    out["gn_silu_conv3x3"].update(alone)
    print(f"  cuDNN F.conv2d alone (the conv only, bf16 channels_last) "
          f"{b}x64x512x512->64, ms (events / device): "
          f"{alone['cudnn_conv_alone_ms']:.4f} / "
          f"{alone['cudnn_conv_alone_device_ms']:.4f}", flush=True)
    del args, kw, x, w
    x = torch.randn(b, 512, 64, 64, device="cuda", generator=g)
    x = x.to(dt).contiguous(memory_format=cl)
    gw = 1 + 0.2 * torch.randn(512, device="cuda", generator=g)
    gb = 0.1 * torch.randn(512, device="cuda", generator=g)
    gw16, gb16 = gw.to(dt), gb.to(dt)
    entry("group_norm", f"{b}x512x64x64 swish off",
          lambda: groupnorm.group_norm(x, gw, gb, 16, swish=False),
          lambda: groupnorm.group_norm_plain(x, gw, gb, 16, swish=False),
          lambda: F.group_norm(x, 16, gw16, gb16, 1e-5),
          10 * x.numel(), 2 * 2 * x.numel())
    for _, c, h, w in K3_SHAPES[:2]:
        x = torch.randn(b, c, h, w, device="cuda", generator=g)
        x = x.to(dt).contiguous(memory_format=cl)
        xf = x.float()
        entry("gn_stats", f"{b}x{c}x{h}x{w}",
              lambda: groupnorm.gn_stats(x),
              lambda: groupnorm.gn_stats_plain(x),
              lambda: torch.var_mean(xf, dim=(2, 3), correction=0),
              3 * x.numel(), 2 * x.numel() + 2 * 4 * b * c)
        del x, xf
    for bh, seq, d in LONG_SHAPES:
        _attention_entries(torch, g, entry, bh, seq, d)
    return out


def _attention_entries(torch, g, entry, bh, seq, d):
    """Timing entries of K4 (with its logsumexp), K5 and K6 at one shape."""
    import torch.nn.functional as F

    from sr3_tpu_torch.ops import attention

    dt = torch.bfloat16
    q, k, v = (torch.randn(bh, seq, d, device="cuda", generator=g).to(dt)
               for _ in range(3))
    gr = torch.randn(bh, seq, d, device="cuda", generator=g)
    scale = d ** -0.5
    o, lse = attention.attention_fwd(q, k, v, scale)
    dsum = (gr * o).sum(-1)
    gr16 = gr.to(dt)  # K5's and K6's dO, as attention_bwd rounds it
    outs = [torch.empty_like(gr) for _ in range(3)]
    shape = f"{bh}x{seq}x{d}"
    mm = 2 * bh * seq * seq * d  # one (seq x seq x d) product
    qkv_bytes = 3 * 2 * q.numel()
    q4, k4, v4 = (t.unsqueeze(1) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
    print(f"  SDPA at head_dim {d} runs: {_sdpa_backend(torch, sdpa)}",
          flush=True)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    lo = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
    lg = gr.to(dt).unsqueeze(1)
    sdpa_bwd = lambda: torch.autograd.grad(lo, (ql, kl, vl), lg,
                                           retain_graph=True)
    try:
        sdpa_bwd()
    except RuntimeError as e:  # no SDPA backward at this head_dim
        print(f"  SDPA backward at head_dim {d}: {e}", flush=True)
        sdpa_bwd = None
    plain_bwd = lambda: attention.attention_bwd_plain(q, k, v, gr, lse, dsum,
                                                      scale)
    entry("flash_attention_fwd", shape + " with lse",
          lambda: attention.attention_fwd(q, k, v, scale),
          lambda: attention.attention_fwd_plain(q, k, v, scale), sdpa,
          2 * mm, qkv_bytes + 4 * (q.numel() + bh * seq))
    entry("flash_attention_bwd_dkv", shape,
          lambda: attention._bwd_kernel(
              "sr3_flash_attention_bwd_dkv", attention.dkv_counter, q, k, v,
              gr16, lse, dsum, outs[1:], scale), plain_bwd, sdpa_bwd,
          4 * mm, qkv_bytes + 2 * gr16.numel() + 4 * 2 * bh * seq
          + 2 * 4 * q.numel())
    entry("flash_attention_bwd_dq", shape,
          lambda: attention._bwd_kernel(
              "sr3_flash_attention_bwd_dq", attention.dq_counter, q, k, v,
              gr16, lse, dsum, outs[:1], scale), plain_bwd, sdpa_bwd,
          3 * mm, qkv_bytes + 2 * gr16.numel() + 4 * 2 * bh * seq
          + 4 * q.numel())


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        device_phase(torch)
        build_phase()
        errs = {}
        # the SR3 16->128 serving and training paths
        checked_tiles = kernel_phase(torch, errs)
        trainer = model_phase(torch)
        serving = serving_phase(torch, trainer)
        times = timing_phase(torch, trainer)
        del trainer
        trainer, launches_128 = training_phase(torch)
        grad_check_phase(torch)
        _, train_times = train_timing_phase(torch, trainer)
        times.update(train_times)
        del trainer
        # the SR3 64->512 training path, and its serving path
        k3_phase(torch, errs)
        long_attention_phase(torch, errs)
        trainer, launches = training_512_phase(torch)
        grad_check_512_phase(torch)
        bf16_attention_grad_phase(torch)
        train_timing_512_phase(torch, trainer)
        del trainer
        serving_512 = serving_512_phase(torch)
        timings = kernel_timing_512_phase(torch)
        k1_tile_phase(checked_tiles)
    except Exception:  # report any phase's failure, print no result
        traceback.print_exc()
        return 1
    kernels = []
    for name, (source, replaces, routes) in KERNELS.items():
        entry = {
            "name": name, "route": "cuda", "route_by_dtype": routes,
            "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name]["max_abs_err"],
            "max_rel_err": errs[name]["max_rel_err"],
            **timings[name],
            "launches_16_128_train": launches_128.get(name, 0),
            "launches_16_128_serving": serving.get(name, 0),
            "launches_64_512_serving": serving_512.get(name, 0),
        }
        if name in times:
            entry["ms_16_128"], entry["plain_ms_16_128"] = times[name]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
