#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (sr3_tpu_torch) once on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each printing its own line and its seconds; any failure exits 1:
  1. device: name and power limit from nvidia-smi, torch and CUDA versions;
     TF32 off for the float32 phases;
  2. build: compile sr3_tpu_torch/csrc with nvcc;
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at every shape the SR3 16->128 sampling path gives it (batch
     2), in float32 and bfloat16, error relative to max|plain|;
  4. full-width model: the 97.8M-parameter SR3 16->128 UNet (random seeded
     weights), one float32 forward on the card (kernels) against the same
     weights on the CPU (plain versions), and the bf16 sampling copy of the
     serving trainer against the same CPU forward;
  5. serving path: GroupedEvaluator.run_sr (what infer_sr runs) in bf16,
     group of 2, T=10 val schedule (the -debug shrink), seeded 16->128
     inputs; launch counters are zeroed just before and every kernel must
     have launched; frames must be finite and 1 + n_snap per image;
  6. timing (printed, not gated): ms per UNet step of the T=2000 chain at
     batch 8 in bf16 and the 2000-step images/s extrapolated from it; ms per
     call of each kernel against its plain version at main-path shapes.

Then one JSON line with every kernel's route, source, the TPU kernel it
replaces, launches in phase 5, max error and times, and last the line
{"ok": true, "device": {...}}. Without a CUDA device, or without the rest of
the repository beside it, it exits non-zero and prints no result.
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
TOL = {"float32": {"gn_silu_conv3x3": 1e-4, "group_norm": 1e-5,
                   "flash_attention_fwd": 1e-4},
       "bfloat16": {"gn_silu_conv3x3": 2e-2, "group_norm": 2e-2,
                    "flash_attention_fwd": 1e-4}}
FORWARD_TOL = 1e-3
# bf16 activations and weights (2^-9 relative rounding per op) through ~30
# layers; measured ~1.2e-2 of max|out| on an H100
FORWARD_TOL_BF16 = 5e-2

# (Cin, Cout, H=W) of every K1 call of the 16->128 UNet
K1_SHAPES = [
    (64, 64, 128), (192, 64, 128), (128, 64, 128), (64, 3, 128),
    (64, 128, 64), (128, 128, 64), (384, 128, 64), (256, 128, 64),
    (128, 256, 32), (256, 256, 32), (768, 256, 32), (512, 256, 32),
    (256, 512, 16), (512, 512, 16), (1024, 512, 16),
    (512, 512, 8), (1024, 512, 8),
]
K2_SHAPES = [(512, 16), (512, 8)]          # (C, H=W), swish off
K4_SHAPES = [(256, 512), (64, 512)]        # (seq, head_dim)
KERNELS = {
    "gn_silu_conv3x3": ("sr3_tpu_torch/csrc/conv_fused.cu",
                        "sr3_tpu/ops/conv_fused.py:117"),
    "group_norm": ("sr3_tpu_torch/csrc/groupnorm.cu",
                   "sr3_tpu/ops/groupnorm.py:237"),
    "flash_attention_fwd": ("sr3_tpu_torch/csrc/attention.cu",
                            "sr3_tpu/ops/attention.py:58"),
}


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

    def record(kernel, dtype, label, out, ref):
        torch.cuda.synchronize()
        rel, absd = rel_err(out, ref)
        tol = TOL[dtype][kernel]
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

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for cin, cout, hw in K1_SHAPES:
            for film in ((False,) if cout == 3 else (False, True)):
                args, kw = _k1_inputs(torch, g, BATCH_CHECK, cin, cout, hw,
                                      dtype, film)
                label = (f"{BATCH_CHECK}x{cin}x{hw}x{hw}->{cout}"
                         + (" +film+residual" if film else ""))
                record("gn_silu_conv3x3", dn, label,
                       conv_fused.gn_silu_conv3x3(*args, **kw),
                       conv_fused.gn_silu_conv3x3_plain(*args, **kw))
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
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failures}")


def _load_opt(dtype=None, val_steps=None):
    from sr3_tpu_torch.utils.config import load_config

    opt = load_config(CONFIG)
    opt["phase"] = "val"
    opt["path"]["resume_state"] = None
    if dtype:
        opt["model"]["dtype"] = dtype
    if val_steps:
        opt["model"]["beta_schedule"]["val"]["n_timestep"] = val_steps
    return opt


def counters():
    from sr3_tpu_torch.ops import attention, conv_fused, groupnorm

    return [conv_fused.counter, groupnorm.counter, attention.counter]


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
    launches = {c.name: c.n for c in counters()}
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
    launches = {c.name: c.n for c in counters()}
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        device_phase(torch)
        build_phase()
        errs = {}
        kernel_phase(torch, errs)
        trainer = model_phase(torch)
        launches = serving_phase(torch, trainer)
        times = timing_phase(torch, trainer)
    except Exception:  # report any phase's failure, print no result
        traceback.print_exc()
        return 1
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        ms, plain_ms = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name]["max_abs_err"],
            "max_rel_err": errs[name]["max_rel_err"],
            "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
