#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (sr3_tpu_torch) once on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each printing its own line and its seconds; any failure exits 1:
  1. device: name and power limit from nvidia-smi, torch and CUDA versions;
     TF32 off for the float32 phases;
  2. build: compile sr3_tpu_torch/csrc with nvcc (one process per source);
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at every shape the SR3 16->128 sampling path gives it (batch
     2), in float32 and bfloat16, error relative to max|plain|; K4's
     logsumexp and the backward kernels K5 / K6 at the training shapes and a
     ragged one; the autograd Functions of K1, K2 and K4 against autograd of
     their plain versions, every input gradient;
  4. full-width model: the 97.8M-parameter SR3 16->128 UNet (random seeded
     weights), one float32 forward on the card (kernels) against the same
     weights on the CPU (plain versions), and the bf16 sampling copy of the
     serving trainer against the same CPU forward;
  5. serving path: GroupedEvaluator.run_sr (what infer_sr runs) in bf16,
     group of 2, T=10 val schedule (the -debug shrink), seeded 16->128
     inputs; launch counters are zeroed just before and every forward
     kernel must have launched; frames must be finite and 1 + n_snap per
     image;
  6. training path: the train-phase Trainer of the same config (batch 4,
     bf16 compute, float32 parameters, dropout 0.2, Adam 1e-4) through
     train_loop for TRAIN_STEPS steps on seeded synthetic (HR, SR) batches;
     counters zeroed just before, and K1, K2, K4, K5 and K6 must all have
     launched; every loss finite, every parameter with a finite gradient,
     every parameter moved;
  7. training gradients: one float32 batch-1 loss and backward of the
     full-width UNet with injected noise, sqrt-gamma and the same dropout
     draws, kernels against the plain ops swapped into the UNet module;
     loss and every parameter's gradient within GRAD_TOL;
  8. timing (printed, not gated): ms per UNet step of the T=2000 chain at
     batch 8 in bf16 and the 2000-step images/s extrapolated from it; ms per
     train step at batch 4 in bf16 (median of TIME_STEPS) and train
     images/s; ms per call of each kernel against its plain version at
     main-path shapes.

Then one JSON line with every kernel's route, source, the TPU kernel it
replaces, launches in phase 6 (and in phase 5), max error and times, and
last the line {"ok": true, "device": {...}}. Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero and prints
no result.
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
# K5 / K6 and K4's logsumexp: both sides compute in float32 from the same
# inputs (attention_bwd.cu header); the autograd Functions in bf16: each
# side rounds its input gradients to bf16 once
TOL = {"float32": {"gn_silu_conv3x3": 1e-4, "group_norm": 1e-5,
                   "flash_attention_fwd": 1e-4, "flash_attention_bwd_dkv": 1e-4,
                   "flash_attention_bwd_dq": 1e-4, "function": 1e-4},
       "bfloat16": {"gn_silu_conv3x3": 2e-2, "group_norm": 2e-2,
                    "flash_attention_fwd": 1e-4, "flash_attention_bwd_dkv": 1e-4,
                    "flash_attention_bwd_dq": 1e-4, "function": 2e-2}}
# float32 loss and gradients of the full-width UNet, kernels vs plain ops
GRAD_TOL = 1e-3
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
# (batch*heads, seq, head_dim) of K4-with-lse, K5 and K6 in the train step
# at batch 4, and a ragged shape
BWD_SHAPES = [(4, 256, 512), (4, 64, 512), (3, 100, 64)]
KERNELS = {
    "gn_silu_conv3x3": ("sr3_tpu_torch/csrc/conv_fused.cu",
                        "sr3_tpu/ops/conv_fused.py:117"),
    "group_norm": ("sr3_tpu_torch/csrc/groupnorm.cu",
                   "sr3_tpu/ops/groupnorm.py:237"),
    "flash_attention_fwd": ("sr3_tpu_torch/csrc/attention.cu",
                            "sr3_tpu/ops/attention.py:58"),
    "flash_attention_bwd_dkv": ("sr3_tpu_torch/csrc/attention_bwd.cu",
                                "sr3_tpu/ops/attention.py:163"),
    "flash_attention_bwd_dq": ("sr3_tpu_torch/csrc/attention_bwd.cu",
                               "sr3_tpu/ops/attention.py:203"),
}
FORWARD_KERNELS = ("gn_silu_conv3x3", "group_norm", "flash_attention_fwd")


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

    def record_fn(name, dtype, i, got, ref):
        torch.cuda.synchronize()
        rel, absd = rel_err(got, ref)
        tol = TOL[dtype]["function"]
        ok = rel <= tol and got.dtype == ref.dtype
        print(f"  autograd {name} {dtype} input {i} gradient: rel {rel:.3e} "
              f"abs {absd:.3e} tol {tol:g} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(f"autograd {name} {dtype} input {i}")

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
        for bh, seq, d in BWD_SHAPES:
            q, k, v = (torch.randn(bh, seq, d, device="cuda",
                                   generator=g).to(dtype) for _ in range(3))
            gr = torch.randn(bh, seq, d, device="cuda", generator=g)
            label = f"{bh}x{seq}x{d}"
            o, lse = attention.attention_fwd(q, k, v, d ** -0.5)
            ref_o, ref_lse = attention.attention_fwd_plain(q, k, v, d ** -0.5)
            record("flash_attention_fwd", dn, label + " with lse: o", o, ref_o)
            record("flash_attention_fwd", dn, label + " with lse: lse", lse,
                   ref_lse)
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
            grads = []
            for f in (wrapper, plain):
                leaves = [t.detach().clone().requires_grad_() for t in inputs]
                out = call(f, leaves)
                w = torch.randn(out.shape, device="cuda", generator=torch
                                .Generator(device="cuda").manual_seed(1))
                (out.float() * w).sum().backward()
                grads.append([t.grad for t in leaves])
            for i, (got, ref) in enumerate(zip(*grads)):
                record_fn(name, dn, i, got, ref)
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failures}")


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


def _load_opt(dtype=None, val_steps=None, phase="val"):
    from sr3_tpu_torch.utils.config import load_config

    opt = load_config(CONFIG)
    opt["phase"] = phase
    opt["path"]["resume_state"] = None
    if dtype:
        opt["model"]["dtype"] = dtype
    if val_steps:
        opt["model"]["beta_schedule"]["val"]["n_timestep"] = val_steps
    return opt


def counters():
    from sr3_tpu_torch.ops import attention, conv_fused, groupnorm

    return [conv_fused.counter, groupnorm.counter, attention.counter,
            attention.dkv_counter, attention.dq_counter]


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


def _synthetic_batches(np, n, b, seed):
    """n seeded (HR, SR) host batches, NHWC float32 in [-1, 1]: the SR image
    is the bicubic-like blur of a 16x16 version of HR, as the dataset's."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lr = rng.uniform(-1, 1, (b, 16, 16, 3)).astype(np.float32)
        sr = np.repeat(np.repeat(lr, 8, axis=1), 8, axis=2)
        hr = np.clip(sr + 0.1 * rng.standard_normal(sr.shape), -1, 1)
        out.append({"HR": hr.astype(np.float32), "SR": sr})
    return out


@phase("training path")
def training_phase(torch):
    import numpy as np

    from sr3_tpu_torch.models.networks import count_params
    from sr3_tpu_torch.training.loops import train_loop
    from sr3_tpu_torch.training.trainer import create_model

    opt = _load_opt(phase="train")
    opt["train"].update(n_iter=TRAIN_STEPS, print_freq=1, val_freq=10 ** 9,
                        save_checkpoint_freq=10 ** 9)
    trainer = create_model(opt)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"],
                                   schedule_phase="train")
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
    before = [p.detach().clone() for p in trainer.netG.parameters()]
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
    launches = {c.name: c.n for c in counters()}
    losses = [float(x) for x in losses]
    print(f"  train_loop {len(losses)} steps in {dt:.2f} s; losses "
          f"{[round(x, 5) for x in losses]}; launches {launches}", flush=True)
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch in training: "
                             f"{launches}")
    bad = [n for n, p in trainer.netG.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all()]
    still = [n for (n, p), p0 in zip(trainer.netG.named_parameters(), before)
             if torch.equal(p.detach(), p0)]
    print(f"  parameters without a finite gradient: {len(bad)}; "
          f"parameters that did not move: {len(still)} of {len(before)}",
          flush=True)
    if bad or still:
        raise AssertionError(f"no finite gradient: {bad[:5]}; "
                             f"not moved: {still[:5]}")
    return trainer, launches


@phase("training gradients")
def grad_check_phase(torch):
    from sr3_tpu_torch.models import unet as unet_module
    from sr3_tpu_torch.models.networks import define_G
    from sr3_tpu_torch.models.schedule import make_schedule
    from sr3_tpu_torch.ops import attention, conv_fused, groupnorm

    opt = _load_opt(dtype="float32", phase="train")
    diffusion = define_G(opt, device="cuda", seed=0)
    net = diffusion.denoise_fn.train()
    sched = make_schedule(opt["model"]["beta_schedule"]["train"], "cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    cl = torch.channels_last
    batch = {k: (torch.rand(1, 3, 128, 128, device="cuda", generator=g) * 2
                 - 1).contiguous(memory_format=cl) for k in ("HR", "SR")}
    injected = {"noise": torch.randn(1, 3, 128, 128, device="cuda",
                                     generator=g),
                "sqrt_gamma": torch.full((1, 1), 0.7, device="cuda")}

    def loss_and_grads():
        net.zero_grad(set_to_none=True)
        masks = torch.Generator(device="cuda").manual_seed(6)
        loss = diffusion.p_losses(net, sched, batch, masks, injected)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in net.named_parameters()}

    for c in counters():
        c.n = 0
    loss_k, grads_k = loss_and_grads()
    launches = {c.name: c.n for c in counters()}
    plain = {"gn_silu_conv3x3": conv_fused.gn_silu_conv3x3_plain,
             "group_norm": groupnorm.group_norm_plain,
             "attention": attention.attention_plain}
    saved = {k: getattr(unet_module, k) for k in plain}
    try:
        for k, f in plain.items():
            setattr(unet_module, k, f)
        loss_p, grads_p = loss_and_grads()
    finally:
        for k, f in saved.items():
            setattr(unet_module, k, f)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst, worst_rel = None, 0.0
    for n, gp in grads_p.items():
        rel, _ = rel_err(grads_k[n], gp)
        if not rel <= worst_rel:
            worst, worst_rel = n, rel
    print(f"  float32 batch 1, kernels {launches} vs plain ops: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.3e}); worst of "
          f"{len(grads_p)} gradients {worst}: rel {worst_rel:.3e}; tol "
          f"{GRAD_TOL:g}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")
    if not (loss_rel <= GRAD_TOL and worst_rel <= GRAD_TOL):
        raise AssertionError(f"gradients disagree: loss {loss_rel}, {worst} "
                             f"{worst_rel}")


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
                v, gr, lse, dsum, out[1:], scale), plain_bwd),
            "flash_attention_bwd_dq": (lambda: attention._bwd_kernel(
                "sr3_flash_attention_bwd_dq", attention.dq_counter, q, k, v,
                gr, lse, dsum, out[:1], scale), plain_bwd),
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
        serving = serving_phase(torch, trainer)
        times = timing_phase(torch, trainer)
        del trainer
        trainer, launches = training_phase(torch)
        grad_check_phase(torch)
        _, train_times = train_timing_phase(torch, trainer)
    except Exception:  # report any phase's failure, print no result
        traceback.print_exc()
        return 1
    times.update(train_times)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        ms, plain_ms = times[name]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "serving_launches": serving.get(name, 0),
            "max_abs_err": errs[name]["max_abs_err"],
            "max_rel_err": errs[name]["max_rel_err"],
            "ms": ms, "plain_ms": plain_ms,
        }
        if name == "flash_attention_fwd":
            entry["lse_ms"], entry["plain_lse_ms"] = \
                times["flash_attention_fwd (lse)"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
