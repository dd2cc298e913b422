"""Throughput benchmark of the port: SR3 16->128 on one NVIDIA GPU,
sampling chains and the train step; the port's copy of the root bench.py
(the same lines, metric names, keys and knobs).

  python -m sr3_tpu_torch.bench                  # on the card
  SR3_PLATFORM=cpu python -m sr3_tpu_torch.bench # on the CPU (tiny config)

Headline metric: images/sec for the full 2000-step reverse chain at 128x128
with the shipped sr_sr3_16_128 model at batch 8, in bf16 on the serving
network (``Trainer._eval_params``: weights with 2+ dimensions in bf16). The
chain is the port's ``p_sample_loop``: a Python loop whose every operation
is queued on the device, with no host sync inside.

Prints one JSON line per metric, the headline sampling line LAST:
  {"metric": "..._train_step_throughput", ..., "mfu": ...}
  {"metric": "..._train_step_loader_throughput", ...}      (128^2 only)
  {"metric": "..._sampling_ddim{n}_eta1_throughput", ...}
  {"metric": "..._sampling_dpmpp{n}_throughput", ...}
  {"metric": "..._sampling_2000step_throughput", "value": N,
   "unit": "images/sec/chip", "vs_baseline": N, "mfu": ..., "batch": B}
Every line names the device it ran on (``"device"``); a ``#`` line on
stderr gives the card's name and power limit from nvidia-smi.

Baselines: the reference publishes no throughput numbers (SURVEY §6).
- Sampling: ~0.005 images/sec for the batch-1 2000-step chain on a
  1080Ti-class GPU (~10 it/s per SR3-era community reports).
- Training: derived from the train step's 269.8 GFLOP/image
  (docs/TRAIN_BASELINE_r03.json) on a 1080Ti (fp32 peak 11.34 TFLOPS,
  GP102 spec, 3584 cores x 1.582 GHz x 2) at an assumed 0.35 sustained
  utilization: 11.34e12 * 0.35 / 269.8e9 = 14.7 images/sec (sensitivity:
  util 0.25 -> 10.5, util 0.50 -> 21.0).

MFU = counted FLOPs / wall time / 989e12 (one H100 SXM, dense bf16; see
``utils/flops.py``): FlopCounterMode over the plain composition at batch 1
on the meta device, times the batch; one UNet forward a chain step, and
``p_losses`` + backward (remat off) a train step. ``mfu`` is null on the
CPU: no device share comes from a CPU run.

Train lines: ``p_losses`` (dropout on), backward, then the port's Adam
(``training/optim.py``) at lr 1e-4 on zero batches (the loader line: on
the bundled PNG fixtures through the port's ``LRHRDataset(cache=False)``,
``DataLoader`` and PNG codec), the config's train schedule, each iteration
its own ``torch.Generator`` seed; two warm-up steps, then
``BENCH_TRAIN_ITERS`` steps on a host clock that ends in a synchronize.
The loader line's decomposition: the same step fed one fixed host batch
(a fresh host-to-device copy each step, no loader work) separates the copy
from decode / collate (``transfer_only_step_ms``, ``loader_overhead_ms``,
``transfer_gap_ms``; ``input_bound`` / ``transfer_bound`` name the larger
of the two when the loader-fed rate is under 0.95 of the synthetic one).

Sampling lines: the ancestral, DDIM (eta 1) and SDE-DPM-Solver++(2M) chains
over the T=BENCH_STEPS linear schedule (1e-6 .. 1e-2) from zero condition
images, each image with its own generator; a short warm-up chain, then
``BENCH_REPEATS`` chains, each ending in one synchronize. The headline is
normalised to 2000 steps.

Env knobs: BENCH_BATCH (default 8), BENCH_STEPS (default 2000),
BENCH_REPEATS (default 1), BENCH_TRAIN_BATCH (default 16),
BENCH_TRAIN_ITERS (default 10), BENCH_SKIP_TRAIN=1, BENCH_SKIP_LOADER=1,
BENCH_LOADER_WORKERS (default 1), BENCH_CONFIG, BENCH_DDIM_STEPS (default
50) / BENCH_SKIP_DDIM=1, BENCH_DPMPP_STEPS (default 50) /
BENCH_SKIP_DPMPP=1, BENCH_INIT_TIMEOUT (default 300 s: a subprocess first
initialises CUDA, and the bench exits 3 if that fails or hangs),
SR3_PLATFORM=cpu (no probe; runs on the CPU).

Fewer-step quality, from the JAX package's converged 100k-step model
(docs/SAMPLER_REQUAL_r05.json, T=2000, eta 1): neither 50-NFE sampler
matches the ancestral chain; DDIM degrades on both metrics, SDE-DPM++(2M)
roughly holds PSNR and loses SSIM. ``python -m sr3_tpu_torch.sampler_eval``
scores them on the port's own checkpoints.
"""

import copy
import glob
import json
import os
import subprocess
import sys
import tempfile
import time


def _probe_backend(timeout_s):
    """Exit 3 unless a subprocess initialises CUDA within ``timeout_s``: a
    failed or hung driver then ends the bench with a message, never a
    silent CPU run or a stall."""
    try:
        r = subprocess.run(
            [sys.executable, "-c",
             "import torch\n"
             "torch.zeros(1, device='cuda')\n"
             "torch.cuda.synchronize()"],
            timeout=timeout_s, capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        print(f"# bench: CUDA init did not complete within {timeout_s}s -- "
              "aborting. SR3_PLATFORM=cpu runs on the CPU.", file=sys.stderr)
        sys.exit(3)
    if r.returncode != 0:
        print("# bench: CUDA init failed:\n" + (r.stderr or "").strip(),
              file=sys.stderr)
        sys.exit(3)


if __name__ == "__main__" and \
        (os.environ.get("SR3_PLATFORM") or "").lower() != "cpu":
    _probe_backend(int(os.environ.get("BENCH_INIT_TIMEOUT", 300)))

import numpy as np
import torch

from sr3_tpu_torch.data.loader import DataLoader
from sr3_tpu_torch.data.lrhr import LRHRDataset
from sr3_tpu_torch.models.schedule import make_schedule
from sr3_tpu_torch.training.evaluation import fold_seed
from sr3_tpu_torch.training.optim import Adam
from sr3_tpu_torch.training.trainer import Trainer
from sr3_tpu_torch.utils.config import load_config
from sr3_tpu_torch.utils.flops import forward_flops, mfu, train_step_flops
from sr3_tpu_torch.utils.runtime import card_name_and_power

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_1080TI_SAMPLING_IMG_PER_SEC = 0.005
# 11.34 TFLOPS fp32 peak * 0.35 util / 269.8 GFLOP per image -- see the
# module docstring + docs/TRAIN_BASELINE_r03.json for the derivation
BASELINE_1080TI_TRAIN_IMG_PER_SEC = 14.7
CL = torch.channels_last


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_device(batch, device):
    """Host NHWC arrays 'HR' and 'SR' -> NCHW float32 in channels_last
    memory on ``device`` (as ``Trainer.feed_data``)."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k], np.float32))
            .permute(0, 3, 1, 2).to(device) for k in ("HR", "SR")}


def _train_step(diffusion, net, sched):
    """A fresh Adam (lr 1e-4) over ``net`` and one train step of it:
    ``step(batch, generator)`` -> loss, left on the device."""
    optimizer = Adam(list(net.parameters()), lr=1e-4)
    net.train()

    def step(batch, generator):
        optimizer.zero_grad(set_to_none=True)
        loss = diffusion.p_losses(net, sched, batch, generator)
        loss.backward()
        optimizer.step()
        return loss

    return step


def bench_train(diffusion, net, sched, res, batch, iters, step_flops):
    device = next(net.parameters()).device
    step = _train_step(diffusion, net, sched)
    data = {k: torch.zeros(batch, 3, res, res, device=device)
            .contiguous(memory_format=CL) for k in ("HR", "SR")}
    # per-iteration generators made outside the timed loop
    gens = [torch.Generator(device=device).manual_seed(100 + i)
            for i in range(iters + 2)]
    step(data, gens[0])  # first call: kernel builds, autotuning
    step(data, gens[1])
    _sync(device)
    t0 = time.perf_counter()
    for i in range(iters):
        step(data, gens[2 + i])
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    flops = step_flops * batch
    share = mfu(flops, dt, device)
    print(f"# train batch={batch} {dt * 1e3:.2f} ms/step "
          f"{batch / dt:.1f} img/s flops/step={flops}", file=sys.stderr)
    return {
        "value": round(batch / dt, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(batch / dt / BASELINE_1080TI_TRAIN_IMG_PER_SEC, 2),
        "mfu": round(share, 4) if share else None,
        "batch": batch,
        "step_ms": round(dt * 1e3, 2),
    }


def bench_train_loader(diffusion, net, sched, res, batch, iters,
                       synthetic_step_ms):
    """End-to-end train throughput over the host data path: PNG files ->
    LRHRDataset (cache off: every batch decodes) -> DataLoader (worker
    threads) -> host-to-device copy -> the same train step."""
    device = next(net.parameters()).device
    step = _train_step(diffusion, net, sched)
    gens = [torch.Generator(device=device).manual_seed(200 + i)
            for i in range(iters + 2)]
    with tempfile.TemporaryDirectory() as tmp:
        # cycle the bundled fixtures into >= 4 full batches of PNG pairs
        fix = os.path.join(ROOT, "dataset", "fixtures_16_128")
        n = max(4 * batch, 64)
        for sub in (f"hr_{res}", f"sr_16_{res}"):
            os.makedirs(os.path.join(tmp, sub), exist_ok=True)
            srcs = sorted(glob.glob(os.path.join(fix, sub, "*.png")))
            if not srcs:
                print(f"# train-loader bench skipped: no fixtures for {sub}",
                      file=sys.stderr)
                return None
            for i in range(n):
                os.symlink(os.path.abspath(srcs[i % len(srcs)]),
                           os.path.join(tmp, sub, f"{i:05d}.png"))
        ds = LRHRDataset(dataroot=tmp, datatype="img", l_resolution=16,
                         r_resolution=res, split="train", need_LR=False,
                         cache=False)
        workers = int(os.environ.get("BENCH_LOADER_WORKERS", 1))
        loader = DataLoader(ds, batch_size=batch, shuffle=True,
                            num_workers=workers, drop_last=True)

        def stream():
            while True:
                yield from loader

        it = stream()

        def one(i):
            return step(_to_device(next(it), device), gens[i])

        one(0)
        one(1)
        _sync(device)
        t0 = time.perf_counter()
        for i in range(iters):
            one(2 + i)
        _sync(device)
        dt = (time.perf_counter() - t0) / iters

        # the same step fed one FIXED host batch (a fresh copy each step,
        # no loader work) separates the copy from decode / collate
        fixed = next(it)
        fixed = {k: np.asarray(fixed[k]) for k in ("HR", "SR")}
        step(_to_device(fixed, device), gens[0])
        _sync(device)
        t0 = time.perf_counter()
        for i in range(iters):
            step(_to_device(fixed, device), gens[(1 + i) % len(gens)])
        _sync(device)
        dt_transfer = (time.perf_counter() - t0) / iters

    ratio = synthetic_step_ms / (dt * 1e3) if synthetic_step_ms else None
    # loader cost is what the copy alone does NOT explain
    loader_ms = max(0.0, (dt - dt_transfer) * 1e3)
    transfer_gap_ms = max(
        0.0, dt_transfer * 1e3 - (synthetic_step_ms or dt_transfer * 1e3))
    print(f"# train+loader batch={batch} {dt * 1e3:.2f} ms/step "
          f"{batch / dt:.1f} img/s (synthetic {synthetic_step_ms} ms, "
          f"transfer-only {dt_transfer * 1e3:.2f} ms)", file=sys.stderr)
    return {
        "value": round(batch / dt, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(batch / dt / BASELINE_1080TI_TRAIN_IMG_PER_SEC,
                             2),
        "batch": batch,
        "step_ms": round(dt * 1e3, 2),
        "transfer_only_step_ms": round(dt_transfer * 1e3, 2),
        "loader_overhead_ms": round(loader_ms, 2),
        "loader_workers": workers,
        "fraction_of_synthetic_rate": round(ratio, 3) if ratio else None,
        "transfer_gap_ms": round(transfer_gap_ms, 2),
        # a sub-0.95 rate is put down to its larger part: the copy
        # (fixed-batch step minus synthetic) or the data pipeline
        # (loader-fed minus fixed-batch: decode / collate it did not hide)
        "input_bound": bool(
            ratio and ratio < 0.95 and loader_ms > transfer_gap_ms),
        "transfer_bound": bool(
            ratio and ratio < 0.95 and transfer_gap_ms >= loader_ms),
    }


def _generators(device, seed, batch):
    """One generator an image, seeded from (seed, image)."""
    return [torch.Generator(device=device).manual_seed(fold_seed(seed, j))
            for j in range(batch)]


def _time_chains(chain, device, batch, repeats):
    """Seconds per call of ``chain(generators)``: a short warm-up call
    (``chain(generators, warmup=True)``), then ``repeats`` calls, each with
    fresh generators and ending in one synchronize."""
    chain(_generators(device, 1, batch), warmup=True)
    _sync(device)
    gens = [_generators(device, 2 + i, batch) for i in range(repeats)]
    t0 = time.perf_counter()
    for g in gens:
        chain(g)
        _sync(device)
    return (time.perf_counter() - t0) / repeats


def main():
    batch = int(os.environ.get("BENCH_BATCH", 8))
    steps = int(os.environ.get("BENCH_STEPS", 2000))
    repeats = int(os.environ.get("BENCH_REPEATS", 1))
    train_batch = int(os.environ.get("BENCH_TRAIN_BATCH", 16))
    train_iters = int(os.environ.get("BENCH_TRAIN_ITERS", 10))
    config = os.environ.get("BENCH_CONFIG",
                            os.path.join(ROOT, "configs", "sr_sr3_16_128.json"))

    opt = load_config(config)
    opt["phase"] = "val"
    opt.pop("path", None)  # seeded weights, never a resume
    trainer = Trainer(opt)
    device, diffusion = trainer.device, trainer.diffusion
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"# device: {card_name_and_power() if device.type == 'cuda' else name}"
          f"; torch {torch.__version__}", file=sys.stderr)
    res = opt["model"]["diffusion"]["image_size"]
    stem = os.path.splitext(os.path.basename(config))[0]
    # the serving network (bf16 weights on the card), taken before any
    # training moves the parameters
    net = trainer._eval_params()

    def emit(metric, line):
        print(json.dumps({"metric": metric, **line, "device": name}),
              flush=True)

    # ---- training throughput + MFU (printed first; headline stays last)
    if os.environ.get("BENCH_SKIP_TRAIN", "0") != "1":
        train_sched = make_schedule(opt["model"]["beta_schedule"]["train"],
                                    device)
        step_flops = train_step_flops(opt)
        tr = bench_train(diffusion, copy.deepcopy(trainer.netG), train_sched,
                         res, train_batch, train_iters, step_flops)
        emit(f"{stem}_train_step_throughput", tr)
        # the same step fed by the host pipeline (PNG -> decode -> copy)
        if os.environ.get("BENCH_SKIP_LOADER", "0") != "1" and res == 128:
            tl = bench_train_loader(diffusion, copy.deepcopy(trainer.netG),
                                    train_sched, res, train_batch,
                                    train_iters, tr["step_ms"])
            if tl:
                emit(f"{stem}_train_step_loader_throughput", tl)

    sched = make_schedule({"schedule": "linear", "n_timestep": steps,
                           "linear_start": 1e-6, "linear_end": 1e-2}, device)
    x_sr = torch.zeros(batch, 3, res, res, device=device) \
        .contiguous(memory_format=CL)

    def strided(loop, n_steps):
        def chain(gens, warmup=False):
            return loop(net, sched, x_sr, gens,
                        n_steps=2 if warmup else n_steps, eta=1.0)
        return chain

    with torch.inference_mode():
        # ---- fewer-step sampling #1: stochastic DDIM (eta=1) over the same
        # schedule; JAX package's converged 100k model: -2.50 dB (SE 0.80)
        # / -0.066 SSIM (SE 0.026) against the ancestral chain
        if os.environ.get("BENCH_SKIP_DDIM", "0") != "1":
            dd_steps = int(os.environ.get("BENCH_DDIM_STEPS", 50))
            ddt = _time_chains(strided(diffusion.ddim_sample_loop, dd_steps),
                               device, batch, repeats)
            print(f"# ddim eta=1 batch={batch} nfe={dd_steps} "
                  f"time/batch={ddt:.2f}s", file=sys.stderr)
            emit(f"{stem}_sampling_ddim{dd_steps}_eta1_throughput", {
                "value": round(batch / ddt, 4),
                "unit": "images/sec/chip",
                "vs_baseline": round(
                    batch / ddt / BASELINE_1080TI_SAMPLING_IMG_PER_SEC, 2),
                "nfe": dd_steps,
                "batch": batch,
                "quality_vs_ancestral_T2000": (
                    "JAX package's converged 100k model: d_psnr -2.50 (SE "
                    "0.80), d_ssim -0.066 (SE 0.026, cluster-robust), 6 "
                    "chains x 6 images (docs/SAMPLER_REQUAL_r05.json)"),
            })

        # ---- fewer-step sampling #2: SDE-DPM-Solver++(2M) over the same
        # schedule; the JAX package's converged model roughly holds PSNR
        # and loses SSIM with it
        if os.environ.get("BENCH_SKIP_DPMPP", "0") != "1":
            dsteps = int(os.environ.get("BENCH_DPMPP_STEPS", 50))
            ddt = _time_chains(strided(diffusion.dpmpp_sample_loop, dsteps),
                               device, batch, repeats)
            print(f"# dpm++ batch={batch} nfe={dsteps} time/batch={ddt:.2f}s",
                  file=sys.stderr)
            emit(f"{stem}_sampling_dpmpp{dsteps}_throughput", {
                "value": round(batch / ddt, 4),
                "unit": "images/sec/chip",
                "vs_baseline": round(
                    batch / ddt / BASELINE_1080TI_SAMPLING_IMG_PER_SEC, 2),
                "nfe": dsteps,
                "batch": batch,
                "quality_vs_ancestral_T2000": (
                    "JAX package's converged 100k model: PSNR -1.77 (SE "
                    "1.02), SSIM collapses 0.511 vs 0.869 "
                    "(docs/SAMPLER_REQUAL_r05.json)"),
            })

        # ---- the ancestral chain (headline); its warm-up: two steps
        def ancestral(gens, warmup=False):
            if not warmup:
                return diffusion.p_sample_loop(net, sched, x_sr, gens)
            img = x_sr
            for t in (steps - 1, 0):
                img = diffusion.p_sample_step(net, sched, img, t, x_sr,
                                              generator=gens)
            return img

        chain_flops = forward_flops(opt) * steps * batch
        dt = _time_chains(ancestral, device, batch, repeats)

    imgs_per_sec = batch / dt
    # normalised to the 2000-step budget if BENCH_STEPS overrode it
    imgs_per_sec_2000 = imgs_per_sec * steps / 2000.0
    share = mfu(chain_flops, dt, device)
    print(f"# sampling batch={batch} steps={steps} time/batch={dt:.2f}s "
          f"({dt / steps * 1e3:.2f} ms/step) flops/chain={chain_flops}",
          file=sys.stderr)
    emit(f"{stem}_sampling_2000step_throughput", {
        "value": round(imgs_per_sec_2000, 4),
        "unit": "images/sec/chip",
        "vs_baseline": round(
            imgs_per_sec_2000 / BASELINE_1080TI_SAMPLING_IMG_PER_SEC, 2),
        "mfu": round(share, 4) if share else None,
        "batch": batch,
    })


if __name__ == "__main__":
    main()
