"""Serving: the ancestral reverse chain, stepped through the window.

The program's serving network is ``Trainer._eval_params()`` (its weights of
two or more dimensions in bf16) and each step is
``GaussianDiffusion.p_sample_step``, called as ``p_sample_loop`` calls it:
one generator for the batch, the condition image beside the state, t
counting down from T - 1. The chain carries its state across the window's
start; set-up runs its first steps. Should a chain end inside the window
the next one starts from fresh noise.

``sample_images_per_s`` = images x steps completed in the window /
(T x the window's seconds); the window ends in a synchronize.

The check: a sample of the window's steps drawn from the seed (a
reservoir over all of them) and the window's last step. For each, the
reference recomputes the noise estimate from the program's own input
state, in float32 from the same bf16-rounded weights, and the posterior
step with the noise redrawn from the generator state before the step.
``eps_gap`` is the largest per-image relative L2 gap of the noise
estimates. ``step_gap`` is the L2 gap of the next states over the batch
in the noise estimate's units: divided by g_t = coef1_t sqrt(1/abar_t -
1), the factor by which the posterior passes an estimate's error on where
x0 is not clipped, and by the norm of the reference's estimate over the
elements where its x0 is not clipped. So it reads an estimate's error
alike at every t, however much of x0 the clip takes.
"""

from __future__ import annotations

import copy
import math
import time

import numpy as np
import torch

from portbench import costs, inputs, trace as tracing
from portbench.checks import per_image_rel_l2
from portbench.kinds import (Run, SetupParts, host_spans, load_library,
                             memory_peak, release, sync)
from portbench.reference import diffusion as ref
from portbench.reference.unet import FP32, Precision, build

# chain steps run in set-up before the window, steps of the window the
# check recomputes (besides the last), host spans and profiled steps of
# the traced run
WARMUP_STEPS = 3
CHECKED_STEPS = 4
HOST_SPAN_STEPS = 10
TRACE_STEPS = 8


def _serving_opt(opt, traffic):
    opt = copy.deepcopy(opt)
    opt["phase"] = "val"
    sched = opt["model"]["beta_schedule"]["val"]
    if int(sched["n_timestep"]) != int(traffic["T"]):
        raise ValueError(f"traffic T {traffic['T']} != the config's "
                         f"{sched['n_timestep']} steps")
    if traffic.get("sampler", "ancestral") != "ancestral":
        raise ValueError(f"sampler {traffic['sampler']!r}")
    return opt


class ProgramServing:
    """The port's serving path: ``step(img, t, cond, g)`` -> (next state,
    the network's noise estimate)."""

    def __init__(self, opt, weights, device):
        from sr3_tpu_torch.training.trainer import Trainer

        self.trainer = Trainer(opt, device=device)
        inputs.load_weights(self.trainer.netG, weights)
        self.trainer.set_new_noise_schedule(
            opt["model"]["beta_schedule"]["val"], "val")
        self.net = self.trainer._eval_params()
        self.diffusion, self.sched = self.trainer.diffusion, self.trainer.sched
        self._eps = None
        self.net.register_forward_hook(self._keep)

    def _keep(self, module, args, output):
        self._eps = output

    def step(self, img, t, cond, g):
        out = self.diffusion.p_sample_step(self.net, self.sched, img, t, cond,
                                           generator=g)
        return out, self._eps


class ReferenceServing:
    """The reference in the program's place, at ``precision`` (the
    control)."""

    def __init__(self, opt, weights, device, precision="float8"):
        self.unet = build(opt, device)
        inputs.load_weights(self.unet, weights)
        self.sched = ref.Schedule(opt["model"]["beta_schedule"]["val"],
                                  device)
        self.prec = Precision(precision)

    def step(self, img, t, cond, g):
        eps = ref.chain_eps(self.unet, self.sched, cond, img, t, self.prec)
        noise = (torch.randn(img.shape, generator=g, device=img.device)
                 if t > 0 else None)
        return ref.chain_step(self.sched, img, t, eps, noise), eps


class _Chain:
    """The chain's state between steps, and the records the check reads."""

    def __init__(self, system, cond, g, T, shape):
        self.system, self.cond, self.g, self.T = system, cond, g, T
        self.shape = shape
        self.img = self.fresh()
        self.t = T - 1

    def fresh(self):
        return torch.randn(self.shape, generator=self.g,
                           device=self.cond.device)

    def step(self, record=False):
        if self.t < 0:
            self.img, self.t = self.fresh(), self.T - 1
        state = self.g.get_state() if record else None
        img, t = self.img, self.t
        out, eps = self.system.step(img, t, self.cond, self.g)
        self.img, self.t = out, t - 1
        return (img, t, state, out, eps) if record else None


def run(opt, traffic, seed, seconds, trace, device, t_start, system=None):
    parts = SetupParts(t_start, device)
    opt = _serving_opt(opt, traffic)
    batch, T = int(traffic["batch"]), int(traffic["T"])
    size = opt["model"]["diffusion"]["image_size"]
    weights = inputs.make_weights(opt, seed, device)
    cond = inputs.condition_images(opt, batch, seed, device)
    parts.mark("weights")
    sys_ = (ProgramServing(opt, weights, device) if system is None
            else system(opt, weights, device))
    del weights
    parts.mark("trainer")
    load_library(device)
    parts.mark("library")
    g = torch.Generator(device=device).manual_seed(
        inputs.sub_seed(seed, "chain"))
    rng = np.random.default_rng(inputs.sub_seed(seed, "checked"))
    k = CHECKED_STEPS
    summary = {"kind": "sample", "batch": batch}

    with torch.inference_mode():
        chain = _Chain(sys_, cond, g, T, (batch, 3, size, size))
        for _ in range(WARMUP_STEPS):
            chain.step()
        parts.mark("warmup_steps")
        setup_s = time.time() - t_start

        # the window: a reservoir of k steps drawn from the seed over all
        # of the window's steps, and the last step
        picked, last, n = [], None, 0
        t0 = time.perf_counter()
        while True:
            slot = n if n < k else int(rng.integers(0, n + 1))
            last = chain.step(record=True)
            if slot < k:
                if n < k:
                    picked.append(last)
                else:
                    picked[slot] = last
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(device)
        window_s = time.perf_counter() - t0

        if trace:
            summary["host_span_ms"] = host_spans(chain.step, HOST_SPAN_STEPS,
                                                 device)
            summary["trace"] = tracing.summarize(
                tracing.profile(chain.step, TRACE_STEPS, device), TRACE_STEPS)
    peak = memory_peak(device)
    records = picked + ([last] if all(last is not r for r in picked) else [])
    del chain, sys_, picked, last
    release(device)

    summary.update(steps=n, window_s=window_s)
    if trace:
        summary.update(flops_per_step=costs.forward_flops(opt) * batch,
                       k1_sites=costs.k1_sites(opt, batch, training=False))
    numbers = check(opt, seed, cond, records, device)
    e2e = {"sample_images_per_s": n * batch / (T * window_s),
           "setup_s": setup_s}
    return Run(e2e, n, 0, numbers, peak, summary,
               {"checked_t": [r[1] for r in records],
                "setup_parts": parts.marks})


def check(opt, seed, cond, records, device):
    """eps_gap and step_gap over the recorded steps (see the module
    docstring)."""
    weights = inputs.make_weights(opt, seed, device)
    if _serving_dtype(opt, device) == "bfloat16":
        # the program's serving copy: weights of 2+ dimensions in bf16
        weights = {n: (w.to(torch.bfloat16).float() if w.dim() >= 2 else w)
                   for n, w in weights.items()}
    unet = build(opt, device)
    inputs.load_weights(unet, weights)
    del weights
    sched = ref.Schedule(opt["model"]["beta_schedule"]["val"], device)
    size = opt["model"]["diffusion"]["image_size"]
    rows = max(1, 4 * 262144 // (size * size))
    eps_gap = step_gap = 0.0
    with torch.no_grad():
        for img, t, state, out, eps in records:
            x = img.float()
            want = torch.cat([
                ref.chain_eps(unet, sched, cond[r:r + rows], x[r:r + rows],
                              t, FP32)
                for r in range(0, x.shape[0], rows)])
            g = torch.Generator(device=device)
            g.set_state(state)
            noise = (torch.randn(x.shape, generator=g, device=device)
                     if t > 0 else None)
            nxt = ref.chain_step(sched, x, t, want, noise)
            eps_gap = max(eps_gap, per_image_rel_l2(eps, want))
            step_gap = max(step_gap, _step_gap(sched, t, x, want, out, nxt))
    return {"eps_gap": eps_gap, "step_gap": step_gap}


def _step_gap(sched, t, x, eps, got, want):
    """|got - want| / (g_t |eps where x0 is not clipped|), over the
    batch."""
    if got is None or tuple(got.shape) != tuple(want.shape):
        return math.inf
    x0 = sched.sqrt_recip[t] * x - sched.sqrt_recipm1[t] * eps
    free = float((eps * (x0.abs() < 1)).norm())
    gain = float(sched.coef1[t] * sched.sqrt_recipm1[t])
    return float((got.float() - want).norm()) / max(gain * free, 1e-30)


def _serving_dtype(opt, device):
    """The program's compute dtype: the config's ``model.dtype``, else
    bf16 on a card and float32 on the CPU."""
    return opt["model"].get("dtype") or (
        "bfloat16" if torch.device(device).type == "cuda" else "float32")
