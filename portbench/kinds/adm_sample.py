"""Serving guided-diffusion's ADM upsampler: its respaced, learned-variance
ancestral chain, stepped through the window.

The contract of ``kinds/sample.py``, for a class-conditional network that
takes the low-resolution image itself (``which_model_G: "adm"``): the
program's serving network is ``Trainer._eval_params()`` (weights of two or
more dimensions in bf16) and each step is ``GaussianDiffusion.p_sample_step``
on the schedule respaced to the traffic's ``T`` steps of its ``T_train``,
with one generator for the batch and the condition an ``SRCondition`` of
the seed's low-resolution images and class labels. The chain carries its
state across the window's start; set-up runs its first steps; a chain that
ends inside the window starts again from fresh noise.

``sample_images_per_s`` = images x steps completed in the window / (T x
the window's seconds); the window ends in a synchronize.

The check: a reservoir of the window's steps drawn from the seed, and the
last step. For each the reference (``reference/adm.py``) recomputes the
network's output from the program's own input state, in float32 from the
same bf16-rounded weights, and the step with the noise redrawn from the
generator state before it. ``eps_gap`` and ``var_gap`` are the largest
per-image relative L2 gaps of the noise estimate and of v, the variance's
interpolation value; ``step_gap`` is ``kinds/sample.py``'s, the next
states' gap in the noise estimate's units.
"""

from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np
import torch

from portbench import inputs, trace as tracing
from portbench.checks import per_image_rel_l2
from portbench.kinds import (Run, SetupParts, host_spans, load_library,
                             memory_peak, release, sync)
from portbench.kinds.sample import _Chain, _serving_dtype, _step_gap
from portbench.reference import adm as ref
from portbench.reference.unet import FP32, Precision

WARMUP_STEPS = 3
CHECKED_STEPS = 4
HOST_SPAN_STEPS = 10
TRACE_STEPS = 8


@dataclasses.dataclass(frozen=True)
class Condition:
    """The seed's low-resolution images (b, 3, h, w) and class labels (b,)
    or None."""

    low: torch.Tensor
    labels: torch.Tensor | None

    @property
    def device(self):
        return self.low.device


def _serving_opt(opt, traffic):
    opt = copy.deepcopy(opt)
    opt["phase"] = "val"
    sched = opt["model"]["beta_schedule"]["val"]
    if int(sched["n_timestep"]) != int(traffic["T_train"]):
        raise ValueError(f"traffic T_train {traffic['T_train']} != the "
                         f"config's {sched['n_timestep']} steps")
    if int(sched.get("timestep_respacing") or sched["n_timestep"]) != \
            int(traffic["T"]):
        raise ValueError(f"traffic T {traffic['T']} != the config's "
                         f"respacing {sched.get('timestep_respacing')}")
    if traffic.get("sampler", "ancestral") != "ancestral":
        raise ValueError(f"sampler {traffic['sampler']!r}")
    return opt


def adm_weights(opt, seed, device):
    """Random float32 weights from one draw on ``device``, by the rule of
    ``inputs.make_weights`` over the ADM's parameters: weights of 2+
    dimensions N(0, 1 / fan_in), GroupNorm scales 1 + N(0, 0.1^2), biases
    and GroupNorm shifts N(0, 0.05^2)."""
    shapes = [(n, tuple(p.shape))
              for n, p in ref.build(opt, "meta").named_parameters()]
    total = sum(int(np.prod(s)) for _, s in shapes)
    g = torch.Generator(device=device).manual_seed(
        inputs.sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape in shapes:
        n = int(np.prod(shape))
        w = flat[off:off + n].view(shape)
        off += n
        if len(shape) >= 2:
            w.mul_(1.0 / np.sqrt(n // shape[0]))
        elif name.endswith("weight"):
            w.mul_(0.1).add_(1.0)
        else:
            w.mul_(0.05)
        out[name] = w
    return out


def condition(opt, batch, seed, device):
    """The chain's condition: (batch, 3, l, l) low-resolution images
    uniform in [-1, 1] at ``datasets.val.l_resolution``, and labels uniform
    over ``model.unet.num_classes`` (None without classes)."""
    low = int(opt["datasets"]["val"]["l_resolution"])
    g = torch.Generator(device=device).manual_seed(
        inputs.sub_seed(seed, "cond"))
    lr = torch.rand((batch, 3, low, low), generator=g, device=device) * 2 - 1
    n = opt["model"]["unet"].get("num_classes")
    labels = None
    if n:
        g.manual_seed(inputs.sub_seed(seed, "labels"))
        labels = torch.randint(0, int(n), (batch,), generator=g,
                               device=device)
    return Condition(lr.contiguous(memory_format=torch.channels_last),
                     labels)


class ProgramServing:
    """The port's serving path: ``step(img, t, cond, g)`` -> (next state,
    the network's output: eps, then v)."""

    def __init__(self, opt, weights, device):
        from sr3_tpu_torch.models.diffusion import SRCondition
        from sr3_tpu_torch.training.trainer import Trainer

        self.trainer = Trainer(opt, device=device)
        inputs.load_weights(self.trainer.netG, weights)
        self.trainer.set_new_noise_schedule(
            opt["model"]["beta_schedule"]["val"], "val")
        self.net = self.trainer._eval_params()
        self.diffusion, self.sched = self.trainer.diffusion, self.trainer.sched
        self._cond = SRCondition
        self._out = None
        self.net.register_forward_hook(self._keep)

    def _keep(self, module, args, output):
        self._out = output

    def step(self, img, t, cond, g):
        out = self.diffusion.p_sample_step(
            self.net, self.sched, img, t, self._cond(cond.low, cond.labels),
            generator=g)
        return out, self._out


class ReferenceServing:
    """The reference in the program's place, at ``precision`` (the
    control)."""

    def __init__(self, opt, weights, device, precision="float8"):
        self.unet = ref.build(opt, device)
        inputs.load_weights(self.unet, weights)
        self.sched = ref.Schedule(opt["model"]["beta_schedule"]["val"],
                                  device)
        self.prec = Precision(precision)

    def step(self, img, t, cond, g):
        out = ref.chain_out(self.unet, self.sched, cond.low, cond.labels,
                            img, t, self.prec)
        noise = (torch.randn(img.shape, generator=g, device=img.device)
                 if t > 0 else None)
        return ref.chain_step(self.sched, img, t, out, noise), out


def run(opt, traffic, seed, seconds, trace, device, t_start, system=None):
    parts = SetupParts(t_start, device)
    opt = _serving_opt(opt, traffic)
    batch, T = int(traffic["batch"]), int(traffic["T"])
    size = opt["model"]["diffusion"]["image_size"]
    weights = adm_weights(opt, seed, device)
    cond = condition(opt, batch, seed, device)
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
    summary = {"kind": "adm_sample", "batch": batch}

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
        summary.update(flops_per_step=ref.forward_flops(opt) * batch,
                       k1_sites=ref.k1_sites(opt, batch))
    numbers = check(opt, seed, cond, records, device)
    e2e = {"sample_images_per_s": n * batch / (T * window_s),
           "setup_s": setup_s}
    return Run(e2e, n, 0, numbers, peak, summary,
               {"checked_t": [r[1] for r in records],
                "setup_parts": parts.marks})


def check(opt, seed, cond, records, device):
    """eps_gap, var_gap and step_gap over the recorded steps (see the
    module docstring)."""
    weights = adm_weights(opt, seed, device)
    if _serving_dtype(opt, device) == "bfloat16":
        # the program's serving copy: weights of 2+ dimensions in bf16
        weights = {n: (w.to(torch.bfloat16).float() if w.dim() >= 2 else w)
                   for n, w in weights.items()}
    unet = ref.build(opt, device)
    inputs.load_weights(unet, weights)
    del weights
    sched = ref.Schedule(opt["model"]["beta_schedule"]["val"], device)
    size = opt["model"]["diffusion"]["image_size"]
    rows = max(1, 4 * 262144 // (size * size))
    c = 3
    eps_gap = var_gap = step_gap = 0.0
    with torch.no_grad():
        for img, t, state, out, got in records:
            x = img.float()
            want = torch.cat([
                ref.chain_out(unet, sched, cond.low[r:r + rows],
                              None if cond.labels is None
                              else cond.labels[r:r + rows],
                              x[r:r + rows], t, FP32)
                for r in range(0, x.shape[0], rows)])
            g = torch.Generator(device=device)
            g.set_state(state)
            noise = (torch.randn(x.shape, generator=g, device=device)
                     if t > 0 else None)
            nxt = ref.chain_step(sched, x, t, want, noise)
            ok = got is not None and tuple(got.shape) == tuple(want.shape)
            eps_gap = max(eps_gap, per_image_rel_l2(
                got[:, :c] if ok else None, want[:, :c]))
            var_gap = max(var_gap, per_image_rel_l2(
                got[:, c:] if ok else None, want[:, c:]))
            step_gap = max(step_gap, _step_gap(sched, t, x, want[:, :c], out,
                                               nxt))
    return {"eps_gap": eps_gap, "var_gap": var_gap, "step_gap": step_gap}
