"""Training: ``Trainer.optimize_parameters_resident`` one step at a time,
on a resident set that the benchmark makes from the seed.

Set-up builds one train-phase ``Trainer`` from the config (dropout,
Adam, EMA and remat as the config and the traffic state them), loads the
benchmark's weights and the resident set, and drives its first
CHECKED_STEPS steps through the window's own call; the window then goes
on with the same object. ``train_images_per_s`` = images trained in the
window / the window's seconds; the window ends in a synchronize.

The check follows those first steps with the reference (float32, the same
weights, data and draws, Adam as optax computes it). Each gap of a leaf is
measured against the larger of the reference leaf's value and the median
leaf's: ``loss_gap`` the largest relative gap of a step's loss;
``grad_gap`` the worst leaf's gap between the norms of the first gradient
(the program's worked out from its first moment after one step);
``grad_diff_median`` and ``grad_diff_worst`` the norm of the first
gradients' difference over up to GRAD_SAMPLE elements of each leaf drawn
from the seed, of the median leaf and of the worst (a gradient whose
direction is wrong in one leaf keeps its norm, and only the worst leaf's
difference sees it); ``change_gap`` the worst leaf's gap between the norms
of the parameters' change over the checked steps, over the leaves whose
reference gradient is at least TINY_GRADIENT of the median leaf's.

The traced run profiles TRACE_STEPS steps; the host's time to issue a
step is read from that trace (``trace.summarize``), since a span around a
step would wait on the card once the launch queue fills.
"""

from __future__ import annotations

import copy
import statistics
import time

import numpy as np
import torch

from portbench import costs, inputs, trace as tracing
from portbench.checks import leaf_norms, median_leaf_gap, worst_leaf_gap
from portbench.kinds import (Run, SetupParts, load_library, memory_peak,
                             release, sync)
from portbench.reference import diffusion as ref
from portbench.reference.unet import Precision, build

# leaves whose reference gradient is under this share of the median
# leaf's move by round-off alone and are not compared in change_gap
TINY_GRADIENT = 1e-3
# elements of each leaf's first gradient that grad_diff_* compare
GRAD_SAMPLE = 4096
# steps of set-up that the check follows, and profiled steps of the
# traced run
CHECKED_STEPS = 3
TRACE_STEPS = 3


def _train_opt(opt, traffic, seed):
    opt = copy.deepcopy(opt)
    opt["phase"] = "train"
    opt["seed"] = inputs.sub_seed(seed, "trainer")
    if "remat" in traffic:
        opt["model"]["unet"]["remat"] = bool(traffic["remat"])
    return opt


class _ResidentSet:
    """The resident arrays as the program's ``load_device_dataset`` reads a
    data set: uint8 (H, W, 3) images by index."""

    min_max = (-1, 1)

    def __init__(self, arrays):
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays["HR"])

    def _decoded(self, i):
        return {k: v[i] for k, v in self.arrays.items()}


class ProgramTraining:
    """The port's train step on the resident set."""

    def __init__(self, opt, weights, arrays, batch, device):
        from sr3_tpu_torch.training.trainer import Trainer

        self.trainer = Trainer(opt, device=device)
        inputs.load_weights(self.trainer.netG, weights)
        self.trainer.set_new_noise_schedule(
            opt["model"]["beta_schedule"]["train"], "train")
        self.trainer.load_device_dataset(_ResidentSet(arrays))
        self.batch = batch

    def step(self):
        self.trainer.optimize_parameters_resident(self.batch, 1)

    def loss(self):
        return self.trainer.log_dict["l_pix"]

    def params(self):
        return dict(self.trainer.netG.named_parameters())

    def first_gradient(self):
        """Each leaf's gradient as Adam received it at step 1, from its
        first moment: mu_1 = (1 - b1) g_1. A leaf with no state is absent."""
        opt = self.trainer.optimizer
        b1 = opt.param_groups[0]["betas"][0]
        out = {}
        for n, p in self.params().items():
            mu = opt.state.get(p, {}).get("exp_avg")
            if mu is not None:
                out[n] = mu.float() / (1.0 - b1)
        return out


class ReferenceTraining:
    """The reference trainer, at ``precision``: the check's side in
    float32, the control's below it."""

    def __init__(self, opt, weights, arrays, batch, device,
                 precision="float8"):
        self.unet = build(opt, device).requires_grad_(True)
        inputs.load_weights(self.unet, weights)
        self.sched = ref.Schedule(opt["model"]["beta_schedule"]["train"],
                                  device)
        self.adam = ref.Adam(self.unet.parameters(),
                             float(opt["train"]["optimizer"]["lr"]))
        self.data = {k: torch.from_numpy(v).to(device)
                     for k, v in arrays.items()}
        self.keep = 1.0 - float(opt["model"]["unet"].get("dropout") or 0.0)
        self.sites = ref.dropout_sites(opt, batch)
        self.batch, self.device = batch, device
        self.seed = opt["seed"]
        self.prec = Precision(precision)
        size = opt["model"]["diffusion"]["image_size"]
        self.rows = max(1, 262144 // (size * size))
        self.count, self._loss, self._grad1 = 0, None, None

    def step(self):
        dev = self.device
        g = torch.Generator(device=dev).manual_seed(
            ref.fold_seed(self.seed, self.count))
        n = len(self.data["HR"])
        idx, flip = ref.resident_draws(g, n, self.batch, dev)
        batch = ref.resident_batch(self.data, idx, flip)
        noise, level = ref.loss_draws(g, self.sched, batch["HR"].shape, dev)
        masks = ref.draw_masks(g, self.sites, self.keep, dev)
        for p in self.unet.parameters():
            p.grad = None
        self._loss = ref.loss_and_grads(self.unet, self.sched, batch, noise,
                                        level, masks, self.prec, self.rows)
        if self.count == 0:
            self._grad1 = {n: p.grad.clone() for n, p in
                           self.unet.named_parameters()}
        self.adam.step()
        self.count += 1

    def loss(self):
        return torch.tensor(self._loss)

    def params(self):
        return dict(self.unet.named_parameters())

    def first_gradient(self):
        return self._grad1


def grad_sample_index(opt, seed, device):
    """Per leaf, up to ``GRAD_SAMPLE`` element indices drawn from the
    seed: where ``grad_diff_*`` compare the first gradients."""
    rng = np.random.default_rng(inputs.sub_seed(seed, "grad sample"))
    out = {}
    for name, shape in inputs.weight_shapes(opt):
        n = int(np.prod(shape))
        idx = (np.arange(n) if n <= GRAD_SAMPLE
               else rng.choice(n, GRAD_SAMPLE, replace=False))
        out[name] = torch.from_numpy(idx).to(device)
    return out


def _follow(system, k, init, index):
    """Drive ``k`` steps. Returns the losses, the first gradient's leaf
    norms and its elements at ``index``, and the leaf norms of the
    parameters' change from ``init``."""
    losses = []
    for i in range(k):
        system.step()
        losses.append(system.loss().detach().reshape(()).float())
        if i == 0:
            first = system.first_gradient()
            norms = leaf_norms(first)
            sample = {n: g.flatten()[index[n]].cpu() for n, g in first.items()}
            del first
    with torch.no_grad():
        change = leaf_norms({n: p.detach() - init[n]
                             for n, p in system.params().items()})
    return {"losses": [float(x) for x in torch.stack(losses).cpu()],
            "grad1": norms, "grad1_sample": sample, "change": change}


def run(opt, traffic, seed, seconds, trace, device, t_start, system=None):
    parts = SetupParts(t_start, device)
    opt = _train_opt(opt, traffic, seed)
    batch, k = int(traffic["batch"]), CHECKED_STEPS
    weights = inputs.make_weights(opt, seed, device)
    index = grad_sample_index(opt, seed, device)
    parts.mark("weights")
    arrays = inputs.resident_arrays(opt, int(traffic["resident"]), seed,
                                    device)
    parts.mark("resident_set")
    sys_ = (ProgramTraining(opt, weights, arrays, batch, device)
            if system is None
            else system(opt, weights, arrays, batch, device))
    parts.mark("trainer")
    load_library(device)
    parts.mark("library")
    got = _follow(sys_, k, weights, index)
    del weights
    parts.mark("checked_steps")
    setup_s = time.time() - t_start

    n = 0
    t0 = time.perf_counter()
    while True:
        sys_.step()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t0

    summary = {"kind": "train", "batch": batch}
    if trace:
        summary["trace"] = tracing.summarize(
            tracing.profile(sys_.step, TRACE_STEPS, device), TRACE_STEPS)
    peak = memory_peak(device)
    del sys_
    release(device)

    summary.update(steps=n, window_s=window_s)
    if trace:
        summary.update(flops_per_step=costs.train_step_flops(opt) * batch,
                       k1_sites=costs.k1_sites(opt, batch, training=True))
    numbers, detail = check(opt, seed, arrays, batch, k, got, index, device)
    detail["setup_parts"] = parts.marks
    e2e = {"train_images_per_s": n * batch / window_s, "setup_s": setup_s}
    return Run(e2e, n, 0, numbers, peak, summary, detail)


def check(opt, seed, arrays, batch, k, got, index, device):
    """loss_gap, grad_gap, grad_diff_median, grad_diff_worst and
    change_gap (see the module docstring)."""
    weights = inputs.make_weights(opt, seed, device)
    system = ReferenceTraining(opt, weights, arrays, batch, device, "float32")
    want = _follow(system, k, weights, index)
    del system, weights
    release(device)
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(got["losses"], want["losses"]))
    grad1 = want["grad1"]
    med = statistics.median(grad1.values())
    moving = {n for n, v in grad1.items() if v >= TINY_GRADIENT * med}
    grad_gap, grad_leaf = worst_leaf_gap(got["grad1"], grad1)
    diff = {n: float((got["grad1_sample"][n] - w).norm())
            for n, w in want["grad1_sample"].items()
            if n in got["grad1_sample"]}
    sample_norms = {n: float(w.norm()) for n, w in
                    want["grad1_sample"].items()}
    diff_median = median_leaf_gap(diff, sample_norms, relative=True)
    diff_worst, diff_leaf = worst_leaf_gap(diff, sample_norms, relative=True)
    change_gap, change_leaf = worst_leaf_gap(got["change"], want["change"],
                                             moving)
    detail = {"losses": [got["losses"], want["losses"]],
              "grad_leaf": [grad_leaf, got["grad1"].get(grad_leaf),
                            grad1.get(grad_leaf), med],
              "diff_leaf": [diff_leaf, diff.get(diff_leaf),
                            sample_norms.get(diff_leaf)],
              "change_leaf": [change_leaf, got["change"].get(change_leaf),
                              want["change"].get(change_leaf)],
              "left_out": sorted(set(grad1) - moving)}
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "grad_diff_median": diff_median, "grad_diff_worst": diff_worst,
            "change_gap": change_gap}, detail
