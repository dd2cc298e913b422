"""Trainer: model, schedules, optimizer, EMA, checkpoints, batched sampling.

Counterpart of ``sr3_tpu/training/trainer.py``: ``create_model``,
``set_new_noise_schedule``, the train phase (``feed_data``,
``optimize_parameters``: one step of ``p_losses`` -> backward -> Adam, then
the EMA; ``get_current_log``; ``finetune_norm``), checkpoints
(``save_network`` / ``load_network`` with the reference's
``I{iter}_E{epoch}_{gen,opt}.pth`` names), the bf16 sampling copy
(``_eval_params``), the sampler choice (``_chain_fn``: ancestral, DDIM or
DPM-Solver++), ``test_batched`` (with class labels for the adm network) /
``sample_batched``, and the
device-resident dataset (``load_device_dataset``,
``optimize_parameters_resident``). Parameters are float32; the UNet
computes in its own dtype (bf16 on CUDA). The optimizer is
``training/optim.py``'s Adam (optax's arithmetic) with the first moment in
``train.optimizer.mu_dtype`` (float32, or "bfloat16"). A step is a
``trainer.step`` span (``utils/profiler.py``: recorded only under a
profiler) holding ``trainer.forward`` (the loss), ``trainer.backward`` and
``trainer.optimizer`` (Adam and the EMA). Every draw of a
host-loader step comes from one ``torch.Generator`` on the trainer's
device, seeded from the config's seed; a resident step draws its batch and
its loss from a generator seeded from (seed, step), as the JAX package folds
the step into its key, so a resumed run draws what the straight run would.

On a mesh (``parallel/mesh.py``; ``Trainer(opt, mesh=...)``), one process
per rank:

- data: the config's ``batch_size`` is the global batch, which the data
  axis must divide (checked before the first step); each rank steps on its
  slice. After the backward the gradients are summed over the space axis
  (each space rank holds its rows' partial) and averaged over the data
  group: ``all_reduce`` SUM of the flattened gradients in buckets, in
  parameter order, then a division (``_reduce_gradients``). Adam and the
  EMA then run the same way on every rank. The logged ``l_pix`` is the
  data-group mean.
- random draws: each data rank draws from its own generator, seeded from
  (seed, data coordinate) (the seed itself when the data axis is 1); ranks
  that share a data coordinate (their model and space peers) draw the same
  numbers. A resident step draws the global batch from (seed, step) on
  every rank, takes the rank's data slice, and draws its loss from
  (seed, step, data coordinate). The evaluator's per-image generators do
  not depend on the grouping, so sharded serving gives one process's
  images.
- model: the UNet's parameters are sharded (``UNet.set_parallel``), and
  with them the Adam moments and the EMA.
- checkpoints: ``save_network`` gathers whole tensors over the model axis,
  the primary rank alone writes, and every rank meets at a barrier before
  returning; ``load_network`` slices whole tensors. A checkpoint from N
  ranks loads in one process, and the reverse.
"""

from __future__ import annotations

import copy
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from sr3_tpu_torch.models.diffusion import SRCondition
from sr3_tpu_torch.models.networks import count_params, define_G
from sr3_tpu_torch.models.schedule import make_schedule
from sr3_tpu_torch.parallel import sharding_rules as tp
from sr3_tpu_torch.parallel.mesh import (barrier, data_mean, data_slice,
                                         is_primary)
from sr3_tpu_torch.training.evaluation import fold_seed
from sr3_tpu_torch.training.optim import Adam
from sr3_tpu_torch.utils.profiler import StepTimer, span
from sr3_tpu_torch.utils.runtime import DTYPES, resolve_device
from sr3_tpu_torch.utils.torch_compat import strip_reference_keys

logger = logging.getLogger("base")
# float32 gradient elements per all-reduce
GRAD_BUCKET = 1 << 24


def finetune_norm(net):
    """Freeze every parameter whose name does not mention 'transformer' and
    zero-init those that do (reference model/model.py:26-35). Returns the
    trainable parameters."""
    trainable = []
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "transformer" in name.lower():
                p.zero_()
                trainable.append(p)
            else:
                p.requires_grad_(False)
    return trainable


class Trainer:
    """Owns the diffusion model, its device, schedules, optimizer and RNGs."""

    def __init__(self, opt, device=None, mesh=None):
        self.opt = opt
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
        self.device = torch.device(device) if device is not None \
            else resolve_device()
        self.phase = opt.get("phase", "train")
        seed = opt.get("seed", 0) or 0
        n_data = 1 if mesh is None else mesh.data.size
        if self.phase == "train" and n_data > 1:
            bs = ((opt.get("datasets") or {}).get("train") or {}) \
                .get("batch_size")
            if bs and bs % n_data:
                raise ValueError(
                    f"datasets.train.batch_size {bs} is the global batch; "
                    f"the data axis ({n_data}) must divide it")
        self.diffusion = define_G(opt, device=self.device, seed=seed)
        self.netG = self.diffusion.denoise_fn
        self.netG.set_parallel(mesh)
        self.conditional = self.diffusion.conditional
        # host RNG: the evaluator draws its base seed from it, as the JAX
        # trainer splits its key
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed if n_data == 1 else fold_seed(seed, mesh.data.rank))
        self.reduced_bytes = 0
        self.schedules = {}
        self.schedule_phase = None
        self.sched = None
        self._eval_net = None

        ema_opt = (opt.get("train") or {}).get("ema_scheduler") or {}
        self.use_ema = bool(ema_opt.get("use_ema", False))
        self.ema_decay = float(ema_opt.get("ema_decay", 0.9999))
        self.step_start_ema = int(ema_opt.get("step_start_ema", 5000))

        self.optimizer = None
        if self.phase == "train":
            opt_cfg = opt["train"]["optimizer"]
            mu_dtype = opt_cfg.get("mu_dtype")
            if mu_dtype not in (None, "float32", "bfloat16"):
                raise ValueError(f"train.optimizer.mu_dtype must be float32 "
                                 f"or bfloat16, got {mu_dtype!r}")
            if opt["model"].get("finetune_norm"):
                params = finetune_norm(self.netG)
            else:
                params = list(self.netG.parameters())
            names = {id(p): n for n, p in self.netG.named_parameters()}
            self._opt_names = [names[id(p)] for p in params]
            # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8
            if params:
                self.optimizer = Adam(params, lr=opt_cfg["lr"],
                                      mu_dtype=DTYPES[mu_dtype or "float32"])
        self.ema = ({n: p.detach().clone()
                     for n, p in self.netG.named_parameters()}
                    if self.use_ema else None)
        self.step = 0
        self.begin_step = 0
        self.begin_epoch = 0
        self.log_dict = {}
        self.data = None
        self._dev_data = None
        self._resident_batch = None
        self.timer = StepTimer()
        self.load_network()

    def set_new_noise_schedule(self, schedule_opt, schedule_phase="train"):
        if self.schedule_phase != schedule_phase:
            self.schedule_phase = schedule_phase
            key = repr(sorted(dict(schedule_opt).items()))
            if key not in self.schedules:
                self.schedules[key] = make_schedule(schedule_opt, self.device)
            self.sched = self.schedules[key]
            # validation or sampling ran in between: keep its wall time out
            # of the train step's EMA
            self.timer._last = None

    # ------------------------------------------------------------ training

    def feed_data(self, data):
        """Host batch (numpy NHWC arrays) -> NCHW float32 tensors in
        channels_last memory on the device; tensors already there (from
        ``data/prefetch.py``) and other entries pass through."""
        self.data = {
            k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            .permute(0, 3, 1, 2).to(self.device, non_blocking=True)
            if isinstance(v, np.ndarray) and v.ndim == 4 else v
            for k, v in data.items()
        }

    def optimize_parameters(self):
        """One training step: loss, backward, Adam, EMA (reference
        model/model.py:48-58). The loss stays on the device until a log
        line reads it."""
        keys = ("HR", "SR") if self.conditional else ("HR",)
        with span("trainer.step", self.device, step=self.step):
            self._train_step({k: self.data[k] for k in keys}, self.generator)
        self.timer.tick()

    def _train_step(self, batch, generator):
        self.netG.train()
        train = self.optimizer is not None
        if train:
            self.optimizer.zero_grad(set_to_none=True)
        with torch.set_grad_enabled(train), \
                span("trainer.forward", self.device):
            loss = self.diffusion.p_losses(self.netG, self.sched, batch,
                                           generator)
        if train:
            with span("trainer.backward", self.device):
                loss.backward()
            self._reduce_gradients()
        with span("trainer.optimizer", self.device):
            if train:
                self.optimizer.step()
            self._update_ema()
        self.step += 1
        self.log_dict["l_pix"] = loss.detach()

    def _reduce_gradients(self):
        """Sum the gradients over the space axis, then average them over
        the data group: all_reduce SUM of the flattened float32 gradients,
        GRAD_BUCKET elements at a time in parameter order, then a division
        by the data size. A parameter with no gradient takes part as zeros
        and keeps none."""
        m = self.mesh
        if m is None or (m.data.size == 1 and m.space.size == 1):
            return
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        nbytes, i = 0, 0
        while i < len(params):
            bucket, n = [], 0
            while i < len(params) and (
                    not bucket or n + params[i].numel() <= GRAD_BUCKET):
                bucket.append(params[i])
                n += params[i].numel()
                i += 1
            flat = torch.cat([(p.grad if p.grad is not None
                               else torch.zeros_like(p)).reshape(-1).float()
                              for p in bucket])
            for axis in (m.space, m.data):
                if axis.size > 1:
                    dist.all_reduce(flat, group=axis.group)
                    nbytes += flat.numel() * flat.element_size()
            if m.data.size > 1:
                flat.div_(m.data.size)
            off = 0
            for p in bucket:
                if p.grad is not None:
                    p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
                off += p.numel()
        self.reduced_bytes = nbytes

    # ------------------------------------------------ device-resident data

    def load_device_dataset(self, dataset):
        """Put the whole train set on the device once, as uint8 NHWC (decoded,
        not normalized: a quarter of float32's bytes): 'HR' and 'SR', 'HR'
        only when unconditional. ``dataset``: the port's ``LRHRDataset``, or
        any set with its ``_decoded(i)`` (uint8 HWC arrays) and ``min_max``
        (default (-1, 1)). Returns the bytes it holds."""
        keys = ("HR", "SR") if self.conditional else ("HR",)
        items = [dataset._decoded(i) for i in range(len(dataset))]
        stacked = {k: np.stack([it[k] for it in items]) for k in keys}
        self._dev_min_max = getattr(dataset, "min_max", (-1, 1))
        for k, v in stacked.items():
            if v.dtype != np.uint8 or v.ndim != 4:
                raise ValueError(f"resident {k}: uint8 (N, H, W, C) arrays, "
                                 f"got {v.dtype} {v.shape}")
        self._dev_data = {k: torch.from_numpy(np.ascontiguousarray(v))
                          .to(self.device) for k, v in stacked.items()}
        self._resident_generator = torch.Generator(device=self.device)
        nbytes = sum(v.nbytes for v in stacked.values())
        logger.info("Device-resident dataset: %d samples, %.1f MB uint8 on "
                    "the device", len(next(iter(stacked.values()))),
                    nbytes / 1e6)
        return nbytes

    def _resident_draws(self, generator, batch_size):
        """The sample indices and horizontal flips of one resident step:
        without replacement (a slice of a permutation) when batch_size <= n
        <= 4096, else uniform with replacement; each flip with p 0.5."""
        n = next(iter(self._dev_data.values())).shape[0]
        if batch_size <= n <= 4096:
            idx = torch.randperm(n, generator=generator,
                                 device=self.device)[:batch_size]
        else:
            idx = torch.randint(0, n, (batch_size,), generator=generator,
                                device=self.device)
        flip = torch.rand(batch_size, generator=generator,
                          device=self.device) < 0.5
        return idx, flip

    def sample_resident_batch(self, idx, flip):
        """The batch of samples ``idx`` of the resident set, each flipped
        left-right where ``flip``, scaled to min_max: NCHW float32 in
        channels_last memory, as ``feed_data`` gives."""
        lo, hi = self._dev_min_max
        # x / 255 * (hi - lo) + lo as XLA compiles it: one float32 scale
        # and one fused multiply-add
        scale = float(np.float32(1 / 255) * np.float32(hi - lo))
        idx = torch.as_tensor(idx, device=self.device)
        flip = torch.as_tensor(flip, device=self.device).reshape(-1, 1, 1, 1)
        out = {}
        for k, v in self._dev_data.items():
            x = v[idx].float()
            x = torch.full_like(x, lo).add_(x, alpha=scale)
            x = torch.where(flip, x.flip(2), x)
            out[k] = x.permute(0, 3, 1, 2)
        return out

    def optimize_parameters_resident(self, batch_size, k_steps=1):
        """``k_steps`` training steps on batches drawn on the device from the
        resident set (``load_device_dataset`` first), with no host sync; the
        log holds the last loss. Step s draws its batch, then its loss, from
        a generator seeded from (seed, s)."""
        if self._dev_data is None:
            raise RuntimeError("load_device_dataset first")
        g = self._resident_generator
        n_data = 1 if self.mesh is None else self.mesh.data.size
        if batch_size % n_data:
            raise ValueError(f"the resident batch {batch_size} is global; "
                             f"the data axis ({n_data}) must divide it")
        for _ in range(k_steps):
            with span("trainer.step", self.device, step=self.step):
                g.manual_seed(fold_seed(self.seed, self.step))
                idx, flip = self._resident_draws(g, batch_size)
                rows = data_slice(batch_size, self.mesh)
                batch = self.sample_resident_batch(idx[rows], flip[rows])
                if n_data > 1:
                    g.manual_seed(fold_seed(fold_seed(self.seed, self.step),
                                            self.mesh.data.rank))
                self._train_step(batch, g)
        self._resident_batch = batch_size
        self.timer.tick(k_steps)

    def _update_ema(self):
        """EMA of the parameters after the update: a copy before
        ``step_start_ema``, decay after it; the step counted before its
        increment (JAX trainer.py:212-225)."""
        if not self.use_ema:
            return
        ema = list(self.ema.values())
        params = [p.detach() for p in self.netG.parameters()]
        if self.step >= self.step_start_ema:
            torch._foreach_mul_(ema, self.ema_decay)
            torch._foreach_add_(ema, params, alpha=1.0 - self.ema_decay)
        else:
            torch._foreach_copy_(ema, params)

    def get_current_log(self):
        """The log values as floats, each the data-group mean (every rank
        calls it together), and this rank's step timer: ``step_time_ms``
        and ``imgs_per_sec`` of the global batch (the fed batch's rows times
        the data axis, else the resident batch)."""
        logs = {k: data_mean(v, self.mesh) for k, v in self.log_dict.items()}
        if self.data is not None:
            batch = self.data["HR"].shape[0] * (
                1 if self.mesh is None else self.mesh.data.size)
        else:
            batch = self._resident_batch
        logs.update(self.timer.stats(batch))
        return logs

    @property
    def is_primary(self):
        return is_primary(self.mesh)

    # ----------------------------------------------------------- inference

    def _eval_params(self):
        """The network to sample with, in eval mode, holding the current
        weights (the EMA weights when EMA is on). In bf16, or with EMA, it
        is a copy refreshed from those weights on every call (as the JAX
        trainer rebuilds its parameter tree); in bf16 its parameters with
        2+ dimensions (conv and linear weights) are bf16, so a chain step
        reads them at half the bytes, and 1-D parameters (GroupNorm
        scale/shift, biases) stay float32."""
        bf16 = self.netG.dtype == torch.bfloat16
        if not (bf16 or self.use_ema):
            return self.netG.eval()
        # normal tensors even when called under inference_mode, so a later
        # refresh outside it may write them
        with torch.inference_mode(False), torch.no_grad():
            if self._eval_net is None:
                net = copy.deepcopy(self.netG).eval().requires_grad_(False)
                if bf16:
                    for p in net.parameters():
                        if p.dim() >= 2:
                            p.data = p.data.to(torch.bfloat16)
                self._eval_net = net
            src = (self.ema.values() if self.use_ema
                   else (p.detach() for p in self.netG.parameters()))
            for p, s in zip(self._eval_net.parameters(), src):
                p.copy_(s)
        return self._eval_net

    def _chain_fn(self, continuous):
        """(net, condition image or shape, generators) -> reverse-chain
        output, per the configured sampler: ``model.diffusion.sampler``
        'ddpm' (the ancestral chain, default), 'ddim' or 'dpm++' with
        ``sampler_steps`` (alias ``ddim_steps``; default 50 for DDIM, 25 for
        DPM++) and ``eta``."""
        diff_opt = (self.opt.get("model") or {}).get("diffusion") or {}
        sampler = diff_opt.get("sampler") or "ddpm"
        dpmpp = sampler in ("dpm++", "dpmpp")
        steps = int(diff_opt.get("sampler_steps") or diff_opt.get("ddim_steps")
                    or (25 if dpmpp else 50))
        eta = float(diff_opt.get("eta") or 0.0)
        diffusion, sched = self.diffusion, self.sched
        if dpmpp:
            chain = lambda net, x, gens: diffusion.dpmpp_sample_loop(
                net, sched, x, gens, n_steps=steps, eta=eta,
                continuous=continuous)
        elif sampler == "ddim":
            chain = lambda net, x, gens: diffusion.ddim_sample_loop(
                net, sched, x, gens, n_steps=steps, eta=eta,
                continuous=continuous)
        elif sampler == "ddpm":
            chain = lambda net, x, gens: diffusion.p_sample_loop(
                net, sched, x, gens, continuous=continuous)
        else:
            raise ValueError(f"model.diffusion.sampler must be 'ddpm', "
                             f"'ddim' or 'dpm++', got {sampler!r}")
        return chain

    def _run_chain(self, x_or_shape, generators, continous):
        """The configured chain on the bf16 / EMA sampling network; host
        numpy (G,h,w,c), or (G,S,h,w,c) process frames."""
        chain = self._chain_fn(bool(continous))
        net = self._eval_params()
        with torch.inference_mode():
            out = chain(net, x_or_shape, generators)
        g = len(generators)
        if continous:
            out = out.reshape(-1, g, *out.shape[1:]).permute(1, 0, 3, 4, 2)
        else:
            out = out.permute(0, 2, 3, 1)
        return out.float().cpu().numpy()

    def test_batched(self, xs, generators, continous=False, labels=None):
        """Conditional SR over a group of images with per-image generators.

        xs: (G,h,w,c) numpy condition images (for the adm network the
        low-resolution images, with ``labels`` (G,) their class labels).
        Returns numpy (G,h,w,c), or (G,S,h,w,c) process frames when
        ``continous``."""
        x = torch.as_tensor(np.asarray(xs, np.float32)).permute(0, 3, 1, 2)
        x = x.to(self.device).contiguous(memory_format=torch.channels_last)
        if self.diffusion.cond_mode == "adm":
            y = None if labels is None else torch.as_tensor(
                np.asarray(labels), dtype=torch.long, device=self.device)
            x = SRCondition(x, y)
        elif labels is not None:
            raise ValueError("class labels are taken by the adm network only")
        return self._run_chain(x, generators, continous)

    def sample_batched(self, generators, continous=False):
        """Unconditional generation of one image per generator; returns as
        ``test_batched``."""
        d = self.diffusion
        shape = (len(generators), d.channels, d.image_size, d.image_size)
        return self._run_chain(shape, generators, continous)

    def print_network(self):
        logger.info("Network G structure: UNet(cond_mode=%s), with "
                    "parameters: %s", self.diffusion.cond_mode,
                    "{:,d}".format(count_params(self.netG)))

    # ---------------------------------------------------------- checkpoints

    def save_network(self, epoch, iter_step):
        """``I{iter}_E{epoch}_gen.pth``: the UNet state_dict under the
        reference names; ``..._opt.pth``: epoch, iter, the optimizer state
        and, with EMA on, the EMA weights (reference model/model.py:124-144).
        """
        prefix = os.path.join(self.opt["path"]["checkpoint"],
                              f"I{iter_step}_E{epoch}")
        gen_path = f"{prefix}_gen.pth"
        # whole tensors (collectives over the model axis on every rank)
        gen = {k: v.detach().cpu()
               for k, v in tp.full_state_dict(self.netG).items()}
        optim = None if self.optimizer is None else self._full_optimizer()
        ema = None
        if self.use_ema:
            axis = tp.model_axis(self.netG)
            ema = self.ema if axis is None else tp.full_tensors(
                list(self.ema.values()), list(self.ema),
                tp.sharded_names(self.netG), axis)
            ema = {k: v.cpu() for k, v in ema.items()}
        if self.is_primary:
            torch.save(gen, gen_path)
            state = {"epoch": epoch, "iter": iter_step, "scheduler": None,
                     "optimizer": optim}
            if ema is not None:
                state["ema"] = ema
            torch.save(state, f"{prefix}_opt.pth")
            logger.info("Saved model in [%s] ...", gen_path)
        barrier(self.mesh)

    def _map_moments(self, sd, fn):
        """The optimizer state dict ``sd`` with ``fn(tensor, model axis)``
        applied to each moment of a parameter sharded over the model axis
        (new per-parameter dicts: the optimizer's own stay untouched)."""
        axis = tp.model_axis(self.netG)
        if axis is None:
            return sd
        sharded = tp.sharded_names(self.netG)
        sd["state"] = {
            i: {k: fn(v, axis) if self._opt_names[i] in sharded
                and torch.is_tensor(v) and v.dim() > 0 else v
                for k, v in st.items()}
            for i, st in sd["state"].items()}
        return sd

    def _full_optimizer(self):
        """The optimizer's state dict with the sharded moments gathered
        whole (a collective over the model axis)."""
        return self._map_moments(self.optimizer.state_dict(),
                                 tp.gather_dim0)

    def _load_optimizer(self, sd):
        """Load a whole optimizer state dict, cut to this rank's slices."""
        self.optimizer.load_state_dict(self._map_moments(sd, tp.slice_dim0))

    def load_network(self):
        """Resume from the ``path.resume_state`` prefix: its ``_gen.pth``,
        and its ``_opt.pth`` when present: in the train phase the optimizer,
        EMA, step and epoch counters; in any phase the EMA weights when EMA
        is on, so sampling from a resume uses them, as the JAX package
        restores its EMA parameters in every phase."""
        load_path = (self.opt.get("path") or {}).get("resume_state")
        if not load_path:
            return
        gen_path = os.path.abspath(f"{load_path}_gen.pth")
        logger.info("Loading pretrained model for G [%s] ...", gen_path)
        sd = torch.load(gen_path, map_location="cpu", weights_only=True)
        tp.load_full_state_dict(self.netG, strip_reference_keys(sd))
        ema = None
        opt_path = os.path.abspath(f"{load_path}_opt.pth")
        train = self.phase == "train"
        if (train or self.use_ema) and os.path.exists(opt_path):
            state = torch.load(opt_path, map_location=self.device,
                               weights_only=True)
            if train:
                self.begin_step = self.step = int(state["iter"])
                self.begin_epoch = int(state["epoch"])
                if self.optimizer is not None and state.get("optimizer"):
                    self._load_optimizer(state["optimizer"])
            ema = state.get("ema")
        if self.use_ema:
            if ema is not None:
                ema = tp.slice_full(ema, self.netG)
            with torch.no_grad():
                for name, p in self.netG.named_parameters():
                    self.ema[name].copy_(p if ema is None else ema[name])


def create_model(opt, device=None, mesh=None) -> Trainer:
    m = Trainer(opt, device=device, mesh=mesh)
    logger.info("Model [%s] is created.", m.__class__.__name__)
    return m
