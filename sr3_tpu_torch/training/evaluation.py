"""Grouped inference over a stream of images.

Counterpart of ``sr3_tpu/training/evaluation.py``: ``per_image``,
``GroupedEvaluator`` (``run_sr``, ``run_uncond``), ``_group_size``, the SR
loops ``validate_in_train``, ``evaluate_sr`` and ``infer_sr``, and the
unconditional ones ``sample_in_train`` and ``evaluate_uncond``.
Images run ``G`` at a time through one batched reverse chain (the sampler
that the config picks, ``Trainer._chain_fn``). Each image's
whole noise stream comes from its own ``torch.Generator`` seeded from
(base seed, global image index) -- the role ``fold_in`` plays in the JAX
package -- so results do not depend on the group size.

On a mesh (``Trainer.mesh``) each group is split over the data axis: the
group is rounded up to a multiple of the data size, each rank runs its
slice with its images' own generators, and the outputs are gathered
(``host_fetch``) and yielded in order on every rank, so sharded serving
gives one process's images. Only the primary rank writes PNGs and metrics
and feeds TensorBoard and W&B, as the JAX evaluators do.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

import sr3_tpu_torch.utils.metrics as Metrics
from sr3_tpu_torch.parallel.mesh import data_slice, host_fetch, is_primary

logger = logging.getLogger("base")


def per_image(dataset):
    """The items of a map-style dataset in order, batch 1 (as the val
    loader yields them)."""
    for i in range(len(dataset)):
        yield dataset[i]


def fold_seed(base_seed, index):
    """64-bit generator seed of stream ``index`` under ``base_seed`` (an
    image of a group, a training step): the role ``jax.random.fold_in``
    plays in the JAX package."""
    return int(np.random.SeedSequence([base_seed, index])
               .generate_state(1, np.uint64)[0])


class GroupedEvaluator:
    """Runs reverse chains for a stream of images in fixed-size groups."""

    def __init__(self, trainer, group_size=None, base_seed=None):
        self.trainer = trainer
        self.mesh = getattr(trainer, "mesh", None)
        n_data = 1 if self.mesh is None else self.mesh.data.size
        group = max(1, int(group_size or 0))
        self.group = -(-group // n_data) * n_data
        if base_seed is None:
            base_seed = int(trainer.rng.integers(2 ** 62))
        self.base_seed = base_seed

    def _generators(self, idx0):
        dev = self.trainer.device
        return [torch.Generator(device=dev).manual_seed(
                    fold_seed(self.base_seed, idx0 + j))
                for j in range(self.group)]

    def run_sr(self, items, continous=False):
        """items: per-image dicts with 'SR' (the bicubic-up condition, HWC).
        Yields (item, sr_out) in order; sr_out is (h,w,c), or the process
        frames (S,h,w,c) when ``continous``."""
        buf, idx0 = [], 0
        for item in items:
            buf.append(item)
            if len(buf) < self.group:
                continue
            yield from self._flush_sr(buf, idx0, continous)
            idx0 += self.group
            buf = []
        if buf:
            yield from self._flush_sr(buf, idx0, continous)

    def _flush_sr(self, buf, idx0, continous):
        pad = self.group - len(buf)
        xs = np.stack([it["SR"] for it in buf] + [buf[-1]["SR"]] * pad)
        part = data_slice(self.group, self.mesh)
        out = self.trainer.test_batched(xs[part],
                                        self._generators(idx0)[part],
                                        continous)
        out = host_fetch(out, self.mesh)
        for j, it in enumerate(buf):
            yield it, out[j]

    def run_uncond(self, n, continous=False):
        """Yield n unconditional samples in order, (h,w,c) or the process
        frames (S,h,w,c) when ``continous``; sample i draws from its own
        generator, as image i does in ``run_sr``."""
        done = 0
        part = data_slice(self.group, self.mesh)
        while done < n:
            out = self.trainer.sample_batched(self._generators(done)[part],
                                              continous)
            out = host_fetch(out, self.mesh)
            yield from out[:min(self.group, n - done)]
            done += self.group


def _writer(trainer):
    """``Metrics.save_img`` on the primary rank, a no-op on the others."""
    if is_primary(getattr(trainer, "mesh", None)):
        return Metrics.save_img
    return lambda *args, **kwargs: None


def _group_size(opt, n_items=None):
    """datasets.val.batch_size if set; else min(8, n_items), or 1 at output
    resolutions of 256 and up."""
    try:
        val_opt = opt["datasets"]["val"] or {}
    except (KeyError, TypeError):
        val_opt = {}
    g = val_opt.get("batch_size")
    if g:
        return g
    if int(val_opt.get("r_resolution") or 0) >= 256:
        return 1
    return min(8, n_items) if n_items else 8


def evaluate_sr(trainer, val_set, opt, current_step, current_epoch,
                wandb_logger=None):
    """Full SR evaluation (reference sr.py:175-241): full-schedule chains
    with process frames; per image the process grid and sr / hr / lr / inf
    PNGs; average PSNR and SSIM. Returns (avg_psnr, avg_ssim)."""
    result_path = opt["path"]["results"]
    save_img = _writer(trainer)
    if is_primary(getattr(trainer, "mesh", None)):
        os.makedirs(result_path, exist_ok=True)
    log_eval = bool(wandb_logger and opt["log_eval"])

    ev = GroupedEvaluator(trainer, _group_size(opt, len(val_set)))
    avg_psnr, avg_ssim, idx = 0.0, 0.0, 0
    for item, frames in ev.run_sr(per_image(val_set), continous=True):
        idx += 1
        hr_img = Metrics.tensor2img(item["HR"])
        lr_img = Metrics.tensor2img(item["LR"])
        fake_img = Metrics.tensor2img(item["SR"])
        sr_img = Metrics.tensor2img(frames[-1])
        save_img(Metrics.tensor2img(frames),
                         f"{result_path}/{current_step}_{idx}_sr_process.png")
        for img, tag in ((sr_img, "sr"), (hr_img, "hr"), (lr_img, "lr"),
                         (fake_img, "inf")):
            save_img(img,
                             f"{result_path}/{current_step}_{idx}_{tag}.png")
        eval_psnr = Metrics.calculate_psnr(sr_img, hr_img)
        eval_ssim = Metrics.calculate_ssim(sr_img, hr_img)
        avg_psnr += eval_psnr
        avg_ssim += eval_ssim
        if log_eval:
            wandb_logger.log_eval_data(fake_img, sr_img, hr_img, eval_psnr,
                                       eval_ssim)
    if idx == 0:
        logger.warning("Evaluation produced 0 images (empty val set at %s?).",
                       opt["datasets"]["val"]["dataroot"])
        return float("nan"), float("nan")
    avg_psnr /= idx
    avg_ssim /= idx
    logger.info("# Validation # PSNR: {:.4e}".format(avg_psnr))
    logger.info("# Validation # SSIM: {:.4e}".format(avg_ssim))
    logging.getLogger("val").info(
        "<epoch:{:3d}, iter:{:8,d}> psnr: {:.4e}, ssim: {:.4e}".format(
            current_epoch, current_step, avg_psnr, avg_ssim))
    if wandb_logger:
        if log_eval:
            wandb_logger.log_eval_table()
        wandb_logger.log_metrics({"PSNR": float(avg_psnr),
                                  "SSIM": float(avg_ssim)})
    return avg_psnr, avg_ssim


def infer_sr(trainer, dataset, opt, wandb_logger=None):
    """Inference over a prepared directory: process-grid / sr / hr / inf
    PNGs per image, no metrics."""
    result_path = opt["path"]["results"]
    save_img = _writer(trainer)
    if is_primary(getattr(trainer, "mesh", None)):
        os.makedirs(result_path, exist_ok=True)
    log_infer = bool(wandb_logger and opt["log_infer"])

    ev = GroupedEvaluator(trainer, _group_size(opt, len(dataset)))
    idx = 0
    for item, frames in ev.run_sr(per_image(dataset), continous=True):
        idx += 1
        hr_img = Metrics.tensor2img(item["HR"])
        fake_img = Metrics.tensor2img(item["SR"])
        sr_img = Metrics.tensor2img(frames[-1])
        save_img(Metrics.tensor2img(frames),
                         f"{result_path}/0_{idx}_sr_process.png")
        save_img(sr_img, f"{result_path}/0_{idx}_sr.png")
        save_img(hr_img, f"{result_path}/0_{idx}_hr.png")
        save_img(fake_img, f"{result_path}/0_{idx}_inf.png")
        if log_infer:
            wandb_logger.log_eval_data(fake_img, sr_img, hr_img)
    if log_infer:
        wandb_logger.log_eval_table(commit=True)
    logger.info("Inference wrote %d images to %s", idx, result_path)


def validate_in_train(trainer, val_set, opt, current_step, current_epoch,
                      tb_logger=None, wandb_logger=None):
    """In-training validation (reference sr.py:103-154): val-schedule SR
    over the val set, per-image hr/sr/lr/inf PNGs and TB/W&B panels; returns
    the average PSNR. Switches the schedule train -> val -> train."""
    result_path = os.path.join(opt["path"]["results"], str(current_epoch))
    save_img = _writer(trainer)
    if is_primary(getattr(trainer, "mesh", None)):
        os.makedirs(result_path, exist_ok=True)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"],
                                   schedule_phase="val")
    ev = GroupedEvaluator(trainer, _group_size(opt, len(val_set)))
    avg_psnr, idx = 0.0, 0
    for item, sr in ev.run_sr(per_image(val_set), continous=False):
        idx += 1
        sr_img = Metrics.tensor2img(sr)
        hr_img = Metrics.tensor2img(item["HR"])
        lr_img = Metrics.tensor2img(item["LR"])
        fake_img = Metrics.tensor2img(item["SR"])
        for img, tag in ((hr_img, "hr"), (sr_img, "sr"), (lr_img, "lr"),
                         (fake_img, "inf")):
            save_img(img,
                             f"{result_path}/{current_step}_{idx}_{tag}.png")
        panel = np.concatenate((fake_img, sr_img, hr_img), axis=1)
        if tb_logger:
            tb_logger.add_image(f"Iter_{current_step}",
                                np.transpose(panel, [2, 0, 1]), idx)
        if wandb_logger:
            wandb_logger.log_image(f"validation_{idx}", panel)
        avg_psnr += Metrics.calculate_psnr(sr_img, hr_img)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"],
                                   schedule_phase="train")
    if idx == 0:
        # an empty val set must not end a training run with ZeroDivisionError
        logger.warning("Validation produced 0 images (empty val set at %s?) "
                       "— skipping PSNR.", opt["datasets"]["val"]["dataroot"])
        return float("nan")
    avg_psnr /= idx
    logger.info("# Validation # PSNR: {:.4e}".format(avg_psnr))
    logging.getLogger("val").info(
        "<epoch:{:3d}, iter:{:8,d}> psnr: {:.4e}".format(
            current_epoch, current_step, avg_psnr))
    if tb_logger:
        tb_logger.add_scalar("psnr", avg_psnr, current_step)
    return avg_psnr


# ------------------------------------------------------------ unconditional


def sample_in_train(trainer, sample_sum, opt, current_step, current_epoch,
                    wandb_logger=None):
    """In-training unconditional sampling (reference sample.py:100-128):
    ``sample_sum`` val-schedule samples, one PNG each. Switches the schedule
    train -> val -> train."""
    result_path = os.path.join(opt["path"]["results"], str(current_epoch))
    save_img = _writer(trainer)
    if is_primary(getattr(trainer, "mesh", None)):
        os.makedirs(result_path, exist_ok=True)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"],
                                   schedule_phase="val")
    ev = GroupedEvaluator(trainer, _group_size(opt, sample_sum))
    for i, sample in enumerate(ev.run_uncond(sample_sum, continous=False)):
        img = Metrics.tensor2img(sample)
        save_img(img, f"{result_path}/{current_step}_{i + 1}_sample.png")
        if wandb_logger:
            wandb_logger.log_image(f"sample_{i + 1}", img)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"],
                                   schedule_phase="train")


def evaluate_uncond(trainer, sample_sum, opt, current_step,
                    wandb_logger=None):
    """Unconditional eval phase (reference sample.py:132-162): the process
    grid and the final sample of each of ``sample_sum`` draws."""
    result_path = opt["path"]["results"]
    save_img = _writer(trainer)
    if is_primary(getattr(trainer, "mesh", None)):
        os.makedirs(result_path, exist_ok=True)
    ev = GroupedEvaluator(trainer, _group_size(opt, sample_sum))
    for i, frames in enumerate(ev.run_uncond(sample_sum, continous=True)):
        final = Metrics.tensor2img(frames[-1])
        save_img(
            Metrics.tensor2img(frames),
            f"{result_path}/{current_step}_{i + 1}_sample_process.png")
        save_img(final,
                         f"{result_path}/{current_step}_{i + 1}_sample.png")
        if wandb_logger:
            wandb_logger.log_image(f"sample_{i + 1}", final)
