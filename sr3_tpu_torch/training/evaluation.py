"""Grouped inference over a stream of images.

Counterpart of ``sr3_tpu/training/evaluation.py`` for the serving path and
in-training validation (``per_image``, ``GroupedEvaluator.run_sr``,
``_group_size``, ``infer_sr``, ``validate_in_train``).
Images run ``G`` at a time through one batched reverse chain. Each image's
whole noise stream comes from its own ``torch.Generator`` seeded from
(base seed, global image index) -- the role ``fold_in`` plays in the JAX
package -- so results do not depend on the group size.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

import sr3_tpu_torch.utils.metrics as Metrics

logger = logging.getLogger("base")


def per_image(dataset):
    """The items of a map-style dataset in order, batch 1 (as the val
    loader yields them)."""
    for i in range(len(dataset)):
        yield dataset[i]


def image_seed(base_seed, index):
    """64-bit generator seed of one image, from (base seed, image index)."""
    return int(np.random.SeedSequence([base_seed, index])
               .generate_state(1, np.uint64)[0])


class GroupedEvaluator:
    """Runs reverse chains for a stream of images in fixed-size groups."""

    def __init__(self, trainer, group_size=None, base_seed=None):
        self.trainer = trainer
        self.group = max(1, int(group_size or 0))
        if base_seed is None:
            base_seed = int(trainer.rng.integers(2 ** 62))
        self.base_seed = base_seed

    def _generators(self, idx0):
        dev = self.trainer.device
        return [torch.Generator(device=dev).manual_seed(
                    image_seed(self.base_seed, idx0 + j))
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
        out = self.trainer.test_batched(xs, self._generators(idx0), continous)
        for j, it in enumerate(buf):
            yield it, out[j]


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


def infer_sr(trainer, dataset, opt, wandb_logger=None):
    """Inference over a prepared directory: process-grid / sr / hr / inf
    PNGs per image, no metrics."""
    result_path = opt["path"]["results"]
    os.makedirs(result_path, exist_ok=True)
    log_infer = bool(wandb_logger and opt["log_infer"])

    ev = GroupedEvaluator(trainer, _group_size(opt, len(dataset)))
    idx = 0
    for item, frames in ev.run_sr(per_image(dataset), continous=True):
        idx += 1
        hr_img = Metrics.tensor2img(item["HR"])
        fake_img = Metrics.tensor2img(item["SR"])
        sr_img = Metrics.tensor2img(frames[-1])
        Metrics.save_img(Metrics.tensor2img(frames),
                         f"{result_path}/0_{idx}_sr_process.png")
        Metrics.save_img(sr_img, f"{result_path}/0_{idx}_sr.png")
        Metrics.save_img(hr_img, f"{result_path}/0_{idx}_hr.png")
        Metrics.save_img(fake_img, f"{result_path}/0_{idx}_inf.png")
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
            Metrics.save_img(img,
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
