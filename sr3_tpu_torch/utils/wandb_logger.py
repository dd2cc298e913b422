"""Weights & Biases sink of the port's entry points (optional).

The port's own copy of the JAX package's ``WandbLogger``
(``sr3_tpu/utils/wandb_logger.py``): the same constructor, options and
method names. A checkpoint artifact holds the step's
``I{iter}_E{epoch}_{gen,opt}.pth`` files. ``wandb`` is imported when a
logger is made; the entry points make one only under ``-enable_wandb``.
"""

from __future__ import annotations

import os

# table schemas: kind -> (config gate, column names; image columns first)
_TABLE_SPECS = {
    "eval": ("log_eval", ("fake_image", "sr_image", "hr_image",
                          "psnr", "ssim")),
    "infer": ("log_infer", ("fake_image", "sr_image", "hr_image")),
}


class WandbLogger:
    def __init__(self, opt):
        try:
            import wandb
        except ImportError as e:
            raise ImportError(
                "wandb is not installed; run without -enable_wandb") from e
        self._wandb = wandb
        if wandb.run is None:
            wandb.init(project=opt["wandb"]["project"], config=dict(opt),
                       dir="./experiments")
        self.config = wandb.config
        self._tables = {
            kind: wandb.Table(columns=list(cols))
            for kind, (gate, cols) in _TABLE_SPECS.items()
            if self.config.get(gate, None)
        }

    def _img(self, x):
        return self._wandb.Image(x)

    def log_metrics(self, metrics, commit=True):
        self._wandb.log(metrics, commit=commit)

    def log_image(self, key_name, image_array):
        self._wandb.log({key_name: self._img(image_array)})

    def log_images(self, key_name, list_images):
        self._wandb.log({key_name: [self._img(x) for x in list_images]})

    def log_eval_data(self, fake_img, sr_img, hr_img, psnr=None, ssim=None):
        """A row of the eval table (with metrics) or the infer table
        (without)."""
        imgs = [self._img(x) for x in (fake_img, sr_img, hr_img)]
        if psnr is not None and ssim is not None:
            self._tables["eval"].add_data(*imgs, psnr, ssim)
        else:
            self._tables["infer"].add_data(*imgs)

    def log_eval_table(self, commit=False):
        for kind in ("eval", "infer"):
            t = self._tables.get(kind)
            if t is not None:
                self._wandb.log({f"{kind}_data": t}, commit=commit)
                return

    def log_checkpoint(self, current_epoch, current_step):
        """The step's checkpoint files as one W&B model artifact."""
        art = self._wandb.Artifact(
            self._wandb.run.id + "_model", type="model",
            metadata={"epoch": current_epoch, "iter": current_step})
        ckpt_dir = self.config["path"]["checkpoint"]
        prefix = f"I{current_step}_E{current_epoch}"
        for name in os.listdir(ckpt_dir):
            if not name.startswith(prefix):
                continue
            full = os.path.join(ckpt_dir, name)
            if os.path.isdir(full):
                art.add_dir(full, name=name)
            else:
                art.add_file(full)
        self._wandb.log_artifact(art, aliases=["latest"])
