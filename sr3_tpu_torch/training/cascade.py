"""Chained multi-stage generation (the SR3 paper's cascade).

Counterpart of ``sr3_tpu/training/cascade.py``. ``run_cascade`` chains any
number of stages in one process: stage 1 generates seeds unconditionally or
super-resolves given inputs, and each following conditional stage takes the
previous stage's outputs, resized up to its image_size with the offline
prep tool's bicubic resize through the uint8 PNG domain (``to_condition``,
``data/prepare.py``), so a chained stage sees the conditioning it was
trained on. Each stage runs as one ``GroupedEvaluator`` (group size
``datasets.val.batch_size``, ``_group_size``) and is freed, with its device
memory, before the next stage is built. Pillow is imported only to read
input images (``load_input_images``) and, through ``Metrics.save_img``, to
write PNGs when an output directory is given.
"""

from __future__ import annotations

import gc
import logging
import os

import numpy as np
import torch

import sr3_tpu_torch.utils.metrics as Metrics
from sr3_tpu_torch.data.prepare import BICUBIC, resize_and_convert
from sr3_tpu_torch.parallel.mesh import is_primary
from sr3_tpu_torch.training.evaluation import GroupedEvaluator, _group_size

logger = logging.getLogger("base")


def to_condition(img, size):
    """[-1,1] float (h,w,c) -> [-1,1] float32 (size,size,c): to uint8 as a
    PNG holds it, the bicubic resize, back to [-1,1]."""
    arr = Metrics.tensor2img(np.asarray(img), min_max=(-1, 1))
    arr = resize_and_convert(arr, size, BICUBIC)
    return np.asarray(arr).astype(np.float32) / 127.5 - 1.0


def load_input_images(path):
    """Read a directory of images as [-1,1] float arrays (sorted order)."""
    from PIL import Image

    exts = (".png", ".jpg", ".jpeg", ".bmp")
    files = sorted(f for f in os.listdir(path) if f.lower().endswith(exts))
    if not files:
        raise ValueError(f"no images found in {path!r}")
    out = []
    for f in files:
        arr = np.asarray(Image.open(os.path.join(path, f)).convert("RGB"))
        out.append(arr.astype(np.float32) / 127.5 - 1.0)
    return out


def run_stage(opt, images=None, n_samples=None, mesh=None):
    """Run one cascade stage; returns the stage outputs as [-1,1] floats.

    opt: parsed config (phase 'val', path.resume_state the stage's weights).
    images: previous-stage outputs for a conditional stage; n_samples: the
    count for an unconditional seed stage. mesh: the ranks' mesh
    (``parallel/mesh.py``), whose data axis splits each group."""
    from sr3_tpu_torch.training.trainer import create_model

    conditional = opt["model"]["diffusion"]["conditional"]
    if not conditional and images is None and n_samples is None:
        raise ValueError(
            "unconditional stage '%s' needs n_samples" % opt.get("name"))
    if conditional and images is None:
        raise ValueError(
            "conditional stage '%s' needs input images (previous stage "
            "outputs or -i dir)" % opt.get("name"))
    if not (opt.get("path") or {}).get("resume_state"):
        logger.warning(
            "Cascade stage '%s' has no path.resume_state — sampling from "
            "RANDOMLY INITIALIZED weights (outputs will be noise; fine for "
            "smoke tests, wrong for real generation).", opt.get("name"))
    trainer = create_model(opt, mesh=mesh)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"],
                                   schedule_phase="val")
    size = int(opt["model"]["diffusion"]["image_size"])
    n = n_samples if images is None else len(images)
    ev = GroupedEvaluator(trainer, _group_size(opt, n))
    if conditional:
        items = ({"SR": to_condition(img, size)} for img in images)
        outs = [np.asarray(sr) for _, sr in ev.run_sr(items, continous=False)]
    else:
        outs = [np.asarray(s)
                for s in ev.run_uncond(int(n_samples), continous=False)]
    # free the stage's model before the next stage is built
    on_cuda = trainer.device.type == "cuda"
    del ev, trainer
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    return outs


def run_cascade(opts, n_samples=None, input_images=None, out_dir=None,
                save_stages=True, mesh=None):
    """Chain the stages in ``opts``. Returns the final image list.

    Writes per-stage PNGs to out_dir ({stage}_{idx}_{res}.png; the last
    stage also as final_{idx}.png) when out_dir is set, on the primary rank
    of ``mesh``."""
    if not is_primary(mesh):
        out_dir = None
    if input_images is not None and opts and not (
            opts[0]["model"]["diffusion"]["conditional"]):
        raise ValueError(
            "input images were provided but the first stage '%s' is "
            "unconditional and would ignore them — drop -i, or start the "
            "cascade with a conditional stage" % opts[0].get("name"))
    images = input_images
    for k, opt in enumerate(opts):
        conditional = opt["model"]["diffusion"]["conditional"]
        size = opt["model"]["diffusion"]["image_size"]
        logger.info("Cascade stage %d/%d: %s -> %d^2 (%s)", k + 1, len(opts),
                    opt.get("name"), size,
                    "conditional" if conditional else "unconditional")
        images = run_stage(opt, images=images if conditional else None,
                           n_samples=n_samples, mesh=mesh)
        if out_dir and (save_stages or k == len(opts) - 1):
            os.makedirs(out_dir, exist_ok=True)
            for i, img in enumerate(images):
                Metrics.save_img(
                    Metrics.tensor2img(img, min_max=(-1, 1)),
                    os.path.join(out_dir, f"{k + 1}_{i + 1}_{size}.png"))
    if out_dir:
        for i, img in enumerate(images):
            Metrics.save_img(Metrics.tensor2img(img, min_max=(-1, 1)),
                             os.path.join(out_dir, f"final_{i + 1}.png"))
    return images
