"""Trainer, inference subset: model, schedules, weights, batched sampling.

Counterpart of ``sr3_tpu/training/trainer.py`` for the serving path:
``create_model``, ``set_new_noise_schedule``, ``load_network`` (from a
reference-format ``{resume_state}_gen.pth``), the bf16 pre-cast of the
parameters with two or more dimensions for sampling (``_eval_params``), and
``test_batched``. The training step, optimizer, EMA and checkpoint saving
are not ported yet.
"""

from __future__ import annotations

import copy
import logging
import os

import numpy as np
import torch

from sr3_tpu_torch.models.networks import count_params, define_G
from sr3_tpu_torch.models.schedule import make_schedule
from sr3_tpu_torch.utils.runtime import resolve_device
from sr3_tpu_torch.utils.torch_compat import load_gen_pth

logger = logging.getLogger("base")


class Trainer:
    """Owns the diffusion model, its device, schedules and host RNG."""

    def __init__(self, opt, device=None):
        self.opt = opt
        self.device = torch.device(device) if device is not None \
            else resolve_device()
        seed = opt.get("seed", 0) or 0
        self.diffusion = define_G(opt, device=self.device, seed=seed)
        self.netG = self.diffusion.denoise_fn
        # host RNG: the evaluator draws its base seed from it, as the JAX
        # trainer splits its key
        self.rng = np.random.default_rng(seed)
        self.schedules = {}
        self.schedule_phase = None
        self.sched = None
        self._eval_net = None
        self.load_network()

    def set_new_noise_schedule(self, schedule_opt, schedule_phase="train"):
        if self.schedule_phase != schedule_phase:
            self.schedule_phase = schedule_phase
            key = repr(sorted(dict(schedule_opt).items()))
            if key not in self.schedules:
                self.schedules[key] = make_schedule(schedule_opt, self.device)
            self.sched = self.schedules[key]

    def load_network(self):
        """Load ``{path.resume_state}_gen.pth`` when a resume_state is set."""
        load_path = (self.opt.get("path") or {}).get("resume_state")
        if not load_path:
            return
        gen_path = os.path.abspath(f"{load_path}_gen.pth")
        logger.info("Loading pretrained model for G [%s] ...", gen_path)
        load_gen_pth(self.netG, gen_path)
        self._eval_net = None

    def _eval_params(self):
        """The network to sample with. In bf16 it is a copy whose parameters
        with 2+ dimensions (conv and linear weights) are pre-cast to bf16
        once, so a chain step reads them at half the bytes; 1-D parameters
        (GroupNorm scale/shift, biases) stay float32."""
        if self.netG.dtype != torch.bfloat16:
            return self.netG
        if self._eval_net is None:
            net = copy.deepcopy(self.netG)
            for p in net.parameters():
                if p.dim() >= 2:
                    p.data = p.data.to(torch.bfloat16)
            self._eval_net = net.eval()
        return self._eval_net

    def test_batched(self, xs, generators, continous=False):
        """Conditional SR over a group of images with per-image generators.

        xs: (G,h,w,c) numpy condition images. Returns numpy (G,h,w,c), or
        (G,S,h,w,c) process frames when ``continous``."""
        x = torch.as_tensor(np.asarray(xs, np.float32)).permute(0, 3, 1, 2)
        x = x.to(self.device).contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            out = self.diffusion.p_sample_loop(
                self._eval_params(), self.sched, x, generators,
                continuous=bool(continous))
        g = x.shape[0]
        if continous:
            out = out.reshape(-1, g, *out.shape[1:]).permute(1, 0, 3, 4, 2)
        else:
            out = out.permute(0, 2, 3, 1)
        return out.float().cpu().numpy()

    def print_network(self):
        logger.info("Network G structure: UNet(cond_mode=sr3), with "
                    "parameters: %s", "{:,d}".format(count_params(self.netG)))


def create_model(opt, device=None) -> Trainer:
    m = Trainer(opt, device=device)
    logger.info("Model [%s] is created.", m.__class__.__name__)
    return m
