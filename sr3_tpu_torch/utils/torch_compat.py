"""Weights into the port: JAX parameters and reference ``_gen.pth`` files.

Both go through the reference state_dict names that
``sr3_tpu.utils.torch_compat.build_key_map`` enumerates (numpy-only host code
of the JAX package, imported rather than copied) and end in
``load_state_dict(strict=True)``. The schedule is recomputed from the config
(``models/schedule.py``), so schedule buffers in a checkpoint are dropped.
"""

from __future__ import annotations

import torch

from sr3_tpu.utils.torch_compat import (_SCHEDULE_BUFFERS,
                                        flax_params_to_torch_state_dict)


def unet_key_config(unet):
    """build_key_map keyword arguments describing a port UNet."""
    return dict(
        in_channel=unet.in_channel, inner_channel=unet.inner_channel,
        channel_mults=unet.channel_mults, attn_res=unet.attn_res,
        res_blocks=unet.res_blocks, image_size=unet.image_size,
        cond_mode="sr3",
    )


def strip_reference_keys(state_dict):
    """Drop the ``module.`` / ``denoise_fn.`` prefixes, the schedule
    buffers and ``inv_freq`` of a reference GaussianDiffusion state_dict."""
    out = {}
    for k, v in state_dict.items():
        for prefix in ("module.", "denoise_fn."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if k.split(".")[0] in _SCHEDULE_BUFFERS or k.endswith("inv_freq"):
            continue
        out[k] = v
    return out


def load_flax_params(model, params):
    """Load JAX UNet parameters ({'params': tree} of arrays) into ``model``."""
    sd = flax_params_to_torch_state_dict(params, **unet_key_config(model))
    sd = {k: torch.from_numpy(v) for k, v in strip_reference_keys(sd).items()}
    model.load_state_dict(sd, strict=True)
    return model


def load_gen_pth(model, path):
    """Load a reference-format ``*_gen.pth`` (as tools/export_torch_checkpoint
    writes it) into ``model``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(strip_reference_keys(sd), strict=True)
    return model
