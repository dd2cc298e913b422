"""Weights into the port: JAX parameters and reference ``_gen.pth`` files.

Both go through the reference state_dict names that ``build_key_map``
enumerates and end in ``load_state_dict(strict=True)``. ``build_key_map`` and
``flax_params_to_torch_state_dict`` are the port's own copies of the JAX
package's (``sr3_tpu/utils/torch_compat.py``): they replay the reference
UNet's construction loop to pair every flax parameter path with its torch
name. The schedule is recomputed from the config (``models/schedule.py``),
so schedule buffers in a checkpoint are dropped and none are emitted.
"""

from __future__ import annotations

import numpy as np
import torch


def _conv(flax_path, torch_prefix, bias=True):
    out = [(flax_path + ("kernel",), torch_prefix + ".weight", "conv_w")]
    if bias:
        out.append((flax_path + ("bias",), torch_prefix + ".bias", "copy"))
    return out


def _linear(flax_path, torch_prefix):
    return [
        (flax_path + ("kernel",), torch_prefix + ".weight", "linear_w"),
        (flax_path + ("bias",), torch_prefix + ".bias", "copy"),
    ]


def _gn(flax_path, torch_prefix):
    return [
        (flax_path + ("scale",), torch_prefix + ".weight", "copy"),
        (flax_path + ("bias",), torch_prefix + ".bias", "copy"),
    ]


def _resnet_block(flax_path, torch_prefix, cond_mode, has_res_conv):
    """ResnetBlock: block1/block2 (Sequential GN,Swish,Dropout,Conv -- conv
    at index 3), conditioning projection, optional res_conv."""
    m = []
    for blk in ("block1", "block2"):
        m += _gn(flax_path + (blk, "norm"), f"{torch_prefix}.{blk}.block.0")
        m += _conv(flax_path + (blk, "conv"), f"{torch_prefix}.{blk}.block.3")
    if cond_mode == "ddpm":
        # mlp = Sequential(Swish, Linear)
        m += _linear(flax_path + ("cond_proj",), f"{torch_prefix}.mlp.1")
    else:
        # noise_func = FeatureWiseAffine(Sequential(Linear))
        m += _linear(flax_path + ("cond_proj",),
                     f"{torch_prefix}.noise_func.noise_func.0")
    if has_res_conv:
        m += _conv(flax_path + ("res_conv",), f"{torch_prefix}.res_conv")
    return m


def _attn(flax_path, torch_prefix):
    m = _gn(flax_path + ("norm",), f"{torch_prefix}.norm")
    m += _conv(flax_path + ("qkv",), f"{torch_prefix}.qkv", bias=False)
    m += _conv(flax_path + ("out",), f"{torch_prefix}.out")
    return m


def build_key_map(in_channel=6, inner_channel=64, channel_mults=(1, 2, 4, 8, 8),
                  attn_res=(16,), res_blocks=2, image_size=128,
                  cond_mode="sr3", with_cond_emb=True):
    """(flax path, torch name, kind) of every UNet parameter, in the
    reference's construction order."""
    m = []
    if with_cond_emb:
        prefix = "noise_level_mlp" if cond_mode == "sr3" else "time_mlp"
        m += _linear(("cond_mlp_dense0",), f"{prefix}.1")
        m += _linear(("cond_mlp_dense1",), f"{prefix}.3")

    num_mults = len(channel_mults)
    attn_res = tuple(attn_res or ())

    # down path
    idx = 0
    m += _conv((f"downs_{idx}",), f"downs.{idx}")
    idx += 1
    pre = inner_channel
    feat_channels = [pre]
    now_res = image_size
    for ind in range(num_mults):
        is_last = ind == num_mults - 1
        use_attn = now_res in attn_res
        ch = inner_channel * channel_mults[ind]
        for _ in range(res_blocks):
            base = (f"downs_{idx}",)
            m += _resnet_block(base + ("res_block",), f"downs.{idx}.res_block",
                               cond_mode, has_res_conv=(pre != ch))
            if use_attn:
                m += _attn(base + ("attn",), f"downs.{idx}.attn")
            idx += 1
            feat_channels.append(ch)
            pre = ch
        if not is_last:
            m += _conv((f"downs_{idx}",), f"downs.{idx}.conv")
            idx += 1
            feat_channels.append(pre)
            now_res //= 2

    # mid
    m += _resnet_block(("mid_0", "res_block"), "mid.0.res_block",
                       cond_mode, has_res_conv=False)
    m += _attn(("mid_0", "attn"), "mid.0.attn")
    m += _resnet_block(("mid_1", "res_block"), "mid.1.res_block",
                       cond_mode, has_res_conv=False)

    # up path
    idx = 0
    for ind in reversed(range(num_mults)):
        is_last = ind < 1
        use_attn = now_res in attn_res
        ch = inner_channel * channel_mults[ind]
        for _ in range(res_blocks + 1):
            cat_in = pre + feat_channels.pop()
            base = (f"ups_{idx}",)
            m += _resnet_block(base + ("res_block",), f"ups.{idx}.res_block",
                               cond_mode, has_res_conv=(cat_in != ch))
            if use_attn:
                m += _attn(base + ("attn",), f"ups.{idx}.attn")
            idx += 1
            pre = ch
        if not is_last:
            m += _conv((f"ups_{idx}",), f"ups.{idx}.conv")
            idx += 1
            now_res *= 2

    # final block (GN at .block.0, conv at .block.3)
    m += _gn(("final_conv", "norm"), "final_conv.block.0")
    m += _conv(("final_conv", "conv"), "final_conv.block.3")
    return m


_SCHEDULE_BUFFERS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2",
)


def flax_params_to_torch_state_dict(params, **unet_config):
    """JAX UNet parameters ({'params': tree} or the tree) as the reference's
    GaussianDiffusion state_dict: every parameter under ``denoise_fn.``,
    conv kernels (kh, kw, in, out) -> (out, in, kh, kw), dense kernels
    (in, out) -> (out, in), plus ddpm's ``inv_freq`` buffer. Returns
    {key: float32 np.ndarray}."""
    tree = params.get("params", params)

    def _leaf(path):
        node = tree
        for p in path:
            node = node[p]
        return np.asarray(node)

    sd = {}
    for flax_path, torch_key, kind in build_key_map(**unet_config):
        w = _leaf(flax_path)
        if kind == "conv_w":
            w = np.transpose(w, (3, 2, 0, 1))
        elif kind == "linear_w":
            w = np.transpose(w, (1, 0))
        sd["denoise_fn." + torch_key] = np.ascontiguousarray(w,
                                                             dtype=np.float32)

    if unet_config.get("cond_mode", "sr3") == "ddpm":
        dim = unet_config.get("inner_channel", 64)
        sd["denoise_fn.time_mlp.0.inv_freq"] = np.exp(
            np.arange(0, dim, 2, dtype=np.float32) * (-np.log(10000.0) / dim)
        ).astype(np.float32)
    return sd


def unet_key_config(unet):
    """build_key_map keyword arguments describing a port UNet."""
    return dict(
        in_channel=unet.in_channel, inner_channel=unet.inner_channel,
        channel_mults=unet.channel_mults, attn_res=unet.attn_res,
        res_blocks=unet.res_blocks, image_size=unet.image_size,
        cond_mode=unet.cond_mode,
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
