"""The port's from-scratch init against the JAX package's.

The JAX package builds its training UNet with flax's ``orthogonal()`` kernels
(gain 1) and the val / serving UNet with flax's default ``lecun_normal``;
every conv and dense bias is zero and GroupNorm starts at scale 1, bias 0
(``sr3_tpu/models/networks.py`` ``init_type``, ``sr3_tpu/models/unet.py``
``_kernel_init``). The port's ``define_G`` follows ``opt["phase"]`` the same
way. Both sides are held to one definition on a small sr3 UNet (inner
channel 16, mults [1, 2], attention at 8x8; 8 and 16 norm groups):

- orthogonal: each weight flattened to (out, fan_in) has orthonormal rows
  when out <= fan_in and orthonormal columns otherwise (atol 1e-5); flax's
  (kh, kw, in, out) kernel flattened to (kh*kw*in, out) is the transpose of
  that matrix up to a permutation of fan_in, which keeps the property;
- lecun-normal: std within 10% of 1/sqrt(fan_in) on layers of at least
  4096 weights, and no value beyond flax's truncation bound
  2 * (1/sqrt(fan_in)) / 0.87962566.

Weights carried over from the JAX package load bit for bit, whatever the
init they replace.
"""

import copy
import functools

import jax
import numpy as np
import pytest
import torch
from torch import nn

from sr3_tpu.models.networks import define_G as jax_define_G
from sr3_tpu.models.networks import init_params
from sr3_tpu_torch.models.networks import define_G
from sr3_tpu_torch.utils.torch_compat import load_flax_params

ORTHO_ATOL = 1e-5
STD_RTOL = 0.1
MIN_WEIGHTS = 4096
TRUNC_STD = 0.87962566  # std of a standard normal truncated at +-2


def tiny_opt(phase, groups=8):
    sched = {"schedule": "linear", "n_timestep": 10, "linear_start": 1e-6,
             "linear_end": 1e-2}
    return {
        "name": "tiny", "phase": phase,
        "path": {"resume_state": None},
        "model": {
            "which_model_G": "sr3", "dtype": "float32",
            "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 16,
                     "norm_groups": groups, "channel_multiplier": [1, 2],
                     "attn_res": [8], "res_blocks": 1, "dropout": 0.0},
            "beta_schedule": {"train": dict(sched), "val": dict(sched)},
            "diffusion": {"image_size": 16, "channels": 3,
                          "conditional": True},
        },
    }


def port_layers(net):
    """(name, weight as (out, fan_in) float64 numpy, bias) of every Conv2d
    and Linear."""
    out = []
    for name, m in net.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = m.weight.detach().double().reshape(m.weight.shape[0], -1)
            out.append((name, w.numpy(),
                        None if m.bias is None else m.bias.detach().numpy()))
    return out


@functools.lru_cache(maxsize=None)
def jax_params(phase, groups):
    diffusion = jax_define_G(tiny_opt(phase, groups))
    return jax.tree_util.tree_map(
        np.asarray, init_params(diffusion, jax.random.PRNGKey(0)))


def jax_layers(phase, groups):
    """(name, kernel as (out, fan_in) float64, bias) of every conv and dense
    of the JAX package's UNet: flax's (..., in, out) kernel flattened to
    (fan_in, out) and transposed."""
    flat = jax.tree_util.tree_flatten_with_path(jax_params(phase, groups))[0]
    leaves = {"/".join(str(getattr(k, "key", k)) for k in path): v
              for path, v in flat}
    out = []
    for name, v in leaves.items():
        if name.endswith("/kernel"):
            w = v.astype(np.float64).reshape(-1, v.shape[-1]).T
            out.append((name, w, leaves.get(name[:-len("kernel")] + "bias")))
    return out


def assert_orthonormal(name, w):
    rows, cols = w.shape
    gram = w @ w.T if rows <= cols else w.T @ w
    np.testing.assert_allclose(gram, np.eye(min(rows, cols)), rtol=0,
                               atol=ORTHO_ATOL, err_msg=name)


def assert_lecun_normal(name, w):
    fan_in = w.shape[1]
    std = 1.0 / np.sqrt(fan_in)
    assert np.abs(w).max() <= 2 * std / TRUNC_STD * (1 + 1e-6), name
    if w.size >= MIN_WEIGHTS:
        assert abs(w.std() / std - 1) <= STD_RTOL, (name, w.std(), std)


def assert_zero_biases(layers):
    for name, _, bias in layers:
        if bias is not None:
            assert not np.any(bias), name


@pytest.mark.parametrize("groups", [8, 16])
@pytest.mark.parametrize("side", ["port", "jax"])
def test_train_phase_weights_are_orthogonal(side, groups):
    if side == "port":
        layers = port_layers(define_G(tiny_opt("train", groups),
                                      device="cpu").denoise_fn)
    else:
        layers = jax_layers("train", groups)
    assert len(layers) > 10
    for name, w, _ in layers:
        assert_orthonormal(name, w)
    assert_zero_biases(layers)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_other_phases_are_lecun_normal(side):
    if side == "port":
        layers = port_layers(define_G(tiny_opt("val"), device="cpu")
                             .denoise_fn)
    else:
        layers = jax_layers("val", 8)
    assert sum(w.size >= MIN_WEIGHTS for _, w, _ in layers) >= 5
    for name, w, _ in layers:
        assert_lecun_normal(name, w)
    assert_zero_biases(layers)


def test_port_and_jax_layers_have_the_same_shapes():
    port = port_layers(define_G(tiny_opt("train"), device="cpu").denoise_fn)
    ours = sorted(w.shape for _, w, _ in port)
    theirs = sorted(w.shape for _, w, _ in jax_layers("train", 8))
    assert ours == theirs


@pytest.mark.parametrize("phase", ["train", "val"])
def test_group_norm_starts_at_one_and_zero(phase):
    net = define_G(tiny_opt(phase), device="cpu").denoise_fn
    norms = [m for m in net.modules() if isinstance(m, nn.GroupNorm)]
    assert norms
    for m in norms:
        assert torch.equal(m.weight, torch.ones_like(m.weight))
        assert torch.equal(m.bias, torch.zeros_like(m.bias))


def test_init_is_seeded_and_leaves_the_global_generator_alone():
    state = torch.random.get_rng_state()
    a = define_G(tiny_opt("train"), device="cpu", seed=3).denoise_fn
    assert torch.equal(torch.random.get_rng_state(), state)
    b = define_G(tiny_opt("train"), device="cpu", seed=3).denoise_fn
    c = define_G(tiny_opt("train"), device="cpu", seed=4).denoise_fn
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(p, q), name
        if p.dim() > 1:
            assert not torch.equal(p, r), name


def test_meta_build_keeps_shapes():
    net = define_G(tiny_opt("train"), device="meta").denoise_fn
    ref = define_G(tiny_opt("train"), device="cpu").denoise_fn
    for (name, p), q in zip(net.named_parameters(), ref.parameters()):
        assert p.is_meta and p.shape == q.shape, name


@pytest.mark.parametrize("phase", ["train", "val"])
def test_carried_over_jax_weights_load_bit_for_bit(phase):
    """A strict load of the JAX package's parameters replaces the init of
    either phase and gives the same parameters as a load into the other."""
    params = jax_params("train", 8)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda p: (p + 0.1 * rng.standard_normal(p.shape)).astype(np.float32),
        params)
    net = define_G(tiny_opt(phase), device="cpu").denoise_fn
    load_flax_params(net, params)
    other = define_G(tiny_opt("val" if phase == "train" else "train"),
                     device="cpu").denoise_fn
    load_flax_params(other, copy.deepcopy(params))
    for (name, p), q in zip(net.state_dict().items(),
                            other.state_dict().values()):
        assert torch.equal(p, q), name
    # the loaded values are the JAX package's, as float32
    w = net.final_conv.block[3].weight.detach()
    kernel = params["params"]["final_conv"]["conv"]["kernel"]
    np.testing.assert_array_equal(w.permute(2, 3, 1, 0).numpy(), kernel)
