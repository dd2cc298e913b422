"""The statistics route of the port's GroupNorm (kernel K3's plain version,
the group fold, the torch normalize and the hand backward) on the CPU
against the JAX package: ``gn_stats_pallas`` in interpret mode and the
custom_vjp of ``_gn_swish_stats_fwd_bwd`` with its Pallas statistics in
interpret mode, on the same numpy inputs; and the dispatch of
``group_norm`` to the route.

Tolerances, as the JAX package's own tests of that route
(tests/test_ops.py): sums rtol 1e-5 / atol 1e-4 (float32 sums of 128-512
terms in another order); forward atol 1e-5; gradients atol 2e-3 (the
squared-output loss makes gradients O(10), summed over the map).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr3_tpu.ops.groupnorm import _gn_swish_stats_fwd_bwd, gn_stats_pallas
from sr3_tpu_torch.ops import groupnorm


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nchw(x):
    """NHWC numpy -> logical NCHW torch view in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape,block_bytes", [
    ((2, 16, 8, 64), None),
    ((2, 16, 8, 128), None),
    ((1, 64, 4, 128), 16 * 1024),  # H spans 8 blocks of the grid
])
def test_gn_stats_plain_matches_pallas_interpret(shape, block_bytes):
    rng = np.random.default_rng(50)
    x = (rng.standard_normal(shape) + 0.2).astype(np.float32)
    s1, s2 = groupnorm.gn_stats(nchw(x))
    assert s1.dtype == s2.dtype == torch.float32
    assert s1.shape == s2.shape == (shape[0], shape[3])
    r1, r2 = gn_stats_pallas(jnp.asarray(x), interpret=True,
                             block_bytes=block_bytes)
    np.testing.assert_allclose(s1.numpy(), np.asarray(r1), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), np.asarray(r2), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("swish", [True, False])
@pytest.mark.parametrize("groups,c", [(16, 64), (8, 128)])
def test_stats_route_matches_jax_stats_vjp(groups, c, swish):
    """Forward and the input gradients of the squared output, through the
    port's autograd Function and through ``_gn_swish_stats_fwd_bwd``."""
    rng = np.random.default_rng(51)
    x = (rng.standard_normal((2, 16, 8, c)) + 0.2).astype(np.float32)
    s = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    inputs = [nchw(x).requires_grad_(), torch.from_numpy(s).requires_grad_(),
              torch.from_numpy(b).requires_grad_()]
    out = groupnorm.group_norm_stats(*inputs, groups, swish=swish)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ \
        == "_GroupNormStatsBackward"
    assert out.is_contiguous(memory_format=torch.channels_last)
    out.square().sum().backward()

    f = _gn_swish_stats_fwd_bwd(groups, 1e-5, swish, True)
    jx, js, jb = jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)
    ref = f(jx, js, jb)
    gx, gs, gb = jax.grad(lambda a, sc, bi: jnp.sum(f(a, sc, bi) ** 2),
                          argnums=(0, 1, 2))(jx, js, jb)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-5, rtol=0)
    assert inputs[0].grad.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(inputs[0].grad), np.asarray(gx),
                               atol=2e-3, rtol=0)
    np.testing.assert_allclose(inputs[1].grad.numpy(), np.asarray(gs),
                               atol=2e-3, rtol=0)
    np.testing.assert_allclose(inputs[2].grad.numpy(), np.asarray(gb),
                               atol=2e-3, rtol=0)


@pytest.mark.parametrize("h,w,route", [
    (256, 256, True), (255, 256, False), (128, 512, True), (512, 127, False),
])
def test_group_norm_takes_the_route_from_256_squared(monkeypatch, h, w, route):
    calls = []
    monkeypatch.setattr(groupnorm, "group_norm_stats",
                        lambda *a, **k: calls.append(a[0].shape))
    x = torch.zeros(1, 4, h, w).contiguous(memory_format=torch.channels_last)
    out = groupnorm.group_norm(x, torch.ones(4), torch.zeros(4), 2)
    assert (calls == [x.shape]) == route
    assert (out is None) == route
    assert h * w >= groupnorm.STATS_MIN_HW if route else \
        h * w < groupnorm.STATS_MIN_HW


def test_stats_route_equals_group_norm_plain_and_counts_no_cpu_launch():
    """The route on a 256^2 map (through group_norm) against the plain
    GroupNorm, float32 atol 1e-4 (outputs up to ~5 from group sums of 2^17
    terms taken in another order); the CPU runs the plain sums."""
    rng = np.random.default_rng(52)
    x = nchw((2.0 * rng.standard_normal((1, 256, 256, 8)) + 0.5)
             .astype(np.float32))
    s = torch.from_numpy((1 + 0.2 * rng.standard_normal(8)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(8)).astype(np.float32))
    groupnorm.stats_counter.n = groupnorm.counter.n = 0
    out = groupnorm.group_norm(x, s, b, 4, swish=True)
    ref = groupnorm.group_norm_plain(x, s, b, 4, swish=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4, rtol=0)
    assert groupnorm.stats_counter.n == groupnorm.counter.n == 0
