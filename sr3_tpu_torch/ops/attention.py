"""Self-attention over spatial tokens: flash-attention forward (kernel K4,
``csrc/attention.cu``) and backward (kernels K5 dK/dV and K6 dQ,
``csrc/attention_bwd.cu``).

Counterpart of ``sr3_tpu/ops/attention.py``. The plain PyTorch versions are
``attention_plain`` (the XLA spec ``attention_xla``: float32 einsum,
softmax, einsum), ``attention_fwd_plain`` (output and per-row logsumexp, as
``attention_flash_fwd``) and ``attention_bwd_plain`` (``attention_flash_bwd``
written out in float32 einsums). The wrappers run them for CPU tensors and
launch the kernels for CUDA tensors. ``attention`` is differentiable: under
autograd it saves the logsumexp and its backward runs K5 then K6, as
``_flash_with_vjp`` does; without grad the forward skips the logsumexp.
Layout (batch*heads, seq, head_dim); outputs are float32, as the TPU
kernels'. On CUDA the input dtype picks each kernel's route: float32 FMAs,
or for bfloat16 the Hopper routes of K4, K5 and K6 (``wgmma`` fed by TMA,
a class per head_dim, counted by ``bf16_tile_launches`` and
``bwd_tile_launches``), which round P (K4), dO, P and dS (K5) and dO, dS
(K6) to bf16 before their products (within 2e-2 of max|plain|; the
logsumexp within 1e-4; the csrc headers give the reasons). Where a call's
blocks fill few of the SMs, each kernel splits its streamed range
into partial sums that a second launch adds in a fixed order; the wrappers
allocate the workspace the C library asks for.
"""

from __future__ import annotations

import ctypes

import torch

from sr3_tpu_torch.ops import _build

counter = _build.LaunchCount("flash_attention_fwd")
dkv_counter = _build.LaunchCount("flash_attention_bwd_dkv")
dq_counter = _build.LaunchCount("flash_attention_bwd_dq")
MAX_HEAD_DIM = 512
# K4's bfloat16 route: its head_dim classes <DC, BK> (columns, keys a tile)
# and the merge of a key split, in the order sr3_flash_attention_fwd_tiles
# reports their launches.
BF16_TILES = ("<64,128>", "<128,128>", "<256,64>", "<512,64>", "merge")
# the fields of sr3_flash_attention_fwd_plan
PLAN_FIELDS = ("cls", "rows", "bk", "q_tiles", "key_tiles", "splits", "per")
# K5's and K6's bfloat16 routes: their head_dim classes <DC, BN> (columns,
# streamed rows a tile) and the merge of a split, in the order
# sr3_flash_attention_bwd_tiles reports their launches
BWD_TILES = ("dkv<64,64>", "dkv<128,64>", "dkv<256,32>", "dkv<512,32>",
             "dq<64,128>", "dq<128,64>", "dq<256,64>", "dq<512,32>", "merge")
# the fields of sr3_flash_attention_bwd_plan; the kernels by index
BWD_PLAN_FIELDS = ("cls", "rows", "bn", "row_tiles", "col_tiles", "splits",
                   "per")
BWD_KERNELS = {"sr3_flash_attention_bwd_dkv": 0,
               "sr3_flash_attention_bwd_dq": 1}


def bf16_tile_launches(reset=False):
    """Launches of each bfloat16 class and of the merge since the last
    reset, by BF16_TILES name; ``reset`` sets them to 0 after reading.
    Loads the CUDA library."""
    counts = (ctypes.c_longlong * len(BF16_TILES))()
    n = _build.load_library().sr3_flash_attention_fwd_tiles(counts,
                                                            int(reset))
    if n != len(BF16_TILES):
        raise RuntimeError(f"the library reports {n} K4 launch counts, "
                           f"expected {len(BF16_TILES)}")
    return dict(zip(BF16_TILES, counts))


def fwd_plan(bh, seq, d):
    """The bfloat16 route's launch plan for (bh, seq, d) on the current
    device, from the C library: a dict of PLAN_FIELDS."""
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    if _build.load_library().sr3_flash_attention_fwd_plan(bh, seq, d,
                                                          out) < 0:
        raise ValueError(f"K4 does not take (bh, seq, d) = {(bh, seq, d)}")
    return dict(zip(PLAN_FIELDS, out))


def bwd_tile_launches(reset=False):
    """Launches of each bfloat16 class of K5 and K6 and of their merge since
    the last reset, by BWD_TILES name; ``reset`` sets them to 0 after
    reading. Loads the CUDA library."""
    counts = (ctypes.c_longlong * len(BWD_TILES))()
    n = _build.load_library().sr3_flash_attention_bwd_tiles(counts,
                                                            int(reset))
    if n != len(BWD_TILES):
        raise RuntimeError(f"the library reports {n} K5 / K6 launch counts, "
                           f"expected {len(BWD_TILES)}")
    return dict(zip(BWD_TILES, counts))


def bwd_plan(bh, seq, d, kernel):
    """The bfloat16 launch plan of K5 (kernel 0) or K6 (kernel 1) for
    (bh, seq, d) on the current device, from the C library: a dict of
    BWD_PLAN_FIELDS."""
    out = (ctypes.c_longlong * len(BWD_PLAN_FIELDS))()
    if _build.load_library().sr3_flash_attention_bwd_plan(bh, seq, d, kernel,
                                                          out) < 0:
        raise ValueError(f"K{5 + kernel} does not take (bh, seq, d) = "
                         f"{(bh, seq, d)}")
    return dict(zip(BWD_PLAN_FIELDS, out))


def attention_plain(q, k, v, scale):
    """q, k, v: (bh, seq, d). Returns (bh, seq, d) float32."""
    q, k, v = q.float(), k.float(), v.float()
    logits = torch.einsum("bqd,bkd->bqk", q, k) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs, v)


def attention_fwd_plain(q, k, v, scale):
    """(o (bh, seq, d), lse (bh, seq)) float32; lse is the logsumexp of each
    row of q k^T * scale."""
    q, k, v = q.float(), k.float(), v.float()
    logits = torch.einsum("bqd,bkd->bqk", q, k) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    return torch.einsum("bqk,bkd->bqd", probs, v), lse


def attention_bwd_plain(q, k, v, g, lse, dsum, scale):
    """(dq, dk, dv) float32 of o = softmax(q k^T * scale) v for the output
    gradient g, from the forward's lse and dsum = rowsum(g * o), both
    (bh, seq)."""
    q, k, v, g = q.float(), k.float(), v.float(), g.float()
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bqk,bqd->bkd", p, g)
    dp = torch.einsum("bqd,bkd->bqk", g, v)
    ds = p * (dp - dsum[..., None]) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, k)
    dk = torch.einsum("bqk,bqd->bkd", ds, q)
    return dq, dk, dv


def _check_qkv(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (bh, seq, d) tensor")
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError("q, k and v must share shape and dtype")
        if t.device != q.device:
            raise ValueError("q, k and v must share a device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention runs on cpu or cuda, not {q.device}")
    if q.device.type == "cuda":
        d = q.shape[-1]
        if d % 16 or d > MAX_HEAD_DIM:
            raise ValueError(f"the flash kernels take head_dim a multiple of "
                             f"16 and at most {MAX_HEAD_DIM}, got {d}")


def _fwd_kernel(q, k, v, scale, with_lse):
    bh, seq, d = q.shape
    lib = _build.load_library()
    code = _build.dtype_code(q)
    out = torch.empty((bh, seq, d), dtype=torch.float32, device=q.device)
    lse = (torch.empty((bh, seq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    n = lib.sr3_flash_attention_fwd_workspace_floats(bh, seq, d, code)
    if n < 0:
        raise RuntimeError(f"sr3_flash_attention_fwd takes no {(bh, seq, d)} "
                           f"of {q.dtype}, or the device could not be read")
    ws = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    err = lib.sr3_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.ptr(lse), _build.ptr(ws), bh, seq, d, float(scale), code,
        _build.stream_of(q),
    )
    _build.check(err, "sr3_flash_attention_fwd")
    counter.n += 1
    return out, lse


def attention_fwd(q, k, v, scale):
    """(o, lse), both float32: the plain version on the CPU, kernel K4 with
    its logsumexp output on CUDA."""
    _check_qkv(q, k, v)
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, scale)
    return _fwd_kernel(q, k, v, scale, with_lse=True)


def attention_bwd(q, k, v, g, lse, dsum, scale):
    """(dq, dk, dv) float32: the plain version on the CPU; on CUDA kernel K5
    (dk, dv) then kernel K6 (dq). g: float32 (bh, seq, d); lse, dsum: float32
    (bh, seq); all contiguous, on q's device. Both kernels take dO in q's
    dtype: the bfloat16 routes get g rounded once; dsum comes from the
    float32 g."""
    _check_qkv(q, k, v)
    bh, seq, d = q.shape
    for name, t, shape in (("g", g, (bh, seq, d)), ("lse", lse, (bh, seq)),
                           ("dsum", dsum, (bh, seq))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {q.device}")
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, g, lse, dsum, scale)
    dq, dk, dv = (torch.empty((bh, seq, d), dtype=torch.float32,
                              device=q.device) for _ in range(3))
    g = g.to(q.dtype)
    _bwd_kernel("sr3_flash_attention_bwd_dkv", dkv_counter, q, k, v, g, lse,
                dsum, (dk, dv), scale)
    _bwd_kernel("sr3_flash_attention_bwd_dq", dq_counter, q, k, v, g, lse,
                dsum, (dq,), scale)
    return dq, dk, dv


def _bwd_kernel(entry, count, q, k, v, g, lse, dsum, outs, scale):
    """Launch one backward kernel (K5: outs (dk, dv); K6: outs (dq,)) on
    checked operands, g in q's dtype."""
    if g.dtype != q.dtype:
        raise ValueError(f"g dtype {g.dtype} != q dtype {q.dtype}")
    bh, seq, d = q.shape
    lib = _build.load_library()
    code = _build.dtype_code(q)
    n = lib.sr3_flash_attention_bwd_workspace_floats(bh, seq, d, code,
                                                     BWD_KERNELS[entry])
    if n < 0:
        raise RuntimeError(f"{entry} takes no {(bh, seq, d)} of {q.dtype}, "
                           f"or the device could not be read")
    ws = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), *(t.data_ptr() for t in outs),
        _build.ptr(ws), bh, seq, d, float(scale), code, _build.stream_of(q))
    _build.check(err, entry)
    count.n += 1


class _FlashAttention(torch.autograd.Function):
    """Counterpart of ``_flash_with_vjp``: the forward saves the logsumexp,
    the backward recomputes P from it, tile by tile."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        g = g.float().contiguous()
        dsum = (g * o).sum(dim=-1)
        dq, dk, dv = attention_bwd(q, k, v, g, lse, dsum, ctx.scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def attention(q, k, v, scale):
    """Non-causal attention, float32 output: the plain versions on the CPU,
    kernels K4 (and under autograd K5, K6) on CUDA."""
    if _build.needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, scale)
    _check_qkv(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    return _fwd_kernel(q, k, v, scale, with_lse=False)[0]
