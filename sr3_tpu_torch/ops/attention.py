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
kernels'.
"""

from __future__ import annotations

import torch

from sr3_tpu_torch.ops import _build

counter = _build.LaunchCount("flash_attention_fwd")
dkv_counter = _build.LaunchCount("flash_attention_bwd_dkv")
dq_counter = _build.LaunchCount("flash_attention_bwd_dq")
MAX_HEAD_DIM = 512


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
    out = torch.empty((bh, seq, d), dtype=torch.float32, device=q.device)
    lse = (torch.empty((bh, seq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = lib.sr3_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.ptr(lse), bh, seq, d, float(scale), _build.dtype_code(q),
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
    (bh, seq); all contiguous, on q's device."""
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
    _bwd_kernel("sr3_flash_attention_bwd_dkv", dkv_counter, q, k, v, g, lse,
                dsum, (dk, dv), scale)
    _bwd_kernel("sr3_flash_attention_bwd_dq", dq_counter, q, k, v, g, lse,
                dsum, (dq,), scale)
    return dq, dk, dv


def _bwd_kernel(entry, count, q, k, v, g, lse, dsum, outs, scale):
    """Launch one backward kernel (K5: outs (dk, dv); K6: outs (dq,)) on
    checked operands."""
    bh, seq, d = q.shape
    err = getattr(_build.load_library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), *(t.data_ptr() for t in outs),
        bh, seq, d, float(scale), _build.dtype_code(q), _build.stream_of(q))
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
