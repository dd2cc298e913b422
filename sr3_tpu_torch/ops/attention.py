"""Self-attention over spatial tokens (kernel K4, ``csrc/attention.cu``).

Counterpart of ``sr3_tpu/ops/attention.py``. ``attention_plain`` is the
plain PyTorch version of the XLA spec ``attention_xla`` (float32 einsum,
softmax, einsum); ``attention`` runs it for a CPU tensor and launches the
flash-attention forward kernel for a CUDA tensor. Layout (batch*heads, seq,
head_dim); the output is float32, as the TPU kernel's.
"""

from __future__ import annotations

import torch

from sr3_tpu_torch.ops import _build

counter = _build.LaunchCount("flash_attention_fwd")
MAX_HEAD_DIM = 512


def attention_plain(q, k, v, scale):
    """q, k, v: (bh, seq, d). Returns (bh, seq, d) float32."""
    q, k, v = q.float(), k.float(), v.float()
    logits = torch.einsum("bqd,bkd->bqk", q, k) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs, v)


def attention(q, k, v, scale):
    """Non-causal attention: the plain version on the CPU, kernel K4 on
    CUDA."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (bh, seq, d) tensor")
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError("q, k and v must share shape and dtype")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cpu or cuda, not {q.device}")
    bh, seq, d = q.shape
    if d % 16 or d > MAX_HEAD_DIM:
        raise ValueError(f"the flash kernel takes head_dim a multiple of 16 "
                         f"and at most {MAX_HEAD_DIM}, got {d}")
    lib = _build.load_library()
    out = torch.empty((bh, seq, d), dtype=torch.float32, device=q.device)
    err = lib.sr3_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bh, seq, d, float(scale), _build.dtype_code(q), _build.stream_of(q),
    )
    _build.check(err, "sr3_flash_attention_fwd")
    counter.n += 1
    return out
