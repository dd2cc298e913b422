"""Plain dropout with an explicit generator.

Counterpart of ``sr3_tpu/ops/dropout.py`` in its plain (mask-saving) form:
its mask-recompute variant was measured to change nothing on the TPU, and
autograd here saves the boolean mask. Same convention as flax ``nn.Dropout``
and the reference's ``nn.Dropout``: keep = 1 - rate, kept values divided by
keep (in x's dtype), dropped ones 0. The keep-mask is drawn by
``dropout_mask`` alone, so a test can substitute its own masks. On an
H-shard the mask of the whole map is drawn and cut to the shard's rows
(every space rank draws it from the same generator), so the draws equal one
device's; that full-size draw is an open cost.
"""

from __future__ import annotations

import torch


def dropout_mask(x, keep, generator=None):
    """Boolean mask of x's shape, device and memory layout, True with
    probability ``keep``, drawn from ``generator``."""
    u = torch.empty_like(x, dtype=torch.float32)
    return u.uniform_(generator=generator) < keep


def dropout(x, rate, generator=None, rows=None):
    """Dropout of x (B, C, h, W). ``rows = (slice, H)``: x holds those rows
    of a map of height H (an H-shard); the mask is drawn for the whole map,
    as one device draws it, and cut to the rows."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    if rows is None:
        mask = dropout_mask(x, keep, generator)
    else:
        sl, h = rows
        whole = torch.empty((x.shape[0], x.shape[1], h, x.shape[3]),
                            dtype=x.dtype, device=x.device,
                            memory_format=torch.channels_last)
        mask = dropout_mask(whole, keep, generator)[:, :, sl]
    scale = torch.tensor(keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
