"""A mirror of K4's bfloat16 launch plan (``csrc/attention.cu``
``fwd_plan``) and of the key tiles each block of it runs, for the CPU
tests (``tests/test_torch_port_attention_bf16.py``); the card's tests hold
the C library's plan against it (``tests/test_torch_port_gpu.py``). It
imports neither JAX nor torch, so the card's tests, which run without JAX,
can import it. Change it with the C plan.
"""

import math

SMS = 132  # an H100 SXM
MAX_SPLITS = 16
MIN_SPLIT_TILES = 4  # key tiles a split runs at least
# the head_dim classes <DC, BK> of csrc/attention.cu (kClassDC, kClassBK,
# kClassRows), in the order sr3_flash_attention_fwd_tiles counts them
CLASS_DC = (64, 128, 256, 512)
CLASS_BK = (128, 128, 64, 64)
CLASS_ROWS = (128, 128, 128, 64)
FIELDS = ("cls", "rows", "bk", "q_tiles", "key_tiles", "splits", "per")


def head_dim_class(d):
    """Index of the class a head_dim runs at: the next multiple of 64 up."""
    return 0 if d <= 64 else 1 if d <= 128 else 2 if d <= 256 else 3


def fwd_plan(bh, seq, d, sms=SMS):
    """The plan as a dict of FIELDS: query tiles of `rows`, key tiles of
    `bk`, and where the blocks (q_tiles x bh) fill at most half of the SMs,
    the key tiles split over `splits` blocks of `per` (at least
    MIN_SPLIT_TILES) tiles."""
    cls = head_dim_class(d)
    rows, bk = CLASS_ROWS[cls], CLASS_BK[cls]
    q_tiles, key_tiles = math.ceil(seq / rows), math.ceil(seq / bk)
    blocks = q_tiles * bh
    n = 1
    if 2 * blocks <= sms:
        n = max(1, min(sms // blocks, MAX_SPLITS,
                       key_tiles // MIN_SPLIT_TILES))
    per = math.ceil(key_tiles / n)
    splits = math.ceil(key_tiles / per)
    return dict(zip(FIELDS, (cls, rows, bk, q_tiles, key_tiles, splits, per)))


def blocks_of(bh, seq, d, sms=SMS):
    """Every block of the launch as (head, query rows, key ranges in the
    order the block runs them, split index): the grid (q_tiles, bh,
    splits), query tile x owning rows [x * rows, (x + 1) * rows) of seq,
    split z the key tiles [z * per, (z + 1) * per) of seq."""
    p = fwd_plan(bh, seq, d, sms)
    out = []
    for z in range(p["splits"]):
        tiles = range(z * p["per"], min(p["key_tiles"], (z + 1) * p["per"]))
        keys = [(t * p["bk"], min(seq, (t + 1) * p["bk"])) for t in tiles]
        for h in range(bh):
            for x in range(p["q_tiles"]):
                rows = (x * p["rows"], min(seq, (x + 1) * p["rows"]))
                out.append((h, rows, keys, z))
    return out
