"""A mirror of the bfloat16 launch plans of K4 (``csrc/attention.cu``
``fwd_plan``) and of K5 / K6 (``csrc/attention_bwd.cu`` ``bwd_plan``),
and of the tiles each block of them runs, for the CPU tests
(``tests/test_torch_port_attention_bf16.py``); the card's tests hold the C
library's plans against it (``tests/test_torch_port_gpu.py``). It imports
neither JAX nor torch, so the card's tests, which run without JAX, can
import it. Change it with the C plans.
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


# K5 (kernel 0) and K6 (kernel 1): the classes of csrc/attention_bwd.cu
# (kClassDC, kDkvBN / kDkvRows, kDqBN / kDqRows), in the order
# sr3_flash_attention_bwd_tiles counts them (K5's, K6's, then the merge)
BWD_CLASS_DC = (64, 128, 256, 512)
BWD_BN = ((64, 64, 32, 32), (128, 64, 64, 32))
BWD_ROWS = ((128, 128, 64, 64), (128, 128, 128, 64))
BWD_FIELDS = ("cls", "rows", "bn", "row_tiles", "col_tiles", "splits", "per")


def bwd_plan(bh, seq, d, kernel, sms=SMS):
    """K5's (kernel 0) or K6's (kernel 1) plan as a dict of BWD_FIELDS:
    resident row tiles of `rows` (K5's keys, K6's queries), streamed tiles
    of `bn` (K5's queries, K6's keys), and where the blocks (row_tiles x bh)
    fill at most a quarter of the SMs, the streamed tiles split over
    `splits` blocks of `per` (at least MIN_SPLIT_TILES) tiles."""
    cls = head_dim_class(d)
    rows, bn = BWD_ROWS[kernel][cls], BWD_BN[kernel][cls]
    row_tiles, col_tiles = math.ceil(seq / rows), math.ceil(seq / bn)
    blocks = row_tiles * bh
    n = 1
    if 4 * blocks <= sms:
        n = max(1, min(sms // blocks, MAX_SPLITS,
                       col_tiles // MIN_SPLIT_TILES))
    per = math.ceil(col_tiles / n)
    splits = math.ceil(col_tiles / per)
    return dict(zip(BWD_FIELDS,
                    (cls, rows, bn, row_tiles, col_tiles, splits, per)))


def bwd_passes(d, kernel):
    """Passes a K5 block makes over its streamed tiles: two (dV, then dK)
    where dK and dV of a warpgroup would take more than 128 registers a
    thread (the output columns a warpgroup owns above 128); K6 one."""
    cls = head_dim_class(d)
    dc = BWD_CLASS_DC[cls]
    cols = dc // 2 if BWD_ROWS[kernel][cls] == 64 else dc
    return 2 if kernel == 0 and cols > 128 else 1


def bwd_blocks_of(bh, seq, d, kernel, sms=SMS):
    """Every block of K5's or K6's launch as (head, resident rows, streamed
    row ranges in the order the block runs them, split index): the grid
    (row_tiles, bh, splits), row tile x owning rows [x * rows, (x + 1) *
    rows) of seq, split z the streamed tiles [z * per, (z + 1) * per)."""
    p = bwd_plan(bh, seq, d, kernel, sms)
    out = []
    for z in range(p["splits"]):
        tiles = range(z * p["per"], min(p["col_tiles"], (z + 1) * p["per"]))
        cols = [(t * p["bn"], min(seq, (t + 1) * p["bn"])) for t in tiles]
        for h in range(bh):
            for x in range(p["row_tiles"]):
                rows = (x * p["rows"], min(seq, (x + 1) * p["rows"]))
                out.append((h, rows, cols, z))
    return out
