"""K1's bfloat16 conv launch plan, on the CPU: the mirror of
``csrc/conv_fused.cu`` ``conv_plan`` (``tests/torch_port_conv_plan.py``)
against the source's class table, the class every K1 site of the
benchmark's five cells takes, and the Hopper kernel's persistent walk,
which has to run every (pixel tile, N-tile) item exactly once and cover
every output pixel and channel of the map once. The card's tests hold the
library's plan against the mirror (``tests/test_torch_port_gpu.py``).
"""

import json
import os
import re
from collections import Counter

import numpy as np
import pytest

from portbench import costs
from portbench.reference import adm
from sr3_tpu_torch.ops import _build, conv_fused
import torch_port_conv_plan as plan_mirror

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (config, batch, training) of the benchmark's five cells
CELLS = [("sr3_16_128", 128, False), ("sr3_64_512", 8, False),
         ("sr3_16_128", 128, True), ("sr3_64_512", 16, True),
         ("adm_128_512", 8, False)]
# ragged and small shapes (b, h, w, cout): C_out past a tile, maps under a
# tile, odd batches with two images a tile, a one-item launch
RAGGED = [(2, 12, 20, 40), (2, 12, 20, 200), (3, 8, 8, 512), (1, 4, 4, 256),
          (2, 5, 20, 40), (1, 12, 12, 3), (3, 8, 8, 3), (5, 9, 7, 100),
          (1, 16, 16, 768), (8, 16, 16, 1536), (2, 33, 17, 384), (1, 1, 1, 9)]


def _sites(name, batch, training):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        opt = json.load(f)["opt"]
    if name == "adm_128_512":
        return adm.k1_sites(opt, batch)
    return costs.k1_sites(opt, batch, training)


def _shapes():
    out = set()
    for cell in CELLS:
        out |= {(s["b"], s["h"], s["w"], s["cout"]) for s in _sites(*cell)}
    return sorted(out)


def _source():
    with open(os.path.join(_build.CSRC_DIR, "conv_fused.cu")) as f:
        return f.read()


def _array(src, name):
    m = re.search(name + r"\[kClasses\] = \{([^}]*)\}", src)
    return tuple(int(v) for v in m.group(1).split(","))


def test_mirror_matches_the_sources_class_table():
    src = _source()
    assert _array(src, "kClassTW") == plan_mirror.CLASS_TW
    assert _array(src, "kClassNI") == plan_mirror.CLASS_NI
    assert _array(src, "kClassBN") == plan_mirror.CLASS_BN
    assert f"constexpr int kClasses = {len(plan_mirror.CLASS_BN)};" in src
    assert f"constexpr int kItemCost = {plan_mirror.ITEM_COST};" in src
    assert f"constexpr int kWTH = {plan_mirror.TILE_ROWS};" in src
    names = tuple(f"<{tw},{ni},{bn}>" for tw, ni, bn in zip(
        plan_mirror.CLASS_TW, plan_mirror.CLASS_NI, plan_mirror.CLASS_BN))
    assert names == conv_fused.BF16_TILES
    for tw, ni in zip(plan_mirror.CLASS_TW, plan_mirror.CLASS_NI):
        assert tw * ni * plan_mirror.TILE_ROWS == plan_mirror.TILE_PIXELS


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}_b{c[1]}"
                         + ("_train" if c[2] else ""))
def test_every_k1_site_of_the_cells_takes_an_instantiated_class(cell):
    src = _source()
    launched = Counter()
    for s in _sites(*cell):
        p = plan_mirror.conv_plan(s["b"], s["h"], s["w"], s["cout"])
        name = conv_fused.BF16_TILES[p["cls"]]
        tw, ni, bn = plan_mirror.CLASS_TW[p["cls"]], \
            plan_mirror.CLASS_NI[p["cls"]], plan_mirror.CLASS_BN[p["cls"]]
        if p["cls"] == plan_mirror.SMALL_CLASS:
            assert "gn_silu_conv3x3_small_kernel" in src
        else:
            assert f"launch_tma<{tw}, {ni}, {bn}>(a, p, st)" in src
        assert 0 < p["grid"] <= max(plan_mirror.SMS, p["items"])
        launched[name] += 1
    print(f"{cell}: {dict(launched)}")
    # every C_out > 8 site runs the Hopper kernel; C_out <= 8 the small one
    small = sum(s["cout"] <= 8 for s in _sites(*cell))
    assert launched["<16,1,8>"] == small


# the classes the rule picks at the cells' main shapes (b, h, w, cout)
@pytest.mark.parametrize("shape,cls", [
    ((8, 512, 512, 192), "<16,1,192>"),   # the ADM's 192 channels
    ((8, 256, 256, 192), "<16,1,192>"),
    ((8, 64, 64, 384), "<16,1,192>"),
    ((8, 16, 16, 768), "<16,1,128>"),     # small maps: more N-tiles
    ((128, 32, 32, 256), "<16,1,256>"),   # SR3 16->128 at 32^2, 16^2
    ((128, 16, 16, 512), "<16,1,256>"),
    ((128, 64, 64, 128), "<16,1,128>"),
    ((128, 128, 128, 64), "<16,1,64>"),
    ((128, 8, 8, 512), "<8,2,128>"),      # 8^2 maps: two images a tile
    ((8, 4, 4, 256), "<8,2,64>"),     # 8 items: more, narrower ones
    ((2, 8, 8, 40), "<8,2,64>"),
    ((8, 512, 512, 3), "<16,1,8>"),
    ((3, 8, 8, 3), "<16,1,8>"),           # C_out 3 on an 8^2 map
])
def test_class_choice_at_the_cells_shapes(shape, cls):
    p = plan_mirror.conv_plan(*shape)
    assert conv_fused.BF16_TILES[p["cls"]] == cls


def _covered_once(b, h, w, cout):
    p = plan_mirror.conv_plan(b, h, w, cout)
    blocks = plan_mirror.walk(b, h, w, cout)
    items = [it for block in blocks for it in block]
    assert sorted(items) == list(range(p["items"]))
    # a block's items run in order, one grid apart
    for x, block in enumerate(blocks):
        assert block == list(range(x, p["items"], p["grid"]))
    # the N-tiles of one pixel tile are neighbouring items
    assert all(plan_mirror.tile_of(p, i)[:3] == plan_mirror.tile_of(p, i + 1)[:3]
               for i in range(p["items"] - 1)
               if (i + 1) % p["n_tiles"])
    cls = p["cls"]
    tw, ni = plan_mirror.CLASS_TW[cls], plan_mirror.CLASS_NI[cls]
    bn = plan_mirror.CLASS_BN[cls]
    hits = np.zeros((b + ni, h + plan_mirror.TILE_ROWS, w + tw,
                     p["n_tiles"] * bn), np.int32)
    for it in items:
        b0, y0, x0, c0 = plan_mirror.tile_of(p, it)
        hits[b0:b0 + ni, y0:y0 + plan_mirror.TILE_ROWS, x0:x0 + tw,
             c0:c0 + bn] += 1
    assert (hits[:b, :h, :w, :cout] == 1).all()
    assert hits.max() == 1


@pytest.mark.parametrize("shape", RAGGED)
def test_walk_covers_every_item_once_at_ragged_shapes(shape):
    _covered_once(*shape)


def test_walk_covers_every_item_once_at_the_cells_sites():
    shapes = _shapes()
    assert len(shapes) >= 29
    for shape in shapes:
        _covered_once(*shape)
