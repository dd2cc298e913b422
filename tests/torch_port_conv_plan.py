"""A mirror of K1's bfloat16 conv launch plan (``csrc/conv_fused.cu``
``conv_plan``) and of the items each block of the Hopper kernel walks,
for the CPU tests (``tests/test_torch_port_conv_plan.py``); the card's
tests hold the C library's plan against it (``tests/test_torch_port_gpu.py``).
It imports neither JAX nor torch, so the card's tests, which run without
JAX, can import it. Change it with the C plan.
"""

SMS = 132  # an H100 SXM
TILE_ROWS = 8  # kWTH: rows of each image a tile
TILE_PIXELS = 128  # kWM
# the classes <TW, NI, BN> of csrc/conv_fused.cu (kClassTW, kClassNI,
# kClassBN), in the order sr3_gn_silu_conv3x3_tiles counts them: the
# Hopper kernel's six, then the small class (C_out <= 8)
CLASS_TW = (16, 16, 16, 16, 8, 8, 16)
CLASS_NI = (1, 1, 1, 1, 2, 2, 1)
CLASS_BN = (256, 192, 128, 64, 128, 64, 8)
SMALL_CLASS = len(CLASS_BN) - 1
ITEM_COST = 32  # kItemCost, in output channels
FIELDS = ("cls", "tiles_h", "tiles_w", "ptiles", "n_tiles", "items", "grid")


def ceil_div(a, b):
    return -(-a // b)


def plan_as(cls, b, h, w, cout, sms=SMS):
    tiles_h, tiles_w = ceil_div(h, TILE_ROWS), ceil_div(w, CLASS_TW[cls])
    ptiles = ceil_div(b, CLASS_NI[cls]) * tiles_h * tiles_w
    n_tiles = ceil_div(cout, CLASS_BN[cls])
    items = ptiles * n_tiles
    grid = items if cls == SMALL_CLASS or items < sms else sms
    return dict(zip(FIELDS, (cls, tiles_h, tiles_w, ptiles, n_tiles, items,
                             grid)))


def conv_plan(b, h, w, cout, sms=SMS):
    """The plan as a dict of FIELDS: the small class for C_out <= 8; else
    among the Hopper kernel's classes for the map's width (two images a
    tile on maps of width <= 8), the one whose waves of items times (BN +
    ITEM_COST) are least, the larger BN on a tie."""
    if cout <= CLASS_BN[SMALL_CLASS]:
        return plan_as(SMALL_CLASS, b, h, w, cout, sms)
    classes = range(4, 6) if w <= 8 else range(0, 4)
    best, least = None, None
    for cls in classes:
        p = plan_as(cls, b, h, w, cout, sms)
        cost = ceil_div(p["items"], sms) * (CLASS_BN[cls] + ITEM_COST)
        if least is None or cost < least:
            best, least = p, cost
    return best


def tile_of(p, item):
    """Item ``item``'s tile: (first image, first row, first column, first
    output channel) -- pixel tile item // n_tiles, N-tile item % n_tiles."""
    cls = p["cls"]
    pt, nt = divmod(item, p["n_tiles"])
    bz, r = divmod(pt, p["tiles_h"] * p["tiles_w"])
    ty, tx = divmod(r, p["tiles_w"])
    return (bz * CLASS_NI[cls], ty * TILE_ROWS, tx * CLASS_TW[cls],
            nt * CLASS_BN[cls])


def walk(b, h, w, cout, sms=SMS):
    """The items each block runs, in order: block x of the Hopper kernel's
    grid runs items x, x + grid, x + 2 grid, ...; a block of the small
    class runs its own item."""
    p = conv_plan(b, h, w, cout, sms)
    return [list(range(x, p["items"], p["grid"])) for x in range(p["grid"])]


def pixels_of(p, b, h, w, item):
    """The (image, row, column) output pixels of ``item``'s tile inside the
    (b, h, w) map, and its output channels as a range."""
    cls = p["cls"]
    b0, y0, x0, c0 = tile_of(p, item)
    pix = [(b0 + i, y0 + r, x0 + c) for i in range(CLASS_NI[cls])
           for r in range(TILE_ROWS) for c in range(CLASS_TW[cls])
           if b0 + i < b and y0 + r < h and x0 + c < w]
    return pix, range(c0, c0 + CLASS_BN[cls])
