"""The comparison that decides ``correct``: each number against its limit.

A number is a gap between what the timed path produced and what the
reference works out for the same inputs; it passes when it is finite and
at most its limit. A number that could not be read (a shape that differs,
a state that is missing) is infinite and fails.
"""

from __future__ import annotations

import math
import statistics

import torch


def per_image_rel_l2(got, want):
    """The largest over images of |got - want| / |want| (L2 norms of each
    image), or inf where the shapes differ."""
    if got is None or tuple(got.shape) != tuple(want.shape):
        return math.inf
    d = (got.float() - want).flatten(1).norm(dim=1)
    return float((d / want.flatten(1).norm(dim=1).clamp_min(1e-30)).max())


def _leaf_gaps(got, want, keep, relative):
    names = [n for n in want if keep is None or n in keep]
    med = statistics.median(want[n] for n in names) if names else 0.0
    out = {}
    for n in names:
        if relative:
            g = got.get(n, math.inf)
        else:
            g = abs(got.get(n, 0.0) - want[n])
        out[n] = g / max(want[n], med, 1e-30) if math.isfinite(g) else g
    return out


def worst_leaf_gap(got, want, keep=None, relative=False):
    """(gap, leaf): the largest over leaves of |got - want| / max(want,
    the median of want), gaps between per-leaf norms, and its leaf; with
    ``relative``, ``got`` holds the norms of the differences themselves.
    ``keep`` (names) limits the leaves; a leaf missing from ``got`` reads
    0 (with ``relative``: inf)."""
    gaps = _leaf_gaps(got, want, keep, relative)
    if not gaps:
        return math.inf, None
    leaf = max(gaps, key=lambda n: gaps[n])
    return gaps[leaf], leaf


def median_leaf_gap(got, want, relative=False):
    """The median over leaves of the gaps of ``worst_leaf_gap``."""
    gaps = _leaf_gaps(got, want, None, relative)
    return statistics.median(gaps.values()) if gaps else math.inf


def leaf_norms(named):
    """{name: float L2 norm} of named tensors, in one device read."""
    names = list(named)
    if not names:
        return {}
    norms = torch.stack(torch._foreach_norm([named[n].float()
                                             for n in names])).cpu()
    return dict(zip(names, norms.tolist()))


def judge(numbers, limits):
    """(correct, {name: {"value", "limit"}}) over the limits' names."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"no reading of {missing}")
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out
