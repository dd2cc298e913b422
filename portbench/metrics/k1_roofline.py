"""Kernel K1's share of its roofline in the traced steps, %: the least time
of its calls (``costs.k1_least_seconds``) over the device time of its
statistics and conv launches. Nothing is read where the trace's conv
launches are not one per call the architecture makes."""

from portbench.costs import k1_least_seconds, peaks_of

CONV, STATS = "gn_silu_conv3x3", "gn_stats_kernel"


def read(summary):
    tr, sites = summary.get("trace"), summary.get("k1_sites")
    peaks = peaks_of(summary.get("device_name"))
    if not tr or not sites or not peaks:
        return None
    ops = tr["device_ops"]
    convs = sum(c for name, c in tr["launch_counts"].items() if CONV in name)
    if convs != len(sites) * tr["steps"]:
        return None
    busy = sum(s for name, s in ops.items() if CONV in name or STATS in name)
    if busy <= 0:
        return None
    least = k1_least_seconds(sites, peaks) * tr["steps"]
    return 100.0 * least / busy
