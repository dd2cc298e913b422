"""The window's counted FLOPs (the reference's count a step, times the
steps) over its seconds, as a share of the card's bf16 peak, %."""

from portbench.costs import peaks_of


def read(summary):
    peaks = peaks_of(summary.get("device_name"))
    flops = summary.get("flops_per_step")
    if not peaks or not flops:
        return None
    rate = flops * summary["steps"] / summary["window_s"]
    return 100.0 * rate / peaks["bf16_flops"]
