"""The share of the network's device time in its resampling ResBlocks, %:
the program's ``unet.resample`` spans (a down / up ResBlock whole: the
GroupNorm+SiLU, the avg-pool or nearest upsample on both branches, the
plain conv and the scale-shift K1 call) over its ``chain.eps`` spans, each
summed over the traced steps."""

from portbench.metrics._program import device_ms


def read(summary):
    part, whole = device_ms("unet.resample"), device_ms("chain.eps")
    if part is None or not whole:
        return None
    return 100.0 * part / whole
