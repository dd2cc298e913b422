"""The share of the network's device time in its attention blocks, %: the
program's ``unet.attention`` spans (GroupNorm, the qkv projection, the
multi-head attention and the output projection with its residual) over
its ``chain.eps`` spans, each summed over the traced steps."""

from portbench.metrics._program import device_ms


def read(summary):
    part, whole = device_ms("unet.attention"), device_ms("chain.eps")
    if part is None or not whole:
        return None
    return 100.0 * part / whole
