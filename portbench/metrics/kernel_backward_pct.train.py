"""The share of the backward's device time spent in the kernel backwards
of K1 and K2 (K1's activation recompute, its conv's gradients and the
GroupNorm(+SiLU) backward kernel; K2's and the statistics route's backward
kernel), %: the program's outermost ``ops.kernel_backward`` spans inside a
``trainer.backward`` span, over the ``trainer.backward`` spans."""

from portbench.metrics._program import device_ms


def read(summary):
    kernel = device_ms("ops.kernel_backward", under="trainer.backward")
    whole = device_ms("trainer.backward")
    if kernel is None or not whole:
        return None
    return 100.0 * kernel / whole
