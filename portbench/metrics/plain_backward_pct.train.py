"""The share of the backward's device time spent in the plain PyTorch
backwards of K1 and K2 (the recompute under autograd, the GroupNorm hand
formula), %: the program's outermost ``ops.plain_backward`` spans inside
a ``trainer.backward`` span, over the ``trainer.backward`` spans."""

from portbench.metrics._program import device_ms


def read(summary):
    plain = device_ms("ops.plain_backward", under="trainer.backward")
    whole = device_ms("trainer.backward")
    if plain is None or not whole:
        return None
    return 100.0 * plain / whole
