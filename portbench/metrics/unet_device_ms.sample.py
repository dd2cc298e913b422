"""The network's device milliseconds a chain step: the program's
``chain.eps`` spans (the UNet's call inside each step) summed over the
traced steps, over the count of ``chain.step`` spans."""

from portbench.metrics._program import per_step


def read(summary):
    return per_step("chain.eps", "chain.step")
