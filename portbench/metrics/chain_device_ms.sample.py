"""The chain's own device milliseconds a step, outside the network: the
posterior mean, the clamp and the noise draw. The program's ``chain.step``
spans less the ``chain.eps`` spans inside them, summed over the traced
steps, over the count of ``chain.step`` spans."""

from portbench.metrics._program import device_ms, spans_named


def read(summary):
    steps = spans_named("chain.step")
    step = device_ms("chain.step")
    eps = device_ms("chain.eps", under="chain.step")
    if not steps or step is None or eps is None:
        return None
    return (step - eps) / len(steps)
