"""The train step's backward (with remat, its replayed forward too),
device milliseconds a step: the program's ``trainer.backward`` spans over
the traced steps' ``trainer.step`` spans."""

from portbench.metrics._program import per_step


def read(summary):
    return per_step("trainer.backward", "trainer.step")
