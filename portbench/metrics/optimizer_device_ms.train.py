"""The train step's Adam update and EMA, device milliseconds a step: the
program's ``trainer.optimizer`` spans over the traced steps'
``trainer.step`` spans."""

from portbench.metrics._program import per_step


def read(summary):
    return per_step("trainer.optimizer", "trainer.step")
