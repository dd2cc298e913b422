"""The train step's forward (the loss through the UNet), device
milliseconds a step: the program's ``trainer.forward`` spans over the
traced steps' ``trainer.step`` spans."""

from portbench.metrics._program import per_step


def read(summary):
    return per_step("trainer.forward", "trainer.step")
