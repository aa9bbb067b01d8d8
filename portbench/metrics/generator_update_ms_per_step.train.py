"""generator_update_ms_per_step.train: the device extents of the generator
update's loss and gradient (``g.loss``, ``g.grad``) over the profiled steps,
in ms."""

from portbench.spans import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "g.loss", "g.grad")
