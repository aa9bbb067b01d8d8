"""optimizer_ms_per_step.train: the device extents of every Adam step
(``optim.adam``) and of G's EMA (``train.ema``) over the profiled steps, in
ms."""

from portbench.spans import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "optim.adam", "train.ema")
