"""critic_ms_per_step.train: the device extents of the critic iterations' work
(``critic.fake``, ``critic.loss`` and ``critic.grad``: the fake batch, D on
both batches with the GP's forward, the gradient with the GP's double
backward) over the profiled steps, in ms."""

from portbench.spans import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "critic.fake", "critic.loss",
                              "critic.grad")
