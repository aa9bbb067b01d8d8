"""device_ops_per_step.train: device operations in the profiled train steps over
the steps."""

from portbench.readers import device_ops_per_unit as read  # noqa: F401
