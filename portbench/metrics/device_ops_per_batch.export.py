"""device_ops_per_batch.export: device operations in the profiled export stretch
over its 1024-level batches."""

from portbench.readers import device_ops_per_unit as read  # noqa: F401
