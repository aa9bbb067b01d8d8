"""host_syncs_per_batch.export: host-blocking CUDA synchronisations in the
profiled export stretch over its batches."""

from portbench.readers import host_syncs_per_unit as read  # noqa: F401
