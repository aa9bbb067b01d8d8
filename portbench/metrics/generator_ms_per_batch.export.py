"""generator_ms_per_batch.export: the device extent of the export's generator
(``export.generator``: the linear, K1 on three stages, the K1L stage and
to_tiles) over the profiled stretch's batches, in ms."""

from portbench.spans import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "export.generator")
