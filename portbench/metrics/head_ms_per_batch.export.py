"""head_ms_per_batch.export: the device extent of the export's sampling head
(``export.head``: the Gumbel draw, argmax and decode) over the profiled
stretch's batches, in ms."""

from portbench.spans import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "export.head")
