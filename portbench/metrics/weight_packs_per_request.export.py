"""weight_packs_per_request.export: the change of the stage kernels'
weight-pack counter (``k1.packs``) over the profiled requests."""

from portbench.spans import count_per_request


def read(rec):
    return count_per_request(rec, "k1.packs")
