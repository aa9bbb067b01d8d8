"""fused_heads_per_request.export: launches of the fused sampling-head
kernel (the counter ``head.launches``) over the profiled requests; one a
batch where the export's head runs as that kernel.  A program that has
never counted the kernel (one without it) reads nothing."""

from portbench.spans import count_per_request


def read(rec):
    try:
        from levelgan_torch import obs
    except ImportError:
        return None
    if "head.launches" not in obs.counters:
        return None
    return count_per_request(rec, "head.launches")
