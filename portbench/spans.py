"""What the per-layer metrics read from the program's own spans and
counters (``levelgan_torch.obs``): the last profiler session, which is the
profiled stretch, over the stretch's units (batches or steps) or its
requests.  Each returns ``None`` where the program keeps no such record (a
checkout without ``obs``) or the session holds no span of the kind."""

from __future__ import annotations


def _session(rec):
    if rec.get("stretch") is None or not rec["stretch"].units:
        return None
    try:
        from levelgan_torch import obs
    except ImportError:
        return None
    s = obs.last_session()
    return s if s.spans else None


def device_ms_per_unit(rec, *names):
    """The summed device extents of the spans ``names`` over the stretch's
    units, in ms."""
    s = _session(rec)
    if s is None:
        return None
    total = s.device_s(*names)
    return None if total is None else 1e3 * total / rec["stretch"].units


def count_per_request(rec, name):
    """The session's change of the counter ``name`` over its requests."""
    s = _session(rec)
    reqs = s.named("export.request") if s is not None else []
    if not reqs:
        return None
    return s.counters.get(name, 0) / len(reqs)
