"""Presence-prior schedules, port of part of ``levelgan/ops/presence.py``.

Only the two step schedules are ported here.  The presence penalty itself
(``presence_penalty``, used when ``train.w_presence > 0``) lands with the
structural-head training slice; the WGAN-GP step raises until then.
"""

from __future__ import annotations


def excess_weight_schedule(t, step: int) -> float:
    """Effective excess-hinge weight at ``step``: ``presence_excess``, or 0
    before ``presence_excess_start`` then a linear rise to it over
    ``presence_excess_ramp`` steps when a start or ramp is configured."""
    w = t.presence_excess
    if not w or not (t.presence_excess_start or t.presence_excess_ramp):
        return w
    frac = (step - t.presence_excess_start) / max(t.presence_excess_ramp, 1)
    return float(w) * min(max(frac, 0.0), 1.0)


def mbstd_scale_schedule(t, step: int) -> float | None:
    """Critic mbstd-channel multiplier at ``step``: None when the anneal is
    off, else a linear fade 1 -> ``mbstd_anneal_floor`` over
    [mbstd_anneal_start, mbstd_anneal_start + mbstd_anneal_steps)."""
    if not t.mbstd_anneal_steps:
        return None
    frac = (step - t.mbstd_anneal_start) / t.mbstd_anneal_steps
    frac = min(max(frac, 0.0), 1.0)
    return 1.0 - (1.0 - float(t.mbstd_anneal_floor)) * frac
