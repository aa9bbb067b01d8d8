"""Statistical-identity gates of generated levels against a corpus.

NumPy-only copy of ``levelgan/lio/stats.py``: the tile-marginal KL gate
(add-one smoothed), the per-position chi-square of gen vs ref per-cell
tile distributions (with per-channel breakdowns), quantile buckets of a
feature, and the response statistics of conditioning along one feature.
"""

from __future__ import annotations

import numpy as np


def per_position_counts(levels: np.ndarray, n_tiles: int) -> np.ndarray:
    """uint8 [N, H, W] -> counts [H, W, n_tiles]."""
    n, h, w = levels.shape
    out = np.zeros((h, w, n_tiles), np.int64)
    for t in range(n_tiles):
        out[..., t] = (levels == t).sum(axis=0)
    return out


def per_position_chi2(gen_levels: np.ndarray, ref_levels: np.ndarray,
                      n_tiles: int, channels: dict | None = None) -> dict:
    """Mean per-cell chi-square statistic of gen vs ref per-position
    tile distributions (expected counts from ref, add-one smoothed),
    normalized per generated sample.  Returns summary stats.

    ``channels`` (name -> tuple of tile ids) adds per-subset breakdowns —
    the per-cell chi2 contribution restricted to those tile channels, one
    dof per channel.  Used to isolate the STRUCTURAL channels
    (START/GOAL): the presence prior's measured positional collapse lives
    there while the full-vocabulary statistic dilutes it 4x
    (BASELINE.md "Sample quality")."""
    n_gen = len(gen_levels)
    gen_c = per_position_counts(gen_levels, n_tiles).astype(np.float64)
    ref_c = per_position_counts(ref_levels, n_tiles).astype(np.float64)
    ref_p = (ref_c + 1.0) / (ref_c.sum(-1, keepdims=True) + n_tiles)
    expected = ref_p * n_gen
    contrib = (gen_c - expected) ** 2 / expected   # [H, W, n_tiles]
    chi2 = contrib.sum(-1)                         # [H, W]
    dof = n_tiles - 1
    out = {
        "chi2_mean": float(chi2.mean()),
        "chi2_max": float(chi2.max()),
        "dof": dof,
        # per-cell chi2/dof ~ 1 when distributions match
        "chi2_per_dof_mean": float(chi2.mean() / dof),
    }
    for name, tiles in (channels or {}).items():
        sub = contrib[..., list(tiles)]            # [H, W, |tiles|]
        out[f"chi2_per_dof_{name}"] = float(sub.mean())
    return out


def quantile_buckets(values: np.ndarray, n_buckets: int) -> list[np.ndarray]:
    """Split corpus indices into ``n_buckets`` quantile buckets of a scalar
    feature.  Returns a list of index arrays (some may be small if the
    feature is heavily tied — e.g. goal_dist on a gridded corpus)."""
    edges = np.quantile(values, np.linspace(0, 1, n_buckets + 1))
    # merge tied edges so every bucket is a genuine half-open interval
    edges = np.unique(edges)
    out = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        mask = (values >= lo) & ((values < hi) if hi < edges[-1]
                                 else (values <= hi))
        out.append(np.nonzero(mask)[0])
    return out


def response_stats(requested: np.ndarray, realized: np.ndarray) -> dict:
    """Causality of conditioning along one feature dim.

    requested: [P] swept condition values; realized: [P] mean measured
    feature of the levels generated at each sweep point.  Reports the
    Pearson correlation (the gate quantity: ~1 when the generator obeys
    the condition, ~0 when it ignores it), the OLS slope (ideal 1.0 —
    <1 means attenuated response), and the mean absolute requested-vs-
    realized error."""
    requested = np.asarray(requested, np.float64)
    realized = np.asarray(realized, np.float64)
    dq = requested - requested.mean()
    dr = realized - realized.mean()
    qss, rss = float(dq @ dq), float(dr @ dr)
    if qss == 0.0 or rss == 0.0:
        r, slope = 0.0, 0.0
    else:
        r = float((dq @ dr) / np.sqrt(qss * rss))
        slope = float(dq @ dr) / qss
    return {
        "pearson_r": r,
        "slope": slope,
        "mae": float(np.abs(requested - realized).mean()),
        "requested": requested.tolist(),
        "realized": realized.tolist(),
    }


def kl_gate(gen_levels: np.ndarray, ref_counts: np.ndarray, n_tiles: int,
            threshold: float) -> dict:
    gen_counts = np.bincount(np.asarray(gen_levels).reshape(-1),
                             minlength=n_tiles)[:n_tiles].astype(np.float32)
    p = np.asarray(gen_counts, np.float64) + 1.0
    q = np.asarray(ref_counts, np.float64) + 1.0
    p, q = p / p.sum(), q / q.sum()
    kl = float(np.sum(p * (np.log(p) - np.log(q))))
    return {"kl": kl, "threshold": threshold, "passed": kl <= threshold,
            "tiles_sampled": int(gen_levels.size)}
