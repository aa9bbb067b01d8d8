"""Whether a conditional tile model obeys its condition: the port of what
``tools/eval_cond.py`` computes.

1. **Response sweep.**  Each of the four condition dims (``data/
   features.FEATURE_NAMES``) is swept over the corpus's own q10-q90 at
   ``points`` values, the other dims held at the corpus mean; the levels
   generated at each point are measured with ``level_features`` and the
   requested values are held against the realized means
   (``lio/stats.response_stats``: Pearson r, OLS slope, MAE).  goal_dist
   is measured on the levels that hold both START and GOAL only; a dim
   that some point leaves with none is unmeasurable.
2. **Bucketed per-position chi-square.**  The corpus is split into
   ``BUCKETS`` quantile buckets of each feature; the model is asked for
   each bucket's mean feature vector and its levels are held against that
   bucket's corpus levels (``lio/stats.per_position_chi2``).
3. **Calibration fit** (``fit_calibration``): the internal condition is
   swept over ``CAL_SPAN`` times the q10-q90 half-band at ``cal_points``
   values a dim and ``lio/calibration.fit_from_sweeps`` fits the inverse
   response.

Generation is the caller's ``sample(cond, seed) -> uint8 levels [n, H,
W]`` (``export.generate`` in ``cli/validate``: the model runs on the
card); with a ``calibration`` every requested condition goes through
``apply_calibration`` first.  Each point's seed is eval_cond's: the sweep
``seed + 1000 d + j``, the fit ``seed + 5000 (d + 1) + j``, the buckets
``seed + 7000 + 100 d + b``.  Features are computed on ``device``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from levelgan_torch.config import GOAL, START
from levelgan_torch.data.features import (FEATURE_NAMES, batched_features,
                                          level_features)
from levelgan_torch.lio.calibration import apply_calibration, fit_from_sweeps
from levelgan_torch.lio.stats import (per_position_chi2, quantile_buckets,
                                      response_stats)

Sampler = Callable[[np.ndarray, int], np.ndarray]
THRESHOLD = 0.5      # the gate: the least per-dim Pearson r
BUCKETS = 3          # corpus quantile buckets a feature
CAL_SPAN = 4.0       # the fit's half-width, in q10-q90 half-bands


def features(levels: np.ndarray, device=None) -> np.ndarray:
    """``level_features`` of host levels -> host [N, 4]."""
    return batched_features(level_features, levels, device=device)


def _measure(d: int, levels: np.ndarray, f: np.ndarray):
    """(the mean realized feature of dim ``d``, the share of levels that
    hold START and GOAL for goal_dist else None).  The extractor puts an
    absent tile at cell (0, 0), so goal_dist reads valid levels only."""
    if FEATURE_NAMES[d] != "goal_dist":
        return float(f[:, d].mean()), None
    valid = (levels == START).any(axis=(1, 2)) & (levels == GOAL).any(
        axis=(1, 2))
    f = f[valid] if valid.any() else f[:0]
    return (float(f[:, d].mean()) if len(f) else float("nan"),
            float(valid.mean()))


def _band(feats: np.ndarray, d: int):
    return np.quantile(feats[:, d], [0.10, 0.90])


def causality_report(sample: Sampler, corpus: np.ndarray, n_tiles: int, *,
                     feats: np.ndarray | None = None, points: int = 5,
                     seed: int = 0, calibration: dict | None = None,
                     fit_calibration: bool = False, cal_points: int = 9,
                     meta: dict | None = None,
                     device=None) -> tuple[dict, dict | None]:
    """(the report eval_cond prints, the fitted calibration or None).
    ``feats``: the corpus's features when the caller has them."""
    if fit_calibration and calibration is not None:
        raise ValueError("the calibration fit runs on the raw internal "
                         "response; pass no calibration with it")
    if feats is None:
        feats = features(corpus, device)
    mean_feat = feats.mean(axis=0)

    def realized(cond, s):
        cond = np.asarray(cond, np.float32)
        if calibration is not None:
            cond = apply_calibration(calibration, cond)
        levels = sample(cond, s)
        return levels, features(levels, device)

    report = {"points": points, "calibrated": calibration is not None,
              "threshold": THRESHOLD,
              "corpus_feature_mean": mean_feat.tolist(), "dims": {}}

    # ---- 1. the response sweep of each dim -------------------------------
    for d, name in enumerate(FEATURE_NAMES):
        lo, hi = _band(feats, d)
        if hi <= lo:       # a constant corpus feature: reported, skipped
            report["dims"][name] = {"skipped": "constant corpus feature",
                                    "pearson_r": None}
            continue
        requested = np.linspace(lo, hi, points)
        means, valid_fracs = [], []
        for j, v in enumerate(requested):
            cond = mean_feat.copy()
            cond[d] = v
            levels, f = realized(cond, seed + 1000 * d + j)
            mean_r, vf = _measure(d, levels, f)
            means.append(mean_r)
            if vf is not None:
                valid_fracs.append(vf)
        if any(np.isnan(means)):
            report["dims"][name] = {
                "skipped": "no levels carry both START and GOAL at some "
                           "sweep points — dim unmeasurable (train with "
                           "w_presence to make it exist)",
                "valid_frac": valid_fracs, "pearson_r": None}
            continue
        row = response_stats(requested, np.asarray(means))
        if valid_fracs:
            row["valid_frac"] = valid_fracs
        report["dims"][name] = row

    # ---- 1b. the calibration fit: a widened internal sweep ---------------
    cal = None
    if fit_calibration:
        sweeps = {}
        for d, name in enumerate(FEATURE_NAMES):
            lo, hi = _band(feats, d)
            if hi <= lo:
                continue
            center, half = (hi + lo) / 2.0, (hi - lo) / 2.0
            internal = center + half * np.linspace(-CAL_SPAN, CAL_SPAN,
                                                   cal_points)
            means = []
            for j, v in enumerate(internal):
                cond = mean_feat.copy()
                cond[d] = v
                levels, f = realized(cond, seed + 5000 * (d + 1) + j)
                means.append(_measure(d, levels, f)[0])
            sweeps[name] = {"internal": internal.tolist(), "realized": means}
        cal = fit_from_sweeps(FEATURE_NAMES, sweeps,
                              meta={**(meta or {}), "cal_span": CAL_SPAN,
                                    "seed": seed})

    # ---- 2. the bucketed per-position chi-square -------------------------
    rows_by_dim = {}
    for d, name in enumerate(FEATURE_NAMES):
        rows = []
        for b, idx in enumerate(quantile_buckets(feats[:, d], BUCKETS)):
            if len(idx) < 8:
                continue
            cond = feats[idx].mean(axis=0)
            levels, f = realized(cond, seed + 7000 + 100 * d + b)
            chi2 = per_position_chi2(levels, corpus[idx], n_tiles)
            rows.append({"bucket": b, "n_corpus": int(len(idx)),
                         "requested": float(cond[d]),
                         "realized": float(f[:, d].mean()),
                         "chi2_per_dof_mean": chi2["chi2_per_dof_mean"]})
        rows_by_dim[name] = rows
    report["bucketed_chi2"] = rows_by_dim

    rs = [v["pearson_r"] for v in report["dims"].values()
          if v.get("pearson_r") is not None]
    report["min_pearson_r"] = min(rs) if rs else None
    # an unmeasurable dim fails the gate; only a constant corpus excuses one
    unmeasurable = any("unmeasurable" in str(v.get("skipped", ""))
                       for v in report["dims"].values())
    report["passed"] = (bool(rs) and not unmeasurable
                        and report["min_pearson_r"] >= THRESHOLD)
    return report, cal
