"""Condition-response calibration: requested -> internal cond map.

NumPy-only copy of ``levelgan/lio/calibration.py`` (the motivation and
its measurements are in that module's note).  A trained conditional
generator obeys its condition in direction but at attenuated magnitude;
the calibration stores, per feature dim, a measured (internal, realized)
response curve, and ``apply_calibration`` maps a requested feature vector
through the inverse curve (clamped to the achievable band).  It is stored
as ``cond_calibration.json`` next to the checkpoint, fitted by
``python -m levelgan_torch.cli.validate --fit-calibration``
(``lio/causality.py``) and applied by ``python -m
levelgan_torch.cli.export --calibrated``.
"""

from __future__ import annotations

import json
import os

import numpy as np

CAL_FILENAME = "cond_calibration.json"


def fit_from_sweeps(feature_names, sweeps: dict, meta: dict | None = None
                    ) -> dict:
    """Build a calibration from per-dim internal-sweep measurements.

    sweeps: name -> {"internal": [P], "realized": [P]} (NaN realized points
    — e.g. goal_dist unmeasurable at extreme internals — are dropped).
    Realized is made monotone non-decreasing along increasing internal via
    a running max (the causality gate guarantees the net response is
    positive on every dim it passes), with an epsilon tie-break so the
    inverse interp stays well-defined.
    """
    cal = {"feature_names": list(feature_names), "dims": {}}
    cal.update(meta or {})
    for name, row in sweeps.items():
        internal = np.asarray(row["internal"], np.float64)
        realized = np.asarray(row["realized"], np.float64)
        ok = np.isfinite(realized) & np.isfinite(internal)
        internal, realized = internal[ok], realized[ok]
        if len(internal) < 2:
            continue
        order = np.argsort(internal)
        internal, realized = internal[order], realized[order]
        realized = np.maximum.accumulate(realized)
        realized = realized + np.arange(len(realized)) * 1e-9
        cal["dims"][name] = {
            "internal": internal.tolist(),
            "realized": realized.tolist(),
            "achievable": [float(realized[0]), float(realized[-1])],
        }
    return cal


def apply_calibration(cal: dict, cond: np.ndarray) -> np.ndarray:
    """Map a requested feature vector (user space) to the internal cond.

    cond: [..., cond_dim] in the order of ``cal['feature_names']``.
    Dims without a fitted curve pass through unchanged; requests outside a
    dim's achievable band clamp to the widest measured internal value.
    """
    cond = np.asarray(cond, np.float32)
    out = cond.copy()
    for d, name in enumerate(cal["feature_names"]):
        row = cal["dims"].get(name)
        if not row or d >= cond.shape[-1]:
            continue
        out[..., d] = np.interp(cond[..., d], row["realized"],
                                row["internal"]).astype(np.float32)
    return out


def calibration_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, CAL_FILENAME)


def save_calibration(ckpt_dir: str, cal: dict) -> str:
    path = calibration_path(ckpt_dir)
    with open(path, "w") as f:
        json.dump(cal, f, indent=2)
        f.write("\n")
    return path


def load_calibration(ckpt_dir: str) -> dict:
    path = calibration_path(ckpt_dir)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no {CAL_FILENAME} under {ckpt_dir!r} — fit one with "
            "`python -m levelgan_torch.cli.validate --ckpt <dir> "
            "--fit-calibration` or fit_from_sweeps + save_calibration")
    with open(path) as f:
        return json.load(f)
