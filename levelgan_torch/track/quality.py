"""Track sample quality: port of ``levelgan/track/quality.py``.

A track is good if a competent driver can lap it.  The evaluator is a
scripted proportional driver (curvature feed-forward plus PD on the
lateral offset and heading error, speed scheduled against the largest
upcoming |curvature|) rolled through the race dynamics
(``track/race.py``), so the metric needs no trained agent.  Geometry
metrics beside it: heading-closure error (a closed circuit turns by
exactly +-2*pi), curvature-bound and width-range violations.

The rollout runs on the tracks' device and only the scalar shares cross
to the host; the diversity term (mean pairwise curvature L1 over at most
128 tracks) is NumPy.
"""

from __future__ import annotations

import numpy as np
import torch

from levelgan_torch.device import resolve_device
from levelgan_torch.track.data import KAPPA_MAX, WIDTH_MAX, WIDTH_MIN
from levelgan_torch.track.ops import TWO_PI
from levelgan_torch.track.race import (CarState, RaceParams, _seg_lookup,
                                       _window, init_cars, race_step)


def scripted_action(tracks: torch.Tensor, car: CarState,
                    p: RaceParams) -> torch.Tensor:
    """The scripted driver's discrete action [B] (int64) in ``car``'s
    state: steering from the feed-forward plus PD control quantised to
    {-1, 0, 1} with a dead zone of 0.2, throttle bang-bang toward
    v_max / (1 + 4 max |kappa| over the next 4 segments)."""
    kappa, width = tracks[..., 0], tracks[..., 1]
    k_here = _seg_lookup(kappa, car.s)
    w_half = 0.5 * _seg_lookup(width, car.s) + 1e-6
    ff = k_here * car.v * torch.cos(car.psi) / p.steer_rate
    ctrl = ff - 1.0 * (car.d / w_half) - 2.0 * torch.sin(car.psi)
    steer = torch.sign(ctrl) * (ctrl.abs() > 0.2).float()
    k_pre = _window(kappa.abs(), car.s, 4).max(dim=-1).values
    v_tgt = p.v_max / (1.0 + 4.0 * k_pre)
    thr = torch.sign(v_tgt - car.v)
    return ((thr + 1.0) * 3.0 + (steer + 1.0)).to(torch.int64)


@torch.no_grad()
def scripted_rollout(tracks: torch.Tensor, p: RaceParams):
    """The scripted driver for ``p.rollout_steps``: per track (progress [B]
    in segments incl. laps, laps [B], crashes [B])."""
    car = init_cars(tracks.shape[0], tracks.device)
    crashes = torch.zeros((tracks.shape[0],), device=tracks.device)
    for _ in range(p.rollout_steps):
        car, _, crashed = race_step(tracks, car,
                                    scripted_action(tracks, car, p), p)
        crashes = crashes + crashed.float()
    return car.laps * tracks.shape[1] + car.s, car.laps, crashes


def default_horizon(n_segments: int) -> int:
    """3x the steps a full-speed car needs for a lap."""
    p = RaceParams()
    return int(3 * n_segments / (p.v_max * p.dt))


def track_quality_report(tracks: np.ndarray, *,
                         rollout_steps: int | None = None,
                         device=None) -> dict[str, float]:
    """Every track quality metric of a float32 [B, T, 2] batch."""
    dev = resolve_device(device)
    t = tracks.shape[1]
    p = RaceParams(rollout_steps=rollout_steps or default_horizon(t))
    tk = torch.as_tensor(np.asarray(tracks, np.float32), device=dev)
    progress, laps, crashes = scripted_rollout(tk, p)
    kappa, width = tk[..., 0], tk[..., 1]
    closure = (kappa.sum(-1).abs() - TWO_PI).abs()
    shares = {
        "lap_frac": (laps >= 1.0).float().mean(),
        "mean_progress_segments": progress.mean(),
        "mean_crashes": crashes.mean(),
        "closure_error_rad_mean": closure.mean(),
        "closure_ok_frac": (closure < 0.5).float().mean(),
        "kappa_violation_frac": (kappa.abs() > KAPPA_MAX + 1e-4
                                 ).float().mean(),
        "width_violation_frac": ((width < WIDTH_MIN - 1e-4)
                                 | (width > WIDTH_MAX + 1e-4)).float().mean(),
    }
    out = {k: float(v) for k, v in
           zip(shares, torch.stack(list(shares.values())).cpu().tolist())}
    out["n_tracks"] = int(len(tracks))
    out["rollout_steps"] = int(p.rollout_steps)
    k = min(128, len(tracks))
    kap = np.asarray(tracks[:k, :, 0])
    diff = np.abs(kap[:, None, :] - kap[None, :, :]).mean(-1)
    out["mean_pairwise_kappa_l1"] = float(
        (diff.sum() - np.trace(diff)) / max(k * (k - 1), 1))
    return out
