"""Feature vectors of levels, the condition of the conditional family.

Port of ``levelgan/data/features.py``.  Features (cond_dim 4): [wall
fraction, hazard fraction, coin fraction, normalised START->GOAL L1
distance], each in [0, 1].  ``level_features`` reads hard levels;
``soft_level_features`` is its differentiable twin on a relaxed or
straight-through one-hot sample (exact soft fractions; the distance with
straight-through positions: the hard argmax cell forward, the
probability-weighted mean position backward), for conditional training.
Where START and GOAL sit in one row or column the distance term is |0|:
the JAX package's forward there is (hard + soft) - soft, a few ulps either
side of 0 by its rounding, so the sign of that term's gradient follows
the rounding; the port's forward is exactly the hard cell and takes
JAX's derivative of |x| at 0 (+1).
"""

from __future__ import annotations

import numpy as np
import torch

from levelgan_torch.config import COIN, GOAL, HAZARD, START, WALL
from levelgan_torch.device import resolve_device
from levelgan_torch.track.ops import track_features

FEATURE_NAMES = ("wall_frac", "hazard_frac", "coin_frac", "goal_dist")
N_FEATURES = 4


def level_features(ids: torch.Tensor) -> torch.Tensor:
    """uint8 tile ids [B, H, W] -> features [B, 4] f32 on ids' device."""
    b, h, w = ids.shape
    area = h * w

    def frac(tile):
        return (ids == tile).sum(dim=(1, 2)).float() / area

    def pos_of(tile):
        # first occurrence (cell 0 if absent), as jnp.argmax gives it
        idx = torch.argmax((ids == tile).reshape(b, -1).to(torch.uint8),
                           dim=-1)
        return idx // w, idx % w

    sr, sc = pos_of(START)
    gr, gc = pos_of(GOAL)
    dist = ((sr - gr).abs() + (sc - gc).abs()).float() / (h + w)
    return torch.stack([frac(WALL), frac(HAZARD), frac(COIN), dist], dim=-1)


def soft_level_features(sample: torch.Tensor) -> torch.Tensor:
    """Differentiable twin of ``level_features`` on a sample
    [B, H, W, n_tiles] -> [B, 4]; equal to it on one-hot inputs."""
    b, h, w, _ = sample.shape
    area = h * w
    sample = sample.float()

    def frac(tile):
        return sample[..., tile].sum(dim=(1, 2)) / area

    rows = torch.arange(h, dtype=torch.float32, device=sample.device)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=sample.device)[None, :]

    def st_pos(tile):
        p = sample[..., tile]
        z = p.sum(dim=(1, 2)) + 1e-6
        soft_r = (p * rows).sum(dim=(1, 2)) / z
        soft_c = (p * cols).sum(dim=(1, 2)) / z
        idx = torch.argmax(p.reshape(b, -1), dim=-1)
        hard_r = (idx // w).float()
        hard_c = (idx % w).float()
        # hard + (soft - soft): exactly the hard cell forward, so START
        # and GOAL in one row or column give a difference of exactly 0
        return (hard_r + (soft_r - soft_r.detach()),
                hard_c + (soft_c - soft_c.detach()))

    sr, sc = st_pos(START)
    gr, gc = st_pos(GOAL)
    dist = (_abs(sr - gr) + _abs(sc - gc)) / (h + w)
    return torch.stack([frac(WALL), frac(HAZARD), frac(COIN), dist], dim=-1)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative at 0 (+1; ``torch.abs`` gives 0 there)."""
    return torch.where(x >= 0, x, -x)


@torch.no_grad()
def batched_features(feature_fn, data: np.ndarray, batch: int = 4096,
                     device=None) -> np.ndarray:
    """``feature_fn`` over a host corpus in fixed-size batches on
    ``device`` -> host float array [N, F] (bounded device memory)."""
    dev = resolve_device(device)
    out = [feature_fn(torch.from_numpy(np.ascontiguousarray(
        data[i:i + batch])).to(dev)).cpu().numpy()
        for i in range(0, len(data), batch)]
    return np.concatenate(out, axis=0)


def corpus_mean_cond(cfg, ds, device=None) -> np.ndarray:
    """The whole corpus's mean feature vector: the default export
    condition of a conditional model (``level_features`` over the tile
    corpus, ``track.ops.track_features`` over a track corpus)."""
    if cfg.model.family == "track":
        feats = batched_features(track_features, np.asarray(ds.tracks),
                                 device=device)
    else:
        feats = batched_features(level_features, np.asarray(ds.levels),
                                 device=device)
    return feats.mean(axis=0)
