"""Sample-quality metrics of a level batch: playability and diversity.

Port of ``levelgan/lio/quality.py``, with the flood-fill solver on the
device (``env.solver``):

- ``solvable_fraction``: solvable share and the well-formedness shares;
- ``mean_pairwise_hamming``: mean share of differing cells over pairs of
  a subsample (one-hot agreement as one matmul); 0.0 is total collapse;
- ``unique_fraction``: exact duplicate rate (host);
- ``tile_entropy``: marginal tile entropy in nats (host).
"""

from __future__ import annotations

import numpy as np
import torch

from levelgan_torch.device import resolve_device
from levelgan_torch.env.solver import solvable, well_formed


def playability(ids: torch.Tensor) -> dict[str, torch.Tensor]:
    """The solvable share and the well-formedness shares of a uint8
    [B, H, W] batch on its device, as 0-d f32 tensors."""
    # f32 sum times 1 / n: the rounding of jnp.mean (torch.mean divides)
    inv = 1.0 / ids.shape[0]
    out = {"solvable_frac": solvable(ids).float().sum() * inv}
    out.update({f"{k}_frac": v.float().sum() * inv
                for k, v in well_formed(ids).items()})
    return out


@torch.no_grad()
def solvable_fraction(levels: np.ndarray, device=None) -> dict[str, float]:
    """Playability shares of a uint8 [B, H, W] level batch."""
    ids = torch.from_numpy(np.ascontiguousarray(levels)).to(
        resolve_device(device))
    return {k: float(v) for k, v in playability(ids).items()}


def unique_fraction(levels: np.ndarray) -> float:
    """Fraction of exactly-unique levels in the batch (duplicate detector)."""
    flat = np.ascontiguousarray(levels).reshape(len(levels), -1)
    return len(np.unique(flat, axis=0)) / max(len(flat), 1)


@torch.no_grad()
def mean_pairwise_hamming(levels: np.ndarray, n_tiles: int,
                          sample: int = 256, seed: int = 0,
                          device=None) -> float:
    """Mean fraction of positions that differ between two distinct levels
    over a ``sample``-sized subsample (the same draw as the JAX package)."""
    k = min(sample, len(levels))
    if k < 2:
        return 0.0
    idx = np.random.default_rng(seed).choice(len(levels), k, replace=False)
    x = torch.from_numpy(np.ascontiguousarray(levels[idx].reshape(k, -1)))
    x = x.to(resolve_device(device)).long()
    oh = torch.nn.functional.one_hot(x, n_tiles).float().reshape(k, -1)
    ham = 1.0 - (oh @ oh.t()) / x.shape[1]
    return float((ham.sum() - torch.trace(ham)) / (k * (k - 1)))


def tile_entropy(levels: np.ndarray, n_tiles: int) -> float:
    """Entropy (nats) of the marginal tile distribution; 0 = single tile."""
    counts = np.bincount(np.asarray(levels, np.int64).ravel(),
                         minlength=n_tiles).astype(np.float64)
    p = counts / counts.sum()
    nz = p[p > 0]
    return float(-(nz * np.log(nz)).sum())


def quality_report(levels: np.ndarray, n_tiles: int, *, sample: int = 256,
                   seed: int = 0, device=None) -> dict[str, float]:
    """All quality metrics for a uint8 [B, H, W] level batch."""
    report = {"n_levels": int(len(levels))}
    report.update(solvable_fraction(levels, device))
    report["unique_frac"] = unique_fraction(levels)
    report["mean_pairwise_hamming"] = mean_pairwise_hamming(
        levels, n_tiles, sample=sample, seed=seed, device=device)
    report["tile_entropy_nats"] = tile_entropy(levels, n_tiles)
    return report
