"""On-device track transforms: port of ``levelgan/track/ops.py``.

The track family's twins of the tile family's D4 augmentation, tile
histogram and feature vector, and its two closure operations:

- ``track_augment``: per-sample cyclic shift and mirror (reverse the
  sequence, negate the curvature), with the shifts and flips injected or
  drawn from a ``torch.Generator``;
- ``curvature_hist_device``: curvature-bin counts against the NumPy f32
  edges of ``track.data.curvature_histogram``, so the two agree bit for
  bit;
- ``track_features``: the symmetry-invariant condition vector [B, 4];
- ``closure_project``: the exact heading-closure projection (export repair
  and ``model.closure_in_model``).  Its clip is ``jnp.clip``'s
  ``minimum(maximum(x, lo), hi)``: at a tie both packages pass half the
  gradient (``torch.clamp`` would pass all of it), and ties occur, since
  the second pass leaves clipped segments exactly at the bound;
- ``closure_penalty``: the ``train.w_closure`` prior.
"""

from __future__ import annotations

import math

import torch

from levelgan_torch.track.data import (KAPPA_MAX, WIDTH_MAX, WIDTH_MIN,
                                       curvature_edges)

TWO_PI = 2.0 * math.pi


def draw_augment(batch: int, n_segments: int, device,
                 generator: torch.Generator | None = None):
    """(shifts [B] int64 in [0, T), flips [B] bool) for ``track_augment``."""
    shifts = torch.randint(0, n_segments, (batch,), device=device,
                           generator=generator)
    flips = torch.rand((batch,), device=device, generator=generator) < 0.5
    return shifts, flips


def track_augment(tracks: torch.Tensor, shifts: torch.Tensor,
                  flips: torch.Tensor) -> torch.Tensor:
    """tracks [B, T, 2] rolled by ``shifts`` along T (``jnp.roll``: out[i] =
    in[i - shift]), then mirrored where ``flips``."""
    b, t, c = tracks.shape
    idx = (torch.arange(t, device=tracks.device)[None, :]
           - shifts.to(tracks.device)[:, None]) % t
    rolled = tracks.gather(1, idx[..., None].expand(b, t, c))
    sign = torch.tensor([-1.0, 1.0], dtype=tracks.dtype, device=tracks.device)
    mirrored = rolled.flip(1) * sign
    return torch.where(flips.to(tracks.device)[:, None, None], mirrored,
                       rolled)


def curvature_hist_device(tracks: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Curvature-bin counts [n_bins] f32 on the tracks' device (the binning
    of ``track.data.curvature_histogram``, ``np.digitize`` =
    ``searchsorted(side='right')``)."""
    kappa = tracks[..., 0].reshape(-1).float().contiguous()
    edges = torch.from_numpy(curvature_edges(n_bins)).to(kappa.device)
    idx = torch.searchsorted(edges, kappa, right=True)
    return torch.bincount(idx, minlength=n_bins).float()


def track_features(tracks: torch.Tensor) -> torch.Tensor:
    """Conditioning features [B, 4] of tracks [B, T, 2]: mean |kappa| and
    rms kappa over KAPPA_MAX, the normalised mean width, and the share of
    cyclic sign changes between consecutive segments."""
    kappa = tracks[..., 0].float()
    width = tracks[..., 1].float()
    mean_abs_k = kappa.abs().mean(-1) / KAPPA_MAX
    rms_k = torch.sqrt((kappa * kappa).mean(-1)) / KAPPA_MAX
    mean_w = (width.mean(-1) - WIDTH_MIN) / (WIDTH_MAX - WIDTH_MIN)
    sgn = torch.sign(kappa)
    flips = (sgn * torch.roll(sgn, 1, dims=-1) < 0).float()
    return torch.stack([mean_abs_k, rms_k, mean_w, flips.mean(-1)], dim=-1)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, derivative 0.5 at a
    bound (``torch.clamp`` gives 1 there)."""
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def closure_project(tracks: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Exact heading closure: each track's curvature is shifted so its sum
    is +-2*pi (the sign it leans; zero-sum tracks close positively), the
    correction spread over the segments by their headroom to +-KAPPA_MAX,
    then clipped; a second pass mops up a clipped residual.  Width is
    untouched.  Differentiable (arithmetic and ``clip``)."""
    kappa = tracks[..., 0].float()
    target = torch.where(kappa.sum(-1) >= 0, 1.0, -1.0) * TWO_PI
    for _ in range(iters):
        resid = target - kappa.sum(-1)
        room = torch.where(resid[:, None] >= 0, KAPPA_MAX - kappa,
                           kappa + KAPPA_MAX)
        denom = torch.maximum(room.sum(-1, keepdim=True),
                              torch.tensor(1e-6, device=kappa.device))
        kappa = kappa + resid[:, None] * room / denom
        kappa = clip(kappa, -KAPPA_MAX, KAPPA_MAX)
    return torch.stack([kappa, tracks[..., 1].float()],
                       dim=-1).to(tracks.dtype)


def closure_penalty(tracks: torch.Tensor) -> torch.Tensor:
    """Mean squared heading-closure error, mean_b (|sum_t kappa_b| -
    2*pi)^2."""
    turn = tracks[..., 0].float().sum(-1).abs()
    return (turn - TWO_PI).square().mean()
