"""Synthetic race-track corpus + dataset: port of ``levelgan/track/data.py``.

A NumPy copy, array for array equal to the JAX package's corpus (the
port imports nothing of that package).  Track-family twin of
``data/dataset.py``.

A track is a sequence of ``n_segments`` (curvature, width) pairs, each
segment of unit arc length: curvature kappa_t = heading change over the
segment (radians, bounded), width w_t in [w_min, w_max].  The corpus
generator draws smoothed band-limited noise for curvature (moving-average
filtered white noise), biases it so the total turn is ~2*pi (closed
circuit), and slow-varying widths — structured, drivable-by-construction
tracks, deterministic from the seed (the test/train fixture, like the
drunkard's-walk tile corpus).

Host NumPy, offline; the hot path sees only the float32 [N, T, 2] array.
"""

from __future__ import annotations

import numpy as np

KAPPA_MAX = 0.6          # |curvature| bound per segment (radians)
WIDTH_MIN, WIDTH_MAX = 0.08, 0.30


def _smooth(x: np.ndarray, k: int) -> np.ndarray:
    kernel = np.ones(k) / k
    return np.apply_along_axis(
        lambda r: np.convolve(np.r_[r, r[:k - 1]], kernel, "valid"), -1, x)


def synthetic_tracks(n: int, n_segments: int, seed: int = 1234) -> np.ndarray:
    """float32 [n, n_segments, 2] of (curvature, width)."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(0.0, 1.0, (n, n_segments))
    kappa = _smooth(raw, max(3, n_segments // 8))
    # bias so the heading closes: total turn = +-2*pi exactly (sign =
    # circuit direction); positional closure is approximate — the race sim
    # is Frenet-frame (s wraps), so only heading closure matters physically
    direction = rng.choice([-1.0, 1.0], size=(n, 1))
    kappa = kappa - kappa.mean(-1, keepdims=True)
    kappa = kappa / (np.abs(kappa).max(-1, keepdims=True) + 1e-6) * KAPPA_MAX * 0.5
    kappa = kappa + direction * 2.0 * np.pi / n_segments
    kappa = np.clip(kappa, -KAPPA_MAX, KAPPA_MAX)
    # re-normalize the total turn post-clip to exactly +-2*pi
    kappa = kappa * (direction * 2.0 * np.pi / kappa.sum(-1, keepdims=True))
    kappa = np.clip(kappa, -KAPPA_MAX, KAPPA_MAX)

    wraw = _smooth(rng.normal(0.0, 1.0, (n, n_segments)), max(3, n_segments // 4))
    wraw = (wraw - wraw.min(-1, keepdims=True)) / \
        (np.ptp(wraw, axis=-1, keepdims=True) + 1e-6)
    width = WIDTH_MIN + (WIDTH_MAX - WIDTH_MIN) * wraw

    return np.stack([kappa, width], axis=-1).astype(np.float32)


def centerline(tracks: np.ndarray) -> np.ndarray:
    """(curvature, width) [.., T, 2] -> centerline xy [.., T+1, 2] (unit
    segment length; heading = cumulative curvature)."""
    kappa = tracks[..., 0]
    heading = np.cumsum(kappa, axis=-1)
    dx = np.cos(heading)
    dy = np.sin(heading)
    x = np.concatenate([np.zeros_like(dx[..., :1]), np.cumsum(dx, -1)], -1)
    y = np.concatenate([np.zeros_like(dy[..., :1]), np.cumsum(dy, -1)], -1)
    return np.stack([x, y], axis=-1)


class TrackDataset:
    """Same sampler surface as LevelDataset (sample / sample_at /
    tile_histogram-analog) so api.train is family-agnostic."""

    N_BINS = 16  # curvature histogram bins for the KL gate

    def __init__(self, tracks: np.ndarray, seed: int = 0):
        if tracks.dtype != np.float32 or tracks.ndim != 3 or tracks.shape[-1] != 2:
            raise ValueError(f"expected float32 [N,T,2], got {tracks.dtype} {tracks.shape}")
        self.tracks = tracks
        self._seed = seed
        self._rng = np.random.default_rng(seed)

    @classmethod
    def from_config(cls, data_cfg, model_cfg, seed: int = 0) -> "TrackDataset":
        tracks = synthetic_tracks(data_cfg.corpus_size, model_cfg.n_segments,
                                  seed=data_cfg.corpus_seed)
        return cls(tracks, seed=seed)

    def sample(self, batch_size: int) -> np.ndarray:
        idx = self._rng.integers(0, len(self.tracks), size=batch_size)
        return self.tracks[idx]

    def sample_at(self, step: int, batch_size: int) -> np.ndarray:
        rng = np.random.default_rng((self._seed, step))
        idx = rng.integers(0, len(self.tracks), size=batch_size)
        return self.tracks[idx]

    def tile_histogram(self, n_bins: int | None = None) -> np.ndarray:
        """Curvature-bin counts — the track analog of the tile histogram."""
        n_bins = n_bins or self.N_BINS
        return curvature_histogram(self.tracks, n_bins)


def curvature_edges(n_bins: int) -> np.ndarray:
    """The f32 bin edges of the curvature histogram (``n_bins - 1`` of them).
    The device histogram (``track.ops.curvature_hist_device``) bins against
    these very numbers: ``torch.linspace`` can differ in the last bit, and a
    curvature on an edge would then land in another bin."""
    return np.linspace(np.float32(-KAPPA_MAX), np.float32(KAPPA_MAX),
                       n_bins - 1, dtype=np.float32)


def curvature_histogram(tracks: np.ndarray, n_bins: int) -> np.ndarray:
    # f32 edges to match the on-device twin bit-for-bit at the clip bounds
    idx = np.digitize(tracks[..., 0].reshape(-1), curvature_edges(n_bins))
    return np.bincount(idx, minlength=n_bins).astype(np.float64)
