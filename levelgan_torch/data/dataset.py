"""Level corpus: the seeded synthetic carver and a batched sampler.

Port of ``levelgan/data/dataset.py``.  ``synthetic_corpus`` is the
package's own copy of the JAX package's NumPy random-walk carver (border
walls, a connected carved interior, exactly one START and one GOAL,
hazards / coins / terrain on floor cells); it draws the same NumPy stream,
so both packages build bit-identical corpora from one seed.  Corpus
generation is host NumPy and runs once; the trainer stages the uint8 array
on the device (``api.train``).

``synthetic_native`` is the C carver (``native/corpusgen.c``, a copy of
the JAX package's): its own random stream, so a different corpus from the
same seed, equal bit for bit to the JAX package's native corpus.  Where it
cannot be built it raises with the compiler's message.
"""

from __future__ import annotations

import numpy as np

from levelgan_torch.config import COIN, EMPTY, GOAL, HAZARD, START, WALL
from levelgan_torch.native import build as native_build

SAND, ICE = 6, 7


def _carve_level(rng: np.random.Generator, size: int, wall_density: float,
                 hazard_rate: float, coin_rate: float) -> np.ndarray:
    """One level via random-walk carving. Returns uint8 [size, size]."""
    grid = np.full((size, size), WALL, dtype=np.uint8)
    interior = size - 2

    # Carve a connected floor region with a drunkard's walk.
    target_floor = max(4, int(round(interior * interior * (1.0 - wall_density))))
    r, c = rng.integers(1, size - 1, size=2)
    start_pos = (int(r), int(c))
    grid[r, c] = EMPTY
    carved = [(int(r), int(c))]
    steps = 0
    max_steps = 50 * interior * interior
    while len(carved) < target_floor and steps < max_steps:
        dr, dc = [(0, 1), (0, -1), (1, 0), (-1, 0)][rng.integers(0, 4)]
        nr, nc = r + dr, c + dc
        if 1 <= nr < size - 1 and 1 <= nc < size - 1:
            r, c = nr, nc
            if grid[r, c] == WALL:
                grid[r, c] = EMPTY
                carved.append((int(r), int(c)))
        steps += 1

    # Goal: the carved cell farthest (L1) from the start; guaranteed reachable.
    dists = [abs(p[0] - start_pos[0]) + abs(p[1] - start_pos[1]) for p in carved]
    goal_pos = carved[int(np.argmax(dists))]
    if goal_pos == start_pos:
        if len(carved) > 1:
            goal_pos = carved[-1]
        else:
            # Degenerate 1-cell carve (tiny sizes): force a distinct GOAL
            # cell so the "exactly one START and one GOAL" invariant the
            # env/features rely on still holds.
            r0, c0 = start_pos
            goal_pos = (r0, c0 + 1) if c0 + 1 < size else (r0, c0 - 1)
            grid[goal_pos] = EMPTY

    # Decorations on floor cells (never on start/goal).
    floor = [p for p in carved if p != start_pos and p != goal_pos]
    if floor:
        probs = rng.random(len(floor))
        terrain = rng.random(len(floor))
        for (p, u, t) in zip(floor, probs, terrain):
            if u < hazard_rate:
                grid[p] = HAZARD
            elif u < hazard_rate + coin_rate:
                grid[p] = COIN
            elif t < 0.08:
                grid[p] = SAND
            elif t < 0.16:
                grid[p] = ICE

    grid[start_pos] = START
    grid[goal_pos] = GOAL
    return grid


def synthetic_corpus(n: int, size: int, seed: int = 1234,
                     wall_density: float = 0.25, hazard_rate: float = 0.04,
                     coin_rate: float = 0.06,
                     rate_oversample: float = 0.0) -> np.ndarray:
    """Deterministic corpus of ``n`` uint8 levels [n, size, size].

    The density knobs are centres: each level draws its own wall density /
    hazard rate / coin rate around them.  ``rate_oversample`` is the
    fraction of levels whose hazard/coin multipliers draw from the top
    quartile of the [0, 2] band; 0.0 draws nothing extra from the RNG.
    """
    rng = np.random.default_rng(seed)
    levels = []
    for _ in range(n):
        wd = np.clip(rng.uniform(0.6, 1.6) * wall_density, 0.05, 0.55)
        if rate_oversample and rng.random() < rate_oversample:
            hr = rng.uniform(1.5, 2.0) * hazard_rate
            cr = rng.uniform(1.5, 2.0) * coin_rate
        else:
            hr = rng.uniform(0.0, 2.0) * hazard_rate
            cr = rng.uniform(0.0, 2.0) * coin_rate
        levels.append(_carve_level(rng, size, wd, hr, cr))
    return np.stack(levels)


class LevelDataset:
    """Shuffled batch sampler over a uint8 level corpus [N, H, W]."""

    def __init__(self, levels: np.ndarray, seed: int = 0):
        if levels.dtype != np.uint8 or levels.ndim != 3:
            raise ValueError(f"expected uint8 [N,H,W], got {levels.dtype} "
                             f"{levels.shape}")
        self.levels = levels
        self._seed = seed
        self._rng = np.random.default_rng(seed)

    @classmethod
    def from_config(cls, data_cfg, model_cfg, seed: int = 0) -> "LevelDataset":
        if data_cfg.corpus in ("synthetic", "synthetic_native"):
            # the C carver raises if it cannot be built: no NumPy fallback,
            # whose stream would give another corpus from the same seed
            carve = (synthetic_corpus if data_cfg.corpus == "synthetic"
                     else native_build.synthetic_corpus_native)
            levels = carve(
                data_cfg.corpus_size, model_cfg.level_size,
                seed=data_cfg.corpus_seed, wall_density=data_cfg.wall_density,
                hazard_rate=data_cfg.hazard_rate, coin_rate=data_cfg.coin_rate,
                rate_oversample=data_cfg.rate_oversample)
        else:
            levels = np.load(data_cfg.corpus)
            if isinstance(levels, np.lib.npyio.NpzFile):
                levels = levels["levels"]
            if np.issubdtype(levels.dtype, np.floating) or (
                    levels.size and (int(levels.min()) < 0
                                     or int(levels.max()) > 255)):
                rng_txt = (f"range [{levels.min()}, {levels.max()}]"
                           if levels.size else "empty")
                raise ValueError(
                    f"corpus {data_cfg.corpus} has dtype {levels.dtype} / "
                    f"{rng_txt}: tile ids must be integer in [0, 255]")
            levels = levels.astype(np.uint8)
        hi = int(levels.max()) if levels.size else 0
        if hi >= model_cfg.n_tiles:
            raise ValueError(
                f"corpus contains tile id {hi} but model.n_tiles="
                f"{model_cfg.n_tiles}; raise n_tiles or fix the corpus")
        return cls(levels, seed=seed)

    def sample(self, batch_size: int) -> np.ndarray:
        idx = self._rng.integers(0, len(self.levels), size=batch_size)
        return self.levels[idx]

    def sample_at(self, step: int, batch_size: int) -> np.ndarray:
        """Stateless draw for train step ``step``: depends only on
        (seed, step)."""
        rng = np.random.default_rng((self._seed, step))
        idx = rng.integers(0, len(self.levels), size=batch_size)
        return self.levels[idx]

    def tile_histogram(self, n_tiles: int) -> np.ndarray:
        """Tile-type counts over the whole corpus (the KL reference)."""
        return np.bincount(self.levels.reshape(-1),
                           minlength=n_tiles).astype(np.float64)
