"""The port's skill gap (``levelgan_torch/lio/skillgap.py``) against the
JAX package's ``levelgan.lio.skillgap.skill_gap_report``, on the CPU.

Both packages hold the same agents (bridged from the JAX curriculum
state) and play the same levels; the JAX rollouts' Gumbel noise, which
``_score`` draws from ``split(key(cfg, seed))`` and each rollout from
``split(k, T)``, is reproduced here and injected into the port.  Tile
rollouts agree to the bit (``tests/test_torch_env.py``), so the means
differ by the order of their f32 sums only.  The race dynamics are not
bit-equal to XLA's (``tests/test_torch_track_race.py``); at these inputs
every drawn action agrees, and the track means are held to their own
stated tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan import rng as j_rng
from levelgan.config import preset as j_preset
from levelgan.data.dataset import synthetic_corpus
from levelgan.lio.skillgap import skill_gap_report as j_skill_gap_report
from levelgan.track.data import synthetic_tracks
from levelgan.track.train import create_track_curriculum_state as j_create_t
from levelgan.train.curriculum import create_curriculum_state as j_create_c
from levelgan_torch.config import Config
from levelgan_torch.lio import skillgap
import test_torch_curriculum as tcur
import test_torch_track_train as ttrack
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 8            # levels (or tracks) a set
TILE_TOL = 1e-6      # a mean of N f32 returns, summed in another order
TRACK_TOL = 1e-6     # the same actions; f32 dynamics in another order


def jax_noise(jcfg, seed, n_actions):
    """The noise ``levelgan.lio.skillgap._score`` draws for a set of ``N``:
    strong and weak from ``split(key(cfg, seed))``, one key a step."""
    k_s, k_w = jax.random.split(j_rng.key(jcfg, seed))
    steps = jcfg.curriculum.rollout_steps
    return {who: torch.from_numpy(np.stack([
        np.asarray(jax.random.gumbel(k, (N, n_actions), jnp.float32))
        for k in jax.random.split(key, steps)]))
        for who, key in (("strong", k_s), ("weak", k_w))}


def _tile_case():
    jcfg = j_preset("curriculum_16").override(**tcur.TINY)
    j_state = j_create_c(jcfg, jax.random.key(1))
    cfg = Config.from_dict(jcfg.to_dict())
    corpus = synthetic_corpus(N, 16, seed=5)
    rng = np.random.default_rng(6)
    gen = corpus.copy()
    flip = rng.random(gen.shape) < 0.3
    gen[flip] = rng.integers(0, 2, gen.shape, dtype=np.uint8)[flip]
    for lv in (*gen[::2], *corpus[1::2]):   # GOAL beside START: reachable
        y, x = np.argwhere(lv == 2)[0]
        lv[lv == 3] = 0
        lv[y, x + 1 if x + 1 < 15 else x - 1] = 3
    return jcfg, j_state, cfg, tcur.port_state_from(cfg, j_state), gen, \
        corpus, 4


def _track_case():
    jcfg = j_preset("race_curriculum_32").override(**ttrack.TINY)
    j_state = j_create_t(jcfg, jax.random.key(2))
    cfg = Config.from_dict(jcfg.to_dict())
    corpus = synthetic_tracks(N, ttrack.T, seed=7)
    gen = (corpus * np.random.default_rng(8).uniform(
        0.6, 1.4, (N, 1, 1))).astype(np.float32)
    return jcfg, j_state, cfg, ttrack.port_state_from(cfg, j_state), gen, \
        corpus, 9


@pytest.mark.parametrize("family", ["tile", "track"])
@pytest.mark.parametrize("seed", [0, 3])
def test_skill_gap_matches_jax_with_its_noise(family, seed):
    jcfg, j_state, cfg, state, gen, corpus, n_actions = (
        _tile_case() if family == "tile" else _track_case())
    want = j_skill_gap_report(jcfg, j_state, gen, corpus, seed=seed)
    got = skillgap.skill_gap_report(cfg, state, gen, corpus, seed=seed,
                                    device="cpu",
                                    noise=jax_noise(jcfg, seed, n_actions))
    for part in ("generated", "corpus"):
        assert got[part].keys() == want[part].keys()
    tol = TILE_TOL if family == "tile" else TRACK_TOL
    for part in ("generated", "corpus"):
        for k, v in want[part].items():
            assert got[part][k] == pytest.approx(v, abs=tol), (part, k)
    for k in ("separation", "playable_separation"):
        assert got[k] == pytest.approx(want[k], abs=2 * tol), k
    if family == "tile":        # some levels are reached, some are not
        assert 0 < want["generated"]["playable_strong"] < 1


def test_drawn_noise_is_the_seeds_and_a_state_without_agents_is_refused():
    _, _, cfg, state, gen, corpus, _ = _tile_case()
    a = skillgap.skill_gap_report(cfg, state, gen, corpus, seed=4,
                                  device="cpu")
    b = skillgap.skill_gap_report(cfg, state, gen, corpus, seed=4,
                                  device="cpu")
    assert a == b
    noise = skillgap.draw_rollout_noise(cfg, N, "cpu", seed=4)
    assert noise["strong"].shape == (cfg.curriculum.rollout_steps, N, 4)
    assert a == skillgap.skill_gap_report(cfg, state, gen, corpus,
                                          device="cpu", noise=noise)
    assert 0.0 <= a["corpus"]["playable_strong"] <= 1.0
    with pytest.raises(ValueError, match="no trained agents"):
        skillgap.skill_gap_report(cfg, object(), gen, corpus, device="cpu")
