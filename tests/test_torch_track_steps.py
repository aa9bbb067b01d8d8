"""Sixteen consecutive track steps of the port against the JAX step.

The track presets' whole runs on the card were read against the JAX
package's one run each (ROADMAP Queue 3 fault 10): racetrack_32's
curvature KL and race_curriculum_32's skill-gap separation.  This holds
each preset's step (the GRU emitter with ``closure_in_model``; the race
curriculum with its two racing agents' rollouts), at a small width in
f32, to the JAX step over K consecutive steps from the same initial
state: the JAX step runs under one jit, and each port step gets the draws
the JAX step made at that step (``test_torch_track_train.jax_draws``:
shifts, flips, z, GP eps, exploration and both agents' action noise).
The optimizers, the G EMA and the REINFORCE baseline evolve on each side
on their own.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.api import make_step_fn as j_make_step_fn
from levelgan.config import preset as j_preset
from levelgan.track.train import create_track_curriculum_state as j_create_c
from levelgan.track.train import create_track_state as j_create
from levelgan_torch.config import Config
from levelgan_torch.track.data import synthetic_tracks
from levelgan_torch.track.train import (make_track_curriculum_step,
                                        make_track_wgan_step)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_track_train import (B, LR, N_CRITIC, T, TINY, _flat,
                                    _port_flat, jax_draws, port_state_from)

K = 16
PRESETS = ("racetrack_32", "race_curriculum_32")


@functools.lru_cache(maxsize=None)
def k_steps(name):
    """(jcfg, JAX state after K steps, JAX metrics, port state after K
    steps, port metrics) of ``name``."""
    jcfg = j_preset(name).override(**TINY)
    cfg = Config.from_dict(jcfg.to_dict())
    curriculum = jcfg.train.loss == "curriculum"
    j_state = (j_create_c if curriculum else j_create)(
        jcfg, jax.random.key(0))
    corpus = synthetic_tracks(64, T, seed=4)
    batches = corpus[np.random.default_rng(3).integers(
        0, len(corpus), (K, N_CRITIC, B))]
    j_step = jax.jit(j_make_step_fn(jcfg)[0])
    step = (make_track_curriculum_step if curriculum
            else make_track_wgan_step)(cfg)
    state = port_state_from(cfg, j_state)
    j_mets, mets = [], []
    for batch in batches:
        draws = jax_draws(jcfg, j_state)
        j_state, j_met = j_step(j_state, jnp.asarray(batch))
        state, met = step(state, torch.from_numpy(batch), noise=draws)
        j_mets.append(j_met)
        mets.append(met)
    return jcfg, j_state, j_mets, state, mets


# each step's scalar metrics within METRIC_RTOL of JAX's (denominator at
# least METRIC_FLOOR, as the curriculum's K-step test), the generated
# curvature histogram within one count moved between neighbouring bins as
# in the one-step test; after K steps every parameter within a tenth of its
# module's learning rate in all (not a step), and the baseline within
# BASELINE_RTOL
METRIC_RTOL, METRIC_FLOOR = 1e-4, 1e-2
BASELINE_RTOL = 1e-5


@pytest.mark.parametrize("name", PRESETS)
def test_k_track_steps_hold_to_jax(name):
    jcfg, js, j_mets, state, mets = k_steps(name)
    assert state.step == K == int(js.step)
    for k, (met, j_met) in enumerate(zip(mets, j_mets)):
        assert set(met) == set(j_met), k
        hist = met["gen_hist"].numpy() - np.asarray(j_met["gen_hist"])
        assert hist.sum() == 0 and np.abs(hist).sum() <= 2, (k, hist)
        for m in set(met) - {"gen_hist"}:
            got, want = float(met[m]), float(j_met[m])
            dev = abs(got - want) / max(abs(want), METRIC_FLOOR)
            assert dev <= METRIC_RTOL, (k, m, got, want)
    assert state.opt_d.count == K * N_CRITIC and state.opt_g.count == K
    trees = ["generator", "discriminator", "g_ema"]
    lrs = {"generator": LR, "discriminator": LR, "g_ema": LR}
    if jcfg.train.loss == "curriculum":
        cur = jcfg.curriculum
        np.testing.assert_allclose(float(state.g_baseline),
                                   float(js.g_baseline), rtol=BASELINE_RTOL)
        assert state.opt_as.count == int(js.opt_as[0].count)
        trees += ["agent_strong", "agent_weak"]
        lrs.update(agent_strong=cur.agent_lr, agent_weak=cur.weak_agent_lr)
    want = {k: v for t in trees for k, v in _flat(getattr(js, t), t).items()}
    got = _port_flat(state)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=lrs[k.split("/")[0]] / 10,
                                   err_msg=k)
