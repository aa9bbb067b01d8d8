"""Sixteen consecutive curriculum steps of the port against the JAX step.

``curriculum_16_joint``'s whole runs on the card read a skill-gap
separation below the JAX package's one run (ROADMAP Queue 3 fault 10).
This holds the preset's step, at a small width in f32, to the JAX step
over K consecutive steps from the same initial state: the JAX step runs
with ``use_pallas=False`` under one jit, and each port step gets the draws
the JAX step made at that step (D4 elements, z, Gumbel noise, GP eps, both
agents' rollout action noise; ``test_torch_curriculum.jax_draws``).  The
optimizers, the G EMA, the REINFORCE baseline and the presence prior's
schedule evolve on each side on their own.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.config import preset as j_preset
from levelgan.data.dataset import synthetic_corpus
from levelgan.train.curriculum import create_curriculum_state as j_create
from levelgan.train.curriculum import make_curriculum_step as j_make_step
from levelgan_torch.config import Config
from levelgan_torch.train.curriculum import make_curriculum_step
from test_torch_curriculum import (B, LEVEL, LR, N_CRITIC, TINY, _flat,
                                   _port_flat, jax_draws, port_state_from)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

K = 16
# each step's float metrics within METRIC_RTOL of JAX's (denominator at
# least METRIC_FLOOR: g_gan, a mean of critic scores of order 1, cancels to
# 6e-4 at one step, where the f32 rounding of its sum, 1.3e-7, is 2e-4 of
# it); the sampled levels' histogram and the rollouts' discrete shares
# equal at every step; after K steps every parameter within a tenth of its
# module's learning rate in all (not a step), and the baseline within
# BASELINE_RTOL
METRIC_RTOL, METRIC_FLOOR = 1e-4, 1e-2
BASELINE_RTOL = 1e-4
EXACT = ("playability", "playability_weak", "solvable_frac")
PRESETS = ("curriculum_16_joint", "curriculum_16")


@functools.lru_cache(maxsize=None)
def k_steps(name):
    """(jcfg, JAX states before each step and after the last, JAX metrics,
    port state after K steps, port metrics) of ``name``."""
    jcfg = j_preset(name).override(**TINY)
    cfg = Config.from_dict(jcfg.to_dict())
    j_state = j_create(jcfg, jax.random.key(0))
    ids = synthetic_corpus(K * N_CRITIC * B, LEVEL, seed=3).reshape(
        K, N_CRITIC, B, LEVEL, LEVEL)
    step = jax.jit(j_make_step(jcfg))
    port_step = make_curriculum_step(cfg)
    state = port_state_from(cfg, j_state)
    j_states, j_mets, mets = [j_state], [], []
    for k in range(K):
        draws = jax_draws(jcfg, j_state)
        j_state, j_met = step(j_state, jnp.asarray(ids[k]))
        state, met = port_step(state, torch.from_numpy(ids[k]), noise=draws)
        j_states.append(j_state)
        j_mets.append(j_met)
        mets.append(met)
    return jcfg, j_states, j_mets, state, mets


@pytest.mark.parametrize("name", PRESETS)
def test_k_curriculum_steps_hold_to_jax(name):
    jcfg, j_states, j_mets, state, mets = k_steps(name)
    cur = jcfg.curriculum
    assert state.step == K == int(j_states[-1].step)
    for k, (met, j_met) in enumerate(zip(mets, j_mets)):
        assert set(met) == set(j_met), k
        np.testing.assert_array_equal(met["gen_hist"].numpy(),
                                      np.asarray(j_met["gen_hist"]),
                                      err_msg=f"step {k}")
        for m in EXACT:
            if m in met:
                assert float(met[m]) == float(j_met[m]), (k, m)
        for m in set(met) - {"gen_hist", *EXACT}:
            got, want = float(met[m]), float(j_met[m])
            dev = abs(got - want) / max(abs(want), METRIC_FLOOR)
            assert dev <= METRIC_RTOL, (k, m, got, want)
    np.testing.assert_allclose(float(state.g_baseline),
                               float(j_states[-1].g_baseline),
                               rtol=BASELINE_RTOL)
    js = j_states[-1]
    assert state.opt_d.count == K * N_CRITIC and state.opt_g.count == K
    assert state.opt_as.count == int(js.opt_as[0].count)
    want = {**_flat(js.generator, "generator"),
            **_flat(js.discriminator, "discriminator"),
            **_flat(js.g_ema, "g_ema"),
            **_flat(js.agent_strong, "agent_strong"),
            **_flat(js.agent_weak, "agent_weak")}
    got = _port_flat(state)
    assert set(got) == set(want)
    lrs = {"generator": LR, "discriminator": LR, "g_ema": LR,
           "agent_strong": cur.agent_lr, "agent_weak": cur.weak_agent_lr}
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=lrs[k.split("/")[0]] / 10,
                                   err_msg=k)
