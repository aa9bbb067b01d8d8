"""Port parity: the grid environment (``levelgan_torch/env/sim.py``) against
``levelgan/env/sim.py`` on the CPU.  The transition, the observation and a
rollout with injected Gumbel noise are integer and boolean logic plus the
reward's fixed f32 sums, so they must agree bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.config import COIN, EMPTY, GOAL, HAZARD, START, WALL
from levelgan.data.codec import encode as j_encode
from levelgan.data.dataset import ICE, SAND
from levelgan.env import sim as jsim
from levelgan_torch.data.codec import encode
from levelgan_torch.env import sim
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

P = (8, 0.9)          # rollout_steps, gamma of the unit cases


def _both(params):
    return jsim.EnvParams(*params), sim.EnvParams(*params)


def _t(a):
    return torch.from_numpy(np.array(a))


def _step_both(ids, pos, action, coins=None, done=None, params=P):
    """One transition through both packages; returns the two 4-tuples as
    numpy."""
    ids = np.asarray(ids, np.uint8)
    b = ids.shape[0]
    coins = np.zeros(ids.shape, bool) if coins is None else coins
    done = np.zeros((b,), bool) if done is None else np.asarray(done)
    pos, action = np.asarray(pos, np.int32), np.asarray(action, np.int32)
    jp, tp = _both(params)
    want = jsim.transition(jnp.asarray(ids), jnp.asarray(pos),
                           jnp.asarray(action), jnp.asarray(coins),
                           jnp.asarray(done), jp)
    got = sim.transition(_t(ids), _t(pos), _t(action).long(), _t(coins),
                         _t(done), tp)
    return ([np.asarray(w) for w in want], [g.numpy() for g in got])


def _assert_same(want, got):
    for name, w, g in zip(("pos", "reward", "done", "coins"), want, got):
        assert g.dtype == w.dtype or name == "pos", (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


def _levels(seed, b, size):
    """Seeded levels with every tile kind (walls, ice, sand, hazard, coins,
    goal) and a START in most."""
    rng = np.random.default_rng(seed)
    ids = rng.choice([EMPTY, WALL, COIN, HAZARD, GOAL, SAND, ICE],
                     p=[0.45, 0.2, 0.08, 0.07, 0.04, 0.08, 0.08],
                     size=(b, size, size)).astype(np.uint8)
    for i in range(b - 1):
        ids[i, rng.integers(size), rng.integers(size)] = START
    return ids


def test_transition_matches_jax_on_seeded_levels():
    ids = _levels(0, 32, 8)
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 8, size=(32, 2)).astype(np.int32)
    coins = rng.random((32, 8, 8)) < 0.3
    done = rng.random(32) < 0.2
    for action in range(4):
        want, got = _step_both(ids, pos, np.full(32, action), coins, done)
        _assert_same(want, got)


@pytest.mark.parametrize("case", ["wall", "border", "goal", "hazard", "sand",
                                  "ice", "ice_blocked", "done_frozen"])
def test_transition_unit_cases_match_jax(case):
    rows, pos, action, done = {
        "wall": ([[EMPTY, WALL], [EMPTY, EMPTY]], [0, 0], 3, False),
        "border": ([[EMPTY, EMPTY], [EMPTY, EMPTY]], [0, 0], 0, False),
        "goal": ([[EMPTY, GOAL]], [0, 0], 3, False),
        "hazard": ([[EMPTY, HAZARD]], [0, 0], 3, False),
        "sand": ([[EMPTY, SAND]], [0, 0], 3, False),
        "ice": ([[EMPTY, ICE, EMPTY, WALL]], [0, 0], 3, False),
        "ice_blocked": ([[EMPTY, ICE, EMPTY, WALL]], [0, 2], 3, False),
        "done_frozen": ([[EMPTY, GOAL]], [0, 0], 3, True),
    }[case]
    want, got = _step_both(np.array(rows)[None], [pos], [action],
                           done=[done])
    _assert_same(want, got)


def test_coin_is_collected_once_as_in_jax():
    ids = np.array([[EMPTY, COIN]], np.uint8)[None]
    pos, coins = [[0, 0]], None
    rewards = []
    for action in (3, 2, 3):        # onto the coin, off, back on
        want, got = _step_both(ids, pos, [action], coins)
        _assert_same(want, got)
        pos, coins = got[0], got[3]
        rewards.append(float(got[1][0]))
    assert rewards[0] > rewards[2]


def test_make_obs_matches_jax():
    ids = _levels(2, 6, 8)
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 8, size=(6, 2)).astype(np.int32)
    coins = rng.random((6, 8, 8)) < 0.5
    want = np.asarray(jsim.make_obs(j_encode(jnp.asarray(ids), 8),
                                    jnp.asarray(pos), jnp.asarray(coins)))
    got = sim.make_obs(encode(_t(ids), 8, dtype=torch.float32), _t(pos),
                       _t(coins)).numpy()
    assert got.shape == (6, 8, 8, 9)
    np.testing.assert_array_equal(got, want)


def _sum_policy_jax(params, obs):
    s = obs.sum(axis=(1, 2, 3))
    return jnp.stack([s, -s, 2 * s, jnp.zeros_like(s)], -1), jnp.zeros_like(s)


def _sum_policy_torch(obs):
    s = obs.sum(dim=(1, 2, 3))
    return torch.stack([s, -s, 2 * s, torch.zeros_like(s)], -1), \
        torch.zeros_like(s)


def jax_rollout_noise(key, steps, b):
    """The Gumbel noise ``jax.random.categorical`` adds at each step of the
    JAX rollout (its keys are ``split(key, T)``)."""
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.gumbel(k, (b, sim.N_ACTIONS), jnp.float32))
        for k in jax.random.split(key, steps)]))


def assert_trajectories_equal(got, want):
    for f in ("pos", "coins", "actions", "rewards", "active", "returns",
              "total_return", "reached"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("size", [8, 16])
def test_rollout_with_injected_noise_matches_jax(size):
    """A policy that is the same function in both packages (logits from the
    observation's sum), so the trajectories must agree to the bit."""
    ids = _levels(4, 8, size)
    steps = 8
    jp, tp = _both((steps, 0.97))
    key = jax.random.key(5)
    want = jsim.rollout(_sum_policy_jax, None, jnp.asarray(ids),
                        j_encode(jnp.asarray(ids), 8), key, jp)
    got = sim.rollout(_sum_policy_torch, _t(ids),
                      encode(_t(ids), 8, dtype=torch.float32), tp,
                      noise=jax_rollout_noise(key, steps, 8))
    assert_trajectories_equal(got, want)
    assert got.actions.dtype == torch.int64


def test_rollout_reaches_adjacent_goal_and_draws_from_a_generator():
    ids = np.full((1, 4, 4), EMPTY, np.uint8)
    ids[0, 1, 1], ids[0, 1, 2] = START, GOAL

    def right(obs):
        b = obs.shape[0]
        return (torch.tensor([-1e9, -1e9, -1e9, 0.0]).repeat(b, 1),
                torch.zeros(b))

    traj = sim.rollout(right, _t(ids), encode(_t(ids), 8,
                                              dtype=torch.float32),
                       sim.EnvParams(rollout_steps=3),
                       generator=torch.Generator().manual_seed(0))
    assert bool(traj.reached[0])
    np.testing.assert_allclose(float(traj.total_return[0]), 1.0 - 0.01,
                               atol=1e-6)
    np.testing.assert_array_equal(traj.active[:, 0].numpy(), [1, 0, 0])
