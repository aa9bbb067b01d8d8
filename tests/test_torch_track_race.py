"""Port parity: the race simulation, the drivers and the scripted quality
evaluator (``levelgan_torch/track/{race,quality}.py``) against
``levelgan/track/{race,quality}.py`` on the CPU in f32.

The dynamics are not bit-equal: XLA's CPU ``sin`` / ``cos`` are its own
approximations and it contracts multiply-adds, so ``observe`` and
``race_step`` are held from the same states at 1e-5 absolute and
rollouts with the JAX trajectory's actions fed in (teacher forcing) at
1e-4 (64 steps of accumulated state).  With drawn actions (the JAX
rollout's Gumbel noise injected) the first step's observation is exact
(the cars start at rest), so its actions agree exactly; later actions
agree unless a state difference of a few ulps moves an argmax of logits
+ noise across a near-tie, which the test bounds at 5% of the actions.
The discounted returns are bit-equal from equal rewards (one rounding per
step, as XLA's fused multiply-add), the scripted driver's actions equal
from equal states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.track import quality as j_quality
from levelgan.track import race as j_race
from levelgan_torch.bridge import agent_params_from_flat
from levelgan_torch.track import data, quality, race
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, T, STEPS = 8, 16, 64
RP = race.RaceParams(rollout_steps=STEPS)
JRP = j_race.RaceParams(rollout_steps=STEPS)


def _flat(tree, prefix):
    return {f"{prefix}/" + jax.tree_util.keystr(p, simple=True, separator="/"):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _states(seed=0, batch=B):
    """Random car states (arc positions past the lap and below 0 too)."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(-1.5, T + 0.5, batch).astype(np.float32)
    d = rng.uniform(-0.15, 0.15, batch).astype(np.float32)
    psi = rng.uniform(-1.0, 1.0, batch).astype(np.float32)
    v = rng.uniform(0.0, 1.2, batch).astype(np.float32)
    laps = rng.integers(0, 3, batch).astype(np.float32)
    return ((s, d, psi, v, laps),
            race.CarState(*(torch.from_numpy(a) for a in (s, d, psi, v,
                                                          laps))),
            j_race.CarState(*(jnp.asarray(a) for a in (s, d, psi, v, laps))))


def _tracks(batch=B):
    return data.synthetic_tracks(batch, T, seed=21)


def test_observe_matches_jax():
    tracks = _tracks()
    _, car, jcar = _states(1)
    got = race.observe(torch.from_numpy(tracks), car, RP).numpy()
    want = np.asarray(j_race.observe(jnp.asarray(tracks), jcar, JRP))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [2, 3])
def test_race_step_matches_jax_for_every_action(seed):
    tracks = _tracks(9 * B)
    _, car, jcar = _states(seed, 9 * B)
    action = np.repeat(np.arange(9), B)
    new, rew, crash = race.race_step(torch.from_numpy(tracks), car,
                                     torch.from_numpy(action), RP)
    jnew, jrew, jcrash = j_race.race_step(jnp.asarray(tracks), jcar,
                                          jnp.asarray(action), JRP)
    for a, b in zip(new, jnew):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-5)
    np.testing.assert_array_equal(crash.numpy(), np.asarray(jcrash))
    assert crash.any() and (new.laps > car.laps).any()


def test_scripted_action_matches_jax():
    tracks = _tracks(4 * B)
    _, car, jcar = _states(4, 4 * B)
    got = quality.scripted_action(torch.from_numpy(tracks), car, RP)
    want = j_quality.scripted_action(jnp.asarray(tracks), jcar, JRP)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) > 3


def _drivers():
    jp = j_race.init_driver(jax.random.key(5), JRP)
    pol = race.DriverPolicy(race.OBS_DIM_BASE + RP.preview)
    pol.load_state_dict(agent_params_from_flat(_flat(jp, "agent_strong")))
    return jp, pol


def test_driver_policy_matches_jax():
    jp, pol = _drivers()
    obs = np.random.default_rng(6).normal(size=(B, 10)).astype(np.float32)
    logits, value = pol(torch.from_numpy(obs))
    jl, jv = j_race.driver_apply(jp, jnp.asarray(obs))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                               atol=1e-6)
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jv),
                               atol=1e-6)
    fresh = race.init_driver(RP, torch.Generator().manual_seed(0))
    assert ({k: tuple(v.shape) for k, v in fresh.state_dict().items()}
            == {k.split("/", 1)[1].replace("/", "."): v.shape
                for k, v in _flat(jp, "agent_strong").items()})


def _jax_rollout(jp, tracks, key):
    return j_race.race_rollout(j_race.driver_apply, jp, jnp.asarray(tracks),
                               key, JRP)


def test_teacher_forced_rollout_matches_jax():
    jp, pol = _drivers()
    tracks = _tracks()
    jt = _jax_rollout(jp, tracks, jax.random.key(7))
    got = race.race_rollout(pol, torch.from_numpy(tracks), RP,
                            actions=torch.from_numpy(np.asarray(jt.actions)))
    np.testing.assert_array_equal(got.actions.numpy(), np.asarray(jt.actions))
    for name in ("obs", "rewards", "returns", "total_return", "progress"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(jt, name)), atol=1e-4,
                                   rtol=0, err_msg=name)
    np.testing.assert_array_equal(got.crashes.numpy(), np.asarray(jt.crashes))
    assert float(jt.crashes.sum()) > 0


def test_drawn_rollout_with_injected_noise_agrees_with_jax():
    jp, pol = _drivers()
    tracks = _tracks()
    key = jax.random.key(8)
    noise = np.stack([np.asarray(jax.random.gumbel(k, (B, 9), jnp.float32))
                      for k in jax.random.split(key, STEPS)])
    jt = _jax_rollout(jp, tracks, key)
    got = race.race_rollout(pol, torch.from_numpy(tracks), RP,
                            noise=torch.from_numpy(noise))
    same = got.actions.numpy() == np.asarray(jt.actions)
    assert same[0].all()
    assert same.mean() >= 0.95, same.mean()


def test_discounted_returns_bit_equal_jax():
    rew = np.random.default_rng(9).normal(size=(STEPS, B)).astype(np.float32)

    def disc(carry, r):
        g = r + JRP.gamma * carry
        return g, g

    _, want = jax.jit(lambda r: jax.lax.scan(disc, jnp.zeros((B,)), r,
                                             reverse=True))(jnp.asarray(rew))
    got = race.discounted_returns(torch.from_numpy(rew), RP.gamma)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_track_quality_report_matches_jax():
    tracks = data.synthetic_tracks(32, 32, seed=10)
    tracks[:4, :, 0] *= 0.5          # unclosed: closure_ok 0
    got = quality.track_quality_report(tracks, device="cpu")
    want = j_quality.track_quality_report(tracks)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert 0.0 < got["lap_frac"] and got["closure_ok_frac"] < 1.0
