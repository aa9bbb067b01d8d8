"""Port parity: the curriculum's agent (``levelgan_torch/env/agent.py``)
against ``levelgan/env/agent.py`` on the CPU in f32: the policy from bridged
Flax weights (with Flax's SAME padding at stride 2), the A2C loss and one
Adam update, and a rollout of the bridged policy with injected noise."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from levelgan.config import CurriculumConfig as JCurriculumConfig
from levelgan.data.codec import encode as j_encode
from levelgan.env import agent as jagent
from levelgan.env import sim as jsim
from levelgan_torch.bridge import agent_params_from_flat, agent_params_to_flat
from levelgan_torch.config import Config, CurriculumConfig, ModelConfig
from levelgan_torch.data.codec import encode
from levelgan_torch.env import agent, sim
from levelgan_torch.train.state import make_agent_optimizers
from test_torch_env import _levels, assert_trajectories_equal, \
    jax_rollout_noise
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-6)
CUR = CurriculumConfig(entropy_coef=0.05, value_coef=0.5)


def _flat(tree, prefix=""):
    return {prefix + jax.tree_util.keystr(p, simple=True, separator="/"):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_agent(size, c_in=9, seed=0):
    obs = jnp.zeros((1, size, size, c_in))
    return jagent.AgentPolicy().init(jax.random.key(seed), obs)["params"]


def port_agent(params, size, c_in=9):
    pol = agent.AgentPolicy(c_in, size)
    pol.load_state_dict(agent_params_from_flat(_flat(params)))
    return pol


@pytest.mark.parametrize("size", [16, 8, 7])
def test_policy_matches_jax(size):
    """Even sizes pad (0, 1) at stride 2 (the odd pixel at the high end), 7
    pads (1, 1): both against the Flax module."""
    params = jax_agent(size)
    obs = np.random.default_rng(size).random((5, size, size, 9),
                                             np.float32)
    want = jagent.policy_apply(params, jnp.asarray(obs))
    got = port_agent(params, size)(torch.from_numpy(obs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    assert agent._same_pad(16) == (0, 1) and agent._same_pad(7) == (1, 1)


def test_agent_bridge_roundtrip_and_init():
    params = jax_agent(16)
    pol = port_agent(params, 16)
    flat = agent_params_to_flat(pol.state_dict(), "agent_weak")
    want = _flat(params, "agent_weak/")
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v)
    fresh = agent.init_agent(ModelConfig(level_size=16),
                             torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in fresh.state_dict().items()} == \
        {k.replace("/", "."): v.shape for k, v in _flat(params).items()}
    # lecun_normal: variance 1 / fan_in; the heads normal(0.01); zero biases
    k0 = fresh.Conv_0.kernel.detach()
    assert abs(float(k0.std()) * np.sqrt(3 * 3 * 9) - 1) < 0.15
    assert abs(float(fresh.Dense_1.kernel.detach().std()) / 0.01 - 1) < 0.3
    assert not any(float(p.detach().abs().max())
                   for n, p in fresh.named_parameters()
                   if n.endswith("bias"))


def _trajectory(size=8, b=6, steps=6, seed=1):
    ids = _levels(seed, b, size)
    params = jax_agent(size, seed=seed)
    key = jax.random.key(seed + 10)
    traj = jsim.rollout(jagent.policy_apply, params, jnp.asarray(ids),
                        j_encode(jnp.asarray(ids), 8), key,
                        jsim.EnvParams(rollout_steps=steps))
    return ids, params, key, traj


def test_rollout_of_the_bridged_policy_matches_jax():
    ids, params, key, want = _trajectory()
    got = sim.rollout(port_agent(params, 8), torch.from_numpy(ids),
                      encode(torch.from_numpy(ids), 8, dtype=torch.float32),
                      sim.EnvParams(rollout_steps=6),
                      noise=jax_rollout_noise(key, 6, 6))
    assert_trajectories_equal(got, want)


def _port_traj(traj):
    return sim.Trajectory(*(torch.from_numpy(np.array(x)) for x in traj))


def test_a2c_loss_matches_jax():
    ids, params, _, traj = _trajectory()
    jcur = JCurriculumConfig(entropy_coef=CUR.entropy_coef,
                             value_coef=CUR.value_coef)
    onehot = j_encode(jnp.asarray(ids), 8)
    (w_loss, w_aux), w_grads = jax.value_and_grad(
        jagent.a2c_loss, has_aux=True)(params, onehot, traj, jcur)
    pol = port_agent(params, 8)
    loss, aux = agent.a2c_loss(pol, encode(torch.from_numpy(ids), 8,
                                           dtype=torch.float32),
                               _port_traj(traj), CUR)
    np.testing.assert_allclose(float(loss.detach()), float(w_loss), **TOL)
    for k in ("pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(aux[k].detach()), float(w_aux[k]), **TOL,
                                   err_msg=k)
    grads = torch.autograd.grad(loss, list(pol.parameters()))
    want = _flat(w_grads)
    for (n, _), g in zip(pol.named_parameters(), grads):
        w = want[n.replace(".", "/")]
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=n)


def test_a2c_loss_from_obs_matches_jax():
    rng = np.random.default_rng(2)
    obs = rng.random((3, 4, 8, 8, 9), np.float32)
    actions = rng.integers(0, 4, (3, 4))
    returns = rng.standard_normal((3, 4)).astype(np.float32)
    active = (rng.random((3, 4)) < 0.7).astype(np.float32)
    params = jax_agent(8)
    jcur = JCurriculumConfig(entropy_coef=CUR.entropy_coef)
    w_loss, _ = jagent.a2c_loss_from_obs(
        params, jagent.policy_apply, jnp.asarray(obs), jnp.asarray(actions),
        jnp.asarray(returns), jnp.asarray(active), jcur)
    t = torch.from_numpy
    loss, _ = agent.a2c_loss_from_obs(port_agent(params, 8), t(obs),
                                      t(actions), t(returns), t(active), CUR)
    np.testing.assert_allclose(float(loss.detach()), float(w_loss), **TOL)


@pytest.mark.parametrize("updates", [1, 2])
def test_agent_update_matches_optax(updates):
    """``agent_update`` with the port's Adam against ``optax.adam(lr)``:
    the new parameters and the moments after each update."""
    ids, params, _, traj = _trajectory()
    lr = 3e-3
    jcur = JCurriculumConfig()
    cur = CurriculumConfig(agent_lr=lr)
    tx = optax.adam(lr)
    onehot_j = j_encode(jnp.asarray(ids), 8)
    j_params, j_opt = params, tx.init(params)
    pol = port_agent(params, 8)
    opt, _ = make_agent_optimizers(Config(curriculum=cur), pol, pol)
    onehot = encode(torch.from_numpy(ids), 8, dtype=torch.float32)
    for _ in range(updates):
        j_params, j_opt, w_loss, _ = jagent.agent_update(
            j_params, j_opt, tx, onehot_j, traj, jcur)
        loss, _ = agent.agent_update(pol, opt, onehot, _port_traj(traj), cur)
        np.testing.assert_allclose(float(loss.detach()), float(w_loss), **TOL)
    assert opt.count == int(j_opt[0].count) == updates
    want = _flat(j_params)
    mu, nu = _flat(j_opt[0].mu), _flat(j_opt[0].nu)
    for n, p in pol.named_parameters():
        k = n.replace(".", "/")
        # Adam moves each element by about lr an update: lr / 100 is far
        # inside a sign flip or a missed update
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0,
                                   atol=lr / 100, err_msg=n)
        st = opt.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[k], rtol=1e-4,
                                   atol=1e-5 * np.abs(mu[k]).max(),
                                   err_msg=n)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[k],
                                   rtol=1e-3, atol=1e-6 * np.abs(nu[k]).max(),
                                   err_msg=n)
