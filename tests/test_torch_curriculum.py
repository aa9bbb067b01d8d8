"""Port parity: the curriculum step (``levelgan_torch/train/curriculum.py``)
against ``levelgan/train/curriculum.py`` on the CPU in f32, and curriculum
checkpoints between the two packages.

The whole-step tests run the JAX step with ``use_pallas=False`` (its
oracle), reproduce its key derivation (``curriculum.py:117-119``, the
critic iterations' as in ``wgan_gp.py:50-52``, the rollouts' action keys as
``env/sim.py:168``) to draw the same D4 elements, z, Gumbel noise, GP eps
and action noise, and feed them to the port's step from the same
parameters, agents and baseline.  Three cases: ``curriculum_16``'s reward
(with the critic's trunk mbstd channel), ``curriculum_16_joint``'s (cell
credit, the solvable reward with its ceiling, the gap on solvable levels,
the presence prior at a constant excess weight; the fused GP on the port's
side) and a conditional one with two A2C updates a step.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.config import preset as j_preset
from levelgan.lio.checkpoint import load_checkpoint as j_load_checkpoint
from levelgan.lio.checkpoint import save_checkpoint as j_save_checkpoint
from levelgan.train.curriculum import create_curriculum_state as j_create
from levelgan.train.curriculum import make_curriculum_step as j_make_step
from levelgan_torch import api
from levelgan_torch.bridge import (agent_params_from_flat,
                                   critic_params_from_flat,
                                   generator_params_from_flat)
from levelgan_torch.config import Config
from levelgan_torch.env.agent import AgentPolicy
from levelgan_torch.lio.checkpoint import load_checkpoint
from levelgan_torch.models import Critic, Generator
from levelgan_torch.train.curriculum import make_curriculum_step
from levelgan_torch.train.state import create_state
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, N_CRITIC, T, LEVEL = 4, 2, 6, 16
LR = 1e-4
TINY = {
    "train.batch_size": B, "train.n_critic": N_CRITIC,
    "model.base_channels": 16, "model.critic_base_channels": 16,
    "model.group_size": 8, "model.latent_dim": 8, "model.dtype": "float32",
    "curriculum.rollout_steps": T, "data.corpus_size": 16,
}
CASES = {
    "curriculum_16": ("curriculum_16", {"model.critic_mbstd": "trunk"}, {}),
    "joint_fused": ("curriculum_16_joint", {
        "train.presence_excess": 0.5, "train.presence_excess_ramp": 100},
        {"model.pallas_gp": "fused"}),
    "conditional": ("curriculum_16", {
        "model.cond_dim": 4, "curriculum.agent_updates_per_step": 2}, {}),
}
START_STEP, BASELINE = 2, 0.25


def _flat(tree, prefix):
    return {f"{prefix}/" + jax.tree_util.keystr(p, simple=True, separator="/"):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_draws(jcfg, state):
    """The draws the JAX curriculum step makes from ``state.rng`` at
    ``state.step``."""
    m = jcfg.model
    shape = (B, m.level_size, m.level_size, m.n_tiles)
    base = jax.random.fold_in(state.rng, state.step)
    iter_keys = jax.random.split(jax.random.fold_in(base, 0), N_CRITIC)
    k_zg, k_sg, k_rs, k_rw = jax.random.split(jax.random.fold_in(base, 1), 4)
    its = []
    for k in iter_keys:
        k_aug, k_z, k_s, k_eps = jax.random.split(k, 4)
        its.append({
            "elements": _t(jax.random.randint(k_aug, (B,), 0, 8)),
            "z": _t(jax.random.normal(k_z, (B, m.latent_dim), jnp.float32)),
            "noise": _t(jax.random.gumbel(k_s, shape, jnp.float32)),
            "eps": _t(jax.random.uniform(k_eps, (B, 1, 1, 1), jnp.float32))})

    def actions(key):
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.gumbel(k, (B, 4), jnp.float32))
            for k in jax.random.split(key, jcfg.curriculum.rollout_steps)]))

    return {"critic": its,
            "g": {"z": _t(jax.random.normal(k_zg, (B, m.latent_dim),
                                            jnp.float32)),
                  "noise": _t(jax.random.gumbel(k_sg, shape, jnp.float32))},
            "rollout_strong": actions(k_rs), "rollout_weak": actions(k_rw)}


def port_state_from(cfg, j_state):
    """The port's state holding ``j_state``'s parameters, agents, step and
    baseline (fresh optimizers, as the JAX state's at step 0 counts)."""
    m = cfg.model
    flat = {**_flat(j_state.generator, "generator"),
            **_flat(j_state.discriminator, "discriminator")}
    gen = Generator(m)
    gen.load_state_dict(generator_params_from_flat(flat))
    critic = Critic(m)
    critic.load_state_dict(critic_params_from_flat(flat))
    agents = []
    for name in ("agent_strong", "agent_weak"):
        pol = AgentPolicy(m.n_tiles + 1, m.level_size)
        pol.load_state_dict(agent_params_from_flat(
            _flat(getattr(j_state, name), name), name))
        agents.append(pol)
    state = create_state(cfg, "cpu", generator=gen, critic=critic,
                         agents=tuple(agents))
    state.step = int(j_state.step)
    state.g_baseline = torch.tensor(float(j_state.g_baseline))
    return state


@functools.lru_cache(maxsize=None)
def one_step(case):
    """(jcfg, cfg, JAX state before, JAX state after, JAX metrics, port
    state after, port metrics) of one step of ``case``."""
    name, kw, port_kw = CASES[case]
    jcfg = j_preset(name).override(**TINY, **kw)
    cfg = Config.from_dict(jcfg.to_dict()).override(**port_kw)
    j_state = j_create(jcfg, jax.random.key(0)).replace(
        step=jnp.int32(START_STEP), g_baseline=jnp.float32(BASELINE))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 8, size=(N_CRITIC, B, LEVEL, LEVEL)).astype(
        np.uint8)
    j_new, j_met = jax.jit(j_make_step(jcfg))(j_state, jnp.asarray(ids))
    state = port_state_from(cfg, j_state)
    state, met = make_curriculum_step(cfg)(state, torch.from_numpy(ids),
                                           noise=jax_draws(jcfg, j_state))
    return jcfg, cfg, j_state, j_new, j_met, state, met


def _port_flat(state):
    out = {}
    for field, prefix in (("generator", "generator"),
                          ("critic", "discriminator"), ("g_ema", "g_ema"),
                          ("agent_strong", "agent_strong"),
                          ("agent_weak", "agent_weak")):
        out.update({f"{prefix}/{k.replace('.', '/')}": v.detach().numpy()
                    for k, v in getattr(state, field).state_dict().items()})
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_one_curriculum_step_matches_jax(case):
    """The metrics at rtol 1e-4 (the sampled levels' histogram and the
    rollouts' playability exactly), the baseline, and every parameter after
    its Adam update within a tenth of its learning rate."""
    jcfg, cfg, j_state, j_new, j_met, state, met = one_step(case)
    cur = jcfg.curriculum
    assert state.step == START_STEP + 1
    assert set(met) == set(j_met)
    np.testing.assert_array_equal(met["gen_hist"].numpy(),
                                  np.asarray(j_met["gen_hist"]))
    for k in ("playability", "playability_weak", "solvable_frac"):
        if k in met:
            assert float(met[k]) == float(j_met[k]), k
    for k in set(met) - {"gen_hist"}:
        np.testing.assert_allclose(float(met[k]), float(j_met[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(state.g_baseline),
                               float(j_new.g_baseline), rtol=1e-5)
    updates = max(1, cur.agent_updates_per_step)
    assert state.opt_as.count == int(j_new.opt_as[0].count) == updates
    assert state.opt_d.count == N_CRITIC and state.opt_g.count == 1

    before = {**_flat(j_state.generator, "generator"),
              **_flat(j_state.discriminator, "discriminator"),
              **_flat(j_state.agent_strong, "agent_strong"),
              **_flat(j_state.agent_weak, "agent_weak")}
    want = {**_flat(j_new.generator, "generator"),
            **_flat(j_new.discriminator, "discriminator"),
            **_flat(j_new.g_ema, "g_ema"),
            **_flat(j_new.agent_strong, "agent_strong"),
            **_flat(j_new.agent_weak, "agent_weak")}
    got = _port_flat(state)
    assert set(got) == set(want)
    # each update moves an element by about its lr (b1 = 0 for G and D, the
    # agents' first updates at optax's b1 0.9 too): lr / 10 catches a sign
    # flip or a missed update
    lrs = {"generator": LR, "discriminator": LR, "g_ema": LR,
           "agent_strong": cur.agent_lr, "agent_weak": cur.weak_agent_lr}
    for k, w in want.items():
        lr = lrs[k.split("/")[0]]
        old = before[k.replace("g_ema/", "generator/")]
        np.testing.assert_allclose(got[k] - old, w - old, atol=lr / 10,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("override,match", [
    ({"model.head": "softmax"}, "requires model.head='gumbel'"),
    ({"model.structural_head": "spatial"},
     "structural_head='spatial' is not supported"),
    ({"train.w_closure": 1.0}, "w_closure is track-family only"),
])
def test_curriculum_refusals_match_jax(override, match):
    jcfg = j_preset("curriculum_16").override(**TINY, **override)
    with pytest.raises(ValueError, match=match):
        j_make_step(jcfg)
    with pytest.raises(ValueError, match=match):
        make_curriculum_step(Config.from_dict(jcfg.to_dict()))


def test_curriculum_ignores_cond_match_as_jax_does():
    """The curriculum step has no cond-match term: both packages build it
    with ``train.w_cond_match`` set, on an unconditional model too."""
    jcfg = j_preset("curriculum_16").override(
        **TINY, **{"train.w_cond_match": 1.0})
    j_make_step(jcfg)
    make_curriculum_step(Config.from_dict(jcfg.to_dict()))


def _port_run(out, steps, cfg, resume=""):
    return api.train(cfg.override(**{
        "io.out_dir": out, "train.steps": steps, "io.resume": resume}),
        device="cpu", echo=False)


@pytest.fixture(scope="module")
def port_cfg():
    return Config.from_dict(j_preset("curriculum_16_joint").override(
        **TINY, **{"io.log_every": 1}).to_dict())


def test_port_checkpoint_loads_in_jax_and_skillgap_runs(tmp_path, port_cfg):
    """A port curriculum checkpoint restores into the JAX package's
    ``CurriculumState`` (agents, their Adams and the baseline exact) and
    the JAX package's skill-gap evaluation runs on it."""
    from levelgan.lio.skillgap import skill_gap_report
    res = _port_run(str(tmp_path / "run"), 2, port_cfg)
    path = res["checkpoint"]
    state = create_state(port_cfg, "cpu")
    state = load_checkpoint(path, state)[0]
    jcfg = j_preset("curriculum_16_joint").override(**TINY)
    restored, cfg2 = j_load_checkpoint(path, j_create(jcfg,
                                                      jax.random.key(7)))
    assert cfg2.train.loss == "curriculum" and int(restored.step) == 2
    assert float(restored.g_baseline) == float(state.g_baseline) != 0.0
    for name, opt in (("agent_strong", "opt_as"), ("agent_weak", "opt_aw")):
        want = {k.replace(".", "/"): v.numpy()
                for k, v in getattr(state, name).state_dict().items()}
        for k, v in _flat(getattr(restored, name), name).items():
            np.testing.assert_array_equal(v, want[k.split("/", 1)[1]])
        adam = getattr(restored, opt)[0]
        assert int(adam.count) == getattr(state, opt).count == 2
        port_opt = getattr(state, opt)
        mu = _flat(adam.mu, "mu")
        for n, p in getattr(state, name).named_parameters():
            np.testing.assert_array_equal(
                mu[f"mu/{n.replace('.', '/')}"],
                port_opt.state[p]["exp_avg"].numpy())
    rng = np.random.default_rng(1)
    gen = rng.integers(0, 8, size=(4, LEVEL, LEVEL)).astype(np.uint8)
    rep = skill_gap_report(jcfg, restored, gen, gen[::-1].copy())
    assert np.isfinite(rep["separation"])


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX state after one step, saved by the JAX package, restores
    into the port exactly (agents, Adam counts and moments, baseline) and
    the port trains on from it through ``io.resume``."""
    jcfg, cfg, _, j_new, _, _, _ = one_step("curriculum_16")
    out = tmp_path / "run"
    path = j_save_checkpoint(str(out / "ckpt"), j_new, jcfg)
    state = load_checkpoint(path, create_state(cfg, "cpu"))[0]
    assert state.step == START_STEP + 1
    assert float(state.g_baseline) == float(j_new.g_baseline)
    for name, opt in (("agent_strong", "opt_as"), ("agent_weak", "opt_aw")):
        for k, v in _flat(getattr(j_new, name), name).items():
            key = k.split("/", 1)[1].replace("/", ".")
            np.testing.assert_array_equal(
                getattr(state, name).state_dict()[key].numpy(), v)
        adam = getattr(j_new, opt)[0]
        assert getattr(state, opt).count == int(adam.count) == 1
        nu = _flat(adam.nu, "nu")
        for n, p in getattr(state, name).named_parameters():
            np.testing.assert_array_equal(
                getattr(state, opt).state[p]["exp_avg_sq"].numpy(),
                nu[f"nu/{n.replace('.', '/')}"])
    res = _port_run(str(out), START_STEP + 2, cfg.override(**{
        "data.corpus_size": 16}), resume="auto")
    assert os.path.basename(res["checkpoint"]) == \
        f"step_{START_STEP + 2:08d}"


def test_resumed_port_run_equals_an_uninterrupted_one(tmp_path, port_cfg):
    """2 steps, then 1 more through ``io.resume='auto'``: the checkpoint
    equals a 3-step run's in every array (agents, their Adams and the
    baseline included)."""
    whole = _port_run(str(tmp_path / "whole"), 3, port_cfg)["checkpoint"]
    _port_run(str(tmp_path / "parts"), 2, port_cfg)
    parts = _port_run(str(tmp_path / "parts"), 3, port_cfg,
                      resume="auto")["checkpoint"]
    a = np.load(os.path.join(whole, "arrays.npz"))
    b = np.load(os.path.join(parts, "arrays.npz"))
    assert set(a.files) == set(b.files)
    assert any(k.startswith("opt_aw/0/nu/") for k in a.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_runs_each_step_with_the_backward_on_its_own_thread(
        tmp_path, port_cfg, monkeypatch):
    """``api.train`` runs every step under ``api.step_mode``: autograd's
    worker thread would order the gradient penalty's double backward by
    another thread's counter, and a process's first run would sum some
    gradients in another order than its later runs."""
    seen = []
    make = api._STEPS["curriculum"]

    def spy(cfg, **kw):
        step = make(cfg, **kw)

        def run(*a, **k):
            seen.append(torch._C._is_multithreading_enabled())
            return step(*a, **k)
        return run
    monkeypatch.setitem(api._STEPS, "curriculum", spy)
    _port_run(str(tmp_path / "run"), 2, port_cfg)
    assert seen == [False, False]
    assert torch._C._is_multithreading_enabled()
