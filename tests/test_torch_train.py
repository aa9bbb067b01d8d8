"""Port parity: the WGAN-GP training path against the JAX package, on the
CPU in f32 — the optimizer and EMA, one whole step with injected
randomness, and the train CLI through to an export.

The whole-step test runs the JAX step with ``use_pallas=False`` (its
oracle), reproduces the step's key derivation (``wgan_gp.py:117-120`` and
``:50-52``) to draw the same D4 elements, z, Gumbel noise and GP eps, and
feeds those draws to the port's step, starting from the same parameters.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from levelgan.config import Config as JConfig
from levelgan.config import DataConfig as JDataConfig
from levelgan.config import ModelConfig as JModelConfig
from levelgan.config import TrainConfig as JTrainConfig
from levelgan.data.dataset import synthetic_corpus
from levelgan.train.state import create_state as j_create_state
from levelgan.train.state import update_ema as j_update_ema
from levelgan.train.wgan_gp import make_wgan_gp_step as j_make_step
from levelgan_torch import api
from levelgan_torch.bridge import (critic_params_from_flat,
                                   generator_params_from_flat)
from levelgan_torch.cli import export as cli_export
from levelgan_torch.cli import train as cli_train
from levelgan_torch.config import Config
from levelgan_torch.models import Critic, Generator
from levelgan_torch.train import state as tstate
from levelgan_torch.train.wgan_gp import make_wgan_gp_step
from test_torch_gan_step import exact_st_features  # noqa: F401 (fixture)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

LR = 1e-4
B, N_CRITIC, LEVEL = 4, 2, 16


def _cfgs(**train):
    jcfg = JConfig(
        model=JModelConfig(level_size=LEVEL, base_channels=16,
                           critic_base_channels=16, group_size=8,
                           latent_dim=8, dtype="float32", head="gumbel"),
        train=JTrainConfig(loss="wgan_gp", batch_size=B, n_critic=N_CRITIC,
                           lr_g=LR, lr_d=LR, beta1=0.0, beta2=0.9, steps=10,
                           **train),
        data=JDataConfig(augment=True))
    return jcfg, Config.from_dict(jcfg.to_dict())


def _flat(tree, prefix):
    return {f"{prefix}/" + jax.tree_util.keystr(p, simple=True, separator="/"):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_draws(jcfg, state):
    """The draws the JAX step makes from ``state.rng`` at ``state.step``
    (batch ``train.batch_size``, ``train.n_critic`` critic iterations)."""
    m = jcfg.model
    size = m.level_size
    bsz = jcfg.train.batch_size
    base = jax.random.fold_in(state.rng, state.step)
    iter_keys = jax.random.split(jax.random.fold_in(base, 0),
                                 jcfg.train.n_critic)
    k_zg, k_sg = jax.random.split(jax.random.fold_in(base, 1))

    def t(a):
        return torch.from_numpy(np.array(a))

    def head_noise(key):
        """``sample_head``'s Gumbel draws: one for the plain head, the
        (base, START, GOAL) triple of the spatial structural head."""
        shape = (bsz, size, size, m.n_tiles)
        if m.structural_head != "spatial":
            return t(jax.random.gumbel(key, shape, jnp.float32))
        k_base, k_s, k_g = jax.random.split(key, 3)
        return (t(jax.random.gumbel(k_base, shape, jnp.float32)),
                t(jax.random.gumbel(k_s, (bsz, size * size), jnp.float32)),
                t(jax.random.gumbel(k_g, (bsz, size * size), jnp.float32)))

    its = []
    for k in iter_keys:
        k_aug, k_z, k_s, k_eps = jax.random.split(k, 4)
        its.append({
            "elements": t(jax.random.randint(k_aug, (bsz,), 0, 8)),
            "z": t(jax.random.normal(k_z, (bsz, m.latent_dim), jnp.float32)),
            "noise": head_noise(k_s),
            "eps": t(jax.random.uniform(k_eps, (bsz, 1, 1, 1), jnp.float32))})
    return {"critic": its, "g": {
        "z": t(jax.random.normal(k_zg, (bsz, m.latent_dim), jnp.float32)),
        "noise": head_noise(k_sg)}}


def check_one_step_matches_jax(jcfg, extra_metrics=()):
    """One whole step of the port against the JAX step from the same
    parameters, batch and draws: the metrics at rtol 1e-4, the parameters
    after Adam within lr / 10."""
    cfg = Config.from_dict(jcfg.to_dict())
    m = jcfg.model
    size = m.level_size
    j_state = j_create_state(jcfg, jax.random.key(0))
    ids = synthetic_corpus(N_CRITIC * B, size, seed=3).reshape(
        N_CRITIC, B, size, size)
    j_new, j_met = jax.jit(j_make_step(jcfg))(j_state, jnp.asarray(ids))

    before = {**_flat(j_state.generator, "generator"),
              **_flat(j_state.discriminator, "discriminator")}
    gen = Generator(cfg.model)
    gen.load_state_dict(generator_params_from_flat(before))
    critic = Critic(cfg.model)
    critic.load_state_dict(critic_params_from_flat(before))
    state = tstate.create_state(cfg, "cpu", generator=gen, critic=critic)
    noise = _jax_draws(jcfg, j_state)
    state, met = make_wgan_gp_step(cfg)(state, torch.from_numpy(ids),
                                        noise=noise)

    assert state.step == 1
    assert set(met) == set(j_met)
    for k in ("d_loss", "g_loss", "gp", "wdist") + tuple(extra_metrics):
        np.testing.assert_allclose(float(met[k]), float(j_met[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(met["gen_hist"].numpy(),
                                  np.asarray(j_met["gen_hist"]))

    want = {**_flat(j_new.generator, "generator"),
            **_flat(j_new.discriminator, "discriminator"),
            **_flat(j_new.g_ema, "g_ema")}
    got = {f"generator/{k.replace('.', '/')}": v.numpy()
           for k, v in state.generator.state_dict().items()}
    got.update({f"discriminator/{k.replace('.', '/')}": v.numpy()
                for k, v in state.critic.state_dict().items()})
    got.update({f"g_ema/{k.replace('.', '/')}": v.numpy()
                for k, v in state.g_ema.state_dict().items()})
    assert set(got) == set(want)
    # the largest Adam step with b1 = 0, b2 = 0.9: lr at the first update,
    # lr sqrt(0.19 / 0.1) at the second
    cap = {"discriminator": LR * (1 + np.sqrt(1.9)), "generator": LR,
           "g_ema": LR}
    for k, w in want.items():
        old = before[k.replace("g_ema/", "generator/")]
        # Adam's update is ~lr per element per update: a sign flip shows as
        # 2 lr, a missed update as lr; lr / 10 passes neither
        np.testing.assert_allclose(got[k] - old, w - old, atol=LR / 10,
                                   rtol=0, err_msg=k)
        assert np.abs(got[k] - old).max() <= cap[k.split("/")[0]] * 1.001, k
    return met


@pytest.mark.parametrize("kw", [
    {}, {"model.pallas_gp": "xla", "model.critic_mbstd": "input"},
    {"model.cond_dim": 4, "model.cond_mode": "projection",
     "train.w_cond_match": 1.0, "train.cond_match_dim_weights": "1,8,8,4",
     "data.corpus_size": 64},
    {"model.head": "softmax", "train.w_presence": 10.0,
     "model.critic_mbstd": "input"}],
    ids=["core_gp", "plain_gp_mbstd_input", "conditional_cond_match",
         "softmax_mbstd_pair"])
def test_one_wgan_gp_step_matches_jax(kw, exact_st_features):
    """The port's picker runs ``model.pallas_gp``; the JAX step its oracle.
    The conditional case scores and penalises under each real batch's
    features and adds the cond-match loss (the JAX side's straight-through
    positions as ``exact_st_features`` computes them).  The last case is
    BASELINE's mbstd pair with wgan_gp_32's head: the relaxed softmax
    sample feeds the presence prior and the input mbstd channel."""
    jcfg, _ = _cfgs()
    extra = (("cond_match",) if "model.cond_dim" in kw else ()) + (
        ("presence",) if "train.w_presence" in kw else ())
    check_one_step_matches_jax(jcfg.override(**kw), extra_metrics=extra)


def test_freeze_critic_until_holds_critic_and_its_adam():
    _, cfg = _cfgs(freeze_critic_until=1)
    state = tstate.create_state(cfg, "cpu", seed=2)
    d0 = {k: v.clone() for k, v in state.critic.state_dict().items()}
    g0 = {k: v.clone() for k, v in state.generator.state_dict().items()}
    ids = torch.from_numpy(synthetic_corpus(N_CRITIC * B, LEVEL).reshape(
        N_CRITIC, B, LEVEL, LEVEL))
    step = make_wgan_gp_step(cfg)
    rng = torch.Generator().manual_seed(0)
    state, _ = step(state, ids, generator=rng)
    assert state.opt_d.count == 0 and state.opt_g.count == 1
    for k, v in state.critic.state_dict().items():
        assert torch.equal(v, d0[k]), k
    assert any(not torch.equal(v, g0[k])
               for k, v in state.generator.state_dict().items())
    state, _ = step(state, ids, generator=rng)     # step 1: live again
    assert state.opt_d.count == N_CRITIC


def test_checkpoint_keeps_newest_and_holds_all_three_models(tmp_path):
    from levelgan_torch.lio.checkpoint import (all_checkpoints,
                                               load_generator_params,
                                               save_checkpoint)
    _, cfg = _cfgs()
    st = tstate.create_state(cfg, "cpu", seed=1)
    with torch.no_grad():
        st.g_ema.seed.bias.add_(1.0)
    for step in (1, 2, 3):
        path = save_checkpoint(str(tmp_path), st.generator, cfg, step,
                               critic=st.critic, g_ema=st.g_ema, keep=2)
    assert [os.path.basename(p) for p in all_checkpoints(str(tmp_path))] \
        == ["step_00000002", "step_00000003"]
    keys = set(np.load(os.path.join(path, "arrays.npz")).files)
    assert {f"discriminator/{k.replace('.', '/')}"
            for k in st.critic.state_dict()} <= keys
    params, _ = load_generator_params(path)        # the EMA, first
    assert torch.equal(params["seed.bias"], st.g_ema.seed.bias)


def test_scheduled_adam_matches_optax_cosine():
    jcfg, cfg = _cfgs(lr_schedule="cosine")
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(4)]
    sched = optax.cosine_decay_schedule(LR, 10 * N_CRITIC, alpha=0.01)
    tx = optax.adam(sched, b1=0.0, b2=0.9)
    p_j, opt = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    p_t = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    adam = tstate.ScheduledAdam(
        [p_t], tstate.lr_schedule(cfg, LR, N_CRITIC), (0.0, 0.9))
    for g in grads:
        upd, opt = tx.update(jnp.asarray(g), opt, p_j)
        p_j = optax.apply_updates(p_j, upd)
        p_t.grad = torch.from_numpy(g)
        adam.step()
    np.testing.assert_allclose(p_t.detach().numpy(), np.asarray(p_j),
                               atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("count", [0, 7, 20, 50])
def test_lr_schedule_matches_optax(count):
    _, cfg = _cfgs(lr_schedule="cosine")
    want = float(optax.cosine_decay_schedule(LR, 20, alpha=0.01)(count))
    assert abs(tstate.lr_schedule(cfg, LR, 2)(count) - want) < 1e-6 * LR
    _, flat = _cfgs()
    assert tstate.lr_schedule(flat, LR)(count) == LR


@pytest.mark.parametrize("step", [0, 5, 5000])
def test_update_ema_matches_jax(step):
    jcfg, cfg = _cfgs()
    gen = Generator(cfg.model).init_params(torch.Generator().manual_seed(0))
    ema = Generator(cfg.model).init_params(torch.Generator().manual_seed(1))
    # copies, and the result on the host before the in-place torch update:
    # jnp.asarray may alias the tensors' memory and JAX dispatches async
    want = j_update_ema(
        jcfg, {k: jnp.array(v.numpy()) for k, v in ema.state_dict().items()},
        {k: jnp.array(v.numpy()) for k, v in gen.state_dict().items()},
        jnp.int32(step))
    want = {k: np.asarray(v) for k, v in want.items()}
    tstate.update_ema(cfg, ema, gen, step)
    for k, v in ema.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k], atol=1e-7)


def test_create_state_inits_and_copies_ema():
    _, cfg = _cfgs()
    st = tstate.create_state(cfg, "cpu", seed=4)
    assert st.step == 0
    for (n, p), q in zip(st.generator.named_parameters(),
                         st.g_ema.parameters()):
        assert torch.equal(p, q) and not q.requires_grad, n
    again = tstate.create_state(cfg, "cpu", seed=4)
    assert torch.equal(again.critic.head.kernel, st.critic.head.kernel)


@pytest.mark.parametrize("override,match", [
    ({"model.family": "track"}, "track"),
])
def test_step_raises_for_later_slices(override, match):
    _, cfg = _cfgs()
    with pytest.raises(NotImplementedError, match=match):
        make_wgan_gp_step(cfg.override(**override))


def test_step_randomness_depends_on_seed_and_step_only():
    _, cfg = _cfgs()
    corpus = torch.arange(40, dtype=torch.uint8).reshape(10, 2, 2)
    a = api.sample_batch(corpus, cfg, api.step_generator(cfg, 3, "cpu"))
    b = api.sample_batch(corpus, cfg, api.step_generator(cfg, 3, "cpu"))
    c = api.sample_batch(corpus, cfg, api.step_generator(cfg, 4, "cpu"))
    assert a.shape == (N_CRITIC, B, 2, 2) and torch.equal(a, b)
    assert not torch.equal(a, c)


_SMALL = ["--set", "model.level_size=16", "--set", "model.base_channels=16",
          "--set", "model.critic_base_channels=16", "--set",
          "model.group_size=8", "--set", "model.latent_dim=8", "--set",
          "train.batch_size=4", "--set", "train.n_critic=2", "--set",
          "data.corpus_size=16", "--set", "io.log_every=1"]


def test_train_cli_then_export_cli(tmp_path, capsys):
    out = str(tmp_path / "run")
    assert cli_train.main(["--preset", "gumbel_64", "--device", "cpu",
                           "--set", "train.steps=2", "--out", out]
                          + _SMALL) == 0
    lines = [json.loads(s) for s in
             open(os.path.join(out, "metrics.jsonl")).read().splitlines()]
    assert [r["step"] for r in lines] == [1, 2]
    for r in lines:
        for k in ("d_loss", "g_loss", "gp", "wdist", "kl", "step_ms"):
            assert np.isfinite(r[k]), k
    ckpt = os.path.join(out, "ckpt", "step_00000002")
    keys = np.load(os.path.join(ckpt, "arrays.npz")).files
    for prefix in ("generator/", "g_ema/", "discriminator/"):
        assert any(k.startswith(prefix) for k in keys), prefix
    manifest = json.load(open(os.path.join(ckpt, "manifest.json")))
    assert manifest["step"] == 2
    levels = str(tmp_path / "levels.npz")
    assert cli_export.main(["--ckpt", ckpt, "--n", "4", "--out", levels,
                            "--device", "cpu"]) == 0
    got = np.load(levels)["levels"]
    assert got.shape == (4, 16, 16) and got.dtype == np.uint8
    assert "done: checkpoint=" in capsys.readouterr().out


def test_train_cli_print_config(capsys):
    assert cli_train.main(["--preset", "gumbel_64", "--print-config"]) == 0
    cfg = json.loads(capsys.readouterr().out)
    assert cfg["model"]["level_size"] == 64 and cfg["train"]["n_critic"] == 5
