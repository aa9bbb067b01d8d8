"""Port parity: the BCE GAN step and the cond-match scale against the JAX
package, on the CPU in f32.

The JAX step (``levelgan.train.gan.make_gan_step``) draws its randomness
from ``fold_in(state.rng, state.step)`` split five ways (``gan.py:96-97``):
the D4 elements, z1, the Gumbel draws of D's fake, z2, the Gumbel draws of
G's fake.  The test makes the same draws from the same keys and injects
them into the port's step, from the same parameters and batch.

The conditional cases hold the port to the JAX step with one change on the
JAX side, made by ``exact_st_features``: its straight-through positions
are ``hard + (soft - soft)``, exactly the hard cell forward, as the
port's are.  The package's ``(hard + soft) - soft`` lands a few ulps
either side of the hard cell by its rounding, so where a generated level
has START and GOAL in one row or column, the sign of that |0| distance
term's gradient follows XLA's summation order and no port can match it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.config import Config as JConfig
from levelgan.config import DataConfig as JDataConfig
from levelgan.config import ModelConfig as JModelConfig
from levelgan.config import TrainConfig as JTrainConfig
from levelgan.data import features as j_features
from levelgan.data.dataset import synthetic_corpus
from levelgan.train.gan import corpus_cond_scale as j_corpus_cond_scale
from levelgan.train.gan import make_gan_step as j_make_gan_step
from levelgan.train.state import create_state as j_create_state
from levelgan_torch.bridge import (critic_params_from_flat,
                                   generator_params_from_flat)
from levelgan_torch.config import Config
from levelgan_torch.models import Critic, Generator
from levelgan_torch.train import state as tstate
from levelgan_torch.train.gan import corpus_cond_scale, make_gan_step
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

LR = 1e-4
B, LEVEL = 4, 16
COND = {"model.cond_dim": 4, "model.cond_mode": "projection",
        "train.w_cond_match": 1.0, "train.cond_match_dim_weights": "1,8,8,4",
        "data.corpus_size": 64}


def _exact_st_soft_features(sample):
    """``levelgan.data.features.soft_level_features`` with its
    straight-through positions computed as ``hard + (soft - soft)``."""
    b, h, w, _ = sample.shape
    sample = sample.astype(jnp.float32)
    rows = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)

    def frac(tile):
        return sample[..., tile].sum(axis=(1, 2)) / (h * w)

    def st_pos(tile):
        p = sample[..., tile]
        z = p.sum(axis=(1, 2)) + 1e-6
        soft_r = (p * rows).sum(axis=(1, 2)) / z
        soft_c = (p * cols).sum(axis=(1, 2)) / z
        idx = jnp.argmax(p.reshape(b, -1), axis=-1)
        return ((idx // w).astype(jnp.float32)
                + (soft_r - jax.lax.stop_gradient(soft_r)),
                (idx % w).astype(jnp.float32)
                + (soft_c - jax.lax.stop_gradient(soft_c)))

    sr, sc = st_pos(j_features.START)
    gr, gc = st_pos(j_features.GOAL)
    dist = (jnp.abs(sr - gr) + jnp.abs(sc - gc)) / (h + w)
    return jnp.stack([frac(j_features.WALL), frac(j_features.HAZARD),
                      frac(j_features.COIN), dist], axis=-1)


@pytest.fixture
def exact_st_features(monkeypatch):
    """The JAX steps import ``soft_level_features`` when they trace."""
    monkeypatch.setattr(j_features, "soft_level_features",
                        _exact_st_soft_features)


def _jcfg(**overrides):
    jcfg = JConfig(
        model=JModelConfig(level_size=LEVEL, base_channels=16,
                           critic_base_channels=16, group_size=8,
                           latent_dim=8, dtype="float32", head="gumbel"),
        train=JTrainConfig(loss="gan", batch_size=B, lr_g=LR, lr_d=LR,
                           beta1=0.0, beta2=0.9, steps=10),
        data=JDataConfig(augment=True))
    return jcfg.override(**overrides) if overrides else jcfg


def _flat(tree, prefix):
    return {f"{prefix}/" + jax.tree_util.keystr(p, simple=True, separator="/"):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_gan_draws(jcfg, state):
    """The draws the JAX GAN step makes from ``state.rng`` at ``state.step``."""
    m = jcfg.model
    base = jax.random.fold_in(state.rng, state.step)
    k_aug, k_z1, k_s1, k_z2, k_s2 = jax.random.split(base, 5)

    def t(a):
        return torch.from_numpy(np.array(a))

    def gumbel(k):
        return t(jax.random.gumbel(k, (B, m.level_size, m.level_size,
                                       m.n_tiles), jnp.float32))

    return {"elements": t(jax.random.randint(k_aug, (B,), 0, 8)),
            "z1": t(jax.random.normal(k_z1, (B, m.latent_dim), jnp.float32)),
            "noise1": gumbel(k_s1),
            "z2": t(jax.random.normal(k_z2, (B, m.latent_dim), jnp.float32)),
            "noise2": gumbel(k_s2)}


def _params(state_dicts):
    got = {}
    for prefix, sd in state_dicts.items():
        got.update({f"{prefix}/{k.replace('.', '/')}": v.numpy()
                    for k, v in sd.items()})
    return got


@pytest.mark.parametrize("overrides", [
    {}, {"train.r1_gamma": 0.5}, COND, {**COND, "train.r1_gamma": 0.5}],
    ids=["bce", "bce_r1", "conditional_cond_match", "conditional_r1"])
def test_one_gan_step_matches_jax(overrides, exact_st_features):
    jcfg = _jcfg(**overrides)
    cfg = Config.from_dict(jcfg.to_dict())
    j_state = j_create_state(jcfg, jax.random.key(0))
    ids = synthetic_corpus(B, LEVEL, seed=3)
    j_new, j_met = jax.jit(j_make_gan_step(jcfg))(j_state, jnp.asarray(ids))

    before = {**_flat(j_state.generator, "generator"),
              **_flat(j_state.discriminator, "discriminator")}
    gen = Generator(cfg.model)
    gen.load_state_dict(generator_params_from_flat(before))
    critic = Critic(cfg.model)
    critic.load_state_dict(critic_params_from_flat(before))
    state = tstate.create_state(cfg, "cpu", generator=gen, critic=critic)
    state, met = make_gan_step(cfg)(state, torch.from_numpy(ids),
                                    noise=_jax_gan_draws(jcfg, j_state))

    assert state.step == 1
    assert set(met) == set(j_met)
    keys = ["d_loss", "g_loss", "d_real", "d_fake"]
    if cfg.train.w_cond_match:
        keys.append("cond_match")
    for k in keys:
        np.testing.assert_allclose(float(met[k]), float(j_met[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(met["gen_hist"].numpy(),
                                  np.asarray(j_met["gen_hist"]))

    want = {**_flat(j_new.generator, "generator"),
            **_flat(j_new.discriminator, "discriminator"),
            **_flat(j_new.g_ema, "g_ema")}
    got = _params({"generator": state.generator.state_dict(),
                   "discriminator": state.critic.state_dict(),
                   "g_ema": state.g_ema.state_dict()})
    assert set(got) == set(want)
    assert state.opt_g.count == state.opt_d.count == 1
    for k, w in want.items():
        old = before[k.replace("g_ema/", "generator/")]
        # one Adam update moves an element by ~lr: a sign flip shows as
        # 2 lr, a missed update as lr; lr / 10 passes neither
        np.testing.assert_allclose(got[k] - old, w - old, atol=LR / 10,
                                   rtol=0, err_msg=k)
        assert np.abs(got[k] - old).max() <= LR * 1.001, k


@pytest.mark.parametrize("weights", ["", "1,8,8,4"])
def test_corpus_cond_scale_matches_jax(weights):
    jcfg = _jcfg(**{**COND, "train.cond_match_dim_weights": weights})
    cfg = Config.from_dict(jcfg.to_dict())
    want = np.asarray(j_corpus_cond_scale(jcfg))
    got = corpus_cond_scale(cfg)
    assert got.dtype == torch.float32 and got.shape == (4,)
    np.testing.assert_array_equal(got.numpy(), want)
    # from the trainer's own corpus, the same numbers
    levels = synthetic_corpus(64, LEVEL, seed=jcfg.data.corpus_seed,
                              rate_oversample=jcfg.data.rate_oversample)
    np.testing.assert_array_equal(corpus_cond_scale(cfg, levels).numpy(),
                                  want)


def test_gan_step_refusals():
    cfg = Config.from_dict(_jcfg().to_dict())
    with pytest.raises(ValueError, match="conditional model"):
        make_gan_step(cfg.override(**{"train.w_cond_match": 1.0}))
    with pytest.raises(ValueError, match="track-family"):
        make_gan_step(cfg.override(**{"train.w_closure": 1.0}))
    state = tstate.create_state(cfg, "cpu", seed=1)
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        make_gan_step(cfg)(state, torch.zeros(2, B, LEVEL, LEVEL,
                                              dtype=torch.uint8))


def test_gan_step_draws_depend_on_the_generator_only():
    cfg = Config.from_dict(_jcfg(**{"train.r1_gamma": 0.5}).to_dict())
    ids = torch.from_numpy(synthetic_corpus(B, LEVEL, seed=5))
    outs = []
    for _ in range(2):
        state = tstate.create_state(cfg, "cpu", seed=2)
        state, met = make_gan_step(cfg)(
            state, ids, generator=torch.Generator().manual_seed(7))
        outs.append((met, state.generator.state_dict()))
    for k in ("d_loss", "g_loss", "d_real", "d_fake"):
        assert torch.equal(outs[0][0][k], outs[1][0][k]), k
    for k, v in outs[0][1].items():
        assert torch.equal(v, outs[1][1][k]), k
