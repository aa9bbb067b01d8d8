"""Port parity: Generator (through the parameter bridge) and the sampling
heads against the JAX package, on the CPU in f32.

JAX params are initialised, perturbed with numpy noise (so the zero-init
FiLM path is exercised), flattened as a checkpoint flattens them and loaded
into the port through ``generator_params_from_flat``.  The heads get the
exact Gumbel draws the JAX head made from its key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.config import ModelConfig as JModelConfig
from levelgan.models import Generator as JGenerator
from levelgan.models.heads import sample_head as j_sample_head
from levelgan.ops.gumbel import tau_schedule as j_tau_schedule
from levelgan_torch.bridge import generator_params_from_flat
from levelgan_torch.config import ModelConfig
from levelgan_torch.models import Generator, sample_head
from levelgan_torch.ops.gumbel import tau_schedule
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOGIT_TOL = 1e-4   # f32 on both sides; the JAX Pallas-vs-XLA tolerance


def _small(level_size, cond_dim=0):
    kw = dict(level_size=level_size, base_channels=16, group_size=8,
              latent_dim=8, dtype="float32", cond_dim=cond_dim,
              cond_embed_dim=8, head="gumbel")
    return JModelConfig(**kw), ModelConfig(**kw)


def _flat_params(jm, seed):
    z = jnp.zeros((2, jm.latent_dim))
    cond = jnp.zeros((2, jm.cond_dim)) if jm.cond_dim else None
    params = JGenerator(jm).init(jax.random.key(seed), z, cond)["params"]
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    flat = {"generator/" + jax.tree_util.keystr(p, simple=True, separator="/"):
            np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return tree, flat


@pytest.mark.parametrize("level_size,cond_dim", [(16, 0), (32, 0), (16, 4)])
def test_generator_logits_match_jax(level_size, cond_dim):
    jm, tm = _small(level_size, cond_dim)
    tree, flat = _flat_params(jm, seed=level_size + cond_dim)
    rng = np.random.default_rng(1)
    z = rng.standard_normal((3, jm.latent_dim)).astype(np.float32)
    cond = (rng.uniform(0, 1, (3, cond_dim)).astype(np.float32)
            if cond_dim else None)
    want = np.asarray(JGenerator(jm).apply(
        {"params": tree}, jnp.asarray(z),
        None if cond is None else jnp.asarray(cond)))
    gen = Generator(tm)
    gen.load_state_dict(generator_params_from_flat(flat))
    with torch.no_grad():
        got = gen(torch.from_numpy(z),
                  None if cond is None else torch.from_numpy(cond)).numpy()
    assert got.shape == (3, level_size, level_size, tm.n_tiles)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_bridge_prefers_ema_and_names_match():
    jm, tm = _small(16, 4)
    _, flat = _flat_params(jm, seed=0)
    ema = {k.replace("generator/", "g_ema/"): v + 1.0 for k, v in flat.items()}
    params = generator_params_from_flat({**flat, **ema})
    assert set(params) == set(Generator(tm).state_dict())
    np.testing.assert_array_equal(params["seed.kernel"].numpy(),
                                  ema["g_ema/seed/kernel"])


def test_init_params_follows_flax_inits():
    _, tm = _small(16, 4)
    gen = Generator(tm).init_params(torch.Generator().manual_seed(0))
    sd = gen.state_dict()
    assert torch.all(sd["up0.film.kernel"] == 0)
    assert torch.all(sd["up0.scale"] == 1) and torch.all(sd["seed.bias"] == 0)
    assert abs(float(sd["seed.kernel"].std()) - 0.02) < 0.002


def _logits(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 2).astype(
        np.float32)


@pytest.mark.parametrize("head", ["gumbel", "argmax", "softmax"])
def test_plain_head_matches_jax(head):
    logits = _logits((4, 8, 8, 8))
    key = jax.random.key(3)
    want = np.asarray(j_sample_head(key, jnp.asarray(logits), head, tau=0.5))
    noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
    got = sample_head(torch.from_numpy(logits), head, tau=0.5,
                      noise=torch.from_numpy(noise)).numpy()
    if head == "softmax":
        np.testing.assert_allclose(got, want, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("head", ["gumbel", "argmax"])
def test_spatial_structural_head_matches_jax(head):
    logits = _logits((4, 8, 8, 8), seed=5)
    key = jax.random.key(9)
    want = np.asarray(j_sample_head(key, jnp.asarray(logits), head, tau=0.5,
                                    structural="spatial"))
    k_base, k_s, k_g = jax.random.split(key, 3)
    noise = tuple(torch.from_numpy(np.array(jax.random.gumbel(k, s, jnp.float32)))
                  for k, s in ((k_base, logits.shape), (k_s, (4, 64)),
                               (k_g, (4, 64))))
    got = sample_head(torch.from_numpy(logits), head, tau=0.5,
                      structural="spatial", noise=noise).numpy()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=1e-6)
    ids = got.argmax(-1)
    assert ((ids == 2).sum(axis=(1, 2)) == 1).all()   # exactly one START
    assert ((ids == 3).sum(axis=(1, 2)) == 1).all()   # exactly one GOAL


def test_gumbel_head_draws_from_generator():
    logits = torch.zeros(2, 4, 4, 8)
    a = sample_head(logits, "gumbel", generator=torch.Generator().manual_seed(1))
    b = sample_head(logits, "gumbel", generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and torch.all(a.sum(-1) == 1)


@pytest.mark.parametrize("step", [0, 500, 2000, 5000])
def test_tau_schedule_matches_jax(step):
    want = float(j_tau_schedule(step, 2.0, 0.5, 2000))
    assert abs(tau_schedule(step, 2.0, 0.5, 2000) - want) < 1e-6
