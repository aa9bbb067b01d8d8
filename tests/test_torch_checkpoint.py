"""Full-state port checkpoints that the JAX package reads, on the CPU.

The port's ``save_checkpoint`` with the critic and both optimizers writes
every key ``levelgan.lio.checkpoint.flat_to_state`` reads: the optimizers
in optax's ``adam`` layout, ``rng`` key data of ``train.prng_impl``'s shape
and ``g_baseline``.  The key names and leaf shapes are taken from
``state_to_flat`` of a JAX ``create_state`` here, not from the writer.
"""

import os

import jax
import numpy as np
import pytest
import torch

from levelgan.cli import export as j_export
from levelgan.config import Config as JConfig
from levelgan.config import DataConfig as JDataConfig
from levelgan.config import ModelConfig as JModelConfig
from levelgan.config import TrainConfig as JTrainConfig
from levelgan.data.dataset import synthetic_corpus
from levelgan.lio.checkpoint import load_checkpoint, state_to_flat
from levelgan.train.state import create_state as j_create_state
from levelgan_torch import api
from levelgan_torch.cli import train as cli_train
from levelgan_torch.config import Config
from levelgan_torch.lio.checkpoint import save_checkpoint
from levelgan_torch.train import state as tstate
from levelgan_torch.train.wgan_gp import make_wgan_gp_step
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, N_CRITIC, LEVEL = 4, 2, 16


def _cfgs(**train):
    jcfg = JConfig(
        model=JModelConfig(level_size=LEVEL, base_channels=16,
                           critic_base_channels=16, group_size=8,
                           latent_dim=8, dtype="float32", head="gumbel"),
        train=JTrainConfig(loss="wgan_gp", batch_size=B, n_critic=N_CRITIC,
                           beta1=0.0, beta2=0.9, steps=10, **train),
        data=JDataConfig(augment=True))
    return jcfg, Config.from_dict(jcfg.to_dict())


def _stepped_state(cfg, steps=2):
    """A port state after ``steps`` WGAN-GP steps on the CPU."""
    state = tstate.create_state(cfg, "cpu", seed=3)
    step = make_wgan_gp_step(cfg)
    corpus = synthetic_corpus(steps * N_CRITIC * B, LEVEL)
    for i in range(steps):
        ids = torch.from_numpy(corpus[i * N_CRITIC * B:(i + 1) * N_CRITIC * B]
                               .reshape(N_CRITIC, B, LEVEL, LEVEL))
        state, _ = step(state, ids, generator=torch.Generator().manual_seed(i))
    return state


def _jax_example(jcfg):
    return jax.device_get(j_create_state(jcfg, jax.random.key(
        0, impl=jcfg.train.prng_impl)))


@pytest.mark.parametrize("schedule", ["none", "cosine"])
def test_full_state_keys_and_shapes_are_the_jax_state(tmp_path, schedule):
    jcfg, cfg = _cfgs(lr_schedule=schedule)
    st = tstate.create_state(cfg, "cpu", seed=1)
    path = save_checkpoint(str(tmp_path), st.generator, cfg, 0,
                           critic=st.critic, g_ema=st.g_ema, opt_g=st.opt_g,
                           opt_d=st.opt_d)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        got = {k: z[k] for k in z.files}
    want = state_to_flat(_jax_example(jcfg))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k


def test_load_checkpoint_restores_the_port_adam_state(tmp_path):
    jcfg, cfg = _cfgs(lr_schedule="cosine")
    st = _stepped_state(cfg)
    path = api.save_state(str(tmp_path), st, cfg, st.step, keep=0)
    restored, rcfg = load_checkpoint(path, _jax_example(jcfg))
    assert rcfg == jcfg and int(restored.step) == st.step == 2
    for opt, model, (adam, sched) in ((st.opt_g, st.generator,
                                       restored.opt_g),
                                      (st.opt_d, st.critic, restored.opt_d)):
        assert int(adam.count) == int(sched.count) == opt.count > 0
        for name, p in model.named_parameters():
            key = name.replace(".", "/")
            np.testing.assert_array_equal(_leaf(adam.mu, key),
                                          opt.state[p]["exp_avg"].numpy())
            np.testing.assert_array_equal(_leaf(adam.nu, key),
                                          opt.state[p]["exp_avg_sq"].numpy())
    for name, p in st.generator.named_parameters():
        np.testing.assert_array_equal(
            _leaf(restored.generator, name.replace(".", "/")),
            p.detach().numpy())


def _leaf(tree, key):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if jax.tree_util.keystr(path, simple=True, separator="/") == key:
            return np.asarray(leaf)
    raise KeyError(key)


@pytest.mark.parametrize("impl,words", [("threefry2x32", 2), ("rbg", 4)])
def test_rng_key_data_has_the_shape_of_the_prng_impl(tmp_path, impl, words):
    jcfg, cfg = _cfgs(prng_impl=impl)
    st = tstate.create_state(cfg, "cpu", seed=1)
    path = api.save_state(str(tmp_path), st, cfg, 7, keep=0)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        rng, g_baseline = z["rng"], z["g_baseline"]
    assert rng.shape == (words,) and rng.dtype == np.uint32
    assert g_baseline.shape == () and float(g_baseline) == 0.0
    restored, _ = load_checkpoint(path, _jax_example(jcfg))
    assert jax.random.key_impl(restored.rng) == jax.random.key_impl(
        jax.random.key(0, impl=impl))
    np.testing.assert_array_equal(jax.random.key_data(restored.rng), rng)


def test_generator_only_checkpoint_holds_no_optimizer_state(tmp_path):
    _, cfg = _cfgs()
    st = tstate.create_state(cfg, "cpu", seed=1)
    path = save_checkpoint(str(tmp_path), st.generator, cfg, 3)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        keys = set(z.files)
    assert "step" in keys and not keys & {"rng", "g_baseline"}
    assert all(k.startswith("generator/") or k == "step" for k in keys)


@pytest.mark.parametrize("which", ["opt_g", "opt_d", "critic"])
def test_full_state_needs_the_critic_and_both_optimizers(tmp_path, which):
    _, cfg = _cfgs()
    st = tstate.create_state(cfg, "cpu", seed=1)
    kw = dict(critic=st.critic, opt_g=st.opt_g, opt_d=st.opt_d)
    kw[which] = None
    with pytest.raises(ValueError, match="full-state"):
        save_checkpoint(str(tmp_path), st.generator, cfg, 0, **kw)


def test_port_training_checkpoint_exports_through_the_jax_cli(tmp_path):
    out = str(tmp_path / "run")
    assert cli_train.main([
        "--preset", "gumbel_64", "--device", "cpu", "--set", "train.steps=2",
        "--set", "model.level_size=16", "--set", "model.base_channels=16",
        "--set", "model.critic_base_channels=16", "--set",
        "model.group_size=8", "--set", "model.latent_dim=8", "--set",
        "train.batch_size=4", "--set", "train.n_critic=2", "--set",
        "data.corpus_size=16", "--out", out]) == 0
    levels = str(tmp_path / "levels.npz")
    assert j_export.main(["--ckpt", os.path.join(out, "ckpt"), "--n", "4",
                          "--batch", "4", "--out", levels]) in (0, None)
    got = np.load(levels)["levels"]
    assert got.shape == (4, 16, 16) and got.dtype == np.uint8
    assert int(got.max()) < 8
