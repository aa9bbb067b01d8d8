"""The port's level features (``levelgan_torch/data/features.py``) against
the JAX package's ``data/features.py``: hard features exactly, the soft
twin's values and gradients within rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from levelgan.config import preset as j_preset
from levelgan.data import features as jfeat
from levelgan.data.dataset import LevelDataset as JLevelDataset
from levelgan_torch.config import Config
from levelgan_torch.data import features as tfeat
from levelgan_torch.data.dataset import LevelDataset

from test_torch_solver import random_levels
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_level_features_match_jax():
    ids = np.concatenate([random_levels(1, wall=0.2),
                          random_levels(2, wall=0.5, with_start=False)])
    np.testing.assert_array_equal(
        tfeat.level_features(torch.from_numpy(ids)).numpy(),
        np.asarray(jfeat.level_features(jnp.asarray(ids))))


def test_corpus_mean_cond_matches_jax_on_a_cut_corpus():
    jcfg = j_preset("conditional_32").override(**{"data.corpus_size": 48})
    tcfg = Config.from_dict(jcfg.to_dict())
    jds = JLevelDataset.from_config(jcfg.data, jcfg.model, seed=0)
    tds = LevelDataset.from_config(tcfg.data, tcfg.model, seed=0)
    np.testing.assert_array_equal(tds.levels, jds.levels)
    want = jfeat.corpus_mean_cond(jcfg, jds)
    got = tfeat.corpus_mean_cond(tcfg, tds, device="cpu")
    assert got.dtype == want.dtype and got.shape == (4,)
    np.testing.assert_array_equal(got, want)
    # fixed-size batches with a tail batch give the same features
    np.testing.assert_array_equal(
        tfeat.batched_features(tfeat.level_features, tds.levels, batch=20,
                               device="cpu"),
        jfeat.batched_features(jfeat.level_features, jds.levels, batch=20))


def test_soft_level_features_values_and_gradients_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 8, 8, 8)).astype(np.float32)
    w = rng.standard_normal((3, 4)).astype(np.float32)

    def j_loss(x):
        sample = jax.nn.softmax(2.0 * x, axis=-1)
        return jnp.sum(jfeat.soft_level_features(sample) * w)

    xt = torch.from_numpy(x).requires_grad_(True)
    feats = tfeat.soft_level_features(torch.softmax(2.0 * xt, dim=-1))
    np.testing.assert_allclose(
        feats.detach().numpy(),
        np.asarray(jfeat.soft_level_features(
            jax.nn.softmax(2.0 * jnp.asarray(x), axis=-1))),
        rtol=1e-5, atol=1e-7)
    (feats * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(jax.grad(j_loss)(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-7)
    # on one-hot levels the soft twin equals the hard features
    ids = random_levels(6, b=4, size=8)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(ids).long(), 8)
    np.testing.assert_allclose(
        tfeat.soft_level_features(onehot.float()).numpy(),
        tfeat.level_features(torch.from_numpy(ids)).numpy(), atol=1e-6)


def test_soft_distance_at_a_start_goal_tie_takes_jax_abs_derivative():
    """START and GOAL argmax cells in one row: the port's forward there is
    exactly the hard distance and its gradient is the JAX oracle's with
    exact straight-through positions (|x|' = +1 at 0), where torch's abs
    would drop the row term."""
    from test_torch_gan_step import _exact_st_soft_features

    x = np.random.default_rng(7).standard_normal((2, 8, 8, 8)).astype(
        np.float32)
    x[:, 3, 1, 2] = x[:, 3, 6, 3] = 9.0      # START (2), GOAL (3) in row 3
    xt = torch.from_numpy(x).requires_grad_(True)
    dist = tfeat.soft_level_features(torch.softmax(xt, dim=-1))[:, 3]
    assert dist.detach().tolist() == [5 / 16, 5 / 16]   # |6 - 1| / (8 + 8)
    dist.sum().backward()
    want = jax.grad(lambda v: jnp.sum(_exact_st_soft_features(
        jax.nn.softmax(v, axis=-1))[:, 3]))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-8)
