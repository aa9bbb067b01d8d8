"""Port parity: the data path (synthetic corpus, D4 augmentation, dataset),
the metrics and the step schedules against the JAX package, on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.config import ModelConfig as JModelConfig
from levelgan.config import TrainConfig as JTrainConfig
from levelgan.data.augment import d4_apply as j_d4_apply
from levelgan.data.dataset import LevelDataset as JLevelDataset
from levelgan.data.dataset import synthetic_corpus as j_synthetic_corpus
from levelgan.lio.metrics import kl_divergence as j_kl
from levelgan.lio.metrics import tile_histogram as j_tile_histogram
from levelgan.ops import presence as jpresence
from levelgan_torch.config import DataConfig, ModelConfig, TrainConfig
from levelgan_torch.data import augment as taug
from levelgan_torch.data.dataset import LevelDataset, synthetic_corpus
from levelgan_torch.lio.metrics import MetricsLogger, kl_divergence
from levelgan_torch.lio.metrics import tile_histogram
from levelgan_torch.ops import presence
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("kw", [{}, {"rate_oversample": 0.5, "seed": 7}])
def test_synthetic_corpus_bit_identical_to_jax(kw):
    want = j_synthetic_corpus(24, 16, **kw)
    got = synthetic_corpus(24, 16, **kw)
    assert got.dtype == np.uint8 and got.shape == (24, 16, 16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("element", range(8))
@pytest.mark.parametrize("spatial_offset", [0, 1])
def test_d4_element_matches_jax(element, spatial_offset):
    shape = (5, 5, 3) if spatial_offset else (5, 5)
    x = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    want = np.asarray(j_d4_apply(jnp.asarray(x), jnp.int32(element),
                                 spatial_offset))
    got = taug.d4_apply(torch.from_numpy(x), element, spatial_offset).numpy()
    np.testing.assert_array_equal(got, want)


def test_augment_injected_elements_match_jax_per_sample():
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 8, (8, 6, 6)).astype(np.uint8)
    elements = np.arange(8)
    got = taug.augment(torch.from_numpy(batch), torch.from_numpy(elements))
    for i, e in enumerate(elements):
        np.testing.assert_array_equal(
            got[i].numpy(),
            np.asarray(j_d4_apply(jnp.asarray(batch[i]), jnp.int32(e))))


def test_augment_draws_from_generator_and_rejects_non_square():
    batch = torch.arange(2 * 4 * 4).reshape(2, 4, 4)
    a = taug.augment(batch, generator=torch.Generator().manual_seed(3))
    b = taug.augment(batch, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        taug.augment(torch.zeros(2, 4, 5))
    with pytest.raises(ValueError):
        taug.d4_apply(torch.zeros(4, 5), 1)


def _data_cfg(**kw):
    return DataConfig(corpus_size=12, **kw)


def test_dataset_from_config_matches_jax():
    jm = JModelConfig(level_size=16)
    from levelgan.config import DataConfig as JDataConfig
    want = JLevelDataset.from_config(JDataConfig(corpus_size=12), jm, seed=3)
    got = LevelDataset.from_config(_data_cfg(), ModelConfig(level_size=16),
                                   seed=3)
    np.testing.assert_array_equal(got.levels, want.levels)
    np.testing.assert_array_equal(got.sample_at(5, 6), want.sample_at(5, 6))
    np.testing.assert_array_equal(got.sample(4), want.sample(4))
    np.testing.assert_array_equal(got.tile_histogram(8),
                                  want.tile_histogram(8))


def test_dataset_npz_corpus_and_checks(tmp_path):
    levels = synthetic_corpus(6, 16)
    path = tmp_path / "c.npz"
    np.savez(path, levels=levels)
    ds = LevelDataset.from_config(_data_cfg(corpus=str(path)),
                                  ModelConfig(level_size=16))
    np.testing.assert_array_equal(ds.levels, levels)
    np.save(tmp_path / "f.npy", levels.astype(np.float32))
    with pytest.raises(ValueError, match="tile ids must be integer"):
        LevelDataset.from_config(_data_cfg(corpus=str(tmp_path / "f.npy")),
                                 ModelConfig(level_size=16))
    with pytest.raises(ValueError, match="n_tiles"):
        LevelDataset.from_config(_data_cfg(corpus=str(path)),
                                 ModelConfig(level_size=16, n_tiles=4))
    with pytest.raises(ValueError):
        LevelDataset(levels.astype(np.int32))


def test_synthetic_native_raises_until_copied():
    """The C carver is copied now: ``synthetic_native`` is the JAX
    package's native corpus (its own stream, not the NumPy carver's)."""
    got = LevelDataset.from_config(_data_cfg(corpus="synthetic_native"),
                                   ModelConfig(level_size=16))
    want = JLevelDataset.from_config(_data_cfg(corpus="synthetic_native"),
                                     JModelConfig(level_size=16))
    np.testing.assert_array_equal(got.levels, want.levels)
    numpy_carver = LevelDataset.from_config(_data_cfg(corpus="synthetic"),
                                            ModelConfig(level_size=16))
    assert not np.array_equal(got.levels, numpy_carver.levels)


def test_tile_histogram_and_kl_match_jax():
    ids = np.random.default_rng(1).integers(0, 8, (3, 6, 6))
    hist = tile_histogram(torch.from_numpy(ids), 8)
    np.testing.assert_array_equal(hist.numpy(),
                                  np.asarray(j_tile_histogram(ids, 8)))
    ref = np.random.default_rng(2).integers(1, 50, 8).astype(np.float64)
    assert abs(kl_divergence(hist, ref) - float(j_kl(np.asarray(hist), ref))) \
        < 1e-6


def test_metrics_logger_writes_jsonl(tmp_path):
    log = MetricsLogger(str(tmp_path), echo=False)
    rec = log.log(10, d_loss=torch.tensor(0.5), hist=np.arange(3), kl=0.1234567)
    log.close()
    line = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert line == rec and line["step"] == 10 and line["d_loss"] == 0.5
    assert line["hist"] == [0, 1, 2] and line["kl"] == 0.123457


@pytest.mark.parametrize("step", [0, 50, 149, 400])
@pytest.mark.parametrize("kw", [
    {}, {"presence_excess": 2.0}, {"presence_excess": 2.0,
                                   "presence_excess_start": 100,
                                   "presence_excess_ramp": 200}])
def test_excess_weight_schedule_matches_jax(step, kw):
    want = jpresence.excess_weight_schedule(JTrainConfig(**kw), step)
    got = presence.excess_weight_schedule(TrainConfig(**kw), step)
    assert abs(float(got) - float(want)) < 1e-6


@pytest.mark.parametrize("step", [0, 50, 149, 400])
def test_mbstd_scale_schedule_matches_jax(step):
    assert presence.mbstd_scale_schedule(TrainConfig(), step) is None
    kw = dict(loss="wgan_gp", mbstd_anneal_start=20, mbstd_anneal_steps=100,
              mbstd_anneal_floor=0.25)
    want = float(jpresence.mbstd_scale_schedule(JTrainConfig(**kw), step))
    got = presence.mbstd_scale_schedule(TrainConfig(**kw), step)
    assert abs(got - want) < 1e-6


def test_jax_stays_on_cpu_here():
    assert jax.default_backend() == "cpu"
