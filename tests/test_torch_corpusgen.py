"""The port's C corpus carver (``levelgan_torch/native/corpusgen.c``, built
by ``native/build.py``) against the JAX package's
``levelgan.native.build.synthetic_corpus_native``, bit for bit; the
refusal where the build fails; a run of ``api.train`` on that corpus."""

import numpy as np
import pytest

from levelgan.native.build import synthetic_corpus_native as j_native
from levelgan_torch import api
from levelgan_torch.config import DataConfig, ModelConfig, preset
from levelgan_torch.data.dataset import LevelDataset
from levelgan_torch.native import build as nbuild
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("size", [16, 32])
@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_native_corpus_equals_the_jax_packages(size, seed):
    kw = dict(wall_density=0.3, hazard_rate=0.05, coin_rate=0.07,
              rate_oversample=0.5 if seed == 7 else 0.0)
    got = nbuild.synthetic_corpus_native(24, size, seed=seed, **kw)
    assert got.dtype == np.uint8 and got.shape == (24, size, size)
    np.testing.assert_array_equal(got, j_native(24, size, seed=seed, **kw))
    # and through the dataset, as data.corpus='synthetic_native' asks
    ds = LevelDataset.from_config(
        DataConfig(corpus="synthetic_native", corpus_size=24,
                   corpus_seed=seed, **kw), ModelConfig(level_size=size))
    np.testing.assert_array_equal(ds.levels, got)


def test_a_failed_build_raises_with_the_compilers_message(tmp_path,
                                                          monkeypatch):
    """No NumPy fallback: a missing or failing ``cc`` is an error."""
    monkeypatch.setattr(nbuild, "_libs", {})
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))          # no cc on it
    with pytest.raises(RuntimeError, match="corpusgen.c"):
        LevelDataset.from_config(DataConfig(corpus="synthetic_native",
                                            corpus_size=4),
                                 ModelConfig(level_size=16))
    (tmp_path / "cc").write_text("#!/bin/sh\necho 'cc: broken' >&2\n"
                                 "exit 1\n")
    (tmp_path / "cc").chmod(0o755)
    with pytest.raises(RuntimeError, match="cc: broken"):
        nbuild.synthetic_corpus_native(4, 16)
    assert not list((tmp_path / "_build").glob("*.so"))


def test_training_on_the_native_corpus(tmp_path):
    cfg = preset("toy_dcgan_16").override(**{
        "data.corpus": "synthetic_native", "data.corpus_size": 16,
        "model.base_channels": 16, "model.critic_base_channels": 16,
        "model.group_size": 8, "model.latent_dim": 8, "train.batch_size": 4,
        "train.steps": 1, "io.out_dir": str(tmp_path)})
    out = api.train(cfg, device="cpu", echo=False)
    assert np.isfinite(out["kl"])
    np.testing.assert_array_equal(
        api.make_dataset(cfg).levels,
        j_native(16, 16, seed=cfg.data.corpus_seed,
                 wall_density=cfg.data.wall_density,
                 hazard_rate=cfg.data.hazard_rate,
                 coin_rate=cfg.data.coin_rate,
                 rate_oversample=cfg.data.rate_oversample))
