"""The port's validate CLI on the CPU: its identity and positional numbers
equal the JAX package's ``levelgan.lio.stats`` on the same exported
levels and the corpus the JAX package carves from the checkpoint's config,
and its quality shares equal ``levelgan.lio.quality``'s."""

import json

import numpy as np
import pytest

from levelgan.config import GOAL, START
from levelgan.config import Config as JConfig
from levelgan.data.dataset import LevelDataset as JLevelDataset
from levelgan.lio.quality import solvable_fraction as j_solvable_fraction
from levelgan.lio.stats import kl_gate, per_position_chi2
from levelgan_torch import api
from levelgan_torch.cli import validate
from levelgan_torch.config import preset

TINY = {"model.level_size": 16, "model.base_channels": 16,
        "model.critic_base_channels": 16, "model.group_size": 8,
        "model.latent_dim": 8, "train.batch_size": 4, "train.n_critic": 2,
        "data.corpus_size": 24, "train.steps": 1}


@pytest.mark.parametrize("name", ["toy_dcgan_16", "conditional_32"])
def test_validate_matches_the_jax_stats(tmp_path, name):
    cfg = preset(name).override(**{**TINY, "io.out_dir": str(tmp_path)})
    api.train(cfg, device="cpu", echo=False)
    out = tmp_path / "report.json"
    argv = ["--ckpt", str(tmp_path), "--n", "16", "--quality-n", "8",
            "--batch", "512", "--device", "cpu", "--out", str(out)]
    report, levels = validate.validate(validate.build_parser().parse_args(
        argv))
    # 100k tiles at least: ceil(100000 / 256) levels of 16 x 16
    assert report["n_levels"] == 391 == len(levels["raw"])
    assert len(levels["repaired"]) == 8

    jcfg = JConfig.from_dict(cfg.to_dict())
    ds = JLevelDataset.from_config(jcfg.data, jcfg.model,
                                   seed=jcfg.train.seed)
    assert report["corpus_levels"] == len(ds.levels) == 24
    ref = ds.tile_histogram(8)
    for path in ("raw", "shipped"):
        got = report[path]
        want = {**kl_gate(levels[path], ref, 8, 0.05),
                **per_position_chi2(levels[path], ds.levels, 8,
                                    channels={"structural": (START, GOAL)})}
        for k in ("chi2_per_dof_mean", "chi2_per_dof_structural",
                  "chi2_max"):
            assert got[k] == want[k], (path, k)
        # the JAX package's KL runs in f32 (x64 off), the port's in f64
        assert got["kl"] == pytest.approx(want["kl"], rel=1e-6), path
    for k, v in j_solvable_fraction(levels["repaired"]).items():
        assert report["repaired"][k] == pytest.approx(v, abs=1e-7), k
    gates = report["gates"]
    assert gates["identity"]["kl"] == report["raw"]["kl"]
    assert gates["positional"]["chi2_per_dof_mean"] == \
        report["shipped"]["chi2_per_dof_mean"]
    # every shipped and repaired level has one START and one GOAL
    assert report["shipped"]["one_start_frac"] == 1.0
    assert report["repaired"]["one_goal_frac"] == 1.0
    # one training step from random weights is far from the corpus
    assert not gates["identity"]["passed"] and not report["passed"]
    assert validate.main(argv) == 1
    assert json.loads(out.read_text())["gates"] == json.loads(
        json.dumps(gates))


def test_validate_passes_at_the_corpus(tmp_path, monkeypatch):
    """Levels drawn from the corpus itself pass every gate."""
    cfg = preset("toy_dcgan_16").override(**{
        **TINY, "data.corpus_size": 256, "io.out_dir": str(tmp_path)})
    api.train(cfg, device="cpu", echo=False)
    corpus = JLevelDataset.from_config(
        JConfig.from_dict(cfg.to_dict()).data,
        JConfig.from_dict(cfg.to_dict()).model).levels

    def from_corpus(cfg_, params, n, **kw):
        return corpus[np.arange(n) % len(corpus)]

    monkeypatch.setattr(validate, "generate", from_corpus)
    report, _ = validate.validate(validate.build_parser().parse_args(
        ["--ckpt", str(tmp_path), "--device", "cpu"]))
    assert report["passed"], report["gates"]
    assert report["raw"]["kl"] < 1e-4
    assert report["shipped"]["chi2_per_dof_mean"] < 20
