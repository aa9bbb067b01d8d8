"""The port's calibration, stats gates and quality report against the JAX
package's ``lio`` modules; the training-time quality probe; the export
CLI with repair and with a calibrated condition, on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from levelgan.lio import calibration as jcal
from levelgan.lio import quality as jquality
from levelgan.lio import stats as jstats
from levelgan_torch import api
from levelgan_torch import export as texport
from levelgan_torch.cli import export as cli_export
from levelgan_torch.config import preset
from levelgan_torch.env.solver import solvable, well_formed
from levelgan_torch.lio import calibration as tcal
from levelgan_torch.lio import quality as tquality
from levelgan_torch.lio import stats as tstats
from levelgan_torch.lio.checkpoint import save_checkpoint
from levelgan_torch.models import Generator

from test_torch_solver import random_levels
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAMES = ("wall_frac", "hazard_frac", "coin_frac", "goal_dist")


def test_calibration_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    internal = np.linspace(-2, 2, 9)
    sweeps = {"wall_frac": {"internal": internal,
                            "realized": 0.1 * internal + 0.2},
              "goal_dist": {"internal": internal,
                            "realized": np.where(internal > 1.5, np.nan,
                                                 0.3 * internal
                                                 + 0.05 * rng.random(9))}}
    want = jcal.fit_from_sweeps(NAMES, sweeps, {"ckpt": "x"})
    got = tcal.fit_from_sweeps(NAMES, sweeps, {"ckpt": "x"})
    assert got == want
    req = rng.uniform(-0.5, 1.5, (5, 4)).astype(np.float32)
    np.testing.assert_array_equal(tcal.apply_calibration(got, req),
                                  jcal.apply_calibration(want, req))
    tcal.save_calibration(str(tmp_path), got)
    assert jcal.load_calibration(str(tmp_path)) == json.loads(json.dumps(got))
    assert tcal.calibration_path(str(tmp_path)) == jcal.calibration_path(
        str(tmp_path))


def test_stats_gates_match_jax():
    gen = random_levels(1, b=40, wall=0.3)
    ref = random_levels(2, b=60, wall=0.25)
    ref_counts = np.bincount(ref.reshape(-1), minlength=8).astype(np.float64)
    assert (tstats.kl_gate(gen, ref_counts, 8, 0.01)
            == pytest.approx(jstats.kl_gate(gen, ref_counts, 8, 0.01),
                             rel=1e-6))
    chans = {"structural": (2, 3)}
    assert (tstats.per_position_chi2(gen, ref, 8, chans)
            == jstats.per_position_chi2(gen, ref, 8, chans))
    vals = np.random.default_rng(3).random(50)
    for a, b in zip(tstats.quantile_buckets(vals, 4),
                    jstats.quantile_buckets(vals, 4)):
        np.testing.assert_array_equal(a, b)
    assert (tstats.response_stats(vals[:10], 0.5 * vals[10:20])
            == jstats.response_stats(vals[:10], 0.5 * vals[10:20]))


def test_quality_report_matches_jax():
    levels = np.concatenate([random_levels(4, b=20, wall=0.3),
                             random_levels(4, b=6, wall=0.3)])
    want = jquality.quality_report(levels, 8, sample=24, seed=1)
    got = tquality.quality_report(levels, 8, sample=24, seed=1, device="cpu")
    assert got.keys() == want.keys()
    ham = got.pop("mean_pairwise_hamming")
    assert ham == pytest.approx(want.pop("mean_pairwise_hamming"), abs=1e-6)
    assert got == want


_TINY = {"model.level_size": 16, "model.base_channels": 16,
         "model.critic_base_channels": 16, "model.group_size": 8,
         "model.latent_dim": 8, "train.batch_size": 4, "train.n_critic": 2,
         "train.steps": 2, "data.corpus_size": 16, "io.log_every": 1,
         "io.quality_every": 1, "io.quality_n": 8, "io.keep_best": True}


def test_train_logs_quality_probe_and_keeps_best(tmp_path):
    cfg = preset("gumbel_64").override(**{**_TINY,
                                          "io.out_dir": str(tmp_path)})
    res = api.train(cfg, device="cpu", echo=False)
    recs = [json.loads(s) for s in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    probes = [r for r in recs if "solvable_frac" in r]
    assert [r["step"] for r in probes] == [1, 2]
    for r in probes:
        for k in ("solvable_frac", "has_start_frac", "has_goal_frac"):
            assert 0.0 <= r[k] <= 1.0
    best = os.listdir(tmp_path / "ckpt_best")
    assert len(best) == 1 and best[0].startswith("step_")
    assert res["best"] == str(tmp_path / "ckpt_best" / best[0])


def test_quality_probe_is_seeded_and_reads_the_solver():
    cfg = preset("gumbel_64").override(**_TINY)
    gen = Generator(cfg.model).init_params(torch.Generator().manual_seed(0))
    probe = api.make_quality_probe(cfg, 8)
    a = probe(gen, torch.Generator().manual_seed(3))
    b = probe(gen, torch.Generator().manual_seed(3))
    assert {k: float(v) for k, v in a.items()} == {k: float(v)
                                                  for k, v in b.items()}
    # the same draws through the export give the same shares
    g = torch.Generator().manual_seed(3)
    z = torch.randn((8, cfg.model.latent_dim), generator=g)
    ids = texport.generate_batch(gen, cfg, z, generator=g)
    assert float(a["solvable_frac"]) == float(solvable(ids).float().mean())
    assert (float(a["has_goal_frac"])
            == float(well_formed(ids)["has_goal"].float().mean()))


def test_export_cli_repairs_every_level(tmp_path):
    cfg = preset("gumbel_64").override(**_TINY)
    gen = Generator(cfg.model).init_params(torch.Generator().manual_seed(5))
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), gen, cfg, step=0)
    out = str(tmp_path / "levels.npz")
    assert cli_export.main(["--ckpt", ckpt, "--n", "10", "--batch", "4",
                            "--out", out, "--device", "cpu", "--repair",
                            "--repair-placement", "uniform",
                            "--exactly-one"]) == 0
    levels = torch.from_numpy(np.load(out)["levels"])
    wf = well_formed(levels)
    assert levels.shape == (10, 16, 16)
    assert wf["one_start"].all() and wf["one_goal"].all()
    assert solvable(levels).all()


def test_export_cli_conditional_default_and_calibrated_cond(tmp_path):
    cfg = preset("conditional_32").override(**{
        **_TINY, "model.cond_embed_dim": 8, "data.corpus_size": 24})
    gen = Generator(cfg.model).init_params(torch.Generator().manual_seed(6))
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), gen, cfg, step=0)
    internal = np.linspace(-1, 1, 5)
    cal = tcal.fit_from_sweeps(NAMES, {
        "hazard_frac": {"internal": internal, "realized": 0.05 * internal
                        + 0.05}})
    tcal.save_calibration(ckpt, cal)
    req = np.array([0.3, 0.06, 0.05, 0.4], np.float32)
    runs = {}
    for name, extra in (("cond", ["--cond", "0.3,0.06,0.05,0.4"]),
                        ("calibrated", ["--cond", "0.3,0.06,0.05,0.4",
                                        "--calibrated"]),
                        ("default", [])):
        out = str(tmp_path / f"{name}.npz")
        assert cli_export.main(["--ckpt", ckpt, "--n", "6", "--batch", "4",
                                "--out", out, "--device", "cpu",
                                *extra]) == 0
        runs[name] = np.load(out)["levels"]
    want = texport.generate(cfg, gen, 6, batch_size=4, device="cpu",
                            cond=tcal.apply_calibration(cal, req))
    np.testing.assert_array_equal(runs["calibrated"], want)
    np.testing.assert_array_equal(
        runs["cond"], texport.generate(cfg, gen, 6, batch_size=4,
                                       device="cpu", cond=req))
    assert runs["default"].shape == (6, 16, 16)
    with pytest.raises(SystemExit, match="needs 4 values"):
        cli_export.main(["--ckpt", ckpt, "--n", "2", "--out",
                         str(tmp_path / "x.npz"), "--device", "cpu",
                         "--cond", "0.1"])
