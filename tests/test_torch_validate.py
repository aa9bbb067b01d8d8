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
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


# ---- the rollup against tools/gate_all.py's rules --------------------------

def _numbers(kl=0.02, chi2=43.9, structural=5.0, solvable=0.95, one=1.0):
    return {"raw": {"kl": kl},
            "shipped": {"kl": kl, "chi2_per_dof_mean": chi2,
                        "chi2_per_dof_structural": structural},
            "repaired": {"solvable_frac": solvable, "one_start_frac": one,
                         "one_goal_frac": one}}


def _gate_all(monkeypatch, tmp_path, preset_name, nums, separation,
              causality=None):
    """``tools.gate_all.gate_checkpoint``'s row for a checkpoint whose
    tools report ``nums``: the JAX tools' mains are replaced by ones that
    print those numbers, so gate_all's own rules decide."""
    from levelgan.config import preset as j_preset
    from tools import eval_cond, eval_quality, gate_all
    from tools import validate as j_validate

    cfg = j_preset(preset_name).to_dict()
    monkeypatch.setattr(gate_all, "_manifest_config", lambda ckpt: cfg)

    def fake_validate(argv):
        thr = float(next(a for a in argv if a.startswith("--kl-threshold"))
                     .split("=")[1])
        rep = nums["shipped"] if "--repair" in argv else nums["raw"]
        out = {"threshold": thr, **rep}
        if "chi2_per_dof_mean" not in out:   # tools.validate prints both
            out.update({k: nums["shipped"][k] for k in (
                "chi2_per_dof_mean", "chi2_per_dof_structural")})
        print(json.dumps(out))
        return 0 if rep["kl"] <= thr else 1

    def fake_quality(argv):
        print(json.dumps({"generated": nums["repaired"], "corpus": {},
                          "skill_gap": {"separation": separation,
                                        "playable_separation": 0.0}}))
        return 0

    def fake_cond(argv):
        rep = causality["calibrated" if "--calibrated" in argv else "raw"]
        print(json.dumps(rep))
        return 0 if rep["passed"] else 1

    monkeypatch.setattr(j_validate, "main", fake_validate)
    monkeypatch.setattr(eval_quality, "main", fake_quality)
    monkeypatch.setattr(eval_cond, "main", fake_cond)
    return gate_all.gate_checkpoint(str(tmp_path), n=1024, seed=0,
                                    chi2_threshold=20.0,
                                    solvable_threshold=0.9)


def _port_rollup(nums, curriculum, separation, causality=None,
                 cal_dims=()):
    args = validate.build_parser().parse_args(["--ckpt", "x"])
    gates = validate.tile_gates(nums, args, curriculum)
    if causality is not None:
        gates.update(validate.causality_gates(
            causality["raw"], causality.get("calibrated"), cal_dims))
    if curriculum:
        gates["skillgap"] = validate.skillgap_gate(
            {"separation": separation, "playable_separation": 0.0})
    return gates, validate.rollup(gates)


def _sweep(r, slopes):
    return {"passed": r >= 0.5, "min_pearson_r": r,
            "dims": {k: {"pearson_r": r, "slope": s}
                     for k, s in slopes.items()}}


@pytest.mark.parametrize("preset_name,nums,separation,want,parent", [
    # curriculum_16_joint at PERF.md's positional 43.9: informative now
    ("curriculum_16_joint", _numbers(), 0.15, True, False),
    ("curriculum_16", _numbers(structural=25.0), 0.15, False, False),
    ("curriculum_16", _numbers(chi2=5.0), -0.01, False, True),
    ("curriculum_16", _numbers(kl=0.3, chi2=5.0), 0.15, True, False),
    # not a curriculum: every gate gates, as before
    ("wgan_gp_32", _numbers(), None, False, False),
    ("wgan_gp_32", _numbers(chi2=5.0, structural=25.0), None, True, True),
    ("wgan_gp_32", _numbers(chi2=5.0, solvable=0.5), None, False, False),
], ids=["positional_informative", "structural_gates", "skillgap_gates",
        "identity_informative", "tile_positional", "tile_pass",
        "tile_quality"])
def test_rollup_equals_gate_alls_rules(monkeypatch, tmp_path, preset_name,
                                       nums, separation, want, parent):
    curriculum = preset_name.startswith("curriculum")
    gates, got = _port_rollup(nums, curriculum, separation)
    row = _gate_all(monkeypatch, tmp_path, preset_name, nums, separation)
    assert got["passed"] == row["passed"] == want
    assert got["informative_failures"] == row["informative_failures"]
    assert sorted(gates) == sorted(row["gates"])
    for k, g in row["gates"].items():
        assert gates[k]["passed"] == g["passed"], k
        assert gates[k].get("informative", False) == g.get(
            "informative", False), k
    # the parent's rules: every tile gate gating, no structural or skillgap
    old = all(gates[k]["passed"] for k in (
        "identity", "identity_shipped", "positional", "quality"))
    assert old == parent


@pytest.mark.parametrize("raw_r,slopes,cal_dims,want", [
    (0.8, {"wall_frac": 1.1, "coin_frac": 0.2}, {"wall_frac"}, True),
    (0.8, {"wall_frac": 1.7, "coin_frac": 0.9}, {"wall_frac"}, False),
    (0.3, {"wall_frac": 1.0}, {"wall_frac"}, False),
    (0.8, {"wall_frac": 1.0}, None, True),
], ids=["band_over_fitted_dims", "slope_out_of_band", "weak_response",
        "no_calibration"])
def test_causality_gates_equal_gate_alls_rules(monkeypatch, tmp_path, raw_r,
                                               slopes, cal_dims, want):
    from levelgan.lio.calibration import save_calibration
    reports = {"raw": _sweep(raw_r, slopes)}
    if cal_dims is not None:
        reports["calibrated"] = _sweep(0.9, slopes)
        save_calibration(str(tmp_path), {"feature_names": [], "dims": {
            k: {} for k in cal_dims}})
    nums = _numbers(chi2=5.0)
    gates, got = _port_rollup(nums, False, None, reports, cal_dims or ())
    row = _gate_all(monkeypatch, tmp_path, "conditional_32", nums, None,
                    reports)
    assert got["passed"] == row["passed"] == want
    for k in ("causality", "causality_calibrated"):
        assert (k in gates) == (k in row["gates"]), k
        if k in gates:
            assert gates[k]["passed"] == row["gates"][k]["passed"], k
            assert gates[k]["slopes"] == row["gates"][k]["slopes"], k


def test_validate_gates_a_curriculum_checkpoint_as_gate_all(tmp_path):
    """A curriculum_16 checkpoint: identity, identity_shipped and positional
    informative, structural_shipped and skillgap gating; the skill gap is
    its agents' on the repaired levels against as many corpus ones."""
    from levelgan_torch.lio.checkpoint import (all_checkpoints,
                                               load_checkpoint)
    from levelgan_torch.lio.skillgap import skill_gap_report
    from levelgan_torch.train.state import create_state

    cfg = preset("curriculum_16").override(**{
        **TINY, "curriculum.rollout_steps": 6, "io.out_dir": str(tmp_path)})
    api.train(cfg, device="cpu", echo=False)
    report, levels = validate.validate(validate.build_parser().parse_args(
        ["--ckpt", str(tmp_path), "--n", "16", "--quality-n", "8",
         "--device", "cpu"]))
    gates = report["gates"]
    assert sorted(gates) == ["identity", "identity_shipped", "positional",
                             "quality", "skillgap", "structural_shipped"]
    assert [k for k, g in gates.items() if g.get("informative")] == [
        "identity", "identity_shipped", "positional"]
    assert gates["structural_shipped"]["chi2_per_dof_structural"] == \
        report["shipped"]["chi2_per_dof_structural"]
    assert report["passed"] == all(
        gates[k]["passed"] for k in ("structural_shipped", "quality",
                                     "skillgap"))
    assert report["informative_failures"] == sorted(
        k for k in ("identity", "identity_shipped", "positional")
        if not gates[k]["passed"])
    state = load_checkpoint(all_checkpoints(str(tmp_path / "ckpt"))[-1],
                            create_state(cfg, "cpu"))[0]
    want = skill_gap_report(cfg, state, levels["repaired"],
                            api.make_dataset(cfg).levels[:8], device="cpu")
    assert report["skill_gap"] == want
    assert gates["skillgap"]["separation"] == want["separation"]
