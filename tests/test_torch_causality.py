"""The port's causality sweeps (``levelgan_torch/lio/causality.py``)
against what ``tools/eval_cond.py`` computes, on the CPU.

The two packages draw different noise, so both are given the same levels:
a seeded stand-in for the generator whose walls, hazards, coins and
START -> GOAL distance follow the requested condition (some levels lose
their GOAL, as a generator's do).  ``tools.eval_cond.main`` runs its own
code on them (its ``generate``, ``make_dataset`` and ``load_generator``
replaced by the stand-in and the corpus), with the JAX package's
``level_features``, ``lio/stats`` and ``lio/calibration.fit_from_sweeps``.
Features are equal to the bit (``tests/test_torch_features.py``), so
the sweep grid and the realized means are compared exactly and r, slope,
MAE and the chi-square at 1e-12 relative (the same float64 formulas).
"""

import json

import numpy as np
import pytest

from levelgan.config import preset as j_preset
from levelgan.data.dataset import synthetic_corpus
from levelgan_torch import api
from levelgan_torch.cli import validate
from levelgan_torch.config import COIN, EMPTY, GOAL, HAZARD, START, WALL
from levelgan_torch.config import preset
from levelgan_torch.lio import causality
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZE, N, CORPUS = 16, 32, 96
REL = 1e-12


def stand_in(cond, seed, n=N):
    """Levels [n, 16, 16] whose features follow ``cond``."""
    rng = np.random.default_rng(seed)
    c = np.clip(np.asarray(cond, np.float64), 0.0, 0.9)
    u = rng.random((n, SIZE, SIZE))
    out = np.full((n, SIZE, SIZE), EMPTY, np.uint8)
    out[u < c[0]] = WALL
    out[(u >= c[0]) & (u < c[0] + c[1])] = HAZARD
    out[(u >= c[0] + c[1]) & (u < c[0] + c[1] + c[2])] = COIN
    out[:, 0, 0] = START
    k = np.clip(np.round(c[3] * 2 * SIZE + rng.normal(0, 2, n)), 1,
                2 * SIZE - 2).astype(int)
    for i in range(n):
        if rng.random() < 0.1:
            continue                     # no GOAL: goal_dist invalid
        out[i, min(k[i], SIZE - 1), max(0, k[i] - SIZE + 1)] = GOAL
    return out


@pytest.fixture(scope="module")
def corpus():
    return synthetic_corpus(CORPUS, SIZE, seed=11)


def _eval_cond(monkeypatch, tmp_path, corpus, *extra):
    import levelgan.api as japi
    import levelgan.cli.export as jexport
    import levelgan.train.state as jstate
    from tools import eval_cond

    jcfg = j_preset("conditional_32").override(**{"model.level_size": SIZE})

    class DS:
        levels = corpus

    monkeypatch.setattr(jexport, "load_generator", lambda ckpt: (jcfg, None))
    monkeypatch.setattr(jstate, "eval_generator_params", lambda s: None)
    monkeypatch.setattr(japi, "make_dataset", lambda cfg: DS)
    monkeypatch.setattr(japi, "generate", lambda cfg, params, n, *, seed,
                        cond, **kw: stand_in(cond, seed, n))
    out = tmp_path / "report.json"
    eval_cond.main(["--ckpt", str(tmp_path), "--n", str(N), "--seed", "3",
                    "--repair", "--repair-placement", "uniform", "--out",
                    str(out), *extra])
    return json.loads(out.read_text())


def _assert_same(got, want):
    assert got["corpus_feature_mean"] == want["corpus_feature_mean"]
    assert got["dims"].keys() == want["dims"].keys()
    for name, w in want["dims"].items():
        g = got["dims"][name]
        assert g.keys() == w.keys(), name
        for k in ("requested", "realized", "valid_frac", "skipped"):
            if k in w:
                assert g[k] == w[k], (name, k)
        for k in ("pearson_r", "slope", "mae"):
            assert g[k] == pytest.approx(w[k], rel=REL, abs=1e-15), (name, k)
    assert got["bucketed_chi2"].keys() == want["bucketed_chi2"].keys()
    for name, rows in want["bucketed_chi2"].items():
        assert len(got["bucketed_chi2"][name]) == len(rows), name
        for g, w in zip(got["bucketed_chi2"][name], rows):
            assert g.keys() == w.keys()
            for k, v in w.items():
                assert g[k] == pytest.approx(v, rel=REL), (name, k)
    assert got["min_pearson_r"] == pytest.approx(want["min_pearson_r"],
                                                 rel=REL)
    assert got["passed"] == want["passed"]


def test_sweep_buckets_and_fitted_calibration_match_eval_cond(
        monkeypatch, tmp_path, corpus):
    want = _eval_cond(monkeypatch, tmp_path, corpus, "--fit-calibration")
    j_cal = json.loads((tmp_path / "cond_calibration.json").read_text())
    got, cal = causality.causality_report(
        stand_in, corpus, 8, seed=3, fit_calibration=True, device="cpu",
        meta={"preset": "conditional_32", "n_per_point": N, "repair": True,
              "repair_placement": "uniform"})
    _assert_same(got, want)
    # the grid the sweep asked for: each dim's q10..q90 at 5 points
    feats = causality.features(corpus, "cpu")
    lo, hi = np.quantile(feats[:, 1], [0.1, 0.9])
    assert want["dims"]["hazard_frac"]["requested"] == np.linspace(
        lo, hi, 5).tolist()
    assert want["dims"]["goal_dist"]["valid_frac"]
    assert cal == j_cal


def test_calibrated_sweep_matches_eval_cond(monkeypatch, tmp_path, corpus):
    _eval_cond(monkeypatch, tmp_path, corpus, "--fit-calibration")
    cal = json.loads((tmp_path / "cond_calibration.json").read_text())
    want = _eval_cond(monkeypatch, tmp_path, corpus, "--calibrated")
    assert want["calibrated"]
    got, none = causality.causality_report(stand_in, corpus, 8, seed=3,
                                           calibration=cal, device="cpu")
    assert got["calibrated"] and none is None
    _assert_same(got, want)
    with pytest.raises(ValueError, match="raw internal"):
        causality.causality_report(stand_in, corpus, 8, calibration=cal,
                                   fit_calibration=True)


def test_an_unmeasurable_dim_fails_and_a_constant_one_is_skipped(corpus):
    def no_goal(cond, seed):
        lv = stand_in(cond, seed)
        lv[lv == GOAL] = EMPTY
        return lv

    rep, _ = causality.causality_report(no_goal, corpus, 8, points=3,
                                        device="cpu")
    assert "unmeasurable" in rep["dims"]["goal_dist"]["skipped"]
    assert not rep["passed"]
    flat = corpus.copy()
    flat[flat == HAZARD] = EMPTY
    rep, _ = causality.causality_report(stand_in, flat, 8, points=3,
                                        device="cpu")
    assert rep["dims"]["hazard_frac"] == {
        "skipped": "constant corpus feature", "pearson_r": None}


def test_validate_fits_and_gates_the_calibration(tmp_path):
    """``--fit-calibration`` on a conditional checkpoint: the sweeps run
    through the export, the calibration lands beside the checkpoint, and
    the two causality gates are in the report."""
    cfg = preset("conditional_32").override(**{
        "model.level_size": 16, "model.base_channels": 16,
        "model.critic_base_channels": 16, "model.group_size": 8,
        "model.latent_dim": 8, "train.batch_size": 4, "train.n_critic": 2,
        "data.corpus_size": 48, "train.steps": 1,
        "io.out_dir": str(tmp_path)})
    api.train(cfg, device="cpu", echo=False)
    args = ["--ckpt", str(tmp_path), "--n", "16", "--quality-n", "8",
            "--device", "cpu", "--points", "3", "--cal-points", "3",
            "--fit-calibration"]
    report, _ = validate.validate(validate.build_parser().parse_args(args))
    cau = report["causality"]
    assert cau["n_per_point"] == 128
    assert cau["calibration_written"] == str(
        tmp_path / "cond_calibration.json")
    assert len(cau["raw"]["dims"]["wall_frac"]["requested"]) == 3
    assert cau["calibrated"]["calibrated"]
    gates = report["gates"]
    assert gates["causality"]["min_pearson_r"] == cau["raw"]["min_pearson_r"]
    cal_dims = set(json.loads((tmp_path / "cond_calibration.json")
                              .read_text())["dims"])
    assert set(gates["causality_calibrated"]["slopes"]) <= cal_dims
    assert cau["export_levels_per_s"] > 0
