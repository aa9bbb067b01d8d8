"""``whole_runs.py``: the validate arguments and ``--max-wall`` of ``train``,
and ``record``'s ``verdict_diff`` and ``seed_sets``, on the CPU.

``record`` runs here on synthetic ``runs.json`` / ``validate.json`` files
and a planted ``<work>/<run>/gate_all.json``, which it reuses without
running a JAX tool; the JAX side's rows are the repo's own
(``artifacts/gates_all.json``, ``whole_runs.JAX_ROWS``).
"""

import json
import os
import sys
import textwrap
import time

import pytest

import whole_runs
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _g(passed, informative=False, **numbers):
    return {"passed": passed, **numbers,
            **({"informative": True} if informative else {})}


# --- verdict_diff ---------------------------------------------------------

AGREE = {"identity": _g(True, kl=0.0019), "positional": _g(
    True, chi2_per_dof_mean=1.9), "quality": _g(True, solvable_frac=0.96)}


def test_verdict_diff_is_empty_when_the_tools_agree():
    other = {k: dict(v) for k, v in AGREE.items()}
    other["identity"]["kl"] = 0.0021          # numbers differ, verdicts not
    assert whole_runs.verdict_diff(AGREE, other) == []


def test_verdict_diff_lists_a_gate_whose_passed_differs():
    # wgan_gp_32_mbin_seed3: positional chi2/dof at the threshold of 20
    port = {**AGREE, "positional": _g(True, chi2_per_dof_mean=19.82)}
    ga = {**AGREE, "positional": _g(False, chi2_per_dof_mean=20.88)}
    assert whole_runs.verdict_diff(port, ga) == [
        {"gate": "positional", "why": "passed differs",
         "port": port["positional"], "gate_all": ga["positional"]}]


@pytest.mark.parametrize("side", ["port", "gate_all"])
def test_verdict_diff_lists_a_gate_only_one_side_has(side):
    cal = _g(True, min_pearson_r=0.956, slopes={"wall_frac": 1.0})
    more = {**AGREE, "causality_calibrated": cal}
    port, ga = (more, AGREE) if side == "port" else (AGREE, more)
    diff = whole_runs.verdict_diff(port, ga)
    assert [e["gate"] for e in diff] == ["causality_calibrated"]
    assert diff[0]["why"] == ("only the port has it" if side == "port"
                              else "only gate_all has it")
    assert diff[0][side] == cal
    assert diff[0]["gate_all" if side == "port" else "port"] is None


def test_verdict_diff_reads_informative_gates_as_gate_alls_rollup():
    """A curriculum's positional gate is informative in gate_all's rollup.
    The port's validate since its rollup was shared marks it so too: no
    difference, though both fail it.  Gated by the old validate (failed,
    not informative) it differs from gate_all's, though both fail it."""
    ga = {"positional": _g(False, True, chi2_per_dof_mean=34.77),
          "structural_shipped": _g(True, chi2_per_dof_structural=8.36),
          "skillgap": _g(True, separation=0.386)}
    now = {"positional": _g(False, True, chi2_per_dof_mean=38.15),
           "structural_shipped": _g(True, chi2_per_dof_structural=9.07),
           "skillgap": _g(True, separation=0.41)}
    assert whole_runs.verdict_diff(now, ga) == []
    old = {"positional": _g(False, chi2_per_dof_mean=38.15)}
    diff = whole_runs.verdict_diff(old, ga)
    assert [(e["gate"], e["why"]) for e in diff] == [
        ("positional", "informative on one side only"),
        ("structural_shipped", "only gate_all has it"),
        ("skillgap", "only gate_all has it")]


# --- train: validate's arguments and --max-wall ----------------------------

@pytest.mark.parametrize("name", whole_runs.PRESETS)
def test_validate_argv_fits_the_calibration_of_conditional_models(name):
    cfg = whole_runs._config(name, [])
    argv = whole_runs.validate_argv(cfg, "/ckpt/step_00005000", None)
    assert argv[:4] == ["--ckpt", "/ckpt/step_00005000", "--n", "1024"]
    assert ("--fit-calibration" in argv) == (cfg.model.cond_dim > 0)
    assert (name == "conditional_32") == (cfg.model.cond_dim > 0)
    assert "--device" not in argv
    assert whole_runs.validate_argv(cfg, "c", "cpu")[-2:] == [
        "--device", "cpu"]


# A stand-in for the train CLI: sleeps until SIGTERM, then writes a
# checkpoint at the step given on its command line and exits 0, as the CLI
# does after the step in flight.
_STUB = textwrap.dedent("""
    import os, signal, sys, time
    def stop(*_):
        import json
        import numpy as np
        step = int(sys.argv[2])
        d = os.path.join(sys.argv[1], f"step_{step:08d}")
        os.makedirs(d, exist_ok=True)
        np.savez(os.path.join(d, "arrays.npz"), step=step)
        with open(os.path.join(d, "manifest.json"), "w") as fh:
            json.dump({"step": step}, fh)
        sys.exit(0)
    signal.signal(signal.SIGTERM, stop)
    time.sleep(60)
    sys.exit(3)
""")


def _stub(ckpt, step):
    return [sys.executable, "-c", _STUB, str(ckpt), str(step)]


def test_max_wall_sends_sigterm_to_the_part_in_flight(tmp_path):
    ckpt = tmp_path / "ckpt"
    t0 = time.perf_counter()
    parts = whole_runs.run_parts([_stub(ckpt, 42), _stub(ckpt, 99)],
                                 str(ckpt), None, 3.0, "stub")
    assert time.perf_counter() - t0 < 30
    assert parts == [{"rc": 0, "sigterm": True, "max_wall": True,
                      "wall_s": parts[0]["wall_s"], "checkpoint_step": 42}]
    assert 3.0 <= parts[0]["wall_s"]


def test_max_wall_stops_the_last_part_after_a_split(tmp_path):
    """gumbel_64's first part is stopped at --split and resumed; the wall
    limit, counted from the run's start, then stops the second."""
    ckpt = tmp_path / "ckpt"
    parts = whole_runs.run_parts([_stub(ckpt, 42), _stub(ckpt, 99)],
                                 str(ckpt), 2.0, 5.0, "stub")
    assert [(p["rc"], p["sigterm"], p["max_wall"], p["checkpoint_step"])
            for p in parts] == [(0, True, False, 42), (0, True, True, 99)]
    assert parts[0]["wall_s"] + parts[1]["wall_s"] >= 5.0
    assert parts[1]["wall_s"] < 5.0


# --- record: verdict_diff on every row, seed_sets ---------------------------

def _plant(runs, work, name, preset, port_gates, ga_gates, steps=3000,
           placement=None):
    """A run of ``runs/runs.json`` with its validate.json, and gate_all's
    row for it in ``work/<name>/gate_all.json``."""
    os.makedirs(runs / name, exist_ok=True)
    path = runs / "runs.json"
    doc = (json.loads(path.read_text()) if path.exists()
           else {"card": CARD, "rows": {}})
    doc["rows"][name] = {
        "preset": preset, "sets": ["io.log_every=100"], "steps": steps,
        "card": CARD, "train_wall_s": 1.0,
        "parts": [{"rc": 0, "sigterm": False, "max_wall": False,
                   "wall_s": 1.0, "checkpoint_step": steps}],
        **({"placement": placement} if placement else {})}
    path.write_text(json.dumps(doc))
    (runs / name / "validate.json").write_text(json.dumps(
        {"device": "cuda", "passed": True, "gates": port_gates,
         "n_levels": 1024}))
    os.makedirs(work / name, exist_ok=True)
    (work / name / "gate_all.json").write_text(json.dumps(
        {"passed": all(g["passed"] for g in ga_gates.values()
                       if not g.get("informative")),
         "gates": ga_gates, "rc": 0, "eval_cond_fit_rc": None}))


def _sep(s):
    return {"skillgap": _g(True, separation=s)}


def _record(tmp_path, fill, old_rows=None):
    runs, work, out = tmp_path / "runs", tmp_path / "work", tmp_path / "pg"
    fill(runs, work)
    if old_rows is not None:
        out.write_text(json.dumps({"rows": old_rows}))
    assert whole_runs.main(["record", "--runs", str(runs), "--work",
                            str(work), "--out", str(out)]) == 0
    return json.loads(out.read_text())


def test_record_seed_sets_range_rule(tmp_path):
    """One JAX run: spread iff JAX's value lies within the five port runs'
    range: racetrack_32's curvature KL (JAX 0.0521) inside,
    curriculum_16_joint's skill-gap separation (JAX 0.299) above every
    port run, race_curriculum_32's (JAX 10.39) below every one."""
    rt = [0.0874, 0.061, 0.049, 0.072, 0.095]
    cj = [0.0424, -0.0499, 0.1315, 0.0792, -0.0839]
    rc = [10.5, 11.2, 12.0, 10.9, 13.1]

    def fill(runs, work):
        for i, (k, s, r) in enumerate(zip(rt, cj, rc)):
            tag = f"_seed{i}" if i else ""
            kl = {"identity": _g(True, kl=k)}
            _plant(runs, work, "racetrack_32" + tag, "racetrack_32", kl, kl)
            _plant(runs, work, "curriculum_16_joint" + tag,
                   "curriculum_16_joint", _sep(s), _sep(s))
            _plant(runs, work, "race_curriculum_32" + tag,
                   "race_curriculum_32", _sep(r), _sep(r))
    doc = _record(tmp_path, fill)
    rt_set = doc["seed_sets"]["racetrack_32"]
    assert rt_set["runs"] == ["racetrack_32"] + [
        f"racetrack_32_seed{i}" for i in range(1, 5)]
    kl = rt_set["metrics"]["identity_kl"]
    assert kl["range"] == [0.049, 0.095]
    assert kl["jax"] == pytest.approx(0.0521, abs=1e-4)
    assert kl["verdict"] == rt_set["verdict"] == "seed spread"
    cj_set = doc["seed_sets"]["curriculum_16_joint"]
    sep = cj_set["metrics"]["skillgap_separation"]
    assert sep["range"] == [-0.0839, 0.1315]
    assert sep["jax"] == pytest.approx(0.299, abs=1e-3)
    assert sep["verdict"] == cj_set["verdict"] == "shift"
    rc_set = doc["seed_sets"]["race_curriculum_32"]
    sep = rc_set["metrics"]["skillgap_separation"]
    assert sep["jax"] == pytest.approx(10.39, abs=1e-2)
    assert sep["jax"] < sep["range"][0] == 10.5
    assert sep["verdict"] == rc_set["verdict"] == "shift"
    assert all(r["verdict_diff"] == [] for r in doc["rows"])


TOY_PORT = [0.2735, 0.1152, 0.1431, 0.3315, 0.1530]    # the port's seeds 0-4


@pytest.mark.parametrize("port, p", [
    (TOY_PORT, 0.8413), ([0.3, 0.31, 0.32, 0.33, 0.34], 0.0079)])
def test_record_seed_sets_mann_whitney(tmp_path, port, p):
    """Five JAX runs (toy_dcgan_16, ref_band.json's KLs 0.108-0.266): the
    exact two-sided Mann-Whitney test; five port KLs above every JAX one
    give U = 25 and p = 2 / C(10, 5)."""
    def fill(runs, work):
        for i, k in enumerate(port):
            kl = {"identity": _g(False, kl=k)}
            _plant(runs, work, "toy_dcgan_16" + (f"_seed{i}" if i else ""),
                   "toy_dcgan_16", kl, kl, steps=100)
    m = _record(tmp_path, fill)["seed_sets"]["toy_dcgan_16"]
    kl = m["metrics"]["identity_kl"]
    assert kl["jax"] == whole_runs.JAX_ROWS["toy_dcgan_16"]["kl"]
    assert kl["p"] == pytest.approx(p, abs=1e-4)
    assert kl["u_of"] == 25 and kl["u"] == (14 if port is TOY_PORT else 25)
    assert m["verdict"] == ("seed spread" if p > 0.05 else "shift")


def test_record_keeps_old_rows_and_diffs_them(tmp_path):
    """A row recorded again replaces its old row; an old row that is not
    gets its verdict_diff from its stored gates, its other fields kept."""
    pos = {"positional": _g(False, True, chi2_per_dof_mean=34.8)}
    old_gate = {"positional": _g(False, chi2_per_dof_mean=38.2)}
    old = [{"run": r, "preset": "curriculum_16_joint", "steps": 3000,
            "port_validate": {"gates": old_gate}, "gate_all": {"gates": pos},
            "jax": {}, "kept": r}
           for r in ("curriculum_16_joint", "curriculum_16_joint_dp4")]

    def fill(runs, work):
        _plant(runs, work, "curriculum_16_joint", "curriculum_16_joint",
               pos, pos)
    doc = _record(tmp_path, fill, old)
    rows = {r["run"]: r for r in doc["rows"]}
    assert list(rows) == ["curriculum_16_joint", "curriculum_16_joint_dp4"]
    assert rows["curriculum_16_joint"]["verdict_diff"] == []
    assert "kept" not in rows["curriculum_16_joint"]
    assert rows["curriculum_16_joint"]["jax"]["gate_all"]["ckpt"] == (
        "runs/curriculum_16_joint")
    dp4 = rows["curriculum_16_joint_dp4"]
    assert dp4["kept"] == "curriculum_16_joint_dp4"
    assert [(e["gate"], e["why"]) for e in dp4["verdict_diff"]] == [
        ("positional", "informative on one side only")]
    assert doc["seed_sets"] == {}
