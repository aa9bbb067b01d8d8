"""Each cell's driver rehearsed on the CPU at a tiny float32 size with the
plain path; the benchmark's files found by name; the measuring command's
refusals; planted faults and the control read as not correct."""

import json
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from portbench import faults, harness
from portbench.tests.conftest import TILE_TINY

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def tiny(workload: str) -> dict:
    w = harness.cell(BENCH, workload)
    kind = harness.traffic_file(w["traffic"])["driver"]
    traffic = ({"levels": 64, "batch": 16, "min_requests": 2}
               if kind == "export" else
               {"batch": 8, "corpus": 64, "min_steps": 2})
    return {"config_extra": TILE_TINY, "traffic_extra": traffic}


def run_tiny(workload, trace=False, **kw):
    return harness.run_cell(workload, 2 ** 31 + 12345, 0.2, trace,
                            device="cpu", bench=BENCH, **tiny(workload),
                            **kw)


def test_files_are_found_by_name_and_metrics_list_their_cells():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in BENCH["configs"]:
        conf = harness.load_json(ROOT / c["file"])
        assert conf["reduced"] == c["reduced"] == []
        harness.program_config(conf)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for w in BENCH["workloads"]:
        traffic = harness.traffic_file(w["traffic"])
        harness.driver(traffic["driver"])
        assert harness.limits_file(w["name"])["checks"]
        reported = [m["name"] for m in harness.metrics_of(
            BENCH, w["name"], False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert traffic.get("rate_metric", "train_step_ms") in reported
    for w in cells:
        assert harness.metrics_of(BENCH, w, True)
    for m in BENCH["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_rehearses_on_the_cpu(workload, trace):
    line = run_tiny(workload, trace)
    assert list(line)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] >= 2 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    want = {m["name"] for m in harness.metrics_of(BENCH, workload, trace)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    else:
        assert {"device_ops", "idle_gaps"} == set(line["breakdown"])
    json.dumps(line)


CELL_FAULTS = [(w, f) for w in CELLS for f in {
    "export_65536": ["altered_tile"],
    "train_b512": ["half_batch", "frozen_step", "frozen_ema"],
}[harness.cell(BENCH, w)["traffic"]]]


@pytest.mark.parametrize("workload,fault", CELL_FAULTS)
def test_a_planted_fault_is_not_correct(workload, fault):
    with faults.FAULTS[fault]():
        line = run_tiny(workload)
    assert line["correct"] is False, line["compared"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_fp8_control_is_not_correct(workload):
    assert run_tiny(workload, control=True)["correct"] is False


def test_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    assert "levelgan_torch" in sys.modules or True
    monkeypatch.setitem(sys.modules, "levelgan_torchish",
                        types.ModuleType("levelgan_torchish"))
    assert "levelgan" not in harness.forbidden_modules() or (
        "levelgan" in sys.modules)
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert "jax" in harness.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r});"
            "from portbench import harness;"
            "from portbench.tests.test_portbench_harness import run_tiny;"
            "line = run_tiny('gumbel_64.export');"
            "print(json.dumps([line['correct'], harness.forbidden_modules()]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]


def _command(cwd, workload="gumbel_64.export"):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 99), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=cwd, timeout=300)


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _command(ROOT)
    assert out.returncode != 0 and "{" not in out.stdout
    assert "CUDA" in out.stderr


def test_the_command_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout
