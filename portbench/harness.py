"""One run of one cell: find its files by name, drive it, print the line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the preset, its overrides, the source and the cuts) and a traffic mix
(``traffic/<name>.json``: the driver kind and its parameters).  The driver
``drivers/<kind>.py`` runs set-up, the measured window and, after it, the
comparison with the plain reference against ``limits/<cell>.json``.  With
``--trace 1`` a profiled stretch follows the window, and each per-layer
metric that lists the cell is read by ``metrics/<metric>.py``.  Adding a
cell, a configuration, a mix, a driver, a limit or a metric adds a file;
no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "levelgan")


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its files, the run's arguments."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: object                  # torch.device
    cfg: object                     # levelgan_torch.config.Config
    traffic: dict
    limits: dict
    started: float                  # time.monotonic() at process start
    control: bool = False           # the reference in fp8 in the program's place
    notes: list = dataclasses.field(default_factory=list)

    def note(self, phase: str, since: float) -> float:
        """Record that ``phase`` took from ``since`` to now (monotonic);
        returns now."""
        now = time.monotonic()
        self.notes.append((phase, now - since))
        return now


@dataclasses.dataclass
class Outcome:
    """What a driver returns."""
    end_to_end: dict                # metric -> value (host clock)
    record: dict                    # what the per-layer readers read
    attempted: int
    failed: int
    checks: dict                    # name -> value compared with its limit
    memory_peak_bytes: int
    stretch: object = None          # trace.Stretch of the profiled stretch
    details: dict = dataclasses.field(default_factory=dict)  # calibrate.py


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = REPO) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload '{name}' in BENCHMARK.json")


def config_file(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(REPO / c["file"])
    raise KeyError(f"no config '{name}' in BENCHMARK.json")


def traffic_file(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits_file(workload: str) -> dict:
    return load_json(HERE / "limits" / f"{workload}.json")


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def metric_reader(name: str):
    """``read(record) -> float | None`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_config(conf: dict, extra: dict | None = None):
    """The port's Config of a configuration file (preset + overrides)."""
    from levelgan_torch.config import preset
    return preset(conf["preset"]).override(**conf.get("overrides", {}),
                                           **(extra or {}))


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's metrics: its end-to-end ones, or with ``trace`` the
    per-layer ones that list it."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device=None, started: float | None = None, bench=None,
             config_extra: dict | None = None,
             traffic_extra: dict | None = None,
             control: bool = False, details_sink: dict | None = None) -> dict:
    """Drive one run of ``workload``; returns the result line's object.
    ``config_extra`` / ``traffic_extra`` (tests: tiny sizes on the CPU)
    and ``control`` (``calibrate.py``) are not used by the measuring
    command."""
    import torch
    started = time.monotonic() if started is None else started
    bench = benchmark() if bench is None else bench
    w = cell(bench, workload)
    conf = config_file(bench, w["config"])
    traffic = {**traffic_file(w["traffic"]), **(traffic_extra or {})}
    ctx = Context(workload=workload, seed=int(seed), seconds=float(seconds),
                  trace=bool(trace),
                  device=torch.device(device or "cuda"),
                  cfg=program_config(conf, config_extra), traffic=traffic,
                  limits=limits_file(workload), started=started,
                  control=control)
    ctx.note("start to driver (imports, CUDA)", started)
    out: Outcome = driver(traffic["driver"]).run(ctx)

    values = out.end_to_end
    if trace:
        values = {}
        for m in metrics_of(bench, workload, True):
            v = metric_reader(m["name"])(out.record)
            if v is not None:
                values[m["name"]] = v
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in metrics_of(bench, workload, trace)
               if m["name"] in values}
    missing = [m["name"] for m in metrics_of(bench, workload, False)
               if m["name"] not in out.end_to_end]
    if missing:
        raise RuntimeError(f"the driver gave no {missing}")
    dev = ctx.device
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else dev.type),
        "count": 1, "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": None, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device_info}
    if trace and out.stretch is not None:
        device_info["busy_s"] = out.stretch.busy_s
        device_info["window_s"] = out.stretch.window_s
        line["breakdown"] = {"device_ops": out.stretch.top_ops(),
                             "idle_gaps": out.stretch.idle_gaps}
    # a number the run could not compare (no request completed) fails
    compared = {name: {"value": out.checks.get(name), "limit": spec["limit"]}
                for name, spec in ctx.limits["checks"].items()}
    within = all(c["value"] is not None and c["value"] <= c["limit"]
                 for c in compared.values())
    line["correct"] = bool(within and out.failed == 0 and compared)
    line["compared"] = compared
    if details_sink is not None:
        details_sink.update(out.details)
    for phase, secs in ctx.notes:
        print(f"portbench: {phase} {secs:.3f} s", file=sys.stderr)
    return line
