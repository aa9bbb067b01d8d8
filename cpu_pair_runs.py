#!/usr/bin/env python3
"""BASELINE.md's mbstd pair trained by both packages on the CPU at a cut
size, and gated alike.

``python3 cpu_pair_runs.py --out DIR`` trains the pair (``wgan_gp_32`` with
``train.w_presence=10`` and ``model.critic_mbstd=input``: the softmax head,
bf16 activations) at ``CUT``'s widths and batch, once per package and
seed of SEEDS, through each package's own train CLI (``levelgan.cli.train``
for the JAX package, ``levelgan_torch.cli.train --device cpu`` for the
port), each run a process of its own on THREADS threads, JOBS at a time,
STEPS steps.  Each
final checkpoint is then gated alike: the JAX package's ``tools.gate_all``
(raw and shipped tile KL, structural chi2/dof, quality) and the port's
validate on the CPU, whose raw levels give the START placement (STARTs a
level, the cells that hold a START in some level); gate_all's output
and exit code (1 when a gate fails) are kept beside its JSON.  Writes
``DIR/cpu_pair_runs.json``: per package and seed those numbers, the
training window's tile KL (``whole_runs.kl_window``) and the wall times.
Finished runs and gates are reused.

Every run sees the same corpus and the same schedule; only the package
(and its random streams) differs, so the two packages' spreads over seeds
say whether the port trains the pair as the JAX package does, apart from
the card.  The JAX package runs in its own processes: this script imports
only the port.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import whole_runs

HERE = os.path.dirname(os.path.abspath(__file__))
# the pair at widths and batch a CPU trains in minutes: a quarter of the
# preset's channels (64 -> 16) and of its batch (64 -> 16)
CUT = {"model.base_channels": 16, "model.critic_base_channels": 16,
       "model.group_size": 8, "train.batch_size": 16}
PAIR = {"train.w_presence": 10, "model.critic_mbstd": "input"}
STEPS = 3000
SEEDS = (0, 1, 2)
JOBS = 3              # runs at a time
THREADS = 2           # each run's threads
CLIS = {"jax": ("levelgan.cli.train",),
        "port": ("levelgan_torch.cli.train", "--device", "cpu")}


ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS=str(THREADS),
           XLA_FLAGS=f"--xla_cpu_multi_thread_eigen=false "
                     f"intra_op_parallelism_threads={THREADS}")


def _final(run_dir: str) -> str | None:
    from levelgan_torch.lio.checkpoint import all_checkpoints
    ckpts = all_checkpoints(os.path.join(run_dir, "ckpt"))
    return ckpts[-1] if ckpts else None


def train(side: str, seed: int, out: str) -> dict:
    run_dir = os.path.join(out, f"{side}_seed{seed}")
    log = os.path.join(out, f"{side}_seed{seed}.train.log")
    row = {"side": side, "seed": seed, "run_dir": run_dir}
    final = _final(run_dir)
    if final and final.endswith(f"{STEPS:08d}"):
        return {**row, "train_wall_s": None, "rc": 0}
    sets = {**CUT, **PAIR, "train.steps": STEPS, "train.seed": seed,
            "io.log_every": whole_runs.LOG_EVERY, "io.ckpt_every": STEPS}
    argv = [sys.executable, "-m", *CLIS[side], "--preset", "wgan_gp_32",
            "--out", run_dir,
            *(a for k, v in sets.items() for a in ("--set", f"{k}={v}"))]
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        rc = subprocess.run(argv, cwd=HERE, env=ENV, stdout=fh,
                            stderr=subprocess.STDOUT).returncode
    return {**row, "train_wall_s": time.perf_counter() - t0, "rc": rc}


def gate(row: dict, out: str) -> dict:
    """gate_all and the port's validate on ``row``'s final checkpoint."""
    final = _final(row["run_dir"])
    name = f"{row['side']}_seed{row['seed']}"
    ga_path = os.path.join(out, f"{name}.gate_all.json")
    if not os.path.exists(ga_path):
        log = os.path.join(out, f"{name}.gate_all.log")
        with open(log, "w") as fh:
            rc = subprocess.run([sys.executable, "-m", "tools.gate_all",
                                 "--runs", final, "--out", ga_path + ".tmp"],
                                cwd=HERE, env=ENV, stdout=fh,
                                stderr=subprocess.STDOUT).returncode
        if rc not in (0, 1) or not os.path.exists(ga_path + ".tmp"):
            raise RuntimeError(f"tools.gate_all on {final} exited {rc}: "
                               f"see {log}")
        os.replace(ga_path + ".tmp", ga_path)
    with open(ga_path) as fh:
        ga = json.load(fh)["checkpoints"][0]
    va_path = os.path.join(out, f"{name}.validate.json")
    if not os.path.exists(va_path):
        from levelgan_torch.cli import validate
        args = validate.build_parser().parse_args(
            ["--ckpt", final, "--n", "1024", "--device", "cpu"])
        report, levels = validate.validate(args)
        report = {"gates": report["gates"], "passed": report["passed"],
                  "placement": whole_runs.start_placement(
                      levels["raw"][:whole_runs.PLACEMENT_N])}
        with open(va_path, "w") as fh:
            json.dump(report, fh, indent=2)
    with open(va_path) as fh:
        va = json.load(fh)
    steps = int(os.path.basename(final).split("_")[-1])
    return {**row, "steps": steps,
            "gate_all": {"passed": ga["passed"], "gates": {
                k: {a: b for a, b in g.items() if a != "threshold"}
                for k, g in ga["gates"].items()}},
            "port_validate": {"passed": va["passed"], "gates": {
                k: {a: b for a, b in g.items() if a != "threshold"}
                for k, g in va["gates"].items()}},
            "placement": va["placement"],
            "kl_window": whole_runs.kl_window(
                os.path.join(row["run_dir"], "metrics.jsonl"), steps)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)
    todo = [(side, seed) for seed in SEEDS for side in CLIS]
    with ThreadPoolExecutor(JOBS) as pool:
        rows = list(pool.map(lambda sd: train(*sd, a.out), todo))
    failed = [r for r in rows if r["rc"]]
    if failed:
        print(f"cpu_pair_runs: failed runs {failed}", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(JOBS) as pool:
        rows = list(pool.map(lambda r: gate(r, a.out), rows))
    rows = [{k: v for k, v in r.items() if k != "run_dir"} for r in rows]
    doc = {"what": "the mbstd pair trained by each package on the CPU at "
                   "a cut size, gated by tools.gate_all and the port's "
                   "validate", "script": "cpu_pair_runs.py",
           "config": {"preset": "wgan_gp_32", **CUT, **PAIR,
                      "train.steps": STEPS}, "rows": rows}
    with open(os.path.join(a.out, "cpu_pair_runs.json"), "w") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")
    for r in rows:
        g, p = r["gate_all"]["gates"], r["placement"]
        print(f"{r['side']} seed {r['seed']}: raw KL "
              f"{g['identity']['kl']:.4f}, structural chi2/dof "
              f"{g['identity']['chi2_per_dof_structural']:.1f}, STARTs a "
              f"level {p['starts_per_level']:.2f} on {p['start_cells']} "
              f"cells")
    return 0


if __name__ == "__main__":
    sys.exit(main())
