#!/usr/bin/env python3
"""Whole training runs of the port's presets, gated, and their record.

``python3 whole_runs.py train [--presets ...] [--out DIR]`` (on one CUDA
card): trains each preset at its own defaults and full steps through
``python -m levelgan_torch.cli.train`` (gumbel_64 as two runs joined by
``--resume auto``: the first is sent SIGTERM after ``--split`` seconds),
gates each final checkpoint on the card with ``levelgan_torch.cli.
validate`` (the corpus is carved here while the run trains), and writes to
``DIR/<preset>/``: ``g_ema.npz`` (the EMA generator's arrays and the step)
beside the checkpoint's ``manifest.json``, ``validate.json`` and
``metrics.jsonl`` (a curriculum run's ``g_ema.npz`` also holds its
trained agents, which the skill-gap gate plays); ``DIR/runs.json`` holds
the card's name and power limit, each run's wall time and, for a tile
run, the START placement of validate's raw levels beside the corpus's
(the cells that hold a START in any level, and the inverse Simpson index
of the START marginal).  ``--set dist.dp=4`` trains over four cards.  The full
checkpoints stay in ``whole_runs_work/`` (not kept: the optimizer state
is 5x the EMA).  The track presets (``racetrack_32``,
``race_curriculum_32``) train the same way on their whole 4096-track
corpus; their gates are the track family's (curvature KL, the scripted
driver's laps; a race-curriculum run's drivers are kept for the skill
gap).

``python3 whole_runs.py record --runs DIR [DIR ...] --work SCRATCH [--out
PORT_GATES.json]`` (on a CPU with the JAX package and its ``tools/``):
rebuilds a full-state checkpoint around each EMA generator (the JAX tools
read the whole state and sample from ``g_ema`` only; the critic and the
optimizers there are fresh and unused; a curriculum run's agents are its
own), fits the conditional checkpoint's
calibration on the shipped path (``tools.eval_cond --n 256 --repair
--repair-placement uniform --fit-calibration``, as the JAX row's was
fitted), runs ``tools.gate_all``
on each with its default thresholds (kept in ``SCRATCH/<preset>/`` and
reused), and writes one row per preset: steps, card, wall time, the port
validate's gates, gate_all's gates, the START placement, the training
window's tile KL (``kl_window``: at steps 1,000-3,000 by 500 and its range
over the last 1,000 steps, from ``metrics.jsonl``) and the JAX row it
is compared with: ``JAX_ROWS[run]`` where the run (its name without its
tags: ``_dp<N>``, ``_seed<N>``, ...) has a row of its own, then without a
``gate_all`` row of the preset's; else the preset's.
Rows already in ``--out`` for runs that ``--runs`` does not hold are kept.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PRESETS = ("toy_dcgan_16", "wgan_gp_32", "wgan_gp_32_structural",
           "conditional_32", "gumbel_64", "curriculum_16_joint",
           "curriculum_16", "racetrack_32", "race_curriculum_32")
SPLIT = {"gumbel_64"}         # trained as two runs joined by --resume auto
LOG_EVERY = 100
PLACEMENT_N = 1024            # levels of the START placement (BASELINE.md's)
KL_AT = (1000, 1500, 2000, 2500, 3000)   # steps whose window KL a row keeps

# the JAX package's rows, as its records give them
JAX_ROWS = {
    "toy_dcgan_16": {
        "source": "artifacts/ref_band.json (tools/ref_band.py: 5 seeds, 100 "
                  "steps, 2048 levels each; the JAX package's KL to the "
                  "corpus, no gate_all row)",
        "steps": 100, "kl": [0.10764748603105545, 0.2656335234642029,
                             0.14962613582611084, 0.1613430380821228,
                             0.21266920864582062]},
    "gumbel_64": {
        "source": "BASELINE.md, 20k-step soak, tools/validate at step 4,000 "
                  "(runs/gumbel_soak20k); gate_all's row is its step 20,000",
        "steps": 4000, "kl": 0.00083, "chi2_per_dof_mean": 1.6},
    # BASELINE.md's "mbstd pair" (round 3): wgan_gp_32 + train.w_presence=10
    # + model.critic_mbstd=input at 3,000 steps, trained here by
    # ``train --presets wgan_gp_32 --set train.w_presence=10 --set
    # model.critic_mbstd=input --set train.steps=3000 --tag _mbin`` (and
    # ``--set dist.dp=4 --tag _mbin_dp4`` over four cards)
    "wgan_gp_32_mbin": {
        "source": "artifacts/quality_wgan_presence_mbin3k.json "
                  "(runs/wgan_presence_mbin3k, 1,024 raw levels) and "
                  "BASELINE.md round 3 (the pair's 3,000-step row: tile KL, "
                  "structural chi2/dof, START cells of 1,024 levels; the "
                  "corpus's 623); no gate_all row",
        "steps": 3000, "kl": 0.0287, "chi2_per_dof_structural": 457,
        "start_cells": 865, "start_inv_simpson": 245, "corpus_start_cells": 623,
        "solvable_frac": 0.95703125, "mean_pairwise_hamming": 0.5577974915504456,
        "tile_entropy_nats": 1.3024481326490687},
}
GATES_ALL = {"wgan_gp_32": "runs/wgan_base",
             "wgan_gp_32_structural": "runs/wgan_gp_32_structural",
             "conditional_32": "runs/conditional_projboost",
             "gumbel_64": "runs/gumbel_soak20k",
             "curriculum_16_joint": "runs/curriculum_16_joint",
             "racetrack_32": "runs/track_cim",
             "race_curriculum_32": "runs/race_curriculum_32"}
_KEEP = ("g_ema/", "agent_strong/", "agent_weak/")   # kept of a checkpoint


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def _cli(*args) -> list[str]:
    return [sys.executable, "-m", *args]


def _config(name: str, sets: list[str]):
    from levelgan_torch.cli.train import parse_overrides
    from levelgan_torch.config import load_config
    return load_config(None, name, parse_overrides(sets))


def start_placement(levels) -> dict:
    """START placement over tile levels [n, H, W]: the cells that hold a
    START in some level, the inverse Simpson index of the START marginal
    over the cells, and STARTs a level."""
    import numpy as np
    from levelgan_torch.config import START
    per_cell = (np.asarray(levels) == START).sum(axis=0).astype(np.float64)
    total = per_cell.sum()
    simpson = float(np.square(per_cell / total).sum()) if total else 0.0
    return {"start_cells": int((per_cell > 0).sum()),
            "start_inv_simpson": 1.0 / simpson if simpson else 0.0,
            "starts_per_level": float(total / len(levels))}


def _carve(cfg, box: dict) -> None:
    from levelgan_torch.api import make_dataset
    t0 = time.perf_counter()
    box["ds"] = make_dataset(cfg)
    box["carve_s"] = time.perf_counter() - t0


def train_one(name: str, work: str, out: str, split_s: float,
              sets: list[str], device: str | None, tag: str = "") -> dict:
    """Train ``name`` (two runs if it is in SPLIT) with the ``--set``
    overrides ``sets`` (none for a whole run), validate on the card (or
    ``device``), keep the small artifacts in ``out/<name><tag>``."""
    import numpy as np
    from levelgan_torch.cli import validate
    from levelgan_torch.lio.checkpoint import all_checkpoints

    run_dir = os.path.join(work, name + tag)
    shutil.rmtree(run_dir, ignore_errors=True)
    sets = [f"io.log_every={LOG_EVERY}", *sets]
    base = _cli("levelgan_torch.cli.train", "--preset", name, "--out",
                run_dir, *(a for kv in sets for a in ("--set", kv)),
                *(("--device", device) if device else ()))
    box: dict = {}
    carver = threading.Thread(target=_carve, args=(_config(name, sets), box))
    row = {"preset": name, "sets": sets, "parts": []}
    t0 = time.perf_counter()
    for part, argv in enumerate((base, base + ["--resume", "auto"])):
        t_part = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=HERE)
        if part == 0:
            carver.start()
        stopped = False
        try:
            proc.wait(timeout=split_s if name in SPLIT and part == 0
                      else None)
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGTERM)
            stopped = True
            proc.wait()
        ckpts = all_checkpoints(os.path.join(run_dir, "ckpt"))
        step = None
        if ckpts:
            with np.load(os.path.join(ckpts[-1], "arrays.npz")) as z:
                step = int(z["step"])
        row["parts"].append({"rc": proc.returncode, "sigterm": stopped,
                             "wall_s": time.perf_counter() - t_part,
                             "checkpoint_step": step})
        print(f"[whole_runs] {name} part {part}: rc {proc.returncode}, "
              f"SIGTERM {stopped}, checkpoint at step {step}", flush=True)
        if proc.returncode != 0 or not stopped:
            break
    row["train_wall_s"] = time.perf_counter() - t0
    carver.join()
    if row["parts"][-1]["rc"] != 0 or step is None:
        return row
    final = all_checkpoints(os.path.join(run_dir, "ckpt"))[-1]
    row["steps"] = row["parts"][-1]["checkpoint_step"]
    args = validate.build_parser().parse_args(
        ["--ckpt", final, "--n", "1024",   # tools.gate_all's n
         *(("--device", device) if device else ())])
    t1 = time.perf_counter()
    report, levels = validate.validate(args, ds=box["ds"])
    row["validate_wall_s"] = time.perf_counter() - t1
    if "raw" in levels and levels["raw"].ndim == 3:    # tile levels
        raw = levels["raw"][:PLACEMENT_N]
        row["placement"] = {
            "raw": start_placement(raw),
            "corpus": start_placement(box["ds"].levels[:len(raw)])}
    row["validate_carve_s"] = box["carve_s"]
    row["validate"] = {"gates": report["gates"], "passed": report["passed"]}
    dest = os.path.join(out, name + tag)
    os.makedirs(dest, exist_ok=True)
    with open(os.path.join(dest, "validate.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    with np.load(os.path.join(final, "arrays.npz")) as z:
        np.savez(os.path.join(dest, "g_ema.npz"),
                 **{k: z[k] for k in z.files if k.startswith(_KEEP)},
                 step=z["step"])
    shutil.copy(os.path.join(final, "manifest.json"), dest)
    shutil.copy(os.path.join(run_dir, "metrics.jsonl"), dest)
    print(f"[whole_runs] {name}{tag}: {row['steps']} steps in "
          f"{row['train_wall_s']:.1f} s; validate "
          + json.dumps({k: {a: b for a, b in g.items() if a != "threshold"}
                        for k, g in report["gates"].items()}), flush=True)
    return row


def cmd_train(a) -> int:
    os.makedirs(a.out, exist_ok=True)
    summary_path = os.path.join(a.out, "runs.json")
    summary = {"card": card_line(), "rows": {}}
    if os.path.exists(summary_path):
        with open(summary_path) as fh:
            summary["rows"] = json.load(fh).get("rows", {})
    print(f"card: {summary['card']}", flush=True)
    rc = 0
    for name in a.presets:
        row = train_one(name, a.work, a.out, a.split, a.set, a.device, a.tag)
        row["card"] = summary["card"]
        summary["rows"][name + a.tag] = row
        with open(summary_path, "w") as fh:
            json.dump(summary, fh, indent=2)
        rc |= any(p["rc"] != 0 for p in row["parts"])
    return rc


def _full_checkpoint(src: str, dest: str) -> str:
    """A full-state port checkpoint around ``src``'s EMA generator (the
    generator is the EMA too; a fresh critic and optimizers; a curriculum
    run's trained agents)."""
    import numpy as np
    import torch
    from levelgan_torch.api import save_state
    from levelgan_torch.bridge import (agent_params_from_flat,
                                       generator_params_from_flat)
    from levelgan_torch.config import Config
    from levelgan_torch.train.state import create_state

    with open(os.path.join(src, "manifest.json")) as fh:
        cfg = Config.from_dict(json.load(fh)["config"])
    with np.load(os.path.join(src, "g_ema.npz")) as z:
        flat = {k: z[k] for k in z.files}
    state = create_state(cfg, "cpu")
    params = generator_params_from_flat(flat)
    with torch.no_grad():
        for model in (state.generator, state.g_ema):
            model.load_state_dict(params)
        for name in ("agent_strong", "agent_weak"):
            if hasattr(state, name):
                getattr(state, name).load_state_dict(
                    agent_params_from_flat(flat, name))
    shutil.rmtree(dest, ignore_errors=True)
    return save_state(os.path.join(dest, "ckpt"), state, cfg,
                      int(flat["step"]), 0)


def kl_window(path: str, steps: int) -> dict | None:
    """The training window's tile KL of ``metrics.jsonl`` (logged every
    ``io.log_every`` steps): at KL_AT's steps (those the run reached) and
    its range over the last 1,000 steps; None without KL lines."""
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        kl = {r["step"]: r["kl"] for r in map(json.loads, fh) if "kl" in r}
    if not kl:
        return None
    last = [v for s, v in kl.items() if s > steps - 1000]
    return {"at": {str(s): kl[s] for s in KL_AT if s in kl},
            "last_1000": {"min": min(last), "max": max(last),
                          "n": len(last)} if last else None}


def jax_row_key(name: str) -> str | None:
    """The JAX_ROWS run (not a preset) that the run ``name`` is or extends
    by tags (``_dp4``, ``_seed3``, ...), the longest such; else None."""
    keys = [k for k in JAX_ROWS if k not in PRESETS
            and (name == k or name.startswith(k + "_"))]
    return max(keys, key=len) if keys else None


def _gates(row: dict) -> dict:
    return {k: {a: b for a, b in g.items() if a != "threshold"}
            for k, g in row.get("gates", {}).items()}


def _gate(name: str, preset: str, src: str, work: str) -> dict:
    """``tools.gate_all`` over a full-state checkpoint around ``src``'s EMA,
    kept in ``work/<name>/gate_all.json`` (reused when there)."""
    out = os.path.join(work, name, "gate_all.json")
    if not os.path.exists(out):
        ckpt = _full_checkpoint(src, os.path.join(work, name))
        fit_rc = None
        if preset == "conditional_32":
            # on the shipped path, as tools/round5_gates2.sh:42-44 fitted
            # the JAX row's: writes cond_calibration.json beside the
            # checkpoint; its exit code is its own causality gate's
            fit_rc = subprocess.run(_cli(
                "tools.eval_cond", "--ckpt", ckpt, "--n", "256", "--repair",
                "--repair-placement", "uniform", "--fit-calibration",
                "--out", os.path.join(work, name, "eval_cond_fit.json")),
                cwd=HERE).returncode
        rc = subprocess.run(_cli("tools.gate_all", "--runs", ckpt, "--out",
                                 out + ".tmp"), cwd=HERE).returncode
        with open(out + ".tmp") as fh:
            row = json.load(fh)["checkpoints"][0]
        row.update(rc=rc, eval_cond_fit_rc=fit_rc)
        with open(out, "w") as fh:
            json.dump(row, fh, indent=2)
    with open(out) as fh:
        return json.load(fh)


def cmd_record(a) -> int:
    rows_in = {}
    for runs in a.runs:
        with open(os.path.join(runs, "runs.json")) as fh:
            for name, row in json.load(fh)["rows"].items():
                rows_in[name] = (runs, row)
    with open(os.path.join(HERE, "artifacts", "gates_all.json")) as fh:
        jax_gates = {r["ckpt"]: r for r in json.load(fh)["checkpoints"]}
    rows = []
    order = [p for p in PRESETS if p in rows_in]
    for name in order + sorted(set(rows_in) - set(order)):
        runs, row = rows_in[name]
        with open(os.path.join(runs, name, "validate.json")) as fh:
            port = json.load(fh)
        g = _gate(name, row["preset"], os.path.join(runs, name), a.work)
        key = jax_row_key(name)
        own = key is not None
        jax_row = dict(JAX_ROWS[key] if own
                       else JAX_ROWS.get(row["preset"], {}))
        if not own and row["preset"] in GATES_ALL:
            j = jax_gates[GATES_ALL[row["preset"]]]
            jax_row["gate_all"] = {"ckpt": j["ckpt"], "passed": j["passed"],
                                   "gates": _gates(j)}
        rows.append({
            "run": name, "preset": row["preset"],
            "sets": row.get("sets", [f"io.log_every={LOG_EVERY}"]),
            "steps": row["steps"], "card": row["card"],
            "train_wall_s": row["train_wall_s"], "parts": row["parts"],
            "port_validate": {"device": port["device"],
                              "passed": port["passed"],
                              "gates": _gates(port),
                              "n_levels": port["n_levels"]},
            "gate_all": {"passed": g["passed"], "gates": _gates(g),
                         "rc": g["rc"],
                         **({"eval_cond_fit_rc": g["eval_cond_fit_rc"]}
                            if g["eval_cond_fit_rc"] is not None else {}),
                         **({"error": g["error"]} if "error" in g else {})},
            **({"placement": row["placement"]} if "placement" in row
               else {}),
            **({"kl_window": kl} if (kl := kl_window(os.path.join(
                runs, name, "metrics.jsonl"), row["steps"])) else {}),
            "jax": jax_row})
    if os.path.exists(a.out):
        # earlier calls' rows stay, in their order; a run recorded again
        # replaces its row
        with open(a.out) as fh:
            old = json.load(fh)["rows"]
        new = {r["run"]: r for r in rows}
        rows = ([new.pop(r["run"], r) for r in old]
                + [r for r in rows if r["run"] in new])
    doc = {"what": "whole training runs of the port on the card, gated by "
                   "the port's validate on the card and by the JAX "
                   "package's tools.gate_all on the CPU (default "
                   "thresholds)",
           "script": "whole_runs.py", "rows": rows}
    with open(a.out, "w") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")
    print(f"wrote {a.out}: {len(rows)} rows")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="on the card: train, validate, keep")
    t.add_argument("--presets", nargs="+", default=list(PRESETS),
                   choices=PRESETS)
    t.add_argument("--out", default=os.path.join(HERE, "whole_runs_out"))
    t.add_argument("--work", default=os.path.join(HERE, "whole_runs_work"))
    t.add_argument("--split", type=float, default=600.0,
                   help="seconds before the first gumbel_64 run is stopped")
    t.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="config override for every run (a cut-down dry "
                        "run; whole runs take none)")
    t.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    t.add_argument("--tag", default="",
                   help="suffix of the rows' names (another seed's run)")
    r = sub.add_parser("record", help="on the CPU: gate_all, PORT_GATES.json")
    r.add_argument("--runs", nargs="+", required=True,
                   help="train's --out directories (their rows merge)")
    r.add_argument("--work", required=True)
    r.add_argument("--out", default=os.path.join(HERE, "PORT_GATES.json"))
    a = ap.parse_args(argv)
    return cmd_train(a) if a.cmd == "train" else cmd_record(a)


if __name__ == "__main__":
    sys.exit(main())
