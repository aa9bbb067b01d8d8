#!/usr/bin/env python3
"""Whole training runs of the port's presets, gated, and their record.

``python3 whole_runs.py train [--presets ...] [--out DIR]`` (on one CUDA
card): trains each preset at its own defaults and full steps through
``python -m levelgan_torch.cli.train`` (gumbel_64 as two runs joined by
``--resume auto``: the first is sent SIGTERM after ``--split`` seconds;
``--max-wall S`` sends SIGTERM to whichever part runs S seconds after the
start, and the run is gated at the step it reached), gates each final
checkpoint on the card with ``levelgan_torch.cli.validate`` (the corpus
is carved here while the run trains; a conditional model's calibration is
fitted and gated too, ``--fit-calibration``), and writes to
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
Every row gets ``verdict_diff``, the gates on which the port's validate
and gate_all disagree (empty when they agree gate for gate), and the
record gets ``seed_sets``: each run with ``_seed<N>`` siblings, held with
them to the JAX row by the rule of ROADMAP Queue 3 (``SEED_METRICS``).
With no ``--runs``, ``record`` computes only these two again.
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
                  "corpus's 623) and its exactly-one section (8.7 decoded "
                  "STARTs a level); no gate_all row",
        "steps": 3000, "kl": 0.0287, "chi2_per_dof_structural": 457,
        "starts_per_level": 8.7, "start_cells": 865, "start_inv_simpson": 245,
        "corpus_start_cells": 623,
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

# the metrics a set of seed runs (``<run>`` and ``<run>_seed<N>``) is held to
# JAX's row by, each as (name, path in a PORT_GATES row, key of JAX's value
# in JAX_ROWS[set]; None: the value at the path in gate_all's JAX row), by
# the preset or JAX_ROWS run the set compares with (ROADMAP Queue 3 faults
# 10 and 11).  toy_dcgan_16's JAX side is five runs: a Mann-Whitney test;
# the others have one JAX run: the range rule.
SEED_METRICS = {
    "toy_dcgan_16": (("identity_kl", "gate_all.gates.identity.kl", "kl"),),
    "racetrack_32": (("identity_kl", "gate_all.gates.identity.kl", None),),
    "curriculum_16_joint": (("skillgap_separation",
                             "gate_all.gates.skillgap.separation", None),),
    "race_curriculum_32": (("skillgap_separation",
                            "gate_all.gates.skillgap.separation", None),),
    "wgan_gp_32_mbin": (
        ("identity_kl", "gate_all.gates.identity.kl", "kl"),
        ("starts_per_level", "placement.raw.starts_per_level",
         "starts_per_level")),
}
ALPHA = 0.05


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


def validate_argv(cfg, ckpt: str, device: str | None) -> list[str]:
    """The port validate's arguments for the final checkpoint ``ckpt`` of a
    run of ``cfg``: gate_all's n, and for a conditional model
    ``--fit-calibration`` (so that ``causality_calibrated`` is gated on the
    shipped path, as ``_gate`` fits the JAX side's)."""
    return ["--ckpt", ckpt, "--n", "1024",     # tools.gate_all's n
            *(("--fit-calibration",) if cfg.model.cond_dim > 0 else ()),
            *(("--device", device) if device else ())]


def run_parts(argvs: list[list[str]], ckpt_dir: str, split_s: float | None,
              max_wall: float | None, label: str = "") -> list[dict]:
    """Run the commands ``argvs`` one after another (a run and its
    ``--resume auto``): the first is sent SIGTERM after ``split_s`` seconds
    (None: it runs to its end, and the next is not started), and whichever
    part runs at ``max_wall`` seconds after the start is sent SIGTERM and
    is the last.  A part stopped so writes its checkpoint and exits 0.
    Returns each part's exit code, how it was stopped, its wall time and
    the step of the newest checkpoint under ``ckpt_dir`` after it."""
    import numpy as np
    from levelgan_torch.lio.checkpoint import all_checkpoints

    t0 = time.perf_counter()
    parts = []
    for part, argv in enumerate(argvs):
        t_part = time.perf_counter()
        split = split_s if part == 0 else None
        wall = (None if max_wall is None
                else max(0.0, max_wall - (t_part - t0)))
        by_wall = wall is not None and (split is None or wall <= split)
        proc = subprocess.Popen(argv, cwd=HERE)
        stopped = False
        try:
            proc.wait(timeout=wall if by_wall else split)
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGTERM)
            stopped = True
            proc.wait()
        ckpts = all_checkpoints(ckpt_dir)
        step = None
        if ckpts:
            with np.load(os.path.join(ckpts[-1], "arrays.npz")) as z:
                step = int(z["step"])
        parts.append({"rc": proc.returncode, "sigterm": stopped,
                      "max_wall": stopped and by_wall,
                      "wall_s": time.perf_counter() - t_part,
                      "checkpoint_step": step})
        print(f"[whole_runs] {label} part {part}: rc {proc.returncode}, "
              f"SIGTERM {stopped}{' (max wall)' if stopped and by_wall else ''}"
              f", checkpoint at step {step}", flush=True)
        if proc.returncode != 0 or not stopped or by_wall:
            break
    return parts


def train_one(name: str, work: str, out: str, split_s: float,
              sets: list[str], device: str | None, tag: str = "",
              max_wall: float | None = None) -> dict:
    """Train ``name`` (two runs if it is in SPLIT) with the ``--set``
    overrides ``sets`` (none for a whole run), stopped at ``max_wall``
    seconds if it runs that long, validate on the card (or ``device``),
    keep the small artifacts in ``out/<name><tag>``."""
    import numpy as np
    from levelgan_torch.cli import validate
    from levelgan_torch.lio.checkpoint import all_checkpoints

    run_dir = os.path.join(work, name + tag)
    shutil.rmtree(run_dir, ignore_errors=True)
    sets = [f"io.log_every={LOG_EVERY}", *sets]
    cfg = _config(name, sets)
    base = _cli("levelgan_torch.cli.train", "--preset", name, "--out",
                run_dir, *(a for kv in sets for a in ("--set", kv)),
                *(("--device", device) if device else ()))
    box: dict = {}
    carver = threading.Thread(target=_carve, args=(cfg, box))
    row = {"preset": name, "sets": sets, "target_steps": cfg.train.steps,
           **({"max_wall_s": max_wall} if max_wall is not None else {})}
    t0 = time.perf_counter()
    carver.start()
    ckpt_dir = os.path.join(run_dir, "ckpt")
    row["parts"] = run_parts(
        [base, base + ["--resume", "auto"]], ckpt_dir,
        split_s if name in SPLIT else None, max_wall, name + tag)
    row["train_wall_s"] = time.perf_counter() - t0
    carver.join()
    step = row["parts"][-1]["checkpoint_step"]
    if row["parts"][-1]["rc"] != 0 or step is None:
        return row
    final = all_checkpoints(ckpt_dir)[-1]
    row["steps"] = step
    if step < cfg.train.steps:
        row["stopped_short"] = (f"--max-wall {max_wall} s stopped the run "
                                f"at step {step} of {cfg.train.steps}")
    args = validate.build_parser().parse_args(
        validate_argv(cfg, final, device))
    t1 = time.perf_counter()
    report, levels = validate.validate(args, ds=box["ds"])
    row["validate_wall_s"] = time.perf_counter() - t1
    if cfg.model.family == "tile":
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
    for kept in ("manifest.json", "cond_calibration.json"):
        if os.path.exists(os.path.join(final, kept)):
            shutil.copy(os.path.join(final, kept), dest)
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
        row = train_one(name, a.work, a.out, a.split, a.set, a.device, a.tag,
                        a.max_wall)
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


def _why(p: dict | None, g: dict | None) -> str | None:
    """Why the port's gate ``p`` and gate_all's ``g`` disagree, or None."""
    if p is None or g is None:
        return f"only {'gate_all' if p is None else 'the port'} has it"
    if bool(p.get("informative")) != bool(g.get("informative")):
        return "informative on one side only"
    if p["passed"] != g["passed"]:
        return "passed differs"
    return None


def verdict_diff(port: dict, gate_all: dict) -> list[dict]:
    """The gates (``{name: {"passed", ...numbers}}`` of each tool) where the
    port's validate and ``tools.gate_all`` disagree: one side lacks the
    gate, it is informative (recorded, not rolled up: a curriculum's
    identity and positional gates) on one side only, or its ``passed``
    differs.  Each entry holds both sides' gates; an empty list means the
    two tools agree gate for gate."""
    return [{"gate": k, "why": why, "port": port.get(k),
             "gate_all": gate_all.get(k)}
            for k in [*port, *(k for k in gate_all if k not in port)]
            if (why := _why(port.get(k), gate_all.get(k)))]


def _at(row: dict, path: str):
    for key in path.split("."):
        row = row.get(key) if isinstance(row, dict) else None
    return row


def seed_sets(rows: list[dict]) -> dict:
    """For each run with ``_seed<N>`` siblings among ``rows``: each metric
    of SEED_METRICS per run, their range, JAX's value (or five values) and
    the verdict, seed spread or a shift, by the rule written in ROADMAP
    Queue 3 before the runs: with one JAX run, spread iff JAX's value lies
    within the port runs' range; with five (toy_dcgan_16), the exact
    two-sided Mann-Whitney test at ALPHA."""
    import re
    by_run = {r["run"]: r for r in rows}
    bases = sorted({m.group(1) for r in rows
                    if (m := re.fullmatch(r"(.+)_seed\d+", r["run"]))})
    out = {}
    for base in bases:
        runs = sorted((n for n in by_run if re.fullmatch(
            re.escape(base) + r"_seed\d+", n)),
            key=lambda n: int(n.rsplit("_seed", 1)[1]))
        runs = [base] * (base in by_run) + runs
        first = by_run[runs[0]]
        key = jax_row_key(base) or first["preset"]
        if key not in SEED_METRICS:
            continue
        jax_row = first["jax"]
        metrics, verdicts = {}, []
        for name, path, jax_key in SEED_METRICS[key]:
            vals = {n: _at(by_run[n], path) for n in runs}
            port = [v for v in vals.values() if v is not None]
            jax = JAX_ROWS[key][jax_key] if jax_key else _at(jax_row, path)
            m = {"path": path, "port": vals,
                 "range": [min(port), max(port)] if port else None,
                 "jax": jax}
            if isinstance(jax, list):
                from scipy.stats import mannwhitneyu
                mw = mannwhitneyu(port, jax, method="exact")
                p = float(mw.pvalue)
                m.update(rule=f"exact two-sided Mann-Whitney, alpha {ALPHA}",
                         u=float(mw.statistic), u_of=len(port) * len(jax),
                         p=p, verdict="shift" if p < ALPHA else "seed spread")
            else:
                m.update(rule="seed spread iff JAX's value lies within the "
                              "port runs' range",
                         verdict=("seed spread" if port and jax is not None
                                  and min(port) <= jax <= max(port)
                                  else "shift"))
            metrics[name] = m
            verdicts.append(m["verdict"])
        out[base] = {"runs": runs, "jax_source": jax_row.get("source")
                     or jax_row.get("gate_all", {}).get("ckpt"),
                     "metrics": metrics,
                     "verdict": ("shift" if "shift" in verdicts
                                 else "seed spread")}
    return out


def cmd_record(a) -> int:
    if a.runs and a.work is None:
        raise SystemExit("record --runs needs --work")
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
            "steps": row["steps"],
            **{k: row[k] for k in ("target_steps", "max_wall_s",
                                   "stopped_short") if k in row},
            "card": row["card"],
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
    for r in rows:      # old rows too, from their stored gates
        r["verdict_diff"] = verdict_diff(r["port_validate"]["gates"],
                                         r["gate_all"]["gates"])
    doc = {"what": "whole training runs of the port on the card, gated by "
                   "the port's validate on the card and by the JAX "
                   "package's tools.gate_all on the CPU (default "
                   "thresholds)",
           "script": "whole_runs.py", "rows": rows,
           "seed_sets": seed_sets(rows)}
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
    t.add_argument("--max-wall", type=float, default=None, metavar="S",
                   help="seconds after a run's start at which its part in "
                        "flight is sent SIGTERM: it writes a checkpoint, "
                        "and the run is gated at the step it reached")
    t.add_argument("--tag", default="",
                   help="suffix of the rows' names (another seed's run)")
    r = sub.add_parser("record", help="on the CPU: gate_all, PORT_GATES.json")
    r.add_argument("--runs", nargs="*", default=[],
                   help="train's --out directories (their rows merge); "
                        "none: only verdict_diff and seed_sets are "
                        "computed again over --out's rows")
    r.add_argument("--work", default=None,
                   help="gate_all's work directory (needed with --runs)")
    r.add_argument("--out", default=os.path.join(HERE, "PORT_GATES.json"))
    a = ap.parse_args(argv)
    return cmd_train(a) if a.cmd == "train" else cmd_record(a)


if __name__ == "__main__":
    sys.exit(main())
