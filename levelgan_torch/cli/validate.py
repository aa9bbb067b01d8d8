"""Gate a checkpoint's own export: ``python -m levelgan_torch.cli.validate``.

The port's counterpart of the gates of ``tools/validate.py``,
``tools/eval_quality.py`` and ``tools/gate_all.py``, run on the port's
export (on the GPU; ``--device cpu`` for the plain CPU path).  Tile
checkpoints:

- ``identity``: the raw sample's tile-marginal KL against the corpus the
  checkpoint's config carves (``lio/stats.kl_gate``, ``--kl-threshold``
  0.05), over at least 100k tiles;
- ``identity_shipped``: the same on the shipped path (repair with uniform
  placement and exactly one START / GOAL);
- ``positional``: the shipped path's per-position chi-square per dof
  (``lio/stats.per_position_chi2``) at most ``--chi2-threshold`` (20); the
  structural (START / GOAL) channels' value is reported beside it;
- ``quality``: on ``--quality-n`` repaired levels (the config's placement),
  the solvable share at least ``--solvable-threshold`` (0.9) and the
  exactly-one START / GOAL shares at least ``--exactly-one-threshold``
  (0.9), from ``lio/quality.solvable_fraction``.

Track checkpoints (``tools/gate_all.py:125-127, 214-219``):

- ``identity`` and ``identity_shipped``: the curvature-histogram KL
  (``TrackDataset.N_BINS`` bins) of the raw and the repaired (closure-
  projected) export against the corpus, over at least 100k segments, at
  most ``--kl-threshold`` (0.1 for tracks);
- ``quality``: on ``--quality-n`` repaired tracks, the scripted driver's
  lap share (``track/quality.py``) at least the corpus's less 0.1;
  ``closure_ok_frac`` reported beside it.

Curriculum checkpoints (both families), as ``tools/gate_all.py`` rolls
them up:

- ``identity``, ``identity_shipped`` and (tiles) ``positional`` are
  informative (reported with ``"informative": true``, not gating): the
  curriculum reshapes the output distribution on purpose;
- ``structural_shipped`` (tiles): the shipped path's START / GOAL
  chi-square per dof at most ``--chi2-threshold``, gating;
- ``skillgap``: the checkpoint's own strong and weak agents play the
  ``--quality-n`` repaired levels (or tracks) and as many corpus ones
  (``lio/skillgap.py``, on the card); ``separation`` at least 0.

Conditional tile checkpoints (``model.cond_dim`` > 0) add the causality
gates of ``lio/causality.py`` on the shipped path (repair with uniform
placement), at ``max(--n // 4, 128)`` levels a point:

- ``causality``: the response sweep's smallest Pearson r at least 0.5,
  every dim measurable;
  ``--fit-calibration`` also fits the condition's calibration and writes
  ``cond_calibration.json`` beside ``--ckpt``;
- ``causality_calibrated``, where that file exists: the sweep again
  through the calibration, and the slope of every dim it fitted in [0.5,
  1.5].

A conditional model is asked for the corpus-mean feature vector, as the
JAX tools ask.  Prints one JSON report (also to ``--out``) whose
``informative_failures`` lists the informative gates that failed, and
exits 0 iff every gating gate passes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from levelgan_torch.api import make_dataset
from levelgan_torch.cli.export import load_generator
from levelgan_torch.config import GOAL, START
from levelgan_torch.data.features import corpus_mean_cond
from levelgan_torch.device import resolve_device
from levelgan_torch.export import generate, make_generator
from levelgan_torch.lio import causality
from levelgan_torch.lio.calibration import (calibration_path,
                                            load_calibration,
                                            save_calibration)
from levelgan_torch.lio.checkpoint import load_checkpoint
from levelgan_torch.lio.metrics import kl_divergence
from levelgan_torch.lio.quality import solvable_fraction
from levelgan_torch.lio.skillgap import skill_gap_report
from levelgan_torch.lio.stats import kl_gate, per_position_chi2
from levelgan_torch.track.data import TrackDataset, curvature_histogram
from levelgan_torch.track.quality import track_quality_report
from levelgan_torch.train.state import create_state

MIN_TILES = 100_000          # the identity gate samples at least this many
KL_THRESHOLD = {"tile": 0.05, "track": 0.1}   # gate_all's, per family
LAP_SLACK = 0.1              # lap_frac >= the corpus's less this
SLOPE_BAND = (0.5, 1.5)      # causality_calibrated's slopes


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="levelgan-torch-validate",
        description="Identity, positional and quality gates of a "
                    "checkpoint's export (PyTorch port).")
    ap.add_argument("--ckpt", required=True,
                    help="step dir, ckpt/ parent or run dir")
    ap.add_argument("--n", type=int, default=2048,
                    help="levels per identity export (raised to 100k tiles)")
    ap.add_argument("--quality-n", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--kl-threshold", type=float, default=None,
                    help="identity KL limit (default 0.05 tile, 0.1 track)")
    ap.add_argument("--chi2-threshold", type=float, default=20.0)
    ap.add_argument("--solvable-threshold", type=float, default=0.9)
    ap.add_argument("--exactly-one-threshold", type=float, default=0.9)
    ap.add_argument("--points", type=int, default=5,
                    help="response-sweep points a condition dim")
    ap.add_argument("--fit-calibration", action="store_true",
                    help="fit the condition's calibration from a widened "
                         "internal sweep and write cond_calibration.json "
                         "beside --ckpt (conditional tile models)")
    ap.add_argument("--cal-points", type=int, default=9,
                    help="the fit's internal sweep points a dim")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    ap.add_argument("--out", default="", help="JSON report path")
    return ap


def _export_all(cfg, params, runs: dict, args, cond, device):
    """Each named export of ``runs`` ({name: generate's keywords with
    ``n``}): (arrays by name, wall seconds by name)."""
    out, wall = {}, {}
    for name, kw in runs.items():
        t0 = time.perf_counter()
        kw = dict(kw)
        out[name] = generate(cfg, params, kw.pop("n"), seed=args.seed,
                             batch_size=args.batch, cond=cond,
                             device=device, **kw)
        wall[name] = time.perf_counter() - t0
    return out, wall


def gate(passed: bool, informative: bool = False, **detail) -> dict:
    """One gate's row: ``passed``, its numbers, and ``informative`` where
    it is reported without gating."""
    return {"passed": bool(passed), **detail,
            **({"informative": True} if informative else {})}


def rollup(gates: dict) -> dict:
    """``passed`` (every gating gate passed) and ``informative_failures``
    (the informative gates that failed, sorted), as ``tools/gate_all.py``
    rolls a checkpoint's gates up."""
    return {"passed": all(g["passed"] for g in gates.values()
                          if not g.get("informative")),
            "informative_failures": sorted(
                k for k, g in gates.items()
                if g.get("informative") and not g["passed"])}


def tile_gates(report: dict, args, curriculum: bool) -> dict:
    """The identity, positional, structural and quality gates of a tile
    report's numbers (``report["raw"]``, ``["shipped"]``,
    ``["repaired"]``)."""
    raw, ship, rep = report["raw"], report["shipped"], report["repaired"]
    kl_thr = (KL_THRESHOLD["tile"] if args.kl_threshold is None
              else args.kl_threshold)
    chi2_thr = args.chi2_threshold
    gates = {
        "identity": gate(raw["kl"] <= kl_thr, curriculum, kl=raw["kl"],
                         threshold=kl_thr),
        "identity_shipped": gate(ship["kl"] <= kl_thr, curriculum,
                                 kl=ship["kl"], threshold=kl_thr),
        "positional": gate(
            ship["chi2_per_dof_mean"] <= chi2_thr, curriculum,
            chi2_per_dof_mean=ship["chi2_per_dof_mean"],
            chi2_per_dof_structural=ship["chi2_per_dof_structural"],
            threshold=chi2_thr)}
    if curriculum:
        # what a curriculum ships must still place START / GOAL as the
        # corpus does, whatever it does to the rest of the distribution
        gates["structural_shipped"] = gate(
            ship["chi2_per_dof_structural"] <= chi2_thr,
            chi2_per_dof_structural=ship["chi2_per_dof_structural"],
            threshold=chi2_thr)
    gates["quality"] = gate(
        rep["solvable_frac"] >= args.solvable_threshold
        and min(rep["one_start_frac"], rep["one_goal_frac"])
        >= args.exactly_one_threshold,
        solvable_frac=rep["solvable_frac"],
        one_start_frac=rep["one_start_frac"],
        one_goal_frac=rep["one_goal_frac"],
        threshold=args.solvable_threshold,
        exactly_one_threshold=args.exactly_one_threshold)
    return gates


def skillgap_gate(sg: dict) -> dict:
    return gate(sg["separation"] >= 0.0, separation=sg["separation"],
                playable_separation=sg["playable_separation"])


def causality_gates(raw: dict, calibrated: dict | None,
                    cal_dims) -> dict:
    """``causality`` from the raw sweep's report; ``causality_calibrated``
    from the calibrated one's, its slopes gated over ``cal_dims`` (the
    dims the calibration fitted; the others are reported beside them)."""
    def slopes(rep):
        return {k: v.get("slope") for k, v in rep["dims"].items()}

    gates = {"causality": gate(raw["passed"],
                               min_pearson_r=raw["min_pearson_r"],
                               slopes=slopes(raw))}
    if calibrated is not None:
        got = {k: s for k, s in slopes(calibrated).items() if s is not None}
        gated = {k: s for k, s in got.items() if k in cal_dims}
        ungated = {k: s for k, s in got.items() if k not in cal_dims}
        lo, hi = SLOPE_BAND
        gates["causality_calibrated"] = gate(
            calibrated["passed"] and bool(gated)
            and all(lo <= s <= hi for s in gated.values()),
            min_pearson_r=calibrated["min_pearson_r"], slopes=gated,
            slope_band=list(SLOPE_BAND),
            **({"uncalibrated_dim_slopes": ungated} if ungated else {}))
    return gates


def _agents_state(cfg, path: str, device):
    """The curriculum state of the checkpoint at ``path`` (its agents)."""
    state = create_state(cfg, device)
    return load_checkpoint(path, state, prng_impl=cfg.train.prng_impl)[0]


def validate_track(args, cfg, params, ds: TrackDataset, cond, device,
                   carve_s: float, path: str
                   ) -> tuple[dict, dict[str, np.ndarray]]:
    """The track gates (see the module note)."""
    m = cfg.model
    thr = (KL_THRESHOLD["track"] if args.kl_threshold is None
           else args.kl_threshold)
    n = max(args.n, -(-MIN_TILES // m.n_segments))
    tracks, wall = _export_all(cfg, params, {
        "raw": dict(n=n, repair=False), "shipped": dict(n=n, repair=True),
        "repaired": dict(n=args.quality_n, repair=True)}, args, cond, device)
    ref = ds.tile_histogram()
    kl = {name: kl_divergence(curvature_histogram(tracks[name],
                                                  TrackDataset.N_BINS), ref)
          for name in ("raw", "shipped")}
    corpus = ds.tracks[:max(args.quality_n, 1)]
    gen_q = track_quality_report(tracks["repaired"], device=device)
    corpus_q = track_quality_report(corpus, device=device)
    curriculum = cfg.train.loss == "curriculum"
    report = {"ckpt": args.ckpt, "preset": cfg.preset, "device": str(device),
              "n_levels": n, "quality_n": args.quality_n, "seed": args.seed,
              "corpus_levels": int(len(ds.tracks)), "corpus_carve_s": carve_s,
              "export_s": wall, "raw": {"kl": kl["raw"]},
              "shipped": {"kl": kl["shipped"]}, "repaired": gen_q,
              "corpus_quality": corpus_q}
    gates = {name: gate(kl[p] <= thr, curriculum, kl=kl[p], threshold=thr)
             for name, p in (("identity", "raw"),
                             ("identity_shipped", "shipped"))}
    gates["quality"] = gate(
        gen_q["lap_frac"] >= corpus_q["lap_frac"] - LAP_SLACK,
        lap_frac=gen_q["lap_frac"], corpus_lap_frac=corpus_q["lap_frac"],
        closure_ok_frac=gen_q["closure_ok_frac"])
    if curriculum:
        report["skill_gap"] = skill_gap_report(
            cfg, _agents_state(cfg, path, device), tracks["repaired"],
            corpus, seed=args.seed, device=device)
        gates["skillgap"] = skillgap_gate(report["skill_gap"])
    report["gates"] = gates
    report.update(rollup(gates))
    return report, tracks


def validate_causality(args, cfg, params, ds, device) -> dict:
    """The causality sweeps of a conditional tile model (the report's
    ``causality`` part; writes the calibration under
    ``--fit-calibration``)."""
    n = max(args.n // 4, 128)
    gen = make_generator(cfg, params, device)    # once, for every point
    wall = {"levels": 0, "s": 0.0}

    def sample(cond, seed):
        t0 = time.perf_counter()
        out = generate(cfg, gen, n, seed=seed, batch_size=args.batch,
                       cond=cond, repair=True, repair_placement="uniform",
                       device=device)
        wall["s"] += time.perf_counter() - t0
        wall["levels"] += n
        return out

    t0 = time.perf_counter()
    feats = causality.features(ds.levels, device)
    kw = dict(feats=feats, points=args.points, seed=args.seed,
              device=device)
    raw, cal = causality.causality_report(
        sample, ds.levels, cfg.model.n_tiles, **kw,
        fit_calibration=args.fit_calibration, cal_points=args.cal_points,
        meta={
            "preset": cfg.preset, "n_per_point": n, "repair": True,
            "repair_placement": "uniform"})
    out = {"n_per_point": n, "raw": raw}
    if cal is not None:
        out["calibration_written"] = save_calibration(args.ckpt, cal)
    calibrated, cal_dims = None, ()
    if os.path.exists(calibration_path(args.ckpt)):
        cal = load_calibration(args.ckpt)
        cal_dims = set(cal.get("dims", {}))
        calibrated, _ = causality.causality_report(
            sample, ds.levels, cfg.model.n_tiles, **kw, calibration=cal)
        out["calibrated"] = calibrated
    out["gates"] = causality_gates(raw, calibrated, cal_dims)
    out["wall_s"] = time.perf_counter() - t0
    out["export_levels_per_s"] = wall["levels"] / max(wall["s"], 1e-9)
    return out


def validate(args, ds=None) -> tuple[dict, dict[str, np.ndarray]]:
    """(the report, the exported levels (or tracks) by path: raw, shipped,
    repaired).  ``ds``: the checkpoint config's corpus when the caller has
    carved it already (carved here otherwise)."""
    device = resolve_device(args.device)
    path, cfg, params = load_generator(args.ckpt)
    m = cfg.model
    t0 = time.perf_counter()
    if ds is None:
        ds = make_dataset(cfg)
    carve_s = time.perf_counter() - t0
    cond = corpus_mean_cond(cfg, ds, device) if m.cond_dim else None
    if m.family == "track":
        return validate_track(args, cfg, params, ds, cond, device, carve_s,
                              path)
    kl_thr = (KL_THRESHOLD["tile"] if args.kl_threshold is None
              else args.kl_threshold)
    n = max(args.n, -(-MIN_TILES // m.level_size ** 2))
    runs = {"raw": dict(n=n, repair=False),
            "shipped": dict(n=n, repair=True, repair_placement="uniform",
                            exactly_one=True),
            "repaired": dict(n=args.quality_n, repair=True)}
    levels, wall = _export_all(cfg, params, runs, args, cond, device)
    ref_counts = ds.tile_histogram(m.n_tiles)
    report = {"ckpt": args.ckpt, "preset": cfg.preset, "device": str(device),
              "n_levels": n, "quality_n": args.quality_n, "seed": args.seed,
              "corpus_levels": int(len(ds.levels)),
              "corpus_carve_s": carve_s, "export_s": wall}
    for name in ("raw", "shipped"):
        report[name] = {
            **kl_gate(levels[name], ref_counts, m.n_tiles, kl_thr),
            **per_position_chi2(levels[name], ds.levels, m.n_tiles,
                                channels={"structural": (START, GOAL)}),
            **solvable_fraction(levels[name], device)}
    report["repaired"] = solvable_fraction(levels["repaired"], device)
    curriculum = cfg.train.loss == "curriculum"
    gates = tile_gates(report, args, curriculum)
    if m.cond_dim:
        report["causality"] = validate_causality(args, cfg, params, ds,
                                                 device)
        gates.update(report["causality"].pop("gates"))
    if curriculum:
        corpus = ds.levels[:max(args.quality_n, 1)]
        report["skill_gap"] = skill_gap_report(
            cfg, _agents_state(cfg, path, device), levels["repaired"],
            corpus, seed=args.seed, device=device)
        gates["skillgap"] = skillgap_gate(report["skill_gap"])
    report["gates"] = gates
    report.update(rollup(gates))
    return report, levels


def main(argv=None):
    args = build_parser().parse_args(argv)
    report, _ = validate(args)
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if not report["passed"]:
        failed = [k for k, g in report["gates"].items()
                  if not g["passed"] and not g.get("informative")]
        print(f"[levelgan_torch] validate: failed {', '.join(failed)}",
              file=sys.stderr)
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
