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

On a curriculum checkpoint of the track family the two identity gates are
informative (reported, not gating), as ``gate_all`` records them: the race
curriculum reshapes the curvature distribution on purpose.

A conditional model is asked for the corpus-mean feature vector, as the
JAX tools ask.  Prints one JSON report (also to ``--out``) and exits 0 iff
every gating gate passes.
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
from levelgan_torch.export import generate
from levelgan_torch.lio.metrics import kl_divergence
from levelgan_torch.lio.quality import solvable_fraction
from levelgan_torch.lio.stats import kl_gate, per_position_chi2
from levelgan_torch.track.data import TrackDataset, curvature_histogram
from levelgan_torch.track.quality import track_quality_report

MIN_TILES = 100_000          # the identity gate samples at least this many
KL_THRESHOLD = {"tile": 0.05, "track": 0.1}   # gate_all's, per family
LAP_SLACK = 0.1              # lap_frac >= the corpus's less this


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


def validate_track(args, cfg, params, ds: TrackDataset, cond, device,
                   carve_s: float) -> tuple[dict, dict[str, np.ndarray]]:
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
    gen_q = track_quality_report(tracks["repaired"], device=device)
    corpus_q = track_quality_report(ds.tracks[:max(args.quality_n, 1)],
                                    device=device)
    informative = cfg.train.loss == "curriculum"
    report = {"ckpt": args.ckpt, "preset": cfg.preset, "device": str(device),
              "n_levels": n, "quality_n": args.quality_n, "seed": args.seed,
              "corpus_levels": int(len(ds.tracks)), "corpus_carve_s": carve_s,
              "export_s": wall, "raw": {"kl": kl["raw"]},
              "shipped": {"kl": kl["shipped"]}, "repaired": gen_q,
              "corpus_quality": corpus_q}
    gates = {name: {"passed": kl[path] <= thr, "kl": kl[path],
                    "threshold": thr,
                    **({"informative": True} if informative else {})}
             for name, path in (("identity", "raw"),
                                ("identity_shipped", "shipped"))}
    gates["quality"] = {
        "passed": gen_q["lap_frac"] >= corpus_q["lap_frac"] - LAP_SLACK,
        "lap_frac": gen_q["lap_frac"], "corpus_lap_frac": corpus_q["lap_frac"],
        "closure_ok_frac": gen_q["closure_ok_frac"]}
    report["gates"] = gates
    report["passed"] = all(g["passed"] for g in gates.values()
                           if not g.get("informative"))
    return report, tracks


def validate(args, ds=None) -> tuple[dict, dict[str, np.ndarray]]:
    """(the report, the exported levels (or tracks) by path: raw, shipped,
    repaired).  ``ds``: the checkpoint config's corpus when the caller has
    carved it already (carved here otherwise)."""
    device = resolve_device(args.device)
    cfg, params = load_generator(args.ckpt)
    m = cfg.model
    t0 = time.perf_counter()
    if ds is None:
        ds = make_dataset(cfg)
    carve_s = time.perf_counter() - t0
    cond = corpus_mean_cond(cfg, ds, device) if m.cond_dim else None
    if m.family == "track":
        return validate_track(args, cfg, params, ds, cond, device, carve_s)
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
    raw, ship, rep = report["raw"], report["shipped"], report["repaired"]
    report["gates"] = {
        "identity": {"passed": raw["kl"] <= kl_thr,
                     "kl": raw["kl"], "threshold": kl_thr},
        "identity_shipped": {"passed": ship["kl"] <= kl_thr,
                             "kl": ship["kl"],
                             "threshold": kl_thr},
        "positional": {
            "passed": ship["chi2_per_dof_mean"] <= args.chi2_threshold,
            "chi2_per_dof_mean": ship["chi2_per_dof_mean"],
            "chi2_per_dof_structural": ship["chi2_per_dof_structural"],
            "threshold": args.chi2_threshold},
        "quality": {
            "passed": (rep["solvable_frac"] >= args.solvable_threshold
                       and min(rep["one_start_frac"], rep["one_goal_frac"])
                       >= args.exactly_one_threshold),
            "solvable_frac": rep["solvable_frac"],
            "one_start_frac": rep["one_start_frac"],
            "one_goal_frac": rep["one_goal_frac"],
            "threshold": args.solvable_threshold,
            "exactly_one_threshold": args.exactly_one_threshold},
    }
    report["passed"] = all(g["passed"] for g in report["gates"].values())
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
