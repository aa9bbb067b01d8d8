"""Level export CLI: ``python -m levelgan_torch.cli.export``.

Port of ``levelgan/cli/export.py``: loads a FORMAT.md checkpoint written
by either package (EMA generator weights first), generates on the GPU
(``--device cpu`` for the plain CPU path), and writes ``.npz`` (uint8
``levels``), ``.txt`` (ascii) or ``.png``.  Prints levels/sec.
``--repair`` / ``--repair-placement`` / ``--exactly-one`` repair START and
GOAL on the device; a conditional model takes ``--cond`` (default: the
corpus-mean feature vector) and ``--calibrated`` maps it through the
checkpoint's ``cond_calibration.json``.  Track checkpoints write ``.npz``
(f32 ``tracks`` [n, T, 2]) or ``.png`` (centerline plots,
``track/render.py``); their repair (on by default, ``--no-repair`` off)
is the heading-closure projection.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from levelgan_torch.api import make_dataset
from levelgan_torch.config import Config
from levelgan_torch.data.features import corpus_mean_cond
from levelgan_torch.device import resolve_device
from levelgan_torch.export import generate
from levelgan_torch.lio.calibration import apply_calibration, load_calibration
from levelgan_torch.lio.checkpoint import all_checkpoints, load_generator_params
from levelgan_torch.track.render import write_track_png

ASCII_TILES = ".#SGXo~*"
# RGB palette per tile id (empty, wall, start, goal, hazard, coin, sand, ice)
PALETTE = np.array([
    [236, 236, 228], [60, 56, 54], [69, 133, 66], [214, 93, 14],
    [204, 36, 29], [215, 153, 33], [189, 174, 147], [131, 165, 152],
], dtype=np.uint8)


def load_generator(ckpt: str) -> tuple[str, Config, dict]:
    """(the step dir read, its Config, generator params) from a step dir,
    or the newest readable step under a ckpt parent (or a run dir's
    ``ckpt/``)."""
    if os.path.exists(os.path.join(ckpt, "manifest.json")):
        candidates = [ckpt]
    else:
        candidates = (all_checkpoints(ckpt)
                      or all_checkpoints(os.path.join(ckpt, "ckpt")))
        if not candidates:
            raise FileNotFoundError(
                f"no checkpoint found under {ckpt!r} (expected a step dir "
                "with manifest.json, or a parent containing step_* dirs)")
    errors = []
    for path in reversed(candidates):
        try:
            params, cfg = load_generator_params(path)
            return path, cfg, params
        except Exception as e:  # corrupt/truncated step: try the previous one
            errors.append(f"{path}: {e}")
            print(f"[levelgan_torch] WARNING: skipping unreadable checkpoint "
                  f"{path}: {e}", file=sys.stderr)
    raise FileNotFoundError(
        "no readable checkpoint under {!r}; tried newest-to-oldest:\n  {}"
        .format(ckpt, "\n  ".join(errors)))


def write_txt(path: str, levels: np.ndarray):
    with open(path, "w") as f:
        for lv in levels:
            for row in lv:
                f.write("".join(ASCII_TILES[min(t, len(ASCII_TILES) - 1)]
                                for t in row) + "\n")
            f.write("\n")


def render_levels_rgb(levels: np.ndarray, scale: int = 8,
                      cols: int = 8) -> np.ndarray:
    """Tile a batch of uint8 level grids into one RGB image array."""
    n, h, w = levels.shape
    cols = min(cols, n)
    rows = (n + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w), dtype=np.uint8)
    for i, lv in enumerate(levels):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = lv
    rgb = PALETTE[np.minimum(grid, len(PALETTE) - 1)]
    return np.repeat(np.repeat(rgb, scale, 0), scale, 1)


def write_png(path: str, levels: np.ndarray, scale: int = 8, cols: int = 8):
    rgb = render_levels_rgb(levels, scale, cols)
    try:
        from PIL import Image
        Image.fromarray(rgb).save(path)
    except ImportError:
        np.savez(path + ".npz", rgb=rgb)
        print(f"[levelgan_torch] PIL unavailable; wrote raw RGB to {path}.npz")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="levelgan-torch-export",
        description="Export generated levels from a checkpoint (PyTorch port).")
    ap.add_argument("--ckpt", required=True, help="checkpoint directory")
    ap.add_argument("--n", type=int, default=64, help="number of levels")
    ap.add_argument("--out", required=True, help=".npz / .txt / .png output")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cond", default=None,
                    help="comma-separated feature vector (conditional models)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    ap.add_argument("--repair-placement", default=None,
                    choices=("confidence", "uniform"),
                    help="repair cell choice: the generator's most "
                         "confident valid cell, or a uniform sample over "
                         "the valid cells (the corpus's placement law). "
                         "Default: cfg.io.export_repair_placement.")
    ap.add_argument("--repair", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="place missing START/GOAL tiles, GOAL inside "
                         "START's reachable component (ops/repair.py); "
                         "tracks: the exact heading-closure projection "
                         "(track/ops.py). Default: cfg.io.export_repair "
                         "('auto' = off for tiles, on for tracks); "
                         "--no-repair exports the raw sample.")
    ap.add_argument("--exactly-one", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="with repair: also demote duplicate START/GOAL "
                         "tiles, so each level has exactly one of each. "
                         "Default: cfg.io.export_exactly_one ('auto' = on "
                         "when repairing).")
    ap.add_argument("--calibrated", action="store_true",
                    help="map --cond through the checkpoint's "
                         "cond_calibration.json (lio/calibration.py)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    _, cfg, params = load_generator(args.ckpt)
    track = cfg.model.family == "track"
    if track and not args.out.endswith((".npz", ".png")):
        raise SystemExit("track export supports .npz or .png")
    cond = None
    if args.cond is not None:
        cond = np.array([float(x) for x in args.cond.split(",")], np.float32)
        if cond.size != cfg.model.cond_dim:
            raise SystemExit(f"--cond needs {cfg.model.cond_dim} values, "
                             f"got {cond.size}")
    elif cfg.model.cond_dim:
        # default request: the whole corpus's mean feature vector
        cond = corpus_mean_cond(cfg, make_dataset(cfg), device)
    if args.calibrated:
        if cond is None:
            raise SystemExit("--calibrated requires a conditional model")
        cond = apply_calibration(load_calibration(args.ckpt), cond)

    t0 = time.perf_counter()
    levels = generate(cfg, params, args.n, seed=args.seed,
                      batch_size=args.batch, cond=cond, repair=args.repair,
                      repair_placement=args.repair_placement,
                      exactly_one=args.exactly_one, device=device)
    dt = time.perf_counter() - t0

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    what = "tracks" if track else "levels"
    if args.out.endswith(".npz"):
        np.savez_compressed(args.out, **{what: levels})
    elif track:
        write_track_png(args.out, levels)
    elif args.out.endswith(".txt"):
        write_txt(args.out, levels)
    elif args.out.endswith(".png"):
        write_png(args.out, levels)
    else:
        raise SystemExit("--out must end in .npz, .txt, or .png")
    print(f"[levelgan_torch] exported {len(levels)} {what} to {args.out} "
          f"({len(levels) / dt:,.0f} {what}/sec on {device}, incl. kernel "
          f"build and first-call setup)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
