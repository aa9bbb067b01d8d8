"""Training-progress GIF: ``python -m levelgan_torch.cli.progress_gif``.

Port of ``levelgan/cli/progress_gif.py``: every checkpoint under
``<run>/ckpt`` is sampled with the same seed (so the frames show the
generator's evolution on fixed latents, not sampling noise), on the GPU
(``--device cpu`` for the plain CPU path), and drawn with the export
CLI's tile palette (``cli/export.render_levels_rgb``) or, for tracks, the
centerline rasterizer (``track/render.py``).  One frame a checkpoint,
written as a GIF with PIL, or as ``frames`` in ``<out>.npz`` where PIL is
absent.

  python -m levelgan_torch.cli.progress_gif runs/toy --out progress.gif
      [--n 16] [--seed 0] [--fps 4] [--scale 8] [--cols 4] [--cond ...]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from levelgan_torch.cli.export import load_generator, render_levels_rgb
from levelgan_torch.device import resolve_device
from levelgan_torch.export import generate
from levelgan_torch.lio.checkpoint import all_checkpoints
from levelgan_torch.track.render import render_tracks_gray


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="levelgan-torch-progress-gif")
    ap.add_argument("run", help="run directory (containing ckpt/) "
                                "or a ckpt/ directory itself")
    ap.add_argument("--out", default=None,
                    help="output .gif path (default <run>/progress.gif)")
    ap.add_argument("--n", type=int, default=16, help="levels per frame")
    ap.add_argument("--seed", type=int, default=0,
                    help="latent seed, shared by every frame")
    ap.add_argument("--fps", type=float, default=4.0)
    ap.add_argument("--scale", type=int, default=8,
                    help="pixels per tile (tile family)")
    ap.add_argument("--cols", type=int, default=4)
    ap.add_argument("--cond", default=None,
                    help="comma-separated feature vector (conditional "
                         "models; default 0.25 in every feature)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    return ap


def _ckpt_dir(run: str) -> str:
    sub = os.path.join(run, "ckpt")
    return sub if os.path.isdir(sub) else run


def frames(args) -> list[np.ndarray]:
    """One RGB frame [H, W, 3] uint8 a checkpoint of ``args.run``, oldest
    first."""
    ckpt_dir = _ckpt_dir(args.run)
    ckpts = all_checkpoints(ckpt_dir)
    if not ckpts:
        raise SystemExit(f"no checkpoints under {ckpt_dir}")
    device = resolve_device(args.device)
    out = []
    for path in ckpts:
        _, cfg, params = load_generator(path)
        cond = None
        if args.cond is not None:
            cond = np.array([float(x) for x in args.cond.split(",")],
                            np.float32)
        elif cfg.model.cond_dim:
            cond = np.full(cfg.model.cond_dim, 0.25, np.float32)
        levels = generate(cfg, params, args.n, seed=args.seed, cond=cond,
                          device=device)
        if cfg.model.family == "track":
            img = np.stack([render_tracks_gray(levels, cols=args.cols)] * 3,
                           -1)
        else:
            img = render_levels_rgb(levels, scale=args.scale, cols=args.cols)
        out.append(img)
        print(f"[progress_gif] frame {len(out)}/{len(ckpts)}: {path}",
              flush=True)
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    ckpt_dir = _ckpt_dir(args.run)
    # beside ckpt/: in the run dir, or the parent of a ckpt dir given
    out = args.out or os.path.join(
        args.run if ckpt_dir != args.run
        else os.path.dirname(ckpt_dir) or ".", "progress.gif")
    imgs = frames(args)
    try:
        from PIL import Image
    except ImportError:
        npz = out + ".npz"
        np.savez_compressed(npz, frames=np.stack(imgs))
        print(f"[progress_gif] PIL unavailable; wrote frames to {npz}")
        return 0
    ims = [Image.fromarray(f) for f in imgs]
    ims[0].save(out, save_all=True, append_images=ims[1:],
                duration=int(1000 / args.fps), loop=0)
    print(f"[progress_gif] wrote {len(ims)} frames to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
