"""Track rendering: port of ``levelgan/track/render.py`` (NumPy).

(curvature, width) sequences -> PNG centerline plots, the track family's
twin of the tile exporter's PNG grid: the centerline is integrated from
curvature (unit segment length), drawn with point thickness proportional
to the local width.  Without PIL the image goes to ``<path>.npz`` (key
``img``), as the tile ``write_png`` falls back.
"""

from __future__ import annotations

import numpy as np

from levelgan_torch.track.data import centerline


def rasterize_track(track: np.ndarray, size: int = 128,
                    samples_per_seg: int = 6) -> np.ndarray:
    """One (T,2) track -> uint8 [size, size] image (0=bg, 255=track)."""
    cl = centerline(track[None])[0]            # [T+1, 2]
    width = track[:, 1]
    # densify the polyline
    pts, ws = [], []
    for i in range(len(cl) - 1):
        for a in np.linspace(0.0, 1.0, samples_per_seg, endpoint=False):
            pts.append(cl[i] * (1 - a) + cl[i + 1] * a)
            ws.append(width[i])
    pts = np.asarray(pts)
    ws = np.asarray(ws)

    lo, hi = pts.min(0), pts.max(0)
    span = max((hi - lo).max(), 1e-6)
    xy = ((pts - lo) / span * (size * 0.86) + size * 0.07)

    img = np.zeros((size, size), np.uint8)
    # brush radius from physical width (track units -> pixels)
    radii = np.maximum(1, (ws / span * size * 0.5).astype(int))
    yy, xx = np.mgrid[-3:4, -3:4]
    for (x, y), r in zip(xy, radii):
        r = min(r, 3)
        mask = xx ** 2 + yy ** 2 <= r ** 2
        ys = np.clip(int(y) + yy[mask], 0, size - 1)
        xs = np.clip(int(x) + xx[mask], 0, size - 1)
        img[ys, xs] = 255
    return img


def render_tracks_gray(tracks: np.ndarray, cols: int = 4,
                       size: int = 128) -> np.ndarray:
    """Tile a batch of tracks into one grayscale image array."""
    n = len(tracks)
    if n == 0:
        raise ValueError("render_tracks_gray needs at least one track")
    cols = min(cols, n)
    rows = (n + cols - 1) // cols
    grid = np.zeros((rows * size, cols * size), np.uint8)
    for i, tr in enumerate(tracks):
        r, c = divmod(i, cols)
        grid[r * size:(r + 1) * size, c * size:(c + 1) * size] = \
            rasterize_track(tr, size)
    return grid


def write_track_png(path: str, tracks: np.ndarray, cols: int = 4,
                    size: int = 128):
    grid = render_tracks_gray(tracks, cols, size)
    try:
        from PIL import Image
        Image.fromarray(grid).save(path)
    except ImportError:
        np.savez(path + ".npz", img=grid)
        print(f"[levelgan_torch] PIL unavailable; wrote the raw image to "
              f"{path}.npz")
