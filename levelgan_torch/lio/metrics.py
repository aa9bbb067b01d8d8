"""Metrics: the tile-histogram KL and JSONL logging.

Port of ``levelgan/lio/metrics.py``: KL(P_gen || P_ref) over tile-type
marginals with add-one smoothing, and ``MetricsLogger``, which writes the
same ``metrics.jsonl`` lines ({"step", "wall_time", **scalars}).  Tensors
are pulled to the host only when logged.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from levelgan_torch.dist import mesh


def tile_histogram(ids: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """Tile-type counts [n_tiles] f32 of an id grid batch, on its device."""
    return torch.bincount(ids.reshape(-1).long(),
                          minlength=n_tiles)[:n_tiles].float()


def kl_divergence(p_counts, q_counts) -> float:
    """KL(P || Q) from raw counts with add-one smoothing."""
    p = np.asarray(torch.as_tensor(p_counts).cpu(), np.float64) + 1.0
    q = np.asarray(torch.as_tensor(q_counts).cpu(), np.float64) + 1.0
    p, q = p / p.sum(), q / q.sum()
    return float(np.sum(p * (np.log(p) - np.log(q))))


class MetricsLogger:
    """Structured JSONL metrics writer: one JSON object per line.  Under
    data parallelism only rank 0 writes (and echoes); every rank gets the
    record back from ``log``."""

    def __init__(self, out_dir: str, filename: str = "metrics.jsonl",
                 echo: bool = True):
        self.path = os.path.join(out_dir, filename)
        self._f = None
        if mesh.rank() == 0:
            os.makedirs(out_dir, exist_ok=True)
            self._f = open(self.path, "a", buffering=1)
        self._echo = echo and self._f is not None
        self._t0 = time.monotonic()

    def log(self, step: int, **scalars):
        rec = {"step": int(step),
               "wall_time": round(time.monotonic() - self._t0, 4)}
        for k, v in scalars.items():
            if isinstance(v, (torch.Tensor, np.ndarray)):
                v = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                               else v)
                v = v.item() if v.ndim == 0 else v.tolist()
            rec[k] = round(v, 6) if isinstance(v, float) else v
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")
        if self._echo:
            parts = " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in rec.items()
                             if k != "wall_time")
            print(f"[levelgan_torch] {parts}", flush=True)
        return rec

    def close(self):
        if self._f is not None:
            self._f.close()
