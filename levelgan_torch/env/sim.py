"""Grid-world positions: port of the part of ``levelgan/env/sim.py`` that
the solver and the repair use (``start_positions``, ``_pos_mask``).  The
environment's transition and rewards come with the curriculum.
"""

from __future__ import annotations

import torch

from levelgan_torch.config import START


def start_positions(ids: torch.Tensor) -> torch.Tensor:
    """[B, H, W] ids -> [B, 2] int32 start coords (first START, else the
    centre)."""
    b, h, w = ids.shape
    flat = (ids == START).reshape(b, -1)
    has_start = flat.any(dim=-1)
    # argmax takes no bool; on ties it gives the first index, as jnp's does
    idx = torch.argmax(flat.to(torch.uint8), dim=-1)
    pos = torch.stack([idx // w, idx % w], dim=-1).to(torch.int32)
    center = torch.tensor([h // 2, w // 2], dtype=torch.int32,
                          device=ids.device)
    return torch.where(has_start[:, None], pos, center)


def _pos_mask(h: int, w: int, pos: torch.Tensor) -> torch.Tensor:
    """[..., 2] int coords -> [..., H, W] bool one-hot position mask."""
    iy = torch.arange(h, dtype=torch.int32, device=pos.device)[:, None]
    ix = torch.arange(w, dtype=torch.int32, device=pos.device)[None, :]
    return ((iy == pos[..., 0, None, None])
            & (ix == pos[..., 1, None, None]))
