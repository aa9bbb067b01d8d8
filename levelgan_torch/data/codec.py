"""Tile codec: uint8 tile-id grids <-> one-hot float tensors (NHWC)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def encode(ids: torch.Tensor, n_tiles: int,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8/int tile ids [..., H, W] -> one-hot [..., H, W, n_tiles]."""
    return F.one_hot(ids.long(), n_tiles).to(dtype)


def decode(onehot: torch.Tensor) -> torch.Tensor:
    """one-hot / logits / soft samples [..., H, W, C] -> uint8 ids [..., H, W]
    (argmax over the channel axis, first index on ties)."""
    return torch.argmax(onehot, dim=-1).to(torch.uint8)
