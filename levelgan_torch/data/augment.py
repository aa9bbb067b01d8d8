"""D4 (dihedral) augmentation of square tile grids on the device.

Port of ``levelgan/data/augment.py``.  Each sample takes one element of the
D4 group (4 rotations x optional horizontal flip); the elements are drawn
from a ``torch.Generator`` or injected (the tests hand both packages the
same elements).  Works on id grids [..., H, W] and one-hot tensors
[..., H, W, C] (``spatial_offset`` counts the trailing non-spatial axes).
"""

from __future__ import annotations

import torch


def d4_apply(x: torch.Tensor, element: int,
             spatial_offset: int = 0) -> torch.Tensor:
    """Apply D4 element ``element`` in [0, 8) to one sample.

    element % 4  -> number of 90-degree rotations (numpy's rot90 sense);
    element // 4 -> horizontal flip first.
    """
    h_axis = x.ndim - 2 - spatial_offset
    w_axis = x.ndim - 1 - spatial_offset
    if x.shape[h_axis] != x.shape[w_axis]:
        raise ValueError(f"d4_apply needs square grids, got {tuple(x.shape)}")
    element = int(element)
    if element // 4:
        x = torch.flip(x, dims=(w_axis,))
    return torch.rot90(x, k=element % 4, dims=(h_axis, w_axis))


def augment(batch: torch.Tensor, elements: torch.Tensor | None = None,
            generator: torch.Generator | None = None,
            spatial_offset: int = 0) -> torch.Tensor:
    """An independent D4 transform per sample of ``batch`` [B, ...].

    ``elements`` [B] ints in [0, 8) are injected or drawn from
    ``generator``.  All 8 transforms of the batch are formed and each
    sample picks its own, so nothing leaves the device.
    """
    b = batch.shape[0]
    if elements is None:
        elements = torch.randint(0, 8, (b,), device=batch.device,
                                 generator=generator)
    elements = elements.to(batch.device).long()
    h_axis = batch.ndim - 2 - spatial_offset
    w_axis = batch.ndim - 1 - spatial_offset
    if batch.shape[h_axis] != batch.shape[w_axis]:
        raise ValueError(f"augment needs square grids, got {tuple(batch.shape)}")
    flipped = torch.flip(batch, dims=(w_axis,))
    variants = torch.stack([
        torch.rot90(base, k=k, dims=(h_axis, w_axis))
        for base in (batch, flipped) for k in range(4)])     # [8, B, ...]
    return variants[elements, torch.arange(b, device=batch.device)]
