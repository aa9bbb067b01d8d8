"""Plain PyTorch blocks: the reference versions of the stage kernels.

Port of ``levelgan/ops/blocks.py``.  NHWC in and out, HWIO conv weights,
f32 GroupNorm statistics.  ``upsample_block`` is the plain form of the
fused stage that ``kernels.upsample_block`` (K1) and
``kernels.upsample_rows`` (K1L) compute on the card; the CPU path of the
generator runs it, and the kernels are checked against it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               group_size: int = 16, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample GroupNorm over NHWC [B, ..., C]; statistics in f32."""
    c = x.shape[-1]
    groups = max(1, c // group_size)
    if c % groups:
        raise ValueError(f"channels {c} not divisible into groups of {group_size}")
    xg = x.float().reshape(x.shape[0], -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (xn * gamma.float() + beta.float()).to(x.dtype)


def conv_transpose_2x(x: torch.Tensor, w: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """Stride-2 transposed conv, 4x4 kernel, SAME: [B,H,W,Ci] -> [B,2H,2W,Co].

    ``w`` is HWIO [4, 4, Ci, Co] as in the JAX package; ``lax.conv_transpose``
    with SAME padding equals ``conv_transpose2d(stride=2, padding=1)`` on the
    spatially flipped kernel in torch's [Ci, Co, kh, kw] layout.
    """
    wt = w.permute(2, 3, 0, 1).flip(2, 3).to(compute_dtype)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(compute_dtype), wt,
                           stride=2, padding=1)
    return y.permute(0, 2, 3, 1)


def upsample_block(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, *, slope: float = 0.2,
                   group_size: int = 16,
                   compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """ConvTranspose(4x4, s2, SAME) -> GroupNorm -> LeakyReLU, NHWC.

    The plain counterpart of ``upsample_block_xla`` in the JAX package.
    """
    y = conv_transpose_2x(x, w, compute_dtype=compute_dtype)
    y = group_norm(y, gamma, beta, group_size=group_size)
    return leaky_relu(y, slope).to(compute_dtype).contiguous()
