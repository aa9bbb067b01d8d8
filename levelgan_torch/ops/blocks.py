"""Plain PyTorch blocks: the reference versions of the stage kernels.

Port of ``levelgan/ops/blocks.py``.  NHWC in and out, HWIO conv weights,
f32 GroupNorm statistics.  ``upsample_block`` is the plain form of the
fused stage that ``kernels.upsample_block`` (K1) and
``kernels.upsample_rows`` (K1L) compute on the card; the CPU path of the
generator runs it, and the kernels are checked against it.
``conv_transpose_2x_input_grad`` is the plain form of the backward
kernels' dx contraction.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def up(t: torch.Tensor) -> torch.Tensor:
    """``t`` in at least f32 (bf16 and f32 -> f32; f64 stays f64, so the
    plain versions can be gradchecked in double)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU with the slope rounded to x's dtype first, as JAX rounds
    the weak-typed Python scalar of ``slope * x`` (0.2 is 0.2001953125 in
    bf16); an f32 or f64 x keeps the slope of its own precision."""
    return torch.where(x >= 0, x, _rounded(slope, x.dtype) * x)


def _low(x: torch.Tensor) -> bool:
    return x.dtype in (torch.bfloat16, torch.float16)


class _LowSigmoid(torch.autograd.Function):
    """``jax.nn.sigmoid`` in bf16 as XLA computes it: 1 / (1 + exp(-x)),
    each op rounded to bf16 (0.0059 gives 0.50390625, not 0.5); the
    derivative is ``logistic``'s, g * (y * (1 - y)), rounded op by op."""

    @staticmethod
    def forward(ctx, x):
        y = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1.0 - y))


class _LowTanh(torch.autograd.Function):
    """``jnp.tanh`` in bf16: the value is torch's; the derivative is
    ``tanh``'s in JAX, e + e * y with e = g * (1 - y), rounded op by op."""

    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        e = g * (1.0 - y)
        return e + e * y


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The logistic function where the JAX program rounds: in bf16 (or
    f16) ``_LowSigmoid``, else ``torch.sigmoid``."""
    return _LowSigmoid.apply(x) if _low(x) else torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh, with JAX's derivative in bf16 (or f16) (``_LowTanh``)."""
    return _LowTanh.apply(x) if _low(x) else torch.tanh(x)


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               group_size: int = 16, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample GroupNorm over NHWC [B, ..., C]; statistics in at least
    f32."""
    c = x.shape[-1]
    groups = max(1, c // group_size)
    if c % groups:
        raise ValueError(f"channels {c} not divisible into groups of {group_size}")
    xg = up(x).reshape(x.shape[0], -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (xn * up(gamma) + up(beta)).to(x.dtype)


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


def conv_transpose_2x_input_grad(dy: torch.Tensor, w: torch.Tensor
                                 ) -> torch.Tensor:
    """The input gradient of ``conv_transpose_2x``: dy [B,2H,2W,Co] ->
    dx [B,H,W,Ci] in at least f32, a stride-2 conv of dy with the same
    (flipped) kernel, on dy as stored and w rounded to dy's dtype."""
    wt = up(w.to(dy.dtype)).permute(2, 3, 0, 1).flip(2, 3)
    dx = F.conv2d(up(dy).permute(0, 3, 1, 2), wt, stride=2, padding=1)
    return dx.permute(0, 2, 3, 1)


def group_stats(y: torch.Tensor, group_size: int = 16, eps: float = 1e-5):
    """Per-(sample, channel) GroupNorm mean and rstd [B, C] (at least f32)
    of NHWC y, each channel carrying its group's values."""
    b, c = y.shape[0], y.shape[-1]
    groups = max(1, c // group_size)
    if c % groups:
        raise ValueError(f"channels {c} not divisible into groups of {group_size}")
    yg = up(y).reshape(b, -1, groups, c // groups)
    mean = yg.mean(dim=(1, 3))
    var = (yg - mean[:, None, :, None]).square().mean(dim=(1, 3))
    rstd = torch.rsqrt(var + eps)
    return (mean.repeat_interleave(c // groups, dim=1),
            rstd.repeat_interleave(c // groups, dim=1))


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
