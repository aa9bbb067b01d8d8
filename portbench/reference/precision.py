"""Roundings for the reference (none) and its lower-precision control."""

from __future__ import annotations

import contextlib

import torch

E4M3 = (torch.float8_e4m3fn, 448.0)      # values, as fp8 training keeps them
E5M2 = (torch.float8_e5m2, 57344.0)      # gradients


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _round(x: torch.Tensor, fmt) -> torch.Tensor:
    """Per-tensor scaled fp8 round trip (the tensor's max |x| onto the
    format's largest value), back in x's dtype."""
    dtype, top = fmt
    xf = x.float()
    scale = top / xf.abs().amax().clamp_min(1e-30)
    return ((xf * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """Forward: the value rounded to e4m3; backward: the gradient rounded
    to e5m2 (the usual recipe of fp8 training), written with
    differentiable operations so that a double backward passes through."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, E4M3)

    @staticmethod
    def backward(ctx, g):
        return g + (_round(g.detach(), E5M2) - g.detach())


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` as fp8 training computes with it: e4m3 values, e5m2
    gradients."""
    return _Fp8.apply(x)


@contextlib.contextmanager
def strict_f32():
    """float32 products in float32 (TF32 off for cuBLAS and cuDNN), by
    cuDNN's deterministic algorithms, so that the reference reads the same
    on every run."""
    cudnn = torch.backends.cudnn
    old = (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
           cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
         cudnn.deterministic) = old
