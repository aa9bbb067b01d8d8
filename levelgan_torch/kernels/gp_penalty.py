"""K2 core on Hopper: the WGAN-GP gradient-norm penalty, forward and backward.

Replaces ``levelgan/kernels/gp_penalty.py:_pallas_fwd`` and ``_pallas_bwd``
(their ``pl.pallas_call``s), reached there from ``norm_penalty`` and
``gradient_penalty_pallas``.  CUDA source: ``levelgan_torch/csrc/gp_penalty.cu``.

    forward:  norm_b = sqrt(||g_b||^2 + 1e-12),  pen_b = (norm_b - 1)^2
    backward: dg_b = ct_b * 2 (norm_b - 1) / norm_b * g_b

The critic's forward and its input gradient stay plain PyTorch (cuDNN), as
they stay XLA in the JAX package; what the kernels cover is the penalty
core on both sides of the double backward.  ``NormPenalty`` is the
differentiable op.  Its backward is ``once_differentiable``: its output only
has to flow into the ``create_graph`` inner gradient, which the outer
backward then walks to the critic's parameters; nothing differentiates the
penalty's backward again.

Design.  The TPU kernel tiles the batch to fit VMEM.  On the card the
forward is one block per sample (a row reduction over 32,768 f32 at
gumbel_64: float4 loads, a fixed-order f32 sum and a warp-shuffle tree,
so the result is deterministic), the backward a float4 scaled copy.  What
bounds them on an H100 at B = 64: the bytes, 8.4 MB read (~2.5 us) and
8.4 MB read + 8.4 MB written (~5 us); the launch is of the same order.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from levelgan_torch.kernels import build
from levelgan_torch.ops.blocks import up

EPS = 1e-12

fwd_launches = 0      # forward kernel launches since the last reset
bwd_launches = 0      # backward kernel launches since the last reset


def _lib():
    lib = build.load("gp_penalty")
    fn = lib.norm_penalty_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bwd = lib.norm_penalty_bwd
        bwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        bwd.restype = ctypes.c_int
    return lib


def norm_penalty_fwd_plain(g2: torch.Tensor):
    norm = torch.sqrt(up(g2).square().sum(dim=1) + EPS)
    return (norm - 1.0).square(), norm


def norm_penalty_bwd_plain(g2: torch.Tensor, norm: torch.Tensor,
                           ct: torch.Tensor) -> torch.Tensor:
    return ((ct * 2.0 * (norm - 1.0) / norm)[:, None] * g2).to(g2.dtype)


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if (t.dtype != torch.float32 or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape) or t.device != device):
        raise ValueError(f"K2 core {name} must be contiguous f32 {tuple(shape)}"
                         f" on {device}, got {tuple(t.shape)} {t.dtype} "
                         f"on {t.device}")


def norm_penalty_fwd(g2: torch.Tensor):
    """g2 [B, F] f32 -> (pen [B], norm [B]) f32."""
    if g2.device.type == "cpu":
        return norm_penalty_fwd_plain(g2)
    if g2.device.type != "cuda":
        raise ValueError(f"K2 core runs on CUDA tensors, got {g2.device}")
    b, f = g2.shape
    _check("g2", g2, (b, f), g2.device)
    if f % 4:
        raise ValueError(f"K2 core needs F % 4 == 0, got F={f}")
    pen = torch.empty((b,), dtype=torch.float32, device=g2.device)
    norm = torch.empty_like(pen)
    with torch.cuda.device(g2.device):
        err = _lib().norm_penalty_fwd(build.ptr(g2), build.ptr(pen),
                                      build.ptr(norm), b, f,
                                      build.stream_ptr(g2.device))
    build.check(err, "norm_penalty_fwd")
    global fwd_launches
    fwd_launches += 1
    return pen, norm


def norm_penalty_bwd(g2: torch.Tensor, norm: torch.Tensor,
                     ct: torch.Tensor) -> torch.Tensor:
    """g2 [B, F], norm [B], ct [B] (cotangent of pen) -> dg [B, F] f32."""
    if g2.device.type == "cpu":
        return norm_penalty_bwd_plain(g2, norm, ct)
    if g2.device.type != "cuda":
        raise ValueError(f"K2 core runs on CUDA tensors, got {g2.device}")
    b, f = g2.shape
    _check("g2", g2, (b, f), g2.device)
    _check("norm", norm, (b,), g2.device)
    _check("ct", ct, (b,), g2.device)
    if f % 4:
        raise ValueError(f"K2 core needs F % 4 == 0, got F={f}")
    dg = torch.empty_like(g2)
    with torch.cuda.device(g2.device):
        err = _lib().norm_penalty_bwd(build.ptr(g2), build.ptr(norm),
                                      build.ptr(ct), build.ptr(dg), b, f,
                                      build.stream_ptr(g2.device))
    build.check(err, "norm_penalty_bwd")
    global bwd_launches
    bwd_launches += 1
    return dg


class NormPenalty(torch.autograd.Function):
    """Per-sample (||g||-1)^2 of g2 [B, F] f32 (``norm_penalty``'s custom
    VJP)."""

    @staticmethod
    def forward(ctx, g2):
        pen, norm = norm_penalty_fwd(g2)
        ctx.save_for_backward(g2, norm)
        return pen

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        g2, norm = ctx.saved_tensors
        return norm_penalty_bwd(g2, norm, ct.contiguous())


def gradient_penalty_core(critic, real: torch.Tensor, fake: torch.Tensor,
                          cond=None, eps: torch.Tensor | None = None, *,
                          generator: torch.Generator | None = None
                          ) -> torch.Tensor:
    """Twin of ``ops.grad_penalty.gradient_penalty`` with the K2 core:
    ``critic(x, cond) -> [B]`` scores; differentiable w.r.t. the critic's
    parameters (the inner input gradient is taken with create_graph)."""
    from levelgan_torch.ops.grad_penalty import interpolate

    x_hat = interpolate(real, fake, eps, generator=generator)
    x_hat.requires_grad_(True)
    score = critic(x_hat, cond).float().sum()
    (g,) = torch.autograd.grad(score, x_hat, create_graph=True)
    g2 = g.float().reshape(g.shape[0], -1).contiguous()
    return NormPenalty.apply(g2).mean()
