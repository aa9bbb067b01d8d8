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

Design (in full: the note at the head of ``csrc/gp_penalty.cu``).  The
TPU kernel tiles the batch to fit VMEM.  On the card both kernels move
bytes and do next to no arithmetic, and at B = 64 the launch is most of
their time: chip_smoke's ``queued_ms`` reads 0.0020-0.0022 ms for a
one-cycle kernel on an H100.  The forward is one block a sample that reads
its row in chunks, every chunk's 16-byte loads issued at once, and sums in
a fixed order (each thread in load order, a warp-shuffle butterfly, the
warps by a second one), so two calls give the same bits.  The backward is
a scaled copy over a (chunk, sample) grid of 1024 float4s a block, each
thread's loads issued before its stores; it reads the cotangent with its
stride, so a broadcast cotangent (stride 0, as ``.sum()``'s backward gives)
needs no copy.  The plans (``fwd_plan``, ``bwd_plan``) are plain Python,
passed to the C functions as they are, so a CPU test replays exactly what
is launched (``tests/test_torch_k2_core.py``).

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from levelgan_torch import obs
from levelgan_torch.kernels import build
from levelgan_torch.ops.blocks import up

EPS = 1e-12


FWD_VECS = (4, 16)            # float4 loads a thread a chunk, compiled
FWD_MAX_THREADS = 512         # the kernels' launch bounds
BWD_MAX_THREADS = 256
BWD_VEC = 4                   # float4 loads a backward thread


class FwdPlan(NamedTuple):
    threads: int    # threads of the sample's block
    vec: int        # float4 loads a thread a chunk, issued before their sums


class BwdPlan(NamedTuple):
    chunks: int     # blocks a sample
    threads: int    # threads a block, each with BWD_VEC float4s


def _pow2ceil(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def fwd_plan(b: int, f: int) -> FwdPlan:
    """The forward's launch for g2 [b, f]: one block a sample, of threads
    for about 4 float4s each (a power of two, 32 to 512), each loading 4
    float4s at a time where the row has at most 2048 of them, else 16.
    The row is read in chunks of threads * vec float4s; thread t loads the
    float4s c + j * threads + t of chunk c, j < vec."""
    if f >= 2 ** 31:
        raise ValueError(f"K2 core fwd: g2 [{b}, {f}] has a row length "
                         "outside the kernel's int range")
    n4 = f // 4
    threads = min(FWD_MAX_THREADS, max(32, _pow2ceil(-(-n4 // 4))))
    return FwdPlan(threads, 4 if n4 <= 4 * threads else 16)


def bwd_plan(b: int, f: int) -> BwdPlan:
    """The backward's launch for g2 [b, f]: blocks of 1024 float4s (256
    threads), ceil(f / 4096) a sample.  Chunk c of a sample covers the
    float4s [c * 1024, (c + 1) * 1024) of its row; its thread t the
    float4s c * 1024 + j * 256 + t, j < BWD_VEC."""
    if not 1 <= b <= 65535:
        raise ValueError(f"K2 core bwd: g2 [{b}, {f}] has a batch outside "
                         "1..65535 (the grid's second dimension)")
    per = BWD_MAX_THREADS * BWD_VEC
    return BwdPlan(max(1, -(-(f // 4) // per)), BWD_MAX_THREADS)


def _lib():
    lib = build.load("gp_penalty")
    fn = lib.norm_penalty_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bwd = lib.norm_penalty_bwd
        bwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                  ctypes.c_void_p]
                        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
    return lib


def norm_penalty_fwd_plain(g2: torch.Tensor):
    norm = torch.sqrt(up(g2).square().sum(dim=1) + EPS)
    return (norm - 1.0).square(), norm


def norm_penalty_bwd_plain(g2: torch.Tensor, norm: torch.Tensor,
                           ct: torch.Tensor) -> torch.Tensor:
    return ((ct * 2.0 * (norm - 1.0) / norm)[:, None] * g2).to(g2.dtype)


def _check(name: str, t: torch.Tensor, shape, device, contiguous=True):
    if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
            or t.device != device or (contiguous and not t.is_contiguous())):
        raise ValueError(f"K2 core {name} must be "
                         + ("contiguous " if contiguous else "")
                         + f"f32 {tuple(shape)} on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _check_g2(g2: torch.Tensor):
    if g2.device.type != "cuda":
        raise ValueError(f"K2 core runs on CUDA tensors, got {g2.device}")
    b, f = g2.shape
    _check("g2", g2, (b, f), g2.device)
    if f % 4 or g2.data_ptr() % 16:
        raise ValueError(f"K2 core needs F % 4 == 0 and g2 16-byte aligned, "
                         f"got F={f} at {g2.data_ptr() % 16} bytes past")
    return b, f


def norm_penalty_fwd(g2: torch.Tensor):
    """g2 [B, F] f32 -> (pen [B], norm [B]) f32."""
    if g2.device.type == "cpu":
        return norm_penalty_fwd_plain(g2)
    b, f = _check_g2(g2)
    plan = fwd_plan(b, f)
    pen = torch.empty((b,), dtype=torch.float32, device=g2.device)
    norm = torch.empty_like(pen)
    with torch.cuda.device(g2.device):
        err = _lib().norm_penalty_fwd(build.ptr(g2), build.ptr(pen),
                                      build.ptr(norm), b, f, plan.threads,
                                      plan.vec,
                                      build.stream_ptr(g2.device))
    build.check(err, f"norm_penalty_fwd at [{b}, {f}] by {plan}")
    obs.count("k2.fwd_launches")
    return pen, norm


def norm_penalty_bwd(g2: torch.Tensor, norm: torch.Tensor,
                     ct: torch.Tensor) -> torch.Tensor:
    """g2 [B, F], norm [B], ct [B] (cotangent of pen, any stride) -> dg
    [B, F] f32."""
    if g2.device.type == "cpu":
        return norm_penalty_bwd_plain(g2, norm, ct)
    b, f = _check_g2(g2)
    _check("norm", norm, (b,), g2.device)
    _check("ct", ct, (b,), g2.device, contiguous=False)
    plan = bwd_plan(b, f)
    dg = torch.empty_like(g2)
    with torch.cuda.device(g2.device):
        err = _lib().norm_penalty_bwd(build.ptr(g2), build.ptr(norm),
                                      build.ptr(ct), ct.stride(0),
                                      build.ptr(dg), b, f, plan.chunks,
                                      plan.threads,
                                      build.stream_ptr(g2.device))
    build.check(err, f"norm_penalty_bwd at [{b}, {f}] by {plan}")
    obs.count("k2.bwd_launches")
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
        return norm_penalty_bwd(g2, norm, ct)


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
