"""K1 on Hopper: fused ConvTranspose(4x4, s2) + GroupNorm + LeakyReLU,
forward and backward.

Replaces ``levelgan/kernels/upsample_block.py:_forward`` and ``_backward``
(their ``pl.pallas_call``s), reached there from ``upsample_block_pallas`` /
``upsample_block_sm`` through the ``jax.custom_vjp`` of ``_make_op``.
CUDA source: ``levelgan_torch/csrc/upsample_block.cu``.

Design.  The TPU kernel tiles the batch to fit VMEM and works in a
spatial-major layout for Mosaic's sake; neither reason holds on the card.
Here one thread block owns one (sample, GroupNorm group): all output
positions of the sample for the group's 16 channels.  That tile is kept in
registers as tensor-core (``mma.sync``) accumulators, so the GroupNorm
statistics are a block reduction and the normalise + LeakyReLU epilogue
runs before the one bf16 store; the pre-norm tile never reaches device
memory.  Activations stay batch-major NHWC, as the port's public layout.

What bounds it: the gumbel_64 stages are 68.7 GFLOP each at B = 1024
against tens to hundreds of MB, so the tensor cores bound it; this first
version is plain ``mma.sync`` with single-buffered smem staging (TMA and
``wgmma`` are later work).

Dispatch rule (``fits``): K1 where the (sample, group) tile fits the
block's accumulators — 4*H*W/16 (parity, 16-row) tasks on at most 8 warps x
8 tasks, i.e. H*W <= 256, a 64 KB f32 tile at group size 16.  Otherwise the
stage goes to K1L (``kernels.upsample_rows``).  At gumbel_64 that routes:

    up0  4x4   -> 8x8,   512 -> 256   K1   (tile  4 KB)
    up1  8x8   -> 16x16, 256 -> 128   K1   (tile 16 KB)
    up2  16x16 -> 32x32, 128 -> 64    K1   (tile 64 KB, the limit)
    up3  32x32 -> 64x64,  64 -> 32    K1L  (tile 256 KB does not fit)

Backward (``upsample_block_bwd``, the function of ``_backward``): from the
residuals the forward saves with ``residuals=True`` (the bf16 pre-norm conv
output ``ypre`` and the per-(sample, channel) mean / rstd, as
``_forward(..., residuals=True)`` emits them) it computes LeakyReLU bwd ->
GroupNorm bwd -> the pre-norm cotangent ``dy``, dgamma / dbeta, and the
input gradient dx.  The dx contraction spans every output channel, across
GroupNorm groups, so the kernel runs in two phases (see the .cu): one block
per (sample, group) for the GroupNorm backward, then dx as a gather GEMM
(M = B*H*W, N = Ci, K = 16*Co).  The weight gradient stays a plain matmul
over the 16 taps (``weight_grad``), as the JAX package forms it in XLA
outside Pallas.  At gumbel_64 training (B = 64) the dx GEMM is 4.29 GFLOP
per stage, ~4.3 us on the tensor cores; that bounds up0, while the g,
ypre, dy and dx traffic bounds up1 (~16 MB, ~4.7 us) and up2 (~29 MB,
~8.8 us).

``UpsampleBlockFn`` ties forward and backward together as
``_make_op``'s custom VJP does.

On a CPU tensor the wrappers run the plain versions
(``ops.blocks.upsample_block``, ``upsample_block_fwd_plain``,
``upsample_block_bwd_plain``); on a CUDA tensor they launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes

import torch

from levelgan_torch.kernels import build
from levelgan_torch.ops.blocks import (conv_transpose_2x,
                                       conv_transpose_2x_input_grad,
                                       group_stats, leaky_relu, up)
from levelgan_torch.ops.blocks import upsample_block as upsample_block_plain

MAX_TASKS = 64        # 8 warps x 8 (parity, 16-row M tile) tasks
KC = 64               # input channels per smem chunk (csrc: lgt::KC)
KCB = 32              # cotangent channels per smem chunk (csrc: lgt::KCB)
NB_DX = 32            # dx input channels per block (csrc: lgt::NB_DX)
MROWS_DX = 128        # dx positions per block, at most (csrc: lgt::MROWS_DX)
EPS = 1e-5
PARITIES = ((0, 0), (0, 1), (1, 0), (1, 1))

launches = 0          # forward kernel launches since the last reset
bwd_launches = 0      # backward kernel calls since the last reset


def fits(h: int, w: int) -> bool:
    """Whether a stage with input H x W runs on K1 (else K1L)."""
    return h * w % 16 == 0 and 4 * h * w // 16 <= MAX_TASKS


def pack_taps(w: torch.Tensor) -> torch.Tensor:
    """HWIO [4, 4, Ci, Co] f32 -> [16, Co, Ci] bf16, tap = kh * 4 + kw."""
    kh, kw, ci, co = w.shape
    return w.permute(0, 1, 3, 2).reshape(kh * kw, co, ci).to(
        torch.bfloat16).contiguous()


def pack_taps_bwd(w: torch.Tensor) -> torch.Tensor:
    """HWIO [4, 4, Ci, Co] f32 -> [16, Ci, Co] bf16, tap = kh * 4 + kw."""
    kh, kw, ci, co = w.shape
    return w.reshape(kh * kw, ci, co).to(torch.bfloat16).contiguous()


def dx_fits(h: int, w: int, ci: int, co: int) -> bool:
    """The dx gather kernel's shape rule (K1 phase (b) and K1L bwd)."""
    rt = min(h, MROWS_DX // w) if w <= MROWS_DX else 0
    return (rt > 0 and rt * w % 16 == 0 and h % rt == 0 and ci % NB_DX == 0
            and co % KCB == 0)


def _lib():
    lib = build.load("upsample_block")
    fn = lib.upsample_block_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        bwd = lib.upsample_block_bwd
        bwd.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
                        + [ctypes.c_float, ctypes.c_void_p])
        bwd.restype = ctypes.c_int
    return lib


def upsample_block_fwd_plain(x, w, gamma, beta, *, slope: float = 0.2,
                             group_size: int = 16):
    """The forward with residuals in plain PyTorch: (y, ypre, mu, rstd).

    The conv runs in f32 on x and w rounded to x's dtype; ``ypre`` is its
    output rounded to x's dtype and the statistics come from the unrounded
    conv output, as in the kernel (and in ``_forward(residuals=True)``).
    """
    cdt = x.dtype
    y = conv_transpose_2x(up(x), up(w.to(cdt)), compute_dtype=up(x).dtype)
    mu, rstd = group_stats(y, group_size, EPS)
    yn = (y - mu[:, None, None]) * rstd[:, None, None] * up(gamma) + up(beta)
    out = leaky_relu(yn, slope).to(cdt).contiguous()
    return out, y.to(cdt).contiguous(), mu, rstd


def upsample_block_fwd(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, *, slope: float = 0.2,
                       group_size: int = 16, residuals: bool = False):
    """x [B, H, W, Ci] -> y [B, 2H, 2W, Co] in x's dtype (bf16 on the card).

    ``w`` HWIO [4, 4, Ci, Co] f32, ``gamma``/``beta`` [Co] f32.  With
    ``residuals`` returns ``(y, ypre, mu, rstd)``: the pre-norm conv output
    in x's dtype and the per-(sample, channel) GroupNorm mean and rstd
    [B, Co] f32 that ``upsample_block_bwd`` consumes.
    """
    if x.device.type == "cpu":
        if residuals:
            return upsample_block_fwd_plain(x, w, gamma, beta, slope=slope,
                                            group_size=group_size)
        return upsample_block_plain(x, w, gamma, beta, slope=slope,
                                    group_size=group_size,
                                    compute_dtype=x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {x.device}")
    b, h, ww, ci = x.shape
    co = w.shape[-1]
    gs = group_size
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("K1 takes a contiguous bf16 x")
    if tuple(w.shape) != (4, 4, ci, co):
        raise ValueError(f"K1 weight shape {tuple(w.shape)} != (4, 4, {ci}, {co})")
    for name, t in (("w", w), ("gamma", gamma), ("beta", beta)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"K1 {name} must be f32 on {x.device}")
    if tuple(gamma.shape) != (co,) or tuple(beta.shape) != (co,):
        raise ValueError("K1 gamma/beta must be [Co]")
    if gs not in (8, 16) or co % gs or ci % KC or not fits(h, ww):
        raise ValueError(
            f"K1 shape rule violated: ci={ci} (multiple of {KC}), co={co}, "
            f"group_size={gs} (8 or 16), H*W={h * ww} (multiple of 16, "
            f"<= {4 * MAX_TASKS})")
    wt = pack_taps(w)
    gamma, beta = gamma.contiguous(), beta.contiguous()
    y = torch.empty((b, 2 * h, 2 * ww, co), dtype=torch.bfloat16,
                    device=x.device)
    none = ctypes.c_void_p(None)
    ypre = mu = rstd = None
    if residuals:
        ypre = torch.empty_like(y)
        mu = torch.empty((b, co), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mu)
    with torch.cuda.device(x.device):
        err = _lib().upsample_block_fwd(
            build.ptr(x), build.ptr(wt), build.ptr(gamma), build.ptr(beta),
            build.ptr(y), build.ptr(ypre) if residuals else none,
            build.ptr(mu) if residuals else none,
            build.ptr(rstd) if residuals else none,
            b, h, ww, ci, co, gs, float(slope), EPS,
            build.stream_ptr(x.device))
    build.check(err, "upsample_block_fwd")
    global launches
    launches += 1
    return (y, ypre, mu, rstd) if residuals else y


def upsample_block_bwd_plain(w, gamma, beta, mu, rstd, g, ypre, *,
                             slope: float = 0.2, group_size: int = 16):
    """The backward in plain PyTorch: (dx, dy, dgamma, dbeta).

    The function of ``_backward``: f32 arithmetic on g and ypre in their
    dtype, ``dy`` rounded to ypre's dtype before the dx contraction.
    """
    cdt = ypre.dtype
    b, _, _, co = g.shape
    groups = max(1, co // group_size)
    gs = co // groups
    mu4, rs4 = mu[:, None, None, :], rstd[:, None, None, :]
    gamma, beta = up(gamma), up(beta)
    xn = (up(ypre) - mu4) * rs4
    gg = up(g.to(cdt))
    dout = torch.where(xn * gamma + beta >= 0, gg, slope * gg)
    s1 = dout.sum(dim=(1, 2))                       # [B, Co]
    s2 = (dout * xn).sum(dim=(1, 2))
    cnt = float(g.shape[1] * g.shape[2] * gs)

    def gmean_c(s):
        gm = (s * gamma).reshape(b, groups, gs).sum(-1) / cnt
        return gm.repeat_interleave(gs, dim=1)[:, None, None, :]

    dy = (rs4 * (dout * gamma - gmean_c(s1) - xn * gmean_c(s2))
          ).to(cdt).contiguous()
    dx = conv_transpose_2x_input_grad(dy, w).to(cdt)
    return dx, dy, s2.sum(0), s1.sum(0)


def upsample_block_bwd(w: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, mu: torch.Tensor,
                       rstd: torch.Tensor, g: torch.Tensor,
                       ypre: torch.Tensor, *, slope: float = 0.2,
                       group_size: int = 16):
    """K1 bwd: g, ypre [B, 2H, 2W, Co] -> (dx [B, H, W, Ci], dy, dgamma,
    dbeta).  ``mu``/``rstd`` [B, Co] f32 are the forward's residuals;
    dx and dy come out in ypre's dtype, dgamma/dbeta in f32."""
    if g.device.type == "cpu":
        return upsample_block_bwd_plain(w, gamma, beta, mu, rstd, g, ypre,
                                        slope=slope, group_size=group_size)
    if g.device.type != "cuda":
        raise ValueError(f"K1 bwd runs on CUDA tensors, got {g.device}")
    b, h2, w2, co = g.shape
    h, ww, ci = h2 // 2, w2 // 2, w.shape[2]
    gs = group_size
    for name, t in (("g", g), ("ypre", ypre)):
        if (t.dtype != torch.bfloat16 or not t.is_contiguous()
                or tuple(t.shape) != (b, h2, w2, co)):
            raise ValueError(f"K1 bwd takes a contiguous bf16 {name} "
                             f"{(b, h2, w2, co)}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    for name, t, shape in (("mu", mu, (b, co)), ("rstd", rstd, (b, co)),
                           ("gamma", gamma, (co,)), ("beta", beta, (co,)),
                           ("w", w, (4, 4, ci, co))):
        if (t.dtype != torch.float32 or t.device != g.device
                or tuple(t.shape) != shape):
            raise ValueError(f"K1 bwd {name} must be f32 {shape} on "
                             f"{g.device}, got {tuple(t.shape)} {t.dtype}")
    if gs not in (8, 16) or co % gs or not dx_fits(h, ww, ci, co):
        raise ValueError(
            f"K1 bwd shape rule violated: ci={ci} (multiple of {NB_DX}), "
            f"co={co} (multiple of {KCB} and of group_size={gs} in 8, 16), "
            f"H={h}, W={ww} (dx tiling rule)")
    wb = pack_taps_bwd(w)
    mu, rstd = mu.contiguous(), rstd.contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    dy = torch.empty_like(ypre)
    s1 = torch.empty((b, co), dtype=torch.float32, device=g.device)
    s2 = torch.empty_like(s1)
    dgamma = torch.empty((co,), dtype=torch.float32, device=g.device)
    dbeta = torch.empty_like(dgamma)
    dx = torch.empty((b, h, ww, ci), dtype=torch.bfloat16, device=g.device)
    with torch.cuda.device(g.device):
        err = _lib().upsample_block_bwd(
            build.ptr(g), build.ptr(ypre), build.ptr(mu), build.ptr(rstd),
            build.ptr(gamma), build.ptr(beta), build.ptr(wb), build.ptr(dy),
            build.ptr(s1), build.ptr(s2), build.ptr(dgamma),
            build.ptr(dbeta), build.ptr(dx), b, h, ww, ci, co, gs,
            float(slope), build.stream_ptr(g.device))
    build.check(err, "upsample_block_bwd")
    global bwd_launches
    bwd_launches += 1
    return dx, dy, dgamma, dbeta


def weight_grad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw [4, 4, Ci, Co] (at least f32) from x [B, H, W, Ci] and the merged
    pre-norm cotangent dy [B, 2H, 2W, Co]: dw[a+2r, b+2s] = xp_tap^T @
    dy_(a,b), 16 f32 matmuls on the operands as stored (``_weight_grad``,
    XLA there)."""
    b, h, ww, ci = x.shape
    co = dy.shape[-1]
    xp = torch.nn.functional.pad(up(x), (0, 0, 1, 1, 1, 1))
    dy_r = up(dy).reshape(b, h, 2, ww, 2, co)
    dw = xp.new_empty((4, 4, ci, co))
    for a, bb in PARITIES:
        dyp = dy_r[:, :, a, :, bb].reshape(-1, co)
        for r in (0, 1):
            for s in (0, 1):
                tap = xp[:, a + r:a + r + h, bb + s:bb + s + ww].reshape(-1, ci)
                dw[a + 2 * r, bb + 2 * s] = tap.t() @ dyp
    return dw


class UpsampleBlockFn(torch.autograd.Function):
    """The K1 stage as one differentiable op (``_make_op``'s custom VJP):
    forward with residuals, backward = K1 bwd + ``weight_grad``."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, slope, group_size):
        y, ypre, mu, rstd = upsample_block_fwd(
            x, w, gamma, beta, slope=slope, group_size=group_size,
            residuals=True)
        ctx.save_for_backward(x, w, gamma, beta, ypre, mu, rstd)
        ctx.slope, ctx.group_size = slope, group_size
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, gamma, beta, ypre, mu, rstd = ctx.saved_tensors
        dx, dy, dgamma, dbeta = upsample_block_bwd(
            w, gamma, beta, mu, rstd, g.to(ypre.dtype).contiguous(), ypre,
            slope=ctx.slope, group_size=ctx.group_size)
        return (dx.to(x.dtype), weight_grad(x, dy).to(w.dtype),
                dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None, None)
