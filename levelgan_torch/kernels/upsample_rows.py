"""K1L on Hopper: row-tiled ConvTranspose(4x4, s2) in folded layout, forward
and backward.

Replaces ``levelgan/kernels/upsample_rows.py:_conv_fwd`` and ``_conv_bwd``
(their ``pl.pallas_call``s), reached there from ``upsample_block_rows_sm``
through the ``jax.custom_vjp`` of ``_make_rows_op``.  CUDA source:
``levelgan_torch/csrc/upsample_rows.cu``.

The stage runs in two passes, as in the JAX package:

1. the kernel (``upsample_rows_fwd``): the transposed conv emitted as the
   folded ``yf [B, H, W, 4Co]`` bf16 (channel block p = 2a + b holds output
   parity (a, b)) plus per-(sample, channel) sums ``s1``/``s2`` [B, Co] f32
   of the f32 conv output, accumulated with ``atomicAdd`` into zeroed
   buffers (run-to-run order varies: f32-rounding differences only);
2. ``finish``: GroupNorm from the sums, affine, LeakyReLU and the
   depth-to-space ``unfold``, in plain PyTorch (the JAX package runs this
   outside Pallas too; fusing it is later work).

Design.  A block owns 128 / W input rows of one sample and 32 output
channels for all four parities, so any stage width fits; the TPU kernel's
packed 9-shift weights (structured zeros that bought MXU lanes) are not
carried over: each parity multiplies only its own 4 taps.  What bounds it
at gumbel_64 up3 (B = 1024): 68.7 GFLOP against ~400 MB of x in and yf out
is 171 FLOP/byte, under the card's 295, so the bytes bound it (0.12 ms);
this first version (``mma.sync``, single-buffered staging) runs at about
six times that.

Backward (``UpsampleRowsFn``, the custom VJP of ``_make_rows_op``): the
LeakyReLU + GroupNorm backward in plain PyTorch in folded layout, from the
saved yf and the per-(sample, channel) mean / rstd (XLA in the JAX
package); then the kernel ``upsample_rows_bwd`` for dx from the folded
cotangent (the function of ``_conv_bwd``, read from the folded layout by
the same gather GEMM as K1 bwd's dx launch: ``dx_tile`` picks its tile,
the weight is packed by steps once per version; without the TPU's 9-shift
packed weights and their structured zeros); then ``weight_grad_folded``
with torch matmuls.  At gumbel_64 up3 (B = 64) dx is 4.29 GFLOP against
16.8 MB of dyf in and 8.4 MB of dx out: the bytes bound it (~7.5 us).

On a CPU tensor the wrappers run the plain versions (``conv_rows_plain``,
``conv_rows_bwd_plain``); on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from levelgan_torch.kernels import build
from levelgan_torch.kernels.upsample_block import (KCB, NB_DX, dx_fits,
                                                   dx_tile, pack_taps,
                                                   pack_taps_dx, packed)
from levelgan_torch.ops.blocks import (conv_transpose_2x,
                                       conv_transpose_2x_input_grad,
                                       leaky_relu, up)

KC = 64               # input channels per smem chunk (csrc: lgt::KC)
NC = 32               # output channels per block
MROWS = 128           # positions per parity per block (rows x W)
SHIFTS = tuple((u, v) for u in (0, 1, 2) for v in (0, 1, 2))

launches = 0          # forward kernel launches since the last reset
bwd_launches = 0      # backward kernel launches since the last reset


def unfold(yf: torch.Tensor) -> torch.Tensor:
    """Depth-to-space: [B, H, W, 4Co] folded -> [B, 2H, 2W, Co]."""
    b, h, w, c4 = yf.shape
    co = c4 // 4
    y = yf.reshape(b, h, w, 2, 2, co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, 2 * h, 2 * w, co)


def fold(y: torch.Tensor) -> torch.Tensor:
    """Space-to-depth: [B, 2H, 2W, Co] -> [B, H, W, 4Co] folded."""
    b, h2, w2, co = y.shape
    y = y.reshape(b, h2 // 2, 2, w2 // 2, 2, co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, h2 // 2, w2 // 2, 4 * co)


def conv_rows_plain(x: torch.Tensor, w: torch.Tensor):
    """The kernel's function in plain PyTorch: (yf, s1, s2).

    The conv runs in f32 on x and w rounded to x's dtype, so the sums come
    from the unrounded conv output, as in the kernel.
    """
    y = conv_transpose_2x(up(x), up(w.to(x.dtype)),
                          compute_dtype=up(x).dtype)
    return (fold(y).to(x.dtype).contiguous(), y.sum(dim=(1, 2)),
            y.square().sum(dim=(1, 2)))


def conv_rows_bwd_plain(dyf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch: dx in dyf's dtype."""
    return conv_transpose_2x_input_grad(unfold(dyf), w).to(dyf.dtype)


def _lib():
    lib = build.load("upsample_rows")
    fn = lib.upsample_rows_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bwd = lib.upsample_rows_bwd
        bwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        bwd.restype = ctypes.c_int
    return lib


def upsample_rows_fwd(x: torch.Tensor, w: torch.Tensor):
    """x [B, H, W, Ci] -> (yf [B, H, W, 4Co], s1 [B, Co], s2 [B, Co])."""
    if x.device.type == "cpu":
        return conv_rows_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"K1L runs on CUDA tensors, got {x.device}")
    b, h, ww, ci = x.shape
    co = w.shape[-1]
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("K1L takes a contiguous bf16 x")
    if tuple(w.shape) != (4, 4, ci, co) or w.dtype != torch.float32 \
            or w.device != x.device:
        raise ValueError(f"K1L weight must be f32 (4, 4, {ci}, {co}) on "
                         f"{x.device}, got {tuple(w.shape)} {w.dtype}")
    if (ci % KC or co % NC or ww < 16 or MROWS % ww
            or h % (MROWS // ww)):
        raise ValueError(
            f"K1L shape rule violated: ci={ci} (multiple of {KC}), co={co} "
            f"(multiple of {NC}), W={ww} (divides {MROWS}, >= 16), H={h} "
            f"(multiple of {MROWS} / W)")
    wt = pack_taps(w)
    yf = torch.empty((b, h, ww, 4 * co), dtype=torch.bfloat16,
                     device=x.device)
    s1 = torch.zeros((b, co), dtype=torch.float32, device=x.device)
    s2 = torch.zeros((b, co), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().upsample_rows_fwd(
            build.ptr(x), build.ptr(wt), build.ptr(yf), build.ptr(s1),
            build.ptr(s2), b, h, ww, ci, co, build.stream_ptr(x.device))
    build.check(err, "upsample_rows_fwd")
    global launches
    launches += 1
    return yf, s1, s2


def upsample_rows_bwd(dyf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K1L bwd: folded cotangent dyf [B, H, W, 4Co] -> dx [B, H, W, Ci]."""
    if dyf.device.type == "cpu":
        return conv_rows_bwd_plain(dyf, w)
    if dyf.device.type != "cuda":
        raise ValueError(f"K1L bwd runs on CUDA tensors, got {dyf.device}")
    b, h, ww, c4 = dyf.shape
    co, ci = c4 // 4, w.shape[2]
    if dyf.dtype != torch.bfloat16 or not dyf.is_contiguous():
        raise ValueError("K1L bwd takes a contiguous bf16 dyf")
    if tuple(w.shape) != (4, 4, ci, co) or w.dtype != torch.float32 \
            or w.device != dyf.device:
        raise ValueError(f"K1L bwd weight must be f32 (4, 4, Ci, {co}) on "
                         f"{dyf.device}, got {tuple(w.shape)} {w.dtype}")
    if c4 % 4 or not dx_fits(h, ww, ci, co):
        raise ValueError(
            f"K1L bwd shape rule violated: ci={ci} (multiple of {NB_DX}), "
            f"co={co} (multiple of {KCB}), H={h}, W={ww} (dx tiling rule)")
    sms = torch.cuda.get_device_properties(dyf.device).multi_processor_count
    nsd, rt = dx_tile(b, h, ww, ci, co, sms)
    wpk = packed(w, pack_taps_dx)
    dx = torch.empty((b, h, ww, ci), dtype=torch.bfloat16, device=dyf.device)
    with torch.cuda.device(dyf.device):
        err = _lib().upsample_rows_bwd(
            build.ptr(dyf), build.ptr(wpk), build.ptr(dx), b, h, ww, ci, co,
            nsd, rt, build.stream_ptr(dyf.device))
    build.check(err, "upsample_rows_bwd")
    global bwd_launches
    bwd_launches += 1
    return dx


def _group_shape(co: int, group_size: int) -> tuple[int, int]:
    groups = max(1, co // group_size)
    if co % groups:
        raise ValueError(f"channels {co} not divisible into groups of {group_size}")
    return groups, co // groups


def rows_stats(s1: torch.Tensor, s2: torch.Tensor, positions: int, *,
               group_size: int = 16, eps: float = 1e-5):
    """Per-(sample, channel) GroupNorm mean / rstd [B, Co] from the channel
    sums over ``positions`` output positions (E[y^2] - E[y]^2, as the JAX
    package forms them from the kernel's sums)."""
    b, co = s1.shape
    groups, gs = _group_shape(co, group_size)
    cnt = float(positions * gs)
    mean = s1.reshape(b, groups, gs).sum(-1) / cnt
    var = s2.reshape(b, groups, gs).sum(-1) / cnt - mean * mean
    rstd = torch.rsqrt(var + eps)
    return mean.repeat_interleave(gs, 1), rstd.repeat_interleave(gs, 1)


def normalize(yf: torch.Tensor, mu: torch.Tensor, rstd: torch.Tensor,
              gamma: torch.Tensor, beta: torch.Tensor, *,
              slope: float = 0.2) -> torch.Tensor:
    """Pass 2: GroupNorm with (mu, rstd), affine, LeakyReLU, unfold."""
    mu4 = mu.repeat(1, 4)[:, None, None, :]
    rs4 = rstd.repeat(1, 4)[:, None, None, :]
    yn = ((up(yf) - mu4) * rs4 * up(gamma).repeat(4)
          + up(beta).repeat(4))
    return unfold(leaky_relu(yn, slope).to(yf.dtype)).contiguous()


def finish(yf: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
           gamma: torch.Tensor, beta: torch.Tensor, *, slope: float = 0.2,
           group_size: int = 16, eps: float = 1e-5) -> torch.Tensor:
    """Pass 2 from the kernel's sums: GroupNorm, affine, LeakyReLU, unfold."""
    b, h, w, _ = yf.shape
    mu, rstd = rows_stats(s1, s2, 4 * h * w, group_size=group_size, eps=eps)
    return normalize(yf, mu, rstd, gamma, beta, slope=slope)


def upsample_block_rows(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, *, slope: float = 0.2,
                        group_size: int = 16) -> torch.Tensor:
    """The whole K1L stage: x [B, H, W, Ci] -> y [B, 2H, 2W, Co]."""
    yf, s1, s2 = upsample_rows_fwd(x, w)
    return finish(yf, s1, s2, gamma, beta, slope=slope,
                  group_size=group_size)


def weight_grad_folded(x: torch.Tensor, dyf: torch.Tensor) -> torch.Tensor:
    """dw [4, 4, Ci, Co] (at least f32) from 9 shifted taps of x against the whole
    folded cotangent ([N, Ci]^T @ [N, 4Co] f32 matmuls, the valid parity
    block of each kept), as ``_weight_grad_folded`` forms it in XLA."""
    b, h, ww, ci = x.shape
    co = dyf.shape[-1] // 4
    xp = torch.nn.functional.pad(up(x), (0, 0, 1, 1, 1, 1))
    dyn = up(dyf).reshape(-1, 4 * co)
    dw = xp.new_empty((4, 4, ci, co))
    for u, v in SHIFTS:
        m = xp[:, u:u + h, v:v + ww].reshape(-1, ci).t() @ dyn
        for a in (0, 1):
            for bb in (0, 1):
                if 0 <= u - a <= 1 and 0 <= v - bb <= 1:
                    p = 2 * a + bb
                    dw[2 * u - a, 2 * v - bb] = m[:, p * co:(p + 1) * co]
    return dw


def gn_act_bwd_folded(g, yf, mu, rstd, gamma, beta, *, slope: float = 0.2,
                      group_size: int = 16):
    """LeakyReLU + GroupNorm backward in folded layout, plain PyTorch:
    (dyf in yf's dtype, dgamma, dbeta), the XLA pass of ``_make_rows_op``."""
    b, h, w, c4 = yf.shape
    co = c4 // 4
    groups, gs = _group_shape(co, group_size)
    gf = fold(up(g))
    gamma = up(gamma)
    gm, bt = gamma.repeat(4), up(beta).repeat(4)
    mu4 = mu.repeat(1, 4)[:, None, None, :]
    rs4 = rstd.repeat(1, 4)[:, None, None, :]
    xn = (up(yf) - mu4) * rs4
    dout = torch.where(xn * gm + bt >= 0, gf, slope * gf)
    d5 = dout.reshape(b, h, w, 4, co)
    s1 = d5.sum(dim=(1, 2, 3))                          # [B, Co]
    s2 = (d5 * xn.reshape(b, h, w, 4, co)).sum(dim=(1, 2, 3))
    cnt = 4.0 * gs * h * w

    def gmean4(s):
        m = (s * gamma).reshape(b, groups, gs).sum(-1) / cnt
        return m.repeat_interleave(gs, 1).repeat(1, 4)[:, None, None, :]

    dyf = rs4 * (dout * gm - gmean4(s1) - xn * gmean4(s2))
    return dyf.to(yf.dtype).contiguous(), s2.sum(0), s1.sum(0)


class UpsampleRowsFn(torch.autograd.Function):
    """The whole K1L stage as one differentiable op (``_make_rows_op``'s
    custom VJP): kernel + finish forward; folded GN/act backward, the K1L
    bwd kernel for dx and ``weight_grad_folded`` for dw."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, slope, group_size):
        yf, s1, s2 = upsample_rows_fwd(x, w)
        mu, rstd = rows_stats(s1, s2, 4 * yf.shape[1] * yf.shape[2],
                              group_size=group_size)
        ctx.save_for_backward(x, w, gamma, beta, yf, mu, rstd)
        ctx.slope, ctx.group_size = slope, group_size
        return normalize(yf, mu, rstd, gamma, beta, slope=slope)

    @staticmethod
    def backward(ctx, g):
        x, w, gamma, beta, yf, mu, rstd = ctx.saved_tensors
        dyf, dgamma, dbeta = gn_act_bwd_folded(
            g, yf, mu, rstd, gamma, beta, slope=ctx.slope,
            group_size=ctx.group_size)
        dx = upsample_rows_bwd(dyf, w)
        return (dx.to(x.dtype), weight_grad_folded(x, dyf).to(w.dtype),
                dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None, None)
