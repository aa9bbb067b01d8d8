"""K1L forward on Hopper: row-tiled ConvTranspose(4x4, s2) in folded layout.

Replaces ``levelgan/kernels/upsample_rows.py:_conv_fwd`` (its
``pl.pallas_call``), reached there from ``upsample_block_rows_sm`` /
``_forward_rows``.  CUDA source: ``levelgan_torch/csrc/upsample_rows.cu``.

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

On a CPU tensor the wrapper runs the plain version (``conv_rows_plain``);
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from levelgan_torch.kernels import build
from levelgan_torch.ops.blocks import conv_transpose_2x, leaky_relu

KC = 64               # input channels per smem chunk (csrc: lgt::KC)
NC = 32               # output channels per block
MROWS = 128           # positions per parity per block (rows x W)

launches = 0          # kernel launches since the last reset


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
    y = conv_transpose_2x(x.float(), w.to(x.dtype).float(),
                          compute_dtype=torch.float32)
    return (fold(y).to(x.dtype).contiguous(), y.sum(dim=(1, 2)),
            y.square().sum(dim=(1, 2)))


def _lib():
    lib = build.load("upsample_rows")
    fn = lib.upsample_rows_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def upsample_rows_fwd(x: torch.Tensor, w: torch.Tensor):
    """x [B, H, W, Ci] -> (yf [B, H, W, 4Co], s1 [B, Co], s2 [B, Co])."""
    if x.device.type == "cpu":
        return conv_rows_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"K1L runs on CUDA tensors, got {x.device}")
    from levelgan_torch.kernels.upsample_block import pack_taps

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


def finish(yf: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
           gamma: torch.Tensor, beta: torch.Tensor, *, slope: float = 0.2,
           group_size: int = 16, eps: float = 1e-5) -> torch.Tensor:
    """Pass 2: GroupNorm from the sums, affine, LeakyReLU, unfold."""
    b, h, w, c4 = yf.shape
    co = c4 // 4
    groups = max(1, co // group_size)
    if co % groups:
        raise ValueError(f"channels {co} not divisible into groups of {group_size}")
    gs = co // groups
    cnt = 4.0 * gs * h * w
    mean = s1.reshape(b, groups, gs).sum(-1) / cnt
    var = s2.reshape(b, groups, gs).sum(-1) / cnt - mean * mean
    rstd = torch.rsqrt(var + eps)
    mu4 = mean.repeat_interleave(gs, 1).repeat(1, 4)[:, None, None, :]
    rs4 = rstd.repeat_interleave(gs, 1).repeat(1, 4)[:, None, None, :]
    yn = ((yf.float() - mu4) * rs4 * gamma.float().repeat(4)
          + beta.float().repeat(4))
    return unfold(leaky_relu(yn, slope).to(yf.dtype)).contiguous()


def upsample_block_rows(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, *, slope: float = 0.2,
                        group_size: int = 16) -> torch.Tensor:
    """The whole K1L stage: x [B, H, W, Ci] -> y [B, 2H, 2W, Co]."""
    yf, s1, s2 = upsample_rows_fwd(x, w)
    return finish(yf, s1, s2, gamma, beta, slope=slope,
                  group_size=group_size)
