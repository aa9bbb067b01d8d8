"""K1 forward on Hopper: fused ConvTranspose(4x4, s2) + GroupNorm + LeakyReLU.

Replaces ``levelgan/kernels/upsample_block.py:_forward`` (its
``pl.pallas_call``), reached there from ``upsample_block_pallas`` /
``upsample_block_sm``.  CUDA source: ``levelgan_torch/csrc/upsample_block.cu``.

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

On a CPU tensor the wrapper runs the plain version
(``ops.blocks.upsample_block``); on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from levelgan_torch.kernels import build
from levelgan_torch.ops.blocks import upsample_block as upsample_block_plain

MAX_TASKS = 64        # 8 warps x 8 (parity, 16-row M tile) tasks
KC = 64               # input channels per smem chunk (csrc: lgt::KC)
EPS = 1e-5

launches = 0          # kernel launches since the last reset


def fits(h: int, w: int) -> bool:
    """Whether a stage with input H x W runs on K1 (else K1L)."""
    return h * w % 16 == 0 and 4 * h * w // 16 <= MAX_TASKS


def pack_taps(w: torch.Tensor) -> torch.Tensor:
    """HWIO [4, 4, Ci, Co] f32 -> [16, Co, Ci] bf16, tap = kh * 4 + kw."""
    kh, kw, ci, co = w.shape
    return w.permute(0, 1, 3, 2).reshape(kh * kw, co, ci).to(
        torch.bfloat16).contiguous()


def _lib():
    lib = build.load("upsample_block")
    fn = lib.upsample_block_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def upsample_block_fwd(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, *, slope: float = 0.2,
                       group_size: int = 16) -> torch.Tensor:
    """x [B, H, W, Ci] -> y [B, 2H, 2W, Co] in x's dtype (bf16 on the card).

    ``w`` HWIO [4, 4, Ci, Co] f32, ``gamma``/``beta`` [Co] f32.
    """
    if x.device.type == "cpu":
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
    with torch.cuda.device(x.device):
        err = _lib().upsample_block_fwd(
            build.ptr(x), build.ptr(wt), build.ptr(gamma), build.ptr(beta),
            build.ptr(y), b, h, ww, ci, co, gs, float(slope), EPS,
            build.stream_ptr(x.device))
    build.check(err, "upsample_block_fwd")
    global launches
    launches += 1
    return y
