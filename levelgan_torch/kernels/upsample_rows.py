"""K1L on Hopper: the late upsample stage (ConvTranspose 4x4 / s2, GroupNorm,
LeakyReLU) in one cluster kernel, and its backward.

Replaces ``levelgan/kernels/upsample_rows.py:_conv_fwd`` and ``_conv_bwd``
(their ``pl.pallas_call``s), reached there from ``upsample_block_rows_sm``
through the ``jax.custom_vjp`` of ``_make_rows_op``, together with the XLA
pass that follows ``_conv_fwd`` in ``_forward_rows`` (GroupNorm from the
kernel's sums, affine, LeakyReLU, unfold).  CUDA source:
``levelgan_torch/csrc/upsample_rows.cu`` (+ ``stage_common.cuh``).

Forward (``upsample_block_rows``, one launch of ``upsample_rows_stage``).
A block owns 128 / W input rows of one sample and 32 output channels for
all four parities, each warp a (parity, 64 rows, 32 channels) tile of
``mma.sync`` accumulators with ``ldmatrix`` fragments; the TPU kernel's
packed 9-shift weights (structured zeros that bought MXU lanes) are not
carried over: each parity multiplies only its own 4 taps.  The H / rt
blocks of one (sample, channel block) form a thread-block cluster (8 at
gumbel_64 up3): each publishes its partial channel sums, reduced in a fixed
order, in shared memory; after a cluster barrier every block reads all
ranks' partials through distributed shared memory in rank order, forms the
GroupNorm mean and rstd from E[y^2] - E[y]^2 in f32 (as ``rows_stats``
does), normalises the accumulators in registers and stores the unfolded
bf16 tile once, 16 bytes a lane.  No atomics and no zeroed buffers: two
calls give the same bits.  The clusters are persistent (as many as the
card holds at once, ``stage_grid``), walk over samples, stage their taps
once per call and prefetch the next sample's rows with ``cp.async`` under
the current sample's epilogue.  ``stage_tile`` gives the cluster size and
the ring depth; the weight is packed by chunks once per weight version
(``packed``).  In training (``residuals=True``) the kernel also stores the
folded pre-norm conv output ``yf`` [B, H, W, 4Co] bf16 and the
per-(sample, channel) mean / rstd that the backward reads.  What bounds it
at gumbel_64 up3 (B = 1024): 134 MB of x in and 268 MB of y out (0.120 ms
at 3.35 TB/s) against 68.7 GFLOP (0.069 ms): the bytes.

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

On a CPU tensor the wrappers run the plain versions
(``upsample_block_rows_plain``: ``conv_rows_plain``, ``rows_stats``,
``normalize``; ``conv_rows_bwd_plain``); on a CUDA tensor they launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from levelgan_torch.kernels import build
from levelgan_torch.kernels.upsample_block import (KCB, NB_DX, ROW_BYTES,
                                                   SMEM_MAX, dx_fits, dx_tile,
                                                   pack_taps_chunks,
                                                   pack_taps_dx, packed)
from levelgan_torch.ops.blocks import (conv_transpose_2x,
                                       conv_transpose_2x_input_grad,
                                       leaky_relu, up)

KC = 32               # input channels per staged chunk (csrc: lgt::KC32)
NC = 32               # output channels per block (csrc: lgt::NB32)
MROWS = 128           # positions per parity per block (rows x W)
MAX_CLUSTER = 8       # blocks of a cluster, at most (the portable size)
MAX_STAGES = 3        # input chunks in flight, at most
TAP_ROWS = 16 * NC    # staged rows of one chunk of taps (csrc: TAP_ROWS)
YS_BYTES = 4 * MROWS * NC * 2     # a block's bf16 output tile (csrc)
SUMS_BYTES = (8 * 2 + 4 + 2) * NC * 4   # the sums of a block (csrc: TAIL)
EPS = 1e-5
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
    fn = lib.upsample_rows_stage
    if fn.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ptr] * 8 + [i32] * 8 + [f32] * 2 + [ptr]
        fn.restype = i32
        occ = lib.upsample_rows_stage_max_clusters
        occ.argtypes = [i32] * 4 + [ctypes.POINTER(ctypes.c_int)]
        occ.restype = i32
        smem = lib.upsample_rows_stage_smem
        smem.argtypes = [i32] * 3
        smem.restype = ctypes.c_size_t
        bwd = lib.upsample_rows_bwd
        bwd.argtypes = [ptr] * 3 + [i32] * 7 + [ptr]
        bwd.restype = i32
    return lib


def stage_smem(w: int, ci: int, stages: int) -> int:
    """Dynamic shared memory of one stage block (csrc:
    ``upsample_rows_stage_smem``): the 16 taps x 32 channels x Ci, staged
    once; ``stages`` haloed chunks of the block's input rows; the bf16
    output tile; the sums."""
    rt = MROWS // w
    return (ci // KC * TAP_ROWS * ROW_BYTES
            + stages * (rt + 2) * (w + 2) * ROW_BYTES + YS_BYTES + SUMS_BYTES)


def stage_tile(h: int, w: int, ci: int, co: int,
               group_size: int) -> tuple[int, int]:
    """(cluster size, ring depth) of the stage kernel at an input shape.

    A block takes rt = 128 / W rows of a sample, so a cluster has H / rt
    blocks, at most 8 (the portable cluster size).  The ring holds up to
    one sample's chunks plus one, at most 3, as far as shared memory
    allows beside the resident taps."""
    gs = _group_shape(co, group_size)[1]
    rt = MROWS // w if w and MROWS % w == 0 else 0
    if (w < 16 or not rt or h % rt or h // rt > MAX_CLUSTER or ci % KC
            or co % NC or NC % gs):
        raise ValueError(
            f"K1L shape rule violated: W={w} (divides {MROWS}, >= 16), H={h} "
            f"(a multiple of 128 / W = {rt or '-'}, at most {MAX_CLUSTER} "
            f"times it: one cluster of H / rt blocks per sample), ci={ci} "
            f"(multiple of {KC}), co={co} (multiple of {NC}), group size "
            f"{gs} (divides {NC})")
    for stages in range(min(MAX_STAGES, ci // KC + 1), 1, -1):
        if stage_smem(w, ci, stages) <= SMEM_MAX:
            return h // rt, stages
    raise ValueError(f"K1L at W={w}, ci={ci} needs {stage_smem(w, ci, 2)} "
                     f"bytes of shared memory (at most {SMEM_MAX}): the taps "
                     "of all input channels stay resident")


def stage_grid(b: int, co: int, max_clusters: int) -> int:
    """Clusters of the persistent grid: as many as the card holds at once
    (``max_clusters``), a multiple of the Co / 32 channel blocks (a cluster
    keeps one channel block's taps), and no more than the samples."""
    ncb = co // NC
    per = max_clusters // ncb
    if per < 1:
        raise ValueError(f"K1L: the card holds {max_clusters} clusters at "
                         f"once, fewer than the {ncb} channel blocks")
    return ncb * min(b, per)


_occupancy: dict = {}


def max_clusters(device, csize: int, w: int, ci: int, stages: int) -> int:
    """How many stage clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``), asked once per shape."""
    key = (device, csize, w, ci, stages)
    if key not in _occupancy:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _lib().upsample_rows_stage_max_clusters(
                csize, w, ci, stages, ctypes.byref(out))
        build.check(err, "upsample_rows_stage_max_clusters")
        if out.value < 1:
            raise RuntimeError(
                f"K1L: no cluster of {csize} blocks with "
                f"{stage_smem(w, ci, stages)} bytes of shared memory each "
                "fits the card")
        _occupancy[key] = out.value
    return _occupancy[key]


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


def upsample_block_rows_plain(x, w, gamma, beta, *, slope: float = 0.2,
                              group_size: int = 16,
                              residuals: bool = False):
    """The stage in plain PyTorch: the conv (``conv_rows_plain``), the
    GroupNorm statistics from its sums (``rows_stats``), then
    ``normalize``; with ``residuals`` also (yf, mu, rstd)."""
    yf, s1, s2 = conv_rows_plain(x, w)
    mu, rstd = rows_stats(s1, s2, 4 * yf.shape[1] * yf.shape[2],
                          group_size=group_size, eps=EPS)
    y = normalize(yf, mu, rstd, gamma, beta, slope=slope)
    return (y, yf, mu, rstd) if residuals else y


def upsample_block_rows(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, *, slope: float = 0.2,
                        group_size: int = 16, residuals: bool = False):
    """The whole K1L stage: x [B, H, W, Ci] -> y [B, 2H, 2W, Co] in x's
    dtype (bf16 on the card).

    ``w`` HWIO [4, 4, Ci, Co] f32, ``gamma``/``beta`` [Co] f32.  With
    ``residuals`` returns ``(y, yf, mu, rstd)``: the folded pre-norm conv
    output [B, H, W, 4Co] in x's dtype and the per-(sample, channel)
    GroupNorm mean and rstd [B, Co] f32 that ``gn_act_bwd_folded`` reads.
    """
    if x.device.type == "cpu":
        return upsample_block_rows_plain(x, w, gamma, beta, slope=slope,
                                         group_size=group_size,
                                         residuals=residuals)
    if x.device.type != "cuda":
        raise ValueError(f"K1L runs on CUDA tensors, got {x.device}")
    b, h, ww, ci = x.shape
    co = w.shape[-1]
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("K1L takes a contiguous bf16 x")
    for name, t, shape in (("w", w, (4, 4, ci, co)), ("gamma", gamma, (co,)),
                           ("beta", beta, (co,))):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"K1L {name} must be f32 {shape} on {x.device}")
    csize, stages = stage_tile(h, ww, ci, co, group_size)
    ncl = stage_grid(b, co, max_clusters(x.device, csize, ww, ci, stages))
    gs = _group_shape(co, group_size)[1]
    wpk = packed(w, pack_taps_chunks)
    gamma, beta = gamma.contiguous(), beta.contiguous()
    y = torch.empty((b, 2 * h, 2 * ww, co), dtype=torch.bfloat16,
                    device=x.device)
    none = ctypes.c_void_p(None)
    yf = mu = rstd = None
    if residuals:
        yf = torch.empty((b, h, ww, 4 * co), dtype=torch.bfloat16,
                         device=x.device)
        mu = torch.empty((b, co), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mu)
    with torch.cuda.device(x.device):
        err = _lib().upsample_rows_stage(
            build.ptr(x), build.ptr(wpk), build.ptr(gamma), build.ptr(beta),
            build.ptr(y), build.ptr(yf) if residuals else none,
            build.ptr(mu) if residuals else none,
            build.ptr(rstd) if residuals else none, b, h, ww, ci, co, gs,
            stages, ncl, float(slope), EPS, build.stream_ptr(x.device))
    build.check(err, "upsample_rows_stage")
    global launches
    launches += 1
    return (y, yf, mu, rstd) if residuals else y


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
    custom VJP): the stage kernel with residuals forward; folded GN/act
    backward, the K1L bwd kernel for dx and ``weight_grad_folded`` for
    dw."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, slope, group_size):
        y, yf, mu, rstd = upsample_block_rows(
            x, w, gamma, beta, slope=slope, group_size=group_size,
            residuals=True)
        ctx.save_for_backward(x, w, gamma, beta, yf, mu, rstd)
        ctx.slope, ctx.group_size = slope, group_size
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, gamma, beta, yf, mu, rstd = ctx.saved_tensors
        dyf, dgamma, dbeta = gn_act_bwd_folded(
            g, yf, mu, rstd, gamma, beta, slope=ctx.slope,
            group_size=ctx.group_size)
        dx = upsample_rows_bwd(dyf, w)
        return (dx.to(x.dtype), weight_grad_folded(x, dyf).to(w.dtype),
                dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None, None)
