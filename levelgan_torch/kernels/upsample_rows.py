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

Backward (``upsample_rows_bwd``, one launch in ``UpsampleRowsFn``, the
custom VJP of ``_make_rows_op``): replaces ``_conv_bwd`` together with the
XLA pass before it (the LeakyReLU + GroupNorm backward in folded layout).
The H / rt blocks of one sample form a cluster (``bwd_tile``: rt folded rows
a block, 8 blocks of 4 rows at gumbel_64 up3), persistent over samples
(``max_bwd_clusters``).  A block bulk-copies its rows of the output
cotangent g and of the residual yf and the sample's mean / rstd, sums
dout and dout * xn per channel in a fixed order (a thread's words, lanes,
warps) and pushes its partials to every rank (``st.async`` into
distributed shared memory, counted on an mbarrier); each rank adds them in
rank order and forms the group means.  It writes dyf in bf16 to a haloed
tile in shared memory, pushes its first and last rows into the
neighbours' halo rows, copies dyf to device memory (``weight_grad_folded``
reads it for dw, with torch matmuls), waits for its own halo rows and runs
the dx GEMM from the tile (each parity its own 4 taps, ``mma.sync`` +
``ldmatrix``; the weight packed by ``pack_taps_dx`` once per version,
resident where it fits, else streamed through a ring).  Each cluster sums
its samples' s1 / s2 into ``part``, and one ``.sum(0)`` adds the
clusters' into dbeta / dgamma.  Every sum runs in a fixed order and
nothing is atomic, so two calls give the same bits.  At gumbel_64 up3
(B = 64) g and yf in and dyf and dx out are 58.7 MB (17.5 us at
3.35 TB/s) against 4.29 GFLOP (4.3 us): the bytes bound it.  ``probe``
times the first block's phases (``BWD_PHASES``).  That kernel holds a
block's g and yf rows and the dyf tile of all 4Co channels, one warp per
dx tile (``bwd_tile``); where those do not fit (Ci = 128 at a 32 x 32
input, Co = 96 or beyond 256, ...) ``bwd_plan`` picks the general kernel,
which takes every shape the stage kernel takes (``bwd_general_tile``): it
reads g and yf from device memory, works through the cotangent channels
32 at a time, computes its tile's halo rows itself, exchanges the partial
sums through device memory behind one cluster barrier a sample, and
gives each warp up to two dx tiles.

On a CPU tensor the wrappers run the plain versions
(``upsample_block_rows_plain``: ``conv_rows_plain``, ``rows_stats``,
``normalize``; ``upsample_rows_bwd_plain``: ``gn_act_bwd_folded``, then
``conv_rows_bwd_plain``); on a CUDA tensor they launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from levelgan_torch import obs
from levelgan_torch.kernels import build
from levelgan_torch.kernels.upsample_block import (ROW_BYTES, SMEM_MAX,
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
BWD_MAX_WARPS = 8     # warps of a backward block, at most (csrc: BWD_MAXW)
BWD_MAX_RING = 3      # a streaming weight ring's slots, at most
GEN_PITCH = 4 * KC * 2 + 16   # a general tile position's bytes (csrc)
GEN_MAX_TILES = 2     # dx warp tiles a general warp holds (csrc: GEN_MAXT)
# what the backward's ``probe`` sums, per phase over its first block's samples
BWD_PHASES = ("set-up", "rows wait", "pass 1", "partials push",
              "partials wait", "sums", "pass 2", "halo push", "dyf out",
              "halo wait", "dx GEMM", "dx stores", "exit")
EPS = 1e-5
SHIFTS = tuple((u, v) for u in (0, 1, 2) for v in (0, 1, 2))


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
        bwd.argtypes = [ptr] * 12 + [i32] * 10 + [f32, ptr]
        bwd.restype = i32
        occ = lib.upsample_rows_bwd_max_clusters
        occ.argtypes = [i32] * 7 + [ctypes.POINTER(ctypes.c_int)]
        occ.restype = i32
        smem = lib.upsample_rows_bwd_smem
        smem.argtypes = [i32] * 5
        smem.restype = ctypes.c_size_t
        smem = lib.upsample_rows_bwd_general_smem
        smem.argtypes = [i32] * 4
        smem.restype = ctypes.c_size_t
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
    GroupNorm mean and rstd [B, Co] f32 that the backward reads.
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
    obs.count("k1l.fwd_launches")
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


def upsample_rows_bwd_plain(g, yf, mu, rstd, gamma, beta, w, *,
                            slope: float = 0.2, group_size: int = 16):
    """The backward kernel's function in plain PyTorch:
    ``gn_act_bwd_folded``, then ``conv_rows_bwd_plain`` on its dyf:
    (dx, dyf, dgamma, dbeta)."""
    dyf, dgamma, dbeta = gn_act_bwd_folded(g, yf, mu, rstd, gamma, beta,
                                           slope=slope, group_size=group_size)
    return conv_rows_bwd_plain(dyf, w), dyf, dgamma, dbeta


def bwd_warps(w: int, rt: int, ci: int) -> int:
    """Warps of a backward block: one 32 positions x 32 input channels dx
    tile each (csrc: ``bwd_warps``)."""
    return (rt * w // 32) * (ci // 32)


def bwd_smem(w: int, rt: int, ci: int, co: int, slots: int) -> int:
    """Dynamic shared memory of one staged backward block (csrc:
    ``bwd_layout``):
    the block's g rows and yf rows (8 rt W Co bytes each), the dyf tile of
    (rt + 2) x (W + 2) positions of 4Co bf16 + 16 bytes, ``slots`` weight
    steps of 4 taps x Ci rows, the sums (every rank's partials of two
    samples), the sample's mean / rstd and group means, and four
    mbarriers."""
    m = rt * w
    return (16 * m * co + (rt + 2) * (w + 2) * (8 * co + 16)
            + slots * 4 * ci * ROW_BYTES
            + (2 * bwd_warps(w, rt, ci) + 4 * MAX_CLUSTER + 4) * co * 4 + 32)


def bwd_tile(h: int, w: int, ci: int, co: int,
             group_size: int) -> tuple[int, int]:
    """(rt, weight slots) of the staged backward kernel at an input shape.

    A block takes rt folded rows (rt * W positions, a multiple of 32 and at
    most 128) with one warp per 32 positions x 32 input channels (at most
    8 warps, and a multiple of Co threads: a thread keeps one 8-channel
    chunk of one parity in the per-element passes, and one channel's sums),
    so a cluster has H / rt blocks, at most 8; the largest rt whose block
    fits the shared memory wins.  The weight's 4 Co / 32 steps stay
    resident where they fit beside the rest (slots = steps), else they
    stream through a ring of 3 or 2 slots."""
    gs = _group_shape(co, group_size)[1]
    if (w < 16 or MROWS % w or ci % KC or co < NC or co > 8 * NC
            or co & (co - 1) or NC % gs):
        raise ValueError(
            f"K1L bwd shape rule violated: W={w} (divides {MROWS}, >= 16), "
            f"ci={ci} (multiple of {KC}), co={co} (a power of two, "
            f"{NC}..{8 * NC}), group size {gs} (divides {NC})")
    steps = 4 * co // KC
    for rt in range(min(h, MROWS // w), 0, -1):
        nw = bwd_warps(w, rt, ci)
        if (h % rt or h // rt > MAX_CLUSTER or rt * w % 32
                or nw > BWD_MAX_WARPS or 32 * nw % co):
            continue
        for slots in (steps, *range(min(BWD_MAX_RING, steps - 1), 1, -1)):
            if bwd_smem(w, rt, ci, co, slots) <= SMEM_MAX:
                return rt, slots
    raise ValueError(
        f"K1L bwd at H={h}, W={w}, ci={ci}, co={co}: no row tile rt (H % rt "
        f"== 0, H / rt <= {MAX_CLUSTER}, rt * W a multiple of 32, at most "
        f"{BWD_MAX_WARPS} warps, 32 * warps a multiple of Co) whose block "
        f"fits {SMEM_MAX} bytes of shared memory")


def bwd_general_smem(w: int, ci: int, slots: int) -> int:
    """Dynamic shared memory of one general backward block (csrc:
    ``gen_layout``): the dyf tile of one 32-channel chunk, (rt + 2) x
    (W + 2) positions of 4 x 32 bf16 + 16 bytes with rt = 128 / W,
    ``slots`` weight steps of 4 taps x Ci rows, the warps' partials of one
    chunk and its group means.  Nothing grows with Co."""
    rt = MROWS // w
    return ((rt + 2) * (w + 2) * GEN_PITCH + slots * 4 * ci * ROW_BYTES
            + (BWD_MAX_WARPS * 2 + 2) * KC * 4)


def bwd_general_tile(h: int, w: int, ci: int, co: int,
                     group_size: int) -> tuple[int, int]:
    """(rt, weight slots) of the general backward kernel: rt = 128 / W as
    in the stage kernel (clusters of H / rt <= 8 blocks), 8 warps holding
    the (128 / 32) x (Ci / 32) dx tiles, at most two each (Ci <= 128); the
    weight resident where its steps fit, else a ring of 3 or 2 slots.  It
    takes every shape ``stage_tile`` takes."""
    gs = _group_shape(co, group_size)[1]
    rt = MROWS // w if w and MROWS % w == 0 else 0
    tiles = MROWS // 32 * (ci // KC)
    if (w < 16 or not rt or h % rt or h // rt > MAX_CLUSTER or ci % KC
            or co % NC or NC % gs
            or tiles > BWD_MAX_WARPS * GEN_MAX_TILES):
        raise ValueError(
            f"K1L bwd shape rule violated: W={w} (divides {MROWS}, >= 16), "
            f"H={h} (a multiple of 128 / W = {rt or '-'}, at most "
            f"{MAX_CLUSTER} times it), ci={ci} (multiple of {KC}, at most "
            f"{BWD_MAX_WARPS * GEN_MAX_TILES * KC // (MROWS // 32)}), "
            f"co={co} (multiple of {NC}), group size {gs} (divides {NC})")
    steps = 4 * co // KC
    for slots in (steps, *range(min(BWD_MAX_RING, steps - 1), 1, -1)):
        if bwd_general_smem(w, ci, slots) <= SMEM_MAX:
            return rt, slots
    raise ValueError(f"K1L bwd at W={w}, ci={ci} needs "
                     f"{bwd_general_smem(w, ci, 2)} bytes of shared memory "
                     f"(at most {SMEM_MAX})")


def bwd_plan(h: int, w: int, ci: int, co: int,
             group_size: int) -> tuple[bool, int, int]:
    """(general, rt, slots): the staged kernel's tile where ``bwd_tile``
    takes the shape, else the general kernel's (``bwd_general_tile``)."""
    try:
        return (False, *bwd_tile(h, w, ci, co, group_size))
    except ValueError:
        return (True, *bwd_general_tile(h, w, ci, co, group_size))


def max_bwd_clusters(device, h: int, w: int, rt: int, ci: int, co: int,
                     slots: int, general: bool = False) -> int:
    """How many backward clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``), asked once per shape."""
    key = ("bwd", device, h, w, rt, ci, co, slots, general)
    if key not in _occupancy:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _lib().upsample_rows_bwd_max_clusters(
                h, w, rt, ci, co, slots, int(general), ctypes.byref(out))
        build.check(err, "upsample_rows_bwd_max_clusters")
        if out.value < 1:
            smem = (bwd_general_smem(w, ci, slots) if general
                    else bwd_smem(w, rt, ci, co, slots))
            raise RuntimeError(
                f"K1L bwd: no cluster of {h // rt} blocks with {smem} bytes "
                "of shared memory each fits the card")
        _occupancy[key] = out.value
    return _occupancy[key]


def upsample_rows_bwd(g: torch.Tensor, yf: torch.Tensor, mu: torch.Tensor,
                      rstd: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, w: torch.Tensor, *,
                      slope: float = 0.2, group_size: int = 16,
                      probe: torch.Tensor | None = None):
    """K1L bwd: the output cotangent g [B, 2H, 2W, Co] and the forward's
    residuals (yf [B, H, W, 4Co] bf16, mu / rstd [B, Co] f32, each starting
    on 16 bytes) -> (dx [B, H, W, Ci],
    dyf [B, H, W, 4Co], dgamma [Co], dbeta [Co]); dx and dyf in yf's dtype
    (bf16 on the card), dgamma / dbeta f32.  A g that is not contiguous is
    copied first.  The staged kernel runs where ``bwd_tile`` takes the
    shape, else the general one (``bwd_plan``).  ``probe``, a zeroed int64
    tensor of len(BWD_PHASES) on the card, gets the nanoseconds the staged
    kernel's first block spent in each phase."""
    if g.device.type == "cpu":
        return upsample_rows_bwd_plain(g, yf, mu, rstd, gamma, beta, w,
                                       slope=slope, group_size=group_size)
    if g.device.type != "cuda":
        raise ValueError(f"K1L bwd runs on CUDA tensors, got {g.device}")
    b, h, ww, c4 = yf.shape
    co, ci = c4 // 4, w.shape[2]
    dev = g.device
    if (yf.dtype != torch.bfloat16 or not yf.is_contiguous()
            or yf.device != dev or c4 % 4 or b < 1 or yf.data_ptr() % 16):
        raise ValueError("K1L bwd takes a contiguous bf16 yf [B >= 1, H, W, "
                         "4Co] on g's device")
    if g.dtype != torch.bfloat16 or tuple(g.shape) != (b, 2 * h, 2 * ww, co):
        raise ValueError(f"K1L bwd takes a bf16 g {(b, 2 * h, 2 * ww, co)}, "
                         f"got {g.dtype} {tuple(g.shape)}")
    for name, t, shape in (("mu", mu, (b, co)), ("rstd", rstd, (b, co)),
                           ("gamma", gamma, (co,)), ("beta", beta, (co,)),
                           ("w", w, (4, 4, ci, co))):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"K1L bwd {name} must be f32 {shape} on {dev}")
    if probe is not None and (
            probe.dtype != torch.int64 or probe.device != dev
            or not probe.is_contiguous() or probe.numel() < len(BWD_PHASES)):
        raise ValueError(f"K1L bwd probe must be a contiguous int64 tensor of "
                         f"at least {len(BWD_PHASES)} on {dev}")
    general, rt, slots = bwd_plan(h, ww, ci, co, group_size)
    if probe is not None and general:
        raise ValueError("K1L bwd: the probe times the staged kernel only")
    ncl = min(b, max_bwd_clusters(dev, h, ww, rt, ci, co, slots, general))
    g, mu, rstd = g.contiguous(), mu.contiguous(), rstd.contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    if g.data_ptr() % 16 or mu.data_ptr() % 16 or rstd.data_ptr() % 16:
        raise ValueError("K1L bwd copies g, mu and rstd in bulk: they must "
                         "start on 16 bytes")
    wpk = packed(w, pack_taps_dx)
    dx = torch.empty((b, h, ww, ci), dtype=torch.bfloat16, device=dev)
    dyf = torch.empty_like(yf)
    part = torch.empty((ncl, 2, co), dtype=torch.float32, device=dev)
    none = ctypes.c_void_p(None)
    xch = (torch.empty((ncl, 2, h // rt, 2, co), dtype=torch.float32,
                       device=dev) if general else None)
    with torch.cuda.device(dev):
        err = _lib().upsample_rows_bwd(
            build.ptr(g), build.ptr(yf), build.ptr(mu), build.ptr(rstd),
            build.ptr(gamma), build.ptr(beta), build.ptr(wpk), build.ptr(dx),
            build.ptr(dyf), build.ptr(part),
            build.ptr(xch) if general else none,
            none if probe is None else build.ptr(probe), b, h, ww, ci, co,
            _group_shape(co, group_size)[1], rt, slots, int(general), ncl,
            float(slope), build.stream_ptr(dev))
    build.check(err, "upsample_rows_bwd")
    obs.count("k1l.bwd_launches")
    # each cluster's sums over its samples, added over the clusters
    dgb = part.sum(0)
    return dx, dyf, dgb[1], dgb[0]


class UpsampleRowsFn(torch.autograd.Function):
    """The whole K1L stage as one differentiable op (``_make_rows_op``'s
    custom VJP): the stage kernel with residuals forward; the K1L bwd
    kernel for dx, dyf, dgamma and dbeta, then ``weight_grad_folded`` for
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
        dx, dyf, dgamma, dbeta = upsample_rows_bwd(
            g, yf, mu, rstd, gamma, beta, w, slope=ctx.slope,
            group_size=ctx.group_size)
        return (dx.to(x.dtype), weight_grad_folded(x, dyf).to(w.dtype),
                dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None, None)
