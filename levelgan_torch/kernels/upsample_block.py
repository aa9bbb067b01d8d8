"""K1 on Hopper: fused ConvTranspose(4x4, s2) + GroupNorm + LeakyReLU,
forward and backward.

Replaces ``levelgan/kernels/upsample_block.py:_forward`` and ``_backward``
(their ``pl.pallas_call``s), reached there from ``upsample_block_pallas`` /
``upsample_block_sm`` through the ``jax.custom_vjp`` of ``_make_op``.
CUDA source: ``levelgan_torch/csrc/upsample_block.cu`` (+
``stage_common.cuh``).

Forward design.  The TPU kernel tiles the batch to fit VMEM and works in a
spatial-major layout for Mosaic's sake; neither reason holds on the card.
Here one thread block owns NS samples x 32 output channels (NG = 32 /
group_size GroupNorm groups) and every output position of those samples:
per parity a GEMM with M = NS*H*W <= 256, N = 32, K = 4 taps x Ci.  Each
warp keeps one (parity, 64 rows, 32 channels) tile as ``mma.sync``
accumulators, so the GroupNorm statistics are a reduction inside the block
(fixed order, no atomics: two calls give the same bits) and the normalise +
LeakyReLU epilogue runs before the one bf16 store; the pre-norm tile never
reaches device memory.  Activations stay batch-major NHWC, the port's public
layout.

What bounds it: the gumbel_64 stages are 68.7 GFLOP each at B = 1024
against tens to hundreds of MB, so the tensor cores bound it.  What held
the first version (one block per (sample, group)) was the staging: every
block re-staged its group's taps (4.3 GB of L2 -> shared traffic per call
for a 4 MB weight at the 4x4 stage), copies and products took turns, and
16x16 warp tiles read 512 bytes of fragments per ``mma``.  Now the staged
taps serve the block's NS samples, chunks of 32 input channels stream
through a ring of 2 or 3 buffers filled by ``cp.async`` (copies run under the
products), the weight is pre-packed so that one chunk of one block is one
contiguous run (``pack_taps_chunks``, cached per weight version), and the
64x32 warp tiles load their fragments with ``ldmatrix`` (192 bytes per
``mma``).  ``fwd_tile`` picks (NS, NG, stages) from the shape and the
budgets: 64 accumulator registers a thread, 232,448 bytes of shared memory
a block, and enough blocks for the card's SMs.

Dispatch rule (``fits``): K1 where one sample's (parity, 16-row) tiles fit a
block's 256 rows per parity, i.e. H*W <= 256.  Otherwise the stage goes to
K1L (``kernels.upsample_rows``).  At gumbel_64 that routes:

    up0  4x4   -> 8x8,   512 -> 256   K1   (16 samples a block at B = 1024)
    up1  8x8   -> 16x16, 256 -> 128   K1   (4 samples a block)
    up2  16x16 -> 32x32, 128 -> 64    K1   (1 sample a block, the limit)
    up3  32x32 -> 64x64,  64 -> 32    K1L

Backward (``upsample_block_bwd``, the function of ``_backward``): from the
residuals the forward saves with ``residuals=True`` (the bf16 pre-norm conv
output ``ypre`` and the per-(sample, channel) mean / rstd, as
``_forward(..., residuals=True)`` emits them) it computes LeakyReLU bwd ->
GroupNorm bwd -> the pre-norm cotangent ``dy``, dgamma / dbeta, and the
input gradient dx.  The dx contraction spans every output channel, across
GroupNorm groups, so the call is two launches (see the .cu): one block per
(sample, group) for the GroupNorm backward (the slab read once, 16 bytes a
load), then dx as a gather GEMM (M = B*H*W, N = Ci, K = 16*Co) whose M runs
over the batch, so that a 4x4 input still gives blocks of 8 warps
(``dx_tile``); the same launch sums dgamma / dbeta over the batch.  The
weight gradient stays a plain matmul over the 16 taps (``weight_grad``), as
the JAX package forms it in XLA outside Pallas.  At gumbel_64 training
(B = 64) the dx GEMM is 4.29 GFLOP per stage; that bounds up0, while the g,
ypre, dy and dx traffic bounds up1 (~16 MB) and up2 (~29 MB).

``UpsampleBlockFn`` ties forward and backward together as
``_make_op``'s custom VJP does.

On a CPU tensor the wrappers run the plain versions
(``ops.blocks.upsample_block``, ``upsample_block_fwd_plain``,
``upsample_block_bwd_plain``); on a CUDA tensor they launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from levelgan_torch import obs
from levelgan_torch.kernels import build
from levelgan_torch.ops.blocks import (conv_transpose_2x,
                                       conv_transpose_2x_input_grad,
                                       group_stats, leaky_relu, up)
from levelgan_torch.ops.blocks import upsample_block as upsample_block_plain

MAX_TASKS = 64        # (parity, 16-row tile)s of a sample: 256 rows a parity
KC = 32               # input channels per staged chunk (csrc: lgt::KC32)
NB = 32               # output channels per forward block (csrc: lgt::NB32)
KCB = 32              # cotangent channels per dx step (csrc: lgt::KC32)
NB_DX = 32            # dx input channels per block (csrc: lgt::NB32)
MROWS_DX = 128        # dx positions per block, at most (csrc: lgt::MROWS_DX)
FWD_MAX_ROWS = 256    # forward rows per parity per block (csrc: FWD_MAXM)
FWD_MAX_SAMPLES = 16  # forward samples per block (csrc: FWD_MAXS)
ROW_BYTES = 80        # a staged row: 32 bf16 + 8 of padding (csrc: lgt::ROWB)
FWD_TAIL = 2560       # the forward's reduction slots (csrc: FWD_TAIL)
MAX_STAGES = 3        # ring depth, at most (csrc: lgt::MAX_STAGES)
SMEM_MAX = 232448     # dynamic shared memory of a block on sm_90
SM_COUNT = 132        # H100 SXM
ACC_REGS = 64         # f32 accumulators a forward thread holds (64x32 / 32)
EPS = 1e-5
PARITIES = ((0, 0), (0, 1), (1, 0), (1, 1))

# the intervals between the forward's ``probe`` stamps (its first block)
FWD_PHASES = ("set-up", "main loop", "statistics", "stores")


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


def pack_taps_chunks(w: torch.Tensor) -> torch.Tensor:
    """HWIO [4, 4, Ci, Co] f32 -> [ceil(Co/32), Ci/32, 16, 32, 32] bf16 for
    the forward: ``out[nb, kc, kh*4 + kw, n, k] = w[kh, kw, kc*32 + k,
    nb*32 + n]``, zero for output channels beyond Co.  One (nb, kc) slice is
    what one block stages per chunk, contiguous and in its staged order
    (row = tap x channel, k contiguous)."""
    kh, kw, ci, co = w.shape
    cop = -(-co // NB) * NB
    wz = w.new_zeros((kh * kw, ci, cop))
    wz[:, :, :co] = w.reshape(kh * kw, ci, co)
    return wz.reshape(kh * kw, ci // KC, KC, cop // NB, NB).permute(
        3, 1, 0, 4, 2).to(torch.bfloat16).contiguous()


def pack_taps_dx(w: torch.Tensor) -> torch.Tensor:
    """HWIO [4, 4, Ci, Co] f32 -> [Ci/32, 4, Co/32, 4, 32, 32] bf16 for the dx
    GEMM: ``out[nb, 2a + b, kc, 2r + s, n, k] = w[a + 2r, b + 2s, nb*32 + n,
    kc*32 + k]``.  One (nb, parity, kc) slice is what one block stages per
    step (the parity's 4 taps, row = tap x input channel, k = cotangent
    channel contiguous); a block's steps follow each other in memory."""
    kh, kw, ci, co = w.shape
    # kh = a + 2r, kw = b + 2s  ->  [r, a, s, b, nb, n, kc, k]
    w8 = w.reshape(2, 2, 2, 2, ci // NB_DX, NB_DX, co // KCB, KCB)
    return w8.permute(4, 1, 3, 6, 0, 2, 5, 7).reshape(
        ci // NB_DX, 4, co // KCB, 4, NB_DX, KCB).to(
            torch.bfloat16).contiguous()


PACK_CACHE_MAX = 32
_pack_cache: dict = {}


def packed(w: torch.Tensor, pack) -> torch.Tensor:
    """``pack(w)``, kept per weight version: an export batch or the six
    generator passes of a training step pack a weight once, not per call.

    The key is the packing, the storage pointer, the shape and the strides
    (a transposed view of a weight is another weight); an entry holds while
    the tensor it was made from is alive at that pointer (so no other
    storage can have taken the address) and the version counter that
    ``w`` shares with it is unchanged: an in-place update (an optimizer
    step, ``copy_``) makes the next call pack anew.  Writes through
    ``.data`` bypass the counter, as they do for autograd.  Tensors made
    under ``torch.inference_mode`` carry no counter and are never kept:
    build a model outside it (as ``export.generate`` does) and only run it
    inside."""
    if w.is_inference():
        obs.count("k1.packs")
        return pack(w)
    key = (pack.__name__, w.data_ptr(), w.device, tuple(w.shape),
           tuple(w.stride()))
    hit = _pack_cache.get(key)
    if hit is not None:
        owner = hit[0]()
        if (owner is not None and owner.data_ptr() == key[1]
                and hit[1] == w._version):
            return hit[2]
    obs.count("k1.packs")
    with torch.no_grad():
        out = pack(w)
    for k in [k for k, v in _pack_cache.items() if v[0]() is None]:
        del _pack_cache[k]
    while len(_pack_cache) >= PACK_CACHE_MAX:
        del _pack_cache[next(iter(_pack_cache))]
    _pack_cache[key] = (weakref.ref(w), w._version, out)
    return out


def dx_fits(h: int, w: int, ci: int, co: int) -> bool:
    """The dx gather kernel's shape rule (K1 bwd's dx and K1L bwd)."""
    rt = min(h, MROWS_DX // w) if w <= MROWS_DX else 0
    return (rt > 0 and rt * w % 16 == 0 and h % rt == 0 and ci % NB_DX == 0
            and co % KCB == 0)


def fwd_smem(h: int, w: int, ns: int, stages: int) -> int:
    """Dynamic shared memory of one forward block (csrc:
    ``upsample_block_fwd_smem``): per stage the NS haloed samples, the zero
    rows behind them and the 16 taps x 32 channels of one chunk."""
    rows = ns * (h + 2) * (w + 2) + 2 * (w + 2) + 3 + 16 * NB
    return stages * rows * ROW_BYTES + FWD_TAIL


def ring_depth(smem_of, grid: int, steps: int, sms: int) -> int:
    """Buffers of a forward block's ring: 2, or 3 where the grid gives an SM
    at most one block for the whole call (nothing else hides that block's
    loads), the call has 3 chunks or more and 3 buffers fit a block's
    shared memory.  On an H100 the third buffer paid only there (the 4x4
    stage at B = 64); elsewhere it changed nothing or, where it cost a
    co-resident block, lost a third of the speed.  0 where even two
    buffers do not fit."""
    if smem_of(2) > SMEM_MAX:
        return 0
    return 3 if grid <= sms and steps >= 3 and smem_of(3) <= SMEM_MAX else 2


def fwd_tile(b: int, h: int, w: int, ci: int, co: int, gs: int,
             sms: int = SM_COUNT) -> tuple[int, int, int]:
    """(NS, NG, stages) of the forward at a stage shape: samples and
    GroupNorm groups per block and the depth of its ring.

    A block's N is 32 channels (NG = 32 / gs groups) and each warp holds a
    64x32 tile, 64 accumulator registers a thread, whatever NS.  NS is the
    largest power of two whose NS*H*W rows fit the block's 256 and fill its
    64-row warp tiles while the grid still has a block for three SMs in
    four; with fewer blocks than that at every NS, the smallest such NS.
    The ring's depth is ``ring_depth``'s."""
    hw = h * w
    if not fits(h, w) or gs not in (8, 16) or ci % KC or co % gs:
        raise ValueError(f"no K1 forward tile for H={h}, W={w}, ci={ci}, "
                         f"co={co}, group_size={gs}")
    cands = [ns for ns in (16, 8, 4, 2, 1) if ns * hw <= FWD_MAX_ROWS]
    full = [ns for ns in cands if ns * hw % 64 == 0] or cands
    n_blocks = -(-co // NB)
    ns = next((n for n in full if -(-b // n) * n_blocks >= 0.75 * sms),
              full[-1])
    stages = ring_depth(lambda s: fwd_smem(h, w, ns, s),
                        -(-b // ns) * n_blocks, ci // KC, sms)
    if not stages:
        raise ValueError(f"K1 forward tile at H={h}, W={w} needs "
                         f"{fwd_smem(h, w, ns, 2)} bytes of shared memory")
    return ns, NB // gs, stages


def dx_smem(w: int, nsd: int, rt: int) -> int:
    """Dynamic shared memory of one dx block (csrc: ``dx_gather_smem``):
    two buffers, each the haloed sample slots, the zero rows that dummy M
    rows read (only where the block has fewer than 128 positions) and the
    parity's 4 taps x 32 channels."""
    zero = 2 * (w + 2) + 3 if nsd * rt * w < MROWS_DX else 0
    rows = nsd * (rt + 2) * (w + 2) + zero + 4 * NB_DX
    return 2 * rows * ROW_BYTES


def dx_tile(b: int, h: int, w: int, ci: int, co: int,
            sms: int = SM_COUNT) -> tuple[int, int]:
    """(samples, rows) of a dx block: ``nsd`` whole samples where a sample
    has at most 128 positions (halved while the grid has fewer blocks than
    three quarters of the SMs), else ``rt`` = 128 / W rows of one sample."""
    if not dx_fits(h, w, ci, co):
        raise ValueError(f"no dx tile for H={h}, W={w}, ci={ci}, co={co}")
    n_blocks = ci // NB_DX
    if h * w <= MROWS_DX:
        nsd, rt = MROWS_DX // (h * w), h
        while nsd > 1 and -(-b // nsd) * n_blocks < 0.75 * sms:
            nsd //= 2
    else:
        nsd, rt = 1, MROWS_DX // w
    if dx_smem(w, nsd, rt) > SMEM_MAX:
        raise ValueError(f"dx tile at H={h}, W={w} needs "
                         f"{dx_smem(w, nsd, rt)} bytes of shared memory")
    return nsd, rt


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lib():
    lib = build.load("upsample_block")
    fn = lib.upsample_block_fwd
    if fn.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ptr] * 8 + [i32] * 8 + [f32] * 2 + [ptr] * 2
        fn.restype = i32
        gn = lib.upsample_block_bwd_gn
        gn.argtypes = [ptr] * 9 + [i32] * 5 + [f32, ptr]
        gn.restype = i32
        dx = lib.upsample_block_bwd_dx
        dx.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
        dx.restype = i32
        smem = lib.upsample_block_fwd_smem
        smem.argtypes = [i32] * 4
        smem.restype = ctypes.c_size_t
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
                       group_size: int = 16, residuals: bool = False,
                       probe: torch.Tensor | None = None):
    """x [B, H, W, Ci] -> y [B, 2H, 2W, Co] in x's dtype (bf16 on the card).

    ``w`` HWIO [4, 4, Ci, Co] f32, ``gamma``/``beta`` [Co] f32.  With
    ``residuals`` returns ``(y, ypre, mu, rstd)``: the pre-norm conv output
    in x's dtype and the per-(sample, channel) GroupNorm mean and rstd
    [B, Co] f32 that ``upsample_block_bwd`` consumes.  ``probe``, an int64
    CUDA tensor of at least ``len(FWD_PHASES) + 1`` elements, receives the
    time stamps (ns) that bound the first block's phases.
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
    if probe is not None and (
            probe.dtype != torch.int64 or probe.device != x.device
            or not probe.is_contiguous()
            or probe.numel() < len(FWD_PHASES) + 1):
        raise ValueError(f"K1 probe must be a contiguous int64 tensor of at "
                         f"least {len(FWD_PHASES) + 1} elements on {x.device}")
    ns, _, stages = fwd_tile(b, h, ww, ci, co, gs, _sms(x.device))
    wpk = packed(w, pack_taps_chunks)
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
            build.ptr(x), build.ptr(wpk), build.ptr(gamma), build.ptr(beta),
            build.ptr(y), build.ptr(ypre) if residuals else none,
            build.ptr(mu) if residuals else none,
            build.ptr(rstd) if residuals else none,
            b, h, ww, ci, co, gs, ns, stages, float(slope), EPS,
            none if probe is None else build.ptr(probe),
            build.stream_ptr(x.device))
    build.check(err, "upsample_block_fwd")
    obs.count("k1.fwd_launches")
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
    if (gs not in (8, 16) or co % gs or not fits(h, ww)
            or not dx_fits(h, ww, ci, co)):
        raise ValueError(
            f"K1 bwd shape rule violated: ci={ci} (multiple of {NB_DX}), "
            f"co={co} (multiple of {KCB} and of group_size={gs} in 8, 16), "
            f"H={h}, W={ww} (K1's H*W <= {4 * MAX_TASKS}, dx tiling rule)")
    mu, rstd = mu.contiguous(), rstd.contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    dy, s1, s2 = bwd_gn_pass(g, ypre, mu, rstd, gamma, beta, slope, gs)
    dx, dgamma, dbeta = bwd_dx_pass(dy, w, s1, s2)
    obs.count("k1.bwd_launches")
    return dx, dy, dgamma, dbeta


def bwd_gn_pass(g, ypre, mu, rstd, gamma, beta, slope, gs):
    """K1 bwd's first launch on checked CUDA operands: (dy, s1, s2), the
    pre-norm cotangent and the per-(sample, channel) sums of dout and
    dout * xn [B, Co] f32."""
    b, h2, w2, co = g.shape
    dy = torch.empty_like(ypre)
    s1 = torch.empty((b, co), dtype=torch.float32, device=g.device)
    s2 = torch.empty_like(s1)
    with torch.cuda.device(g.device):
        err = _lib().upsample_block_bwd_gn(
            build.ptr(g), build.ptr(ypre), build.ptr(mu), build.ptr(rstd),
            build.ptr(gamma), build.ptr(beta), build.ptr(dy), build.ptr(s1),
            build.ptr(s2), b, h2 // 2, w2 // 2, co, gs, float(slope),
            build.stream_ptr(g.device))
    build.check(err, "upsample_block_bwd_gn")
    return dy, s1, s2


def bwd_dx_pass(dy, w, s1, s2):
    """K1 bwd's second launch on checked CUDA operands: (dx, dgamma, dbeta)
    from the cotangent, the weight and the first launch's sums."""
    b, h2, w2, co = dy.shape
    h, ww, ci = h2 // 2, w2 // 2, w.shape[2]
    nsd, rt = dx_tile(b, h, ww, ci, co, _sms(dy.device))
    wpk = packed(w, pack_taps_dx)
    dgamma = torch.empty((co,), dtype=torch.float32, device=dy.device)
    dbeta = torch.empty_like(dgamma)
    dx = torch.empty((b, h, ww, ci), dtype=torch.bfloat16, device=dy.device)
    with torch.cuda.device(dy.device):
        err = _lib().upsample_block_bwd_dx(
            build.ptr(dy), build.ptr(wpk), build.ptr(s1), build.ptr(s2),
            build.ptr(dgamma), build.ptr(dbeta), build.ptr(dx), b, h, ww, ci,
            co, nsd, rt, build.stream_ptr(dy.device))
    build.check(err, "upsample_block_bwd_dx")
    return dx, dgamma, dbeta


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
