"""K2 fused on Hopper: the critic trunk's forward and its exact input
gradient in one kernel, and the WGAN-GP penalty built on it.

Replaces ``levelgan/kernels/critic_grad.py:_make_fused.run`` (its
``pl.pallas_call``, body ``_kernel``), reached there from
``make_critic_input_grad`` and ``make_gradient_penalty``.  CUDA source:
``levelgan_torch/csrc/critic_grad.cu``.

What the kernel computes.  From the critic's layer-0 activation
``a0 = leaky_relu(conv0(x_hat (+) cond) + b0)`` it returns ``dy0``, the
gradient of ``sum_b D(x_hat)_b`` at layer 0's pre-activation:

1. forward, for each trunk layer 1..L-1: 4x4 / stride-2 SAME conv with f32
   accumulation, rounded to the compute dtype, bias added in that dtype,
   GroupNorm with f32 statistics (``var = E[y^2] - mean^2``, eps 1e-5; skipped
   with ``model.norm='none'``), LeakyReLU, rounded to the compute dtype;
2. the head's gradient: ``d(sum_b score_b)/d(a_last)`` is the head's weights
   ``[4, 4, Cl]`` for every sample;
3. reverse, for each trunk layer from the last: LeakyReLU backward from the
   sign of the saved GroupNorm output, GroupNorm backward in f32, then the
   conv's input gradient (the cotangent rounded to the compute dtype before
   the products, the result after them);
4. layer 0's LeakyReLU backward from the sign of ``a0``.

Layer 0's conv, its transpose and the condition embedding stay PyTorch
(cuDNN), as they stay XLA in the JAX package: ``critic_input_grad_fwd``.
``CriticInputGrad`` is the differentiable op (``grad_fn``'s custom VJP): its
backward, the WGAN-GP double backward, is the gradient of
``<ct, grad_x sum_b D(x)_b>`` on the plain ``Critic``, taken
reverse-over-reverse (the JAX package takes ``jax.grad`` of ``jax.jvp``; the
Hessian is symmetric, so the two are one function).
``gradient_penalty_fused`` is the penalty: interpolate, ``CriticInputGrad``,
then the K2 core (``NormPenalty``).

Design.  The TPU kernel tiles the batch and works spatial-major; on the card
a cluster of two blocks owns one sample, split by output channels (CS), since
the GroupNorm statistics and the whole chain are per sample and a group
never straddles the halves: every reduction is local to a block and runs in
a fixed order (no atomics), and each layer's new grid is exchanged through
distributed shared memory.  The sample's activations, y and cotangents stay
in shared memory; the weights come through ``pack_weights`` (one launch per
call: the critic's weights change after every training step, so nothing is
cached) as one bf16 stream per block, copied in 32 KB chunks by
``cp.async.bulk`` into an mbarrier ring while the tensor cores
(``mma.sync``, ``ldmatrix`` fragments) work on the chunks before.  The
layout is the port's batch-major NHWC, so no transposes surround the kernel.
What bounds it on an H100 at that shape, B = 64: 4.29 GFLOP (about 4.3 us on
the tensor cores) against about 5.5 MB (1.6 us), so the operations; the
kernel is far from that because a cluster alone takes as long as 64 of them
(its chain of dependent passes; the .cu's header and PERF.md say more).
``probe`` returns the kernel's time by phase; ``passes``, ``smem_layout`` and
``pack_weights_plain`` mirror the kernel's plan for the CPU tests.

``fused_supported`` keeps the JAX package's reject rules, its VMEM footprint
rule included (integer arithmetic, copied here), so that one manifest routes
the same way in both packages.

On a CPU tensor ``critic_trunk_grad`` runs ``critic_trunk_grad_plain``; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from levelgan_torch import obs
from levelgan_torch.device import torch_dtype
from levelgan_torch.kernels import build
from levelgan_torch.kernels.gp_penalty import NormPenalty
from levelgan_torch.models.critic import Critic, critic_channels
from levelgan_torch.ops.blocks import leaky_relu, up
from levelgan_torch.ops.grad_penalty import interpolate

EPS = 1e-5
KC = 64               # K values of a weight row in a sub-unit (csrc: KC)
MAX_TASKS = 32        # (16-row, 16-column) tiles per GEMM pass, the shape rule
MAX_SMEM = 232448     # dynamic shared memory a block may use on sm_90
CS = 2                # blocks per sample: a cluster (csrc: CS)
NCW = 8               # consumer warps of a block (csrc: NCW)
SUB_ROWS = 32         # weight rows (GEMM columns) per sub-unit (csrc)
SUB_BYTES = SUB_ROWS * KC * 2
CHUNK_SUBS = 8        # sub-units per bulk-copied chunk (csrc)
CHUNK_BYTES = CHUNK_SUBS * SUB_BYTES
MAX_DEPTH = 8         # chunks of the ring, at most (the launch's `depth`)
PAD = 8               # grid row pitch = C + PAD bf16 (csrc: PAD)
GMAX = 32             # GroupNorm groups of a block's half, at most (csrc)
_VMEM_BUDGET = 12 * 1024 * 1024   # the JAX package's footprint rule


# ---- the plan and the support rule (levelgan/kernels/critic_grad.py) --------

def critic_arch(mcfg):
    """``(c0, trunk layers, cl)``: layer 0's width, the trunk layers 1..L-1
    as ``(ci, co, has_gn)``, and the last width."""
    chans = critic_channels(mcfg)
    layers = tuple((chans[i - 1], chans[i], mcfg.norm != "none")
                   for i in range(1, len(chans)))
    return chans[0], layers, chans[-1]


def _sublane_pad(n: int, itemsize: int = 4) -> int:
    t = 8 * (4 // itemsize)
    return max(t, -(-n // t) * t)


def _lane_pad(n: int) -> int:
    return -(-n // 128) * 128


def _usage(bt: int, m0: int, c0: int, layers, itemsize: int) -> int:
    """The JAX package's scoped-VMEM estimate of one program at batch tile
    ``bt`` (``_usage`` there), kept only as the routing rule."""
    def blk(m, c, isz):
        return m * m * _sublane_pad(bt) * _lane_pad(c) * isz

    io = blk(m0, c0, itemsize) * 2
    wgt = sum(4 * 4 * _sublane_pad(ci) * _lane_pad(co) * itemsize
              for ci, co, _ in layers)
    m, acts = m0, 4 * blk(m0 // 2 + 2, c0, itemsize)
    for _ci, co, has_gn in layers:
        m //= 2
        acts += (4 if has_gn else 2) * blk(m, co, 4)
        acts += 4 * blk(m // 2 + 2, co, itemsize)
    return 2 * io + 2 * wgt + acts


def fused_supported(mcfg) -> bool:
    """Whether ``model.pallas_gp='fused'`` serves this critic: tile family,
    level size 16 or 32, norm 'group' or 'none', no projection conditioning,
    no ``critic_mbstd``, and the footprint rule."""
    if not (mcfg.family == "tile" and mcfg.level_size in (16, 32)
            and mcfg.norm in ("group", "none")):
        return False
    if mcfg.cond_dim and mcfg.cond_mode != "concat":
        return False
    if mcfg.critic_mbstd:
        return False
    c0, layers, _cl = critic_arch(mcfg)
    itemsize = torch_dtype(mcfg.dtype).itemsize
    return _usage(1, mcfg.level_size // 2, c0, layers,
                  itemsize) <= _VMEM_BUDGET


# ---- the kernel's function, plain ------------------------------------------

def _conv_down(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """4x4 / stride-2 SAME conv, NHWC x and HWIO w as stored, in at least
    f32."""
    y = F.conv2d(up(x).permute(0, 3, 1, 2), up(w).permute(3, 2, 0, 1),
                 stride=2, padding=1)
    return y.permute(0, 2, 3, 1)


def _conv_down_dx(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The input gradient of ``_conv_down``: d [B, m, m, Co] -> [B, 2m, 2m,
    Ci] in at least f32."""
    dx = F.conv_transpose2d(up(d).permute(0, 3, 1, 2),
                            up(w).permute(3, 2, 0, 1), stride=2, padding=1)
    return dx.permute(0, 2, 3, 1)


def _group_mean(s: torch.Tensor, gs: int, cnt: float) -> torch.Tensor:
    """Per-channel sums [B, C] -> their group's mean, per channel."""
    b, c = s.shape
    gm = s.reshape(b, c // gs, gs).sum(-1) / cnt
    return gm.repeat_interleave(gs, dim=1)[:, None, None, :]


def critic_trunk_grad_plain(a0: torch.Tensor, layers, head_w: torch.Tensor,
                            *, slope: float = 0.2, group_size: int = 16
                            ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, step by step with the same
    rounding points (not through autograd).

    ``a0`` [B, M0, M0, C0] in the compute dtype; ``layers`` one
    ``(w HWIO [4, 4, Ci, Co], b [Co], gamma [Co] | None, beta [Co] | None)``
    per trunk layer; ``head_w`` [4, 4, Cl].  Returns ``dy0`` like ``a0``.
    """
    cdt = a0.dtype
    cur, saved = a0, []
    for w, b, gamma, beta in layers:
        y = up(_conv_down(cur, w.to(cdt)).to(cdt) + b.to(cdt))
        if gamma is None:
            saved.append((y, None, None, None, 0))
            o = y
        else:
            co = y.shape[-1]
            gs = co // max(1, co // group_size)
            cnt = float(gs * y.shape[1] * y.shape[2])
            mean = _group_mean(y.sum(dim=(1, 2)), gs, cnt)
            mean2 = _group_mean((y * y).sum(dim=(1, 2)), gs, cnt)
            rstd = torch.rsqrt(mean2 - mean * mean + EPS)
            xn = (y - mean) * rstd
            o = xn * up(gamma) + up(beta)
            saved.append((o, xn, rstd, up(gamma), gs))
        cur = leaky_relu(o, slope).to(cdt)

    d = up(head_w).expand(a0.shape[0], *head_w.shape)
    for (w, _b, _ga, _be), (o, xn, rstd, gamma, gs) in zip(
            reversed(layers), reversed(saved)):
        d = torch.where(o >= 0, d, slope * d)
        if xn is not None:
            cnt = float(gs * d.shape[1] * d.shape[2])
            dxhat = d * gamma
            m1 = _group_mean(dxhat.sum(dim=(1, 2)), gs, cnt)
            m2 = _group_mean((dxhat * xn).sum(dim=(1, 2)), gs, cnt)
            d = rstd * (dxhat - m1 - xn * m2)
        d = up(_conv_down_dx(d.to(cdt), w.to(cdt)).to(cdt))
    return torch.where(up(a0) >= 0, d, slope * d).to(cdt)


# ---- the kernel's plan: passes, the weight stream, shared memory ---------
# (each formula is the csrc's, which tests/test_torch_k2_layout.py replays)

def passes(m0: int, chans) -> list[dict]:
    """The GEMM passes of one block in the order it runs them: forward
    layers 1..L, then the input gradients of layers L..1.

    A pass's rows (M) are output positions (forward: the ``mo x mo`` output;
    reverse: each of 4 parity planes ``mo x mo`` of the input, with its own 4
    taps), its columns (N) the block's half of the output channels, and K
    runs over ``steps`` = taps x ``kch`` chunks of 64 channels.  The weights
    come as sub-units of 32 columns x 64 K values, ``ng`` per plane and step;
    a warp task is one 16 x 32 output tile, ``ksplit`` tasks per tile where
    the tiles are fewer than the consumer warps (each takes every
    ``ksplit``-th step)."""
    n = len(chans) - 1
    out = []
    for i in range(2 * n):
        fwd = i < n
        lay = i + 1 if fwd else 2 * n - i
        ci, co = chans[lay - 1], chans[lay]
        mo = m0 >> lay
        kch = (ci if fwd else co) // KC
        planes = 1 if fwd else 4
        ng = (co if fwd else ci) // CS // SUB_ROWS
        ntiles = planes * (mo * mo // 16) * ng
        ksplit = 1
        while ntiles * ksplit * 2 <= NCW:
            ksplit *= 2
        steps = (16 if fwd else 4) * kch
        out.append(dict(fwd=fwd, layer=lay, mo=mo, kch=kch, steps=steps,
                        planes=planes, ng=ng, mt=mo * mo // 16,
                        ntiles=ntiles, ksplit=ksplit,
                        chunks=steps * planes * ng // CHUNK_SUBS))
    return out


def stream_elems(chans) -> int:
    """bf16 elements of one block's weight stream (half of both
    directions' weights)."""
    return sum(2 * 16 * ci * co for ci, co in zip(chans[:-1], chans[1:])) // CS


def _grid_bytes(m: int, c: int) -> int:
    return (m + 2) * (m + 2) * (c + PAD) * 2


def smem_layout(m0: int, chans, depth: int) -> dict:
    """Byte offsets of a block's shared memory (csrc: make_layout): the ring
    of ``depth`` chunks, a zero-haloed bf16 grid per layer boundary (a_l on
    the way forward, the cotangent of y_l on the way back, all channels),
    the block's half of each trunk layer's y in bf16, the per-(M tile,
    channel) partial sums, the scratch of the split-K sums, the GroupNorm
    statistics, the layers' bias / gamma / beta and the block's half of
    the head, and the mbarriers."""
    n = len(chans) - 1
    off, lay = 0, {"ring": 0}
    off += depth * CHUNK_BYTES
    lay["grid"] = []
    for i in range(n + 1):
        lay["grid"].append(off)
        off += _grid_bytes(m0 >> i, chans[i])
    lay["y"] = [0]
    for i in range(1, n + 1):
        lay["y"].append(off)
        off += (m0 >> i) ** 2 * (chans[i] // CS) * 2
    lay["part"] = off
    off += 2 * max((m0 >> i) ** 2 // 16 * (chans[i] // CS)
                   for i in range(1, n + 1)) * 4
    lay["red"] = off
    off += max((p["ntiles"] * (p["ksplit"] - 1) for p in passes(m0, chans)),
               default=0) * 512 * 4
    lay["stats"] = off
    off += 6 * GMAX * 4       # mean, rstd of two layers; the two bwd sums
    lay["par"] = off          # bias, gamma, beta per layer; the head's half
    off += 3 * sum(chans[1:]) * 4 + 16 * (chans[-1] // CS) * 4
    lay["bars"] = off
    off += (2 * depth + 1) * 8
    lay["total"] = off
    return lay


def ring_depth(m0: int, chans) -> int:
    """The deepest ring (2 .. MAX_DEPTH chunks) whose block fits the card's
    shared memory; ValueError where not even 2 fit."""
    for depth in range(MAX_DEPTH, 1, -1):
        if smem_layout(m0, chans, depth)["total"] <= MAX_SMEM:
            return depth
    raise ValueError(f"K2 fused needs {smem_layout(m0, chans, 2)['total']} "
                     f"bytes of shared memory per block at channels "
                     f"{list(chans)}, side {m0}; a block has {MAX_SMEM}")


def pack_weights_plain(ws) -> torch.Tensor:
    """The weight streams of both blocks of a sample, [CS, stream_elems]
    bf16, from each trunk layer's HWIO [4, 4, Ci, Co] weight (csrc:
    critic_trunk_pack_kernel).

    Block r's stream holds the passes in their order; a pass is its steps,
    a step its planes, a plane its ``ng`` sub-units of 32 rows (GEMM columns
    of block r's half) x 64 K values.  Forward, step (tap, kc), row n, k:
    ``w[tap // 4, tap % 4, kc*64 + k, r*Nh + 32*ng + n]``.  Reverse, step (tt
    = (ry, rx), kc), plane (cy, cx): ``w[1 - cy + 2ry, 1 - cx + 2rx, r*Nh +
    32*ng + n, kc*64 + k]``.  In a row the 16-byte unit u (8 K values) is
    stored at u ^ (n % 8), so that ldmatrix's eight rows of one unit fall in
    eight bank groups without padding the rows."""
    n = len(ws)
    chans = [ws[0].shape[2]] + [w.shape[3] for w in ws]
    swz = torch.arange(8)[None, :] ^ (torch.arange(SUB_ROWS)[:, None] % 8)
    streams = []
    for r in range(CS):
        parts = []
        for p in passes(4 * 2 ** n, chans):
            w = ws[p["layer"] - 1].float()
            ci, co = w.shape[2], w.shape[3]
            if p["fwd"]:
                nh = co // CS
                t = w.reshape(16, ci // KC, KC, CS, nh // SUB_ROWS, SUB_ROWS)
                t = t[:, :, :, r].permute(0, 1, 3, 4, 2).reshape(
                    -1, 1, nh // SUB_ROWS, SUB_ROWS, KC)
            else:
                nh = ci // CS
                # [ry, 1 - cy, rx, 1 - cx, ci, co] -> [ry, cy, rx, cx, ...]
                t = w.reshape(2, 2, 2, 2, ci, co).flip(1, 3)
                t = t.reshape(2, 2, 2, 2, CS, nh // SUB_ROWS, SUB_ROWS,
                              co // KC, KC)[:, :, :, :, r]
                # -> [ry, rx, kc, cy, cx, ng, n, k]
                t = t.permute(0, 2, 6, 1, 3, 4, 5, 7).reshape(
                    -1, 4, nh // SUB_ROWS, SUB_ROWS, KC)
            t = t.reshape(*t.shape[:-1], 8, 8)
            idx = swz.reshape(1, 1, 1, SUB_ROWS, 8, 1).expand(
                *t.shape[:-1], 8)
            parts.append(torch.gather(t, -2, idx).reshape(-1))
        streams.append(torch.cat(parts))
    return torch.stack(streams).to(torch.bfloat16)


# ---- the wrapper -----------------------------------------------------------

def _lib():
    lib = build.load("critic_grad")
    fn = lib.critic_trunk_grad
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        lib.critic_trunk_pack.argtypes = ([ctypes.c_void_p] * 3
                                          + [ctypes.c_int] * 4
                                          + [ctypes.c_void_p])
        lib.critic_trunk_pack.restype = ctypes.c_int
        lib.critic_trunk_grad_smem.argtypes = [ctypes.c_int] * 6
        lib.critic_trunk_grad_smem.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned: the kernel copies its inputs 16
    bytes at a time."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def pack_weights(ws) -> torch.Tensor:
    """``pack_weights_plain`` by one launch of the pack kernel for CUDA
    weights (f32 HWIO, one or two layers); the plain version on the CPU.
    Training changes the weights after every call, so nothing is cached."""
    if ws[0].device.type == "cpu":
        return pack_weights_plain(ws)
    chans = [ws[0].shape[2]] + [w.shape[3] for w in ws]
    out = torch.empty((CS, stream_elems(chans)), dtype=torch.bfloat16,
                      device=ws[0].device)
    ptrs = [build.ptr(w.contiguous()) for w in ws]
    ptrs += [ctypes.c_void_p(None)] * (2 - len(ptrs))
    c3 = chans + [0] * (3 - len(chans))
    with torch.cuda.device(out.device):
        err = _lib().critic_trunk_pack(*ptrs, build.ptr(out), len(ws), *c3,
                                       build.stream_ptr(out.device))
    build.check(err, "critic_trunk_pack")
    return out


PHASES = ("stage a0", "conv", "GroupNorm", "GroupNorm bwd", "conv dx")


def phase_names(n_layers: int) -> list[str]:
    """Names of the intervals between the kernel's ``probe`` stamps (block
    0 of the first cluster, consumer thread 0): a0 staged and the cluster
    met; per forward layer the GEMM pass, then its epilogue (bias,
    statistics, a_l to both blocks); per reverse layer its cotangent made
    and exchanged (the head's for the last layer, else the epilogue of the
    pass above: LeakyReLU and GroupNorm backward), then its input-gradient
    GEMM (for layer 1 with the store of dy0)."""
    fwd = [f"layer {i} {ph}" for i in range(1, n_layers + 1)
           for ph in PHASES[1:3]]
    bwd = [f"layer {i} {ph}" for i in range(n_layers, 0, -1)
           for ph in PHASES[3:]]
    return [PHASES[0]] + fwd + bwd


def critic_trunk_grad(a0: torch.Tensor, layers, head_w: torch.Tensor, *,
                      slope: float = 0.2, group_size: int = 16,
                      probe: torch.Tensor | None = None) -> torch.Tensor:
    """K2 fused: ``a0`` [B, M0, M0, C0] -> ``dy0`` (same shape and dtype);
    arguments as ``critic_trunk_grad_plain``.  On the card ``a0`` is bf16,
    the parameters f32, one or two trunk layers (M0 = 8 or 16), channels in
    multiples of 64, and GroupNorm on every layer or on none, with group
    size 8 or 16.  One call is two launches: the weight pack, then the
    kernel (clusters of CS blocks, one cluster per sample).  ``probe``, an
    int64 CUDA tensor of at least 2 + 4 * layers entries, receives the
    first block's time stamps in nanoseconds, one per boundary of
    ``phase_names``."""
    if a0.device.type == "cpu":
        return critic_trunk_grad_plain(a0, layers, head_w, slope=slope,
                                       group_size=group_size)
    if a0.device.type != "cuda":
        raise ValueError(f"K2 fused runs on CUDA tensors, got {a0.device}")
    if a0.dtype != torch.bfloat16 or not a0.is_contiguous() or a0.ndim != 4:
        raise ValueError("K2 fused takes a contiguous bf16 a0 [B, M0, M0, C0]"
                         f", got {tuple(a0.shape)} {a0.dtype}")
    layers = [tuple(lay) for lay in layers]
    b, m0, m0w, c0 = a0.shape
    n = len(layers)
    if n not in (1, 2) or m0 != m0w or m0 != 4 * 2 ** n:
        raise ValueError(f"K2 fused takes 1 or 2 trunk layers on a0 of side "
                         f"4 * 2^layers, got {n} layers on {m0}x{m0w}")
    has_gn = layers[0][2] is not None
    chans = [c0]
    for i, (w, bias, gamma, beta) in enumerate(layers, start=1):
        ci, co = chans[-1], w.shape[-1]
        want = [("w", w, (4, 4, ci, co)), ("b", bias, (co,))]
        if (gamma is None) == has_gn or (beta is None) == has_gn:
            raise ValueError("K2 fused takes GroupNorm on every trunk layer "
                             "or on none")
        if has_gn:
            want += [("gamma", gamma, (co,)), ("beta", beta, (co,))]
        for name, t, shape in want:
            if (t.dtype != torch.float32 or t.device != a0.device
                    or tuple(t.shape) != shape):
                raise ValueError(
                    f"K2 fused layer {i} {name} must be f32 {shape} on "
                    f"{a0.device}, got {tuple(t.shape)} {t.dtype}")
        chans.append(co)
    if (head_w.dtype != torch.float32 or head_w.device != a0.device
            or tuple(head_w.shape) != (4, 4, chans[-1])):
        raise ValueError(f"K2 fused head_w must be f32 (4, 4, {chans[-1]}) "
                         f"on {a0.device}, got {tuple(head_w.shape)} "
                         f"{head_w.dtype}")
    tasks = max(max((m0 >> i) ** 2 // 16 * (chans[i] // 16),
                    (m0 >> i) ** 2 // 16 * (chans[i - 1] // 16))
                for i in range(1, n + 1))
    if (any(c % KC for c in chans) or tasks > MAX_TASKS
            or (has_gn and group_size not in (8, 16))):
        raise ValueError(
            f"K2 fused shape rule violated: channels {chans} (multiples of "
            f"{KC}), group_size={group_size} (8 or 16), {tasks} tiles per "
            f"GEMM pass (<= {MAX_TASKS})")
    if probe is not None and (
            probe.dtype != torch.int64 or probe.device != a0.device
            or not probe.is_contiguous() or probe.numel() < 2 + 4 * n):
        raise ValueError(f"K2 fused probe must be a contiguous int64 tensor "
                         f"of >= {2 + 4 * n} entries on {a0.device}")
    depth = ring_depth(m0, chans)
    lib = _lib()
    wpk = pack_weights([w for w, *_ in layers])
    none = ctypes.c_void_p(None)
    keep, ptrs = [], []         # keep: tensors alive across the launch
    for _w, bias, gamma, beta in layers:
        vecs = [_aligned(bias)]
        if has_gn:
            vecs += [_aligned(gamma), _aligned(beta)]
        keep += vecs
        ptrs += [build.ptr(t) for t in vecs] + [none] * (3 - len(vecs))
    ptrs += [none] * (6 - len(ptrs))
    head = _aligned(head_w)
    a0 = _aligned(a0)
    c3 = chans + [0] * (3 - len(chans))
    dy0 = torch.empty_like(a0)
    with torch.cuda.device(a0.device):
        err = lib.critic_trunk_grad(
            build.ptr(a0), build.ptr(dy0), build.ptr(wpk), wpk.shape[1],
            *ptrs, build.ptr(head), b, n, m0, *c3,
            group_size if has_gn else 0, float(slope), EPS, depth,
            none if probe is None else build.ptr(probe),
            build.stream_ptr(a0.device))
    build.check(err, "critic_trunk_grad")
    obs.count("k2f.launches")
    return dy0


# ---- the op around the kernel ----------------------------------------------

def _trunk_params(mcfg, params):
    """Critic parameters by ``state_dict`` name -> the kernel's arguments:
    ``(layers, head_w [4, 4, Cl])``; the Dense head [16 * Cl, 1] flattens
    NHWC."""
    _c0, arch, cl = critic_arch(mcfg)
    layers = []
    for i, (_ci, _co, has_gn) in enumerate(arch, start=1):
        layers.append((params[f"down{i}.kernel"], params[f"down{i}.bias"],
                       params[f"scale{i}"] if has_gn else None,
                       params[f"bias{i}"] if has_gn else None))
    return layers, params["head.kernel"][:, 0].reshape(4, 4, cl)


def critic_input_grad_fwd(mcfg, params, x_hat: torch.Tensor, cond=None
                          ) -> torch.Tensor:
    """``d(sum_b D(x_hat)_b)/d(x_hat)`` through the kernel: the condition
    embedding, layer 0 and its transpose in PyTorch around
    ``critic_trunk_grad``.  ``params`` maps the critic's ``state_dict``
    names to tensors."""
    cdt = torch_dtype(mcfg.dtype)
    xc = x_hat.to(cdt)
    if mcfg.cond_dim:
        if cond is None:
            raise ValueError("conditional critic called without cond")
        # the bias after the rounded product, as the Critic's Dense
        emb = leaky_relu(F.linear(cond.to(cdt),
                                  params["cond_embed.kernel"].to(cdt).t())
                         + params["cond_embed.bias"].to(cdt),
                         mcfg.leaky_slope)
        xc = torch.cat([xc, emb[:, None, None, :].expand(
            *xc.shape[:3], emb.shape[-1])], dim=-1)
    w0 = params["down0.kernel"].to(cdt).permute(3, 2, 0, 1)
    y0 = F.conv2d(xc.permute(0, 3, 1, 2), w0, stride=2, padding=1)
    a0 = leaky_relu(y0.permute(0, 2, 3, 1) + params["down0.bias"].to(cdt),
                    mcfg.leaky_slope).contiguous()
    layers, head_w = _trunk_params(mcfg, params)
    dy0 = critic_trunk_grad(a0, layers, up(head_w), slope=mcfg.leaky_slope,
                            group_size=mcfg.group_size)
    dxc = F.conv_transpose2d(dy0.permute(0, 3, 1, 2), w0, stride=2, padding=1)
    return dxc.permute(0, 2, 3, 1)[..., :mcfg.n_tiles].to(x_hat.dtype)


class CriticInputGrad(torch.autograd.Function):
    """``grad_fn``'s custom VJP.  ``apply(critic, x_hat, cond, *params)``
    with ``params`` the critic's parameters in ``named_parameters`` order
    (tensor arguments, so that they receive gradients)."""

    @staticmethod
    def forward(ctx, critic, x_hat, cond, *params):
        ctx.critic = critic
        ctx.save_for_backward(x_hat, cond, *params)
        names = [n for n, _ in critic.named_parameters()]
        return critic_input_grad_fwd(critic.cfg, dict(zip(names, params)),
                                     x_hat, cond)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        x_hat, cond, *params = ctx.saved_tensors
        critic = ctx.critic
        names = [n for n, _ in critic.named_parameters()]
        with torch.enable_grad():
            x = x_hat.detach().requires_grad_(True)
            c = None if cond is None else cond.detach().requires_grad_(True)
            ps = [p.detach().requires_grad_(True) for p in params]
            score = up(torch.func.functional_call(
                critic, dict(zip(names, ps)), (x, c))).sum()
            (gx,) = torch.autograd.grad(score, x, create_graph=True)
            inner = (gx * ct.to(gx.dtype)).sum()
            wrt = [(i, t) for i, t in enumerate([x, c] + ps, start=1)
                   if t is not None and ctx.needs_input_grad[i]]
            grads = torch.autograd.grad(inner, [t for _, t in wrt],
                                        allow_unused=True)
        out = [None] * (3 + len(ps))
        for (i, _), g in zip(wrt, grads):
            out[i] = g
        return tuple(out)


def critic_input_grad(critic: Critic, x_hat: torch.Tensor, cond=None
                      ) -> torch.Tensor:
    """The differentiable fused input gradient of ``critic`` at ``x_hat``."""
    return CriticInputGrad.apply(critic, x_hat, cond, *critic.parameters())


def gradient_penalty_fused(critic, real: torch.Tensor, fake: torch.Tensor,
                           cond=None, eps: torch.Tensor | None = None, *,
                           generator: torch.Generator | None = None
                           ) -> torch.Tensor:
    """Twin of ``ops.grad_penalty.gradient_penalty`` through K2 fused and
    the K2 core.  ``critic`` is the ``Critic`` module itself: the kernel
    embodies its architecture and the double backward needs its
    parameters."""
    if not isinstance(critic, Critic):
        raise TypeError("the fused gradient penalty takes the Critic module, "
                        f"got {type(critic).__name__}")
    x_hat = interpolate(real, fake, eps, generator=generator)
    g = critic_input_grad(critic, x_hat, cond)
    return NormPenalty.apply(up(g).reshape(g.shape[0], -1).contiguous()).mean()
