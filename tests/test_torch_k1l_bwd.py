"""K1L's backward kernel on the CPU: its plan replayed without a card.

The CUDA kernel (``upsample_rows_bwd`` in ``csrc/upsample_rows.cu``) is held
to its plain version on the card (tests/test_torch_cuda.py).  Here what it
computes is replayed with PyTorch ops in its own order and with its own
index formulas: the per-rank dyf tiles with their halo rows, the dx gather
from the tiles against ``pack_taps_dx``'s steps, the pass-1 vectors' g
elements, the fixed order of the sums (a thread's vectors, the butterfly
over the lanes of a channel chunk, warps, cluster ranks), the shared-memory
formula and the chooser; the general kernel's plan (chunks of 32
cotangent channels, halo rows computed by the block itself) and its
chooser against every shape the stage kernel takes; and the plain chain
against the JAX package's VJP at one more shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.kernels.upsample_rows import upsample_block_rows_sm
from levelgan_torch import obs
from levelgan_torch.config import PRESET_NAMES, preset
from levelgan_torch.kernels import upsample_block as k1
from levelgan_torch.kernels import upsample_rows as k1l
from levelgan_torch.models import Generator
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# gumbel_64 up3 (the preset's K1L stage) and up2 as a second shape
SHAPES = [(32, 64, 32), (16, 128, 64)]          # (H = W, Ci, Co)
# shapes only the general kernel takes: up3 at model.base_channels=128,
# and Co = 96
GENERAL_SHAPES = [(32, 128, 64), (32, 64, 96)]


def _residuals(b, h, ci, co, gs=16, seed=0):
    """f32 inputs of the backward from a plain stage forward: x, w, gamma,
    beta, the cotangent g and the residuals (yf, mu, rstd)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, h, ci, generator=gen)
    w = torch.randn(4, 4, ci, co, generator=gen) * 0.05
    gamma = 1 + 0.1 * torch.randn(co, generator=gen)
    beta = 0.1 * torch.randn(co, generator=gen)
    _, yf, mu, rstd = k1l.upsample_block_rows_plain(
        x, w, gamma, beta, group_size=gs, residuals=True)
    g = torch.randn(b, 2 * h, 2 * h, co, generator=gen)
    return x, w, gamma, beta, g, yf, mu, rstd


def _tiles(dyf, rt):
    """Each rank's dyf tile of one sample as the kernel builds it:
    [csize, rt + 2, W + 2, 4Co], zeros first; the interior (rows 1..rt,
    columns 1..W) from pass 2; then row 0 from rank r - 1's row rt and row
    rt + 1 from rank r + 1's row 1 (csrc: the halo copy), left zero at the
    sample's edges."""
    h, w, c4 = dyf.shape
    csize = h // rt
    tiles = torch.zeros(csize, rt + 2, w + 2, c4)
    for r in range(csize):
        tiles[r, 1:rt + 1, 1:w + 1] = dyf[r * rt:(r + 1) * rt]
    own = tiles.clone()                 # the interiors, before the copy
    for r in range(csize):
        if r > 0:
            tiles[r, 0] = own[r - 1, rt]
        if r + 1 < csize:
            tiles[r, rt + 1] = own[r + 1, 1]
    return tiles


@pytest.mark.parametrize("h,ci,co", SHAPES)
def test_halo_rows_rebuild_the_padded_plane(h, ci, co):
    """Rank r's tile is rows r rt .. r rt + rt + 1 of the zero-padded folded
    dyf: the halo rows come from the neighbours, zeros at the edges."""
    rt, _ = k1l.bwd_tile(h, h, ci, co, 16)
    dyf = torch.randn(h, h, 4 * co)
    padded = torch.nn.functional.pad(dyf, (0, 0, 1, 1, 1, 1))
    tiles = _tiles(dyf, rt)
    for r in range(h // rt):
        assert torch.equal(tiles[r], padded[r * rt:r * rt + rt + 2])
    assert not tiles[0, 0].any() and not tiles[-1, rt + 1].any()
    assert not tiles[:, :, 0].any() and not tiles[:, :, h + 1].any()


@pytest.mark.parametrize("h,ci,co", SHAPES)
def test_dx_gather_from_the_tiles_replays_the_plain_dx(h, ci, co):
    """The GEMM's loop (steps = parity x 32-channel chunk of pack_taps_dx,
    4 taps each; position m reads the tile at (il + 2 - a - r,
    j + 2 - b - s)) over every rank's tile gives conv_rows_bwd_plain's dx
    with the weight in bf16."""
    rt, _ = k1l.bwd_tile(h, h, ci, co, 16)
    gen = torch.Generator().manual_seed(h)
    dyf = torch.randn(h, h, 4 * co, generator=gen)
    w = torch.randn(4, 4, ci, co, generator=gen) * 0.05
    wpk = k1.pack_taps_dx(w).float()     # [Ci/32][parity][kc][tap][32][32]
    tiles = _tiles(dyf, rt)
    kcn = co // 32
    dx = torch.zeros(h, h, ci)
    il = torch.arange(rt)[:, None].expand(rt, h)
    j = torch.arange(h)[None, :].expand(rt, h)
    for r in range(h // rt):
        acc = torch.zeros(rt, h, ci)
        for st in range(4 * kcn):
            p, kc = divmod(st, kcn)
            pa, pb = divmod(p, 2)
            for rr in (0, 1):
                for s in (0, 1):
                    a = tiles[r][il + 2 - pa - rr, j + 2 - pb - s,
                                 p * co + kc * 32:p * co + kc * 32 + 32]
                    # B rows: input channel nb * 32 + n, k: cotangent channel
                    wb = wpk[:, p, kc, 2 * rr + s].reshape(ci, 32)
                    acc += a @ wb.t()
        dx[r * rt:(r + 1) * rt] = acc
    # the pack rounds the weight to bf16
    want = k1l.conv_rows_bwd_plain(dyf[None], w.to(torch.bfloat16).float())[0]
    torch.testing.assert_close(dx, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,ci,co", SHAPES)
def test_pass_vectors_read_the_folded_g(h, ci, co):
    """Vector v of a block's pass is (position, parity, 8-channel chunk),
    chunk fastest: its yf words are the v-th 16 bytes of the block's yf
    rows, and its g words sit at ((2 il + a) 2W + 2 j + b) Co + 8 cq of the
    block's g rows (csrc: ``g_at``): together the folded g."""
    rt, _ = k1l.bwd_tile(h, h, ci, co, 16)
    w, cqn = h, co // 8
    g = torch.randn(1, 2 * h, 2 * w, co)
    gf = k1l.fold(g)[0]
    for r in range(h // rt):
        rows = g[0, 2 * r * rt:2 * (r + 1) * rt].reshape(-1)
        want = gf[r * rt:(r + 1) * rt].reshape(-1, 8)
        got = torch.empty_like(want)
        for v in range(rt * w * co // 2):
            u, cq = divmod(v, cqn)
            pos, p = divmod(u, 4)
            il, j = divmod(pos, w)
            off = ((2 * il + (p >> 1)) * 2 * w + 2 * j + (p & 1)) * co + cq * 8
            got[v] = rows[off:off + 8]
        assert torch.equal(got, want)


def _kernel_order_sums(dout, xn, rt, nthr):
    """Per-sample (s1, s2) [Co] as the kernel sums them: a thread's vectors
    v = tid, tid + nthr, ... in order; the butterfly over the lanes of one
    channel chunk (xor offsets Co/8, 2 Co/8, .. 16); warps 0..nw-1 in
    order; cluster ranks 0..n-1 in order.  dout, xn: [H, W, 4Co]."""
    h, w, c4 = dout.shape
    co, cqn = c4 // 4, c4 // 32
    out = []
    for vals in (dout, dout * xn):
        total = torch.zeros(co)
        for r in range(h // rt):
            vec = vals[r * rt:(r + 1) * rt].reshape(-1, 8)   # v order
            part = torch.zeros(nthr, 8)
            for it in range(vec.shape[0] // nthr):
                part = part + vec[it * nthr:(it + 1) * nthr]
            lanes = part.reshape(nthr // 32, 32, 8)
            o = cqn
            while o < 32:
                lanes = lanes + lanes[:, torch.arange(32) ^ o]
                o <<= 1
            red = lanes[:, :cqn].reshape(nthr // 32, co)    # [warp][c]
            block = torch.zeros(co)
            for wi in range(nthr // 32):
                block = block + red[wi]
            total = total + block
        out.append(total)
    return out


@pytest.mark.parametrize("h,ci,co", SHAPES)
def test_kernel_order_of_the_sums_gives_the_plain_sums(h, ci, co):
    """The kernel's fixed order of s1 = sum dout and s2 = sum dout * xn,
    replayed in f32, gives gn_act_bwd_folded's (dbeta and dgamma of one
    sample), and dyf from those sums by the kernel's formula gives its dyf."""
    gs, slope = 16, 0.2
    _, _, gamma, beta, g, yf, mu, rstd = _residuals(2, h, ci, co, gs, seed=h)
    rt, _ = k1l.bwd_tile(h, h, ci, co, gs)
    nthr = 32 * k1l.bwd_warps(h, rt, ci)
    for b in range(2):
        mu4 = mu[b].repeat(4)
        rs4 = rstd[b].repeat(4)
        xn = (yf[b] - mu4) * rs4
        gf = k1l.fold(g[b:b + 1])[0]
        dout = torch.where(xn * gamma.repeat(4) + beta.repeat(4) >= 0, gf,
                           slope * gf)
        s1, s2 = _kernel_order_sums(dout, xn, rt, nthr)
        dyf, dgamma, dbeta = k1l.gn_act_bwd_folded(
            g[b:b + 1], yf[b:b + 1], mu[b:b + 1], rstd[b:b + 1], gamma, beta,
            slope=slope, group_size=gs)
        torch.testing.assert_close(s1, dbeta, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(s2, dgamma, rtol=1e-5, atol=1e-4)
        cnt = 4.0 * gs * h * h
        m1 = ((s1 * gamma).reshape(-1, gs).sum(-1) / cnt).repeat_interleave(gs)
        m2 = ((s2 * gamma).reshape(-1, gs).sum(-1) / cnt).repeat_interleave(gs)
        got = rs4 * (dout * gamma.repeat(4) - m1.repeat(4) - xn * m2.repeat(4))
        torch.testing.assert_close(got, dyf[0], rtol=1e-4, atol=1e-6)


def _bwd_shapes():
    """Every shape the chooser is asked about: H, W in 16..128, Ci 32..512,
    Co 32..256."""
    return [(h, w, ci, co) for h in (16, 32, 64, 128) for w in (16, 32, 64, 128)
            for ci in (32, 64, 128, 256, 512) for co in (32, 64, 128, 256)]


def _valid(h, w, rt, ci, co):
    nw = k1l.bwd_warps(w, rt, ci)
    return (h % rt == 0 and h // rt <= k1l.MAX_CLUSTER and rt * w % 32 == 0
            and rt * w <= k1l.MROWS and nw <= k1l.BWD_MAX_WARPS
            and 32 * nw % co == 0)


def test_bwd_tile_at_every_shape_is_inside_the_budgets():
    """Where the chooser takes a shape: whole clusters of at most 8 blocks,
    whole warp tiles, at most 8 warps, the weight resident or a ring of 2-3
    slots, within the shared memory; no larger rt would fit.  Where it
    refuses one, no rt fits at all."""
    taken = 0
    for h, w, ci, co in _bwd_shapes():
        steps = 4 * co // 32
        try:
            rt, slots = k1l.bwd_tile(h, w, ci, co, 16)
        except ValueError:
            assert not any(
                _valid(h, w, rt, ci, co)
                and k1l.bwd_smem(w, rt, ci, co, 2) <= k1.SMEM_MAX
                for rt in range(1, h + 1)), (h, w, ci, co)
            continue
        taken += 1
        assert _valid(h, w, rt, ci, co)
        assert slots == steps or 2 <= slots <= k1l.BWD_MAX_RING < steps
        assert k1l.bwd_smem(w, rt, ci, co, slots) <= k1.SMEM_MAX
        if slots < steps:
            assert k1l.bwd_smem(w, rt, ci, co, steps) > k1.SMEM_MAX
        assert not any(_valid(h, w, r2, ci, co)
                       and k1l.bwd_smem(w, r2, ci, co, 2) <= k1.SMEM_MAX
                       for r2 in range(rt + 1, h + 1)), (h, w, ci, co)
    assert taken >= 16


def test_bwd_smem_is_the_sum_of_its_parts():
    """The formula at the gumbel_64 shapes, part by part (csrc:
    ``bwd_layout``): g and yf rows, the haloed tile, the weight steps, the
    sums (every rank's partials of two samples), mean / rstd, the group
    means and four mbarriers (no ticket: the clusters' sums are added by
    the wrapper)."""
    # up3: rt 4, 8 warps, the 4 weight steps resident
    assert k1l.bwd_tile(32, 32, 64, 32, 16) == (4, 4)
    assert k1l.bwd_smem(32, 4, 64, 32, 4) == (
        2 * (8 * 64 * 32 * 2) + 6 * 34 * (128 * 2 + 16) + 4 * 4 * 64 * 80
        + (2 * 8 + 4 * 8 + 4) * 32 * 4 + 32) == 209632
    # up2: rt 4 (8 rows would need 16 warps and 308 KB), a ring of 2
    assert k1l.bwd_tile(16, 16, 128, 64, 16) == (4, 2)
    assert k1l.bwd_smem(16, 4, 128, 64, 2) == 217824
    assert k1l.bwd_smem(16, 8, 128, 64, 2) > k1.SMEM_MAX
    assert k1l.bwd_smem(16, 4, 128, 64, 3) > k1.SMEM_MAX


@pytest.mark.parametrize("name", PRESET_NAMES)
def test_bwd_tile_takes_every_preset_k1l_stage(name):
    """Every stage that runs K1L in training (K1 does not fit it) gets a
    backward tile."""
    m = preset(name).model
    for i, st in enumerate(Generator(m).stages()):
        h, ci, co = 4 * 2 ** i, st.kernel.shape[2], st.kernel.shape[3]
        if not k1.fits(h, h):
            rt, slots = k1l.bwd_tile(h, h, ci, co, m.group_size)
            assert k1l.bwd_smem(h, rt, ci, co, slots) <= k1.SMEM_MAX


@pytest.mark.parametrize("args,match", [
    ((32, 8, 64, 32, 16), "W=8"),          # W < 16
    ((32, 24, 64, 32, 16), "W=24"),        # W does not divide 128
    ((32, 32, 48, 32, 16), "ci=48"),       # ci not a multiple of 32
    ((32, 32, 64, 96, 16), "co=96"),       # co not a power of two
    ((32, 32, 64, 512, 16), "co=512"),     # co beyond 256
    ((32, 32, 64, 32, 10), "groups"),      # 3 groups of 32 channels
    ((32, 32, 64, 64, 64), "group size 64"),  # a group beyond 32 channels
    ((128, 16, 64, 32, 16), "no row tile"),   # 16 blocks a cluster
    ((32, 32, 512, 256, 16), "no row tile"),  # beyond the shared memory
])
def test_bwd_tile_refuses_other_shapes(args, match):
    with pytest.raises(ValueError, match=match):
        k1l.bwd_tile(*args)


def test_wrapper_on_the_cpu_is_the_plain_chain():
    """A CPU tensor takes the plain chain (gn_act_bwd_folded, then
    conv_rows_bwd_plain), and no kernel launches."""
    x, w, gamma, beta, g, yf, mu, rstd = _residuals(2, 16, 32, 32, 8, seed=3)
    n = obs.counters["k1l.bwd_launches"]
    got = k1l.upsample_rows_bwd(g, yf, mu, rstd, gamma, beta, w,
                                group_size=8)
    assert obs.counters["k1l.bwd_launches"] == n
    dyf, dgamma, dbeta = k1l.gn_act_bwd_folded(g, yf, mu, rstd, gamma, beta,
                                               group_size=8)
    want = (k1l.conv_rows_bwd_plain(dyf, w), dyf, dgamma, dbeta)
    for a, r in zip(got, want):
        assert torch.equal(a, r)


def test_k1l_vjp_matches_jax_rows_at_group_size_4():
    """The plain chain, with dw by weight_grad_folded, against
    _make_rows_op's VJP (interpret mode) at group size 4 and Co = 32, f32."""
    rng = np.random.default_rng(8)
    b, h, ci, co = 2, 8, 16, 32
    x = rng.standard_normal((b, h, h, ci)).astype(np.float32)
    w = (rng.standard_normal((4, 4, ci, co)) * 0.1).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, co).astype(np.float32)
    beta = (rng.standard_normal(co) * 0.1).astype(np.float32)
    ct = rng.standard_normal((b, 2 * h, 2 * h, co)).astype(np.float32)

    def op(x, *a):
        y = upsample_block_rows_sm(jnp.transpose(x, (1, 2, 0, 3)), *a,
                                   slope=0.2, group_size=4,
                                   compute_dtype=jnp.float32)
        return jnp.transpose(y, (2, 0, 1, 3))

    _, vjp = jax.vjp(op, *map(jnp.asarray, (x, w, gamma, beta)))
    want = vjp(jnp.asarray(ct))
    xt, wt, gt, bt = map(torch.from_numpy, (x, w, gamma, beta))
    _, yf, mu, rstd = k1l.upsample_block_rows(xt, wt, gt, bt, group_size=4,
                                              residuals=True)
    dx, dyf, dgamma, dbeta = k1l.upsample_rows_bwd(
        torch.from_numpy(ct), yf, mu, rstd, gt, bt, wt, group_size=4)
    got = (dx, k1l.weight_grad_folded(xt, dyf), dgamma, dbeta)
    for name, a, r in zip(("dx", "dw", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


# ---- the general kernel ----------------------------------------------------

def _group_sizes(co):
    return [g for g in (4, 8, 16, 32) if co % g == 0]


def test_bwd_plan_takes_every_shape_the_stage_kernel_takes():
    """Every (H, W, Ci, Co, group size) that ``stage_tile`` takes, the
    backward takes too: the staged kernel where ``bwd_tile`` fits it, else
    the general one, with clusters of the stage kernel's size and its block
    within the shared memory."""
    taken = general = 0
    for h in (8, 16, 32, 64, 128, 256):
        for w in (8, 16, 32, 64, 128, 256):
            for ci in range(32, 513, 32):
                for co in (*range(32, 513, 32), 768, 1024, 2048):
                    for gsz in _group_sizes(co):
                        try:
                            csize, _ = k1l.stage_tile(h, w, ci, co, gsz)
                        except ValueError:
                            continue
                        gen, rt, slots = k1l.bwd_plan(h, w, ci, co, gsz)
                        taken += 1
                        if gen:
                            general += 1
                            assert rt == k1l.MROWS // w and h // rt == csize
                            assert (k1l.bwd_general_smem(w, ci, slots)
                                    <= k1.SMEM_MAX)
                        else:
                            assert (k1l.bwd_smem(w, rt, ci, co, slots)
                                    <= k1.SMEM_MAX)
    assert taken > 1000 and 0 < general < taken
    # the two cases the staged kernel refuses: 16 warp tiles at Ci = 128,
    # and Co = 96
    assert k1l.bwd_plan(32, 32, 128, 64, 16)[0]
    assert k1l.bwd_plan(32, 32, 64, 96, 16)[0]
    assert not k1l.bwd_plan(32, 32, 64, 32, 16)[0]


def test_bwd_general_smem_is_the_sum_of_its_parts():
    """The general block's formula part by part (csrc: ``gen_layout``):
    the haloed tile of one chunk, the weight steps, the warps' partials of
    one chunk and its group means; the largest, at W = 128, still fits."""
    # Ci = 128 at 32 x 32, Co = 64: 8 steps of 40 KB do not fit, a ring of 3
    assert k1l.bwd_general_tile(32, 32, 128, 64, 16) == (4, 3)
    assert k1l.bwd_general_smem(32, 128, 3) == (
        6 * 34 * (4 * 32 * 2 + 16) + 3 * 4 * 128 * 80
        + (8 * 2 + 2) * 32 * 4) == 180672
    assert k1l.bwd_general_smem(32, 128, 8) > k1.SMEM_MAX
    # Co = 96 at Ci = 64: 12 steps of 20 KB do not fit, a ring of 3
    assert k1l.bwd_general_tile(32, 32, 64, 96, 16) == (4, 3)
    # W = 128: one row a block, the stage kernel's widest Ci there is 96
    assert k1l.bwd_general_tile(8, 128, 96, 32, 16) == (1, 4)
    assert k1l.bwd_general_smem(128, 96, 4) <= k1.SMEM_MAX


@pytest.mark.parametrize("args,match", [
    ((32, 32, 160, 32, 16), "ci=160"),     # 20 warp tiles, over 2 a warp
    ((32, 32, 64, 48, 16), "co=48"),       # co not a multiple of 32
    ((64, 32, 64, 32, 16), "H=64"),        # 16 blocks a cluster
    ((32, 32, 64, 64, 64), "group size 64"),  # a group beyond 32 channels
])
def test_bwd_general_tile_refuses_other_shapes(args, match):
    with pytest.raises(ValueError, match=match):
        k1l.bwd_general_tile(*args)


def _general_order_sums(dout, xn, rt, nthr=256):
    """Per-sample (s1, s2) [Co] as the general kernel sums them: chunk by
    chunk of 32 channels, thread t takes the 8 channels 8 (t & 3) of parity
    (t >> 2) & 3 at positions t >> 4, + 16, ...; its words in order, the
    butterfly over lanes t ^ 4, t ^ 8, t ^ 16, warps in order, ranks in
    order.  dout, xn: [H, W, 4Co]."""
    h, w, c4 = dout.shape
    co = c4 // 4
    t = torch.arange(nthr)
    cqq, pp, pos0 = t & 3, (t >> 2) & 3, t >> 4
    out = []
    for vals in (dout, dout * xn):
        total = torch.zeros(co)
        ranks = []
        for r in range(h // rt):
            rows = vals[r * rt:(r + 1) * rt].reshape(rt * w, 4, co)
            block = torch.zeros(co)
            for kc in range(co // 32):
                part = torch.zeros(nthr, 8)
                for u in range(rt * w // (nthr // 16)):
                    pos = pos0 + u * (nthr // 16)
                    ch = kc * 32 + cqq[:, None] * 8 + torch.arange(8)
                    part = part + rows[pos[:, None], pp[:, None], ch]
                lanes = part.reshape(nthr // 32, 32, 8)
                for o in (4, 8, 16):
                    lanes = lanes + lanes[:, torch.arange(32) ^ o]
                red = lanes[:, :4].reshape(nthr // 32, 32)
                acc = torch.zeros(32)
                for wi in range(nthr // 32):
                    acc = acc + red[wi]
                block[kc * 32:(kc + 1) * 32] = acc
            ranks.append(block)
        for block in ranks:
            total = total + block
        out.append(total)
    return out


@pytest.mark.parametrize("h,ci,co", GENERAL_SHAPES)
def test_general_order_of_the_sums_gives_the_plain_sums(h, ci, co):
    """The general kernel's order of s1 and s2, replayed in f32, gives
    gn_act_bwd_folded's dbeta and dgamma of one sample."""
    gs, slope = 16, 0.2
    _, _, gamma, beta, g, yf, mu, rstd = _residuals(1, h, ci, co, gs, seed=h)
    general, rt, _ = k1l.bwd_plan(h, h, ci, co, gs)
    assert general
    xn = (yf[0] - mu[0].repeat(4)) * rstd[0].repeat(4)
    gf = k1l.fold(g)[0]
    dout = torch.where(xn * gamma.repeat(4) + beta.repeat(4) >= 0, gf,
                       slope * gf)
    s1, s2 = _general_order_sums(dout, xn, rt)
    _, dgamma, dbeta = k1l.gn_act_bwd_folded(g, yf, mu, rstd, gamma, beta,
                                             slope=slope, group_size=gs)
    torch.testing.assert_close(s1, dbeta, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(s2, dgamma, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("h,ci,co", GENERAL_SHAPES)
def test_general_chunk_tiles_and_gather_replay_the_plain_dx(h, ci, co):
    """Per chunk kc, rank r's tile holds the chunk's 4 x 32 channels of the
    zero-padded dyf's rows r rt .. r rt + rt + 1 (halo rows computed by the
    block itself: zeros only outside the sample); the GEMM's steps (kc,
    parity), 4 taps each, reading the tile at (il + 2 - a - r, j + 2 - b -
    s) and channels 32 parity .. + 32, give conv_rows_bwd_plain's dx."""
    general, rt, _ = k1l.bwd_plan(h, h, ci, co, 16)
    assert general
    gen = torch.Generator().manual_seed(h + co)
    dyf = torch.randn(h, h, 4 * co, generator=gen)
    w = torch.randn(4, 4, ci, co, generator=gen) * 0.05
    wpk = k1.pack_taps_dx(w).float()     # [Ci/32][parity][kc][tap][32][32]
    padded = torch.nn.functional.pad(dyf, (0, 0, 1, 1, 1, 1))
    kcn = co // 32
    il = torch.arange(rt)[:, None].expand(rt, h)
    j = torch.arange(h)[None, :].expand(rt, h)
    dx = torch.zeros(h, h, ci)
    for r in range(h // rt):
        acc = torch.zeros(rt, h, ci)
        for kc in range(kcn):
            chans = torch.cat([torch.arange(p * co + kc * 32,
                                            p * co + kc * 32 + 32)
                               for p in range(4)])
            tile = padded[r * rt:r * rt + rt + 2][:, :, chans]
            assert tile.shape == (rt + 2, h + 2, 128)
            for p in range(4):
                pa, pb = divmod(p, 2)
                for rr in (0, 1):
                    for s in (0, 1):
                        a = tile[il + 2 - pa - rr, j + 2 - pb - s,
                                 p * 32:p * 32 + 32]
                        wb = wpk[:, p, kc, 2 * rr + s].reshape(ci, 32)
                        acc += a @ wb.t()
        dx[r * rt:(r + 1) * rt] = acc
    want = k1l.conv_rows_bwd_plain(dyf[None], w.to(torch.bfloat16).float())[0]
    torch.testing.assert_close(dx, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,ci,co", GENERAL_SHAPES)
def test_wrapper_on_the_cpu_at_general_shapes_is_the_plain_chain(h, ci, co):
    """At a shape only the general kernel takes, a CPU tensor still takes
    the plain chain, whose dx, dyf, dgamma and dbeta have the kernel's
    shapes and dtypes."""
    x, w, gamma, beta, g, yf, mu, rstd = _residuals(1, h, ci, co, 16, seed=5)
    got = k1l.upsample_rows_bwd(g, yf, mu, rstd, gamma, beta, w)
    want = k1l.upsample_rows_bwd_plain(g, yf, mu, rstd, gamma, beta, w)
    for a, r, shape in zip(got, want, [x.shape, yf.shape, (co,), (co,)]):
        assert a.shape == shape and torch.equal(a, r)
