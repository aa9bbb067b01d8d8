"""K1L's stage kernel on the CPU: the cluster and tile chooser at every
preset's stage shapes, the kernel's fixed order of the GroupNorm sums and
its unfolded store replayed from the plain conv, and the entry's rules.

The CUDA kernel itself is held to its plain version on the card
(tests/test_torch_cuda.py); here what it computes is replayed with PyTorch
ops in the kernel's own order (warps, then cluster ranks, then a group's
channels) and with its own index formulas.
"""

import pytest
import torch

from levelgan_torch import obs
from levelgan_torch.config import PRESET_NAMES, preset
from levelgan_torch.kernels import upsample_block as k1
from levelgan_torch.kernels import upsample_rows as k1l
from levelgan_torch.models import Generator
from levelgan_torch.ops.blocks import conv_transpose_2x
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BATCHES = (1, 3, 64, 1024)
NW = 8                 # warps of a block (csrc: NW)


def _stages(name):
    """(input H, Ci, Co, group size) of each upsample stage of a preset."""
    m = preset(name).model
    return [(4 * 2 ** i, st.kernel.shape[2], st.kernel.shape[3], m.group_size)
            for i, st in enumerate(Generator(m).stages())]


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("name", PRESET_NAMES)
def test_stage_tile_and_grid_are_inside_the_budgets(name, b):
    """Every stage K1L takes (and every other one it could: W >= 16) gets a
    cluster of at most 8 blocks, a ring of 2-3 chunks within a block's
    shared memory and a persistent grid of whole clusters."""
    for h, ci, co, gs in _stages(name):
        if h < 16:
            assert k1.fits(h, h)
            with pytest.raises(ValueError, match="K1L shape rule"):
                k1l.stage_tile(h, h, ci, co, gs)
            continue
        csize, stages = k1l.stage_tile(h, h, ci, co, gs)
        assert csize * (k1l.MROWS // h) == h and csize <= k1l.MAX_CLUSTER
        assert 2 <= stages <= min(k1l.MAX_STAGES, ci // k1l.KC + 1)
        assert k1l.stage_smem(h, ci, stages) <= k1.SMEM_MAX
        ncb = co // k1l.NC
        for maxc in (ncb, 15, 16):
            ncl = k1l.stage_grid(b, co, maxc)
            assert ncl % ncb == 0 and ncb <= ncl <= min(maxc, ncb * b)
            # every (sample, channel block) has exactly one cluster
            per = ncl // ncb
            owners = sorted((c % ncb, c // ncb + k * per)
                            for c in range(ncl)
                            for k in range(-(-(b - c // ncb) // per)))
            assert owners == [(nb, s) for nb in range(ncb) for s in range(b)]


def test_stage_tiles_at_the_gumbel_64_shapes():
    """up3 (the preset's K1L stage): clusters of 8 with the taps of 64
    input channels resident and 3 chunks in flight; up2 as a second shape:
    clusters of 2, 128 channels of taps and a ring of 2."""
    assert k1l.stage_tile(32, 32, 64, 32, 16) == (8, 3)
    assert k1l.stage_smem(32, 64, 3) == 166464
    assert k1l.stage_tile(16, 16, 128, 64, 16) == (2, 2)
    assert k1l.stage_smem(16, 128, 2) == 228224
    assert k1l.stage_smem(16, 128, 3) > k1.SMEM_MAX
    assert [k1l.stage_grid(b, 32, 16) for b in (1, 3, 64, 1024)] == [
        1, 3, 16, 16]
    assert k1l.stage_grid(1024, 64, 15) == 14


def test_stage_grid_refuses_a_card_without_room_for_the_channel_blocks():
    with pytest.raises(ValueError, match="clusters"):
        k1l.stage_grid(64, 64, 1)


@pytest.mark.parametrize("args", [
    (8, 8, 64, 32, 16),        # W < 16
    (64, 64, 32, 16, 8),       # 32 blocks a cluster
    (32, 24, 64, 32, 16),      # W does not divide 128
    (32, 32, 48, 32, 16),      # ci not a multiple of 32
    (32, 32, 64, 48, 16),      # co not a multiple of 32
    (32, 32, 64, 96, 48),      # a group wider than a block's channels
    (16, 16, 512, 32, 16),     # taps beyond the shared memory
])
def test_stage_tile_refuses_other_shapes(args):
    with pytest.raises(ValueError, match="K1L"):
        k1l.stage_tile(*args)


def _kernel_order_stats(y, rt, group_size, eps=k1l.EPS):
    """(mu, rstd) [B, Co] from the f32 conv output y [B, 2H, 2W, Co] in the
    kernel's order: per warp (parity, 64 rows) a partial; the block's
    partial as warps 0..7 in order; the cluster's as ranks 0..n-1 in
    order; a group's channels in index order."""
    b, h2, w2, co = y.shape
    h, w = h2 // 2, w2 // 2
    csize, groups = h // rt, co // group_size
    # [b, rank, il, pa, j, pb, c] -> [b, rank, parity, m, c], m = il * W + j
    blk = y.reshape(b, csize, rt, 2, w, 2, co).permute(0, 1, 3, 5, 2, 4, 6)
    warps = blk.reshape(b, csize, NW, rt * w // 2, co)
    sums = []
    for part in (warps.sum(3), warps.square().sum(3)):
        block = torch.zeros(b, csize, co)
        for wi in range(NW):
            block = block + part[:, :, wi]
        tot = torch.zeros(b, co)
        for r in range(csize):
            tot = tot + block[:, r]
        grp = torch.zeros(b, groups)
        per_group = tot.reshape(b, groups, group_size)
        for jj in range(group_size):
            grp = grp + per_group[..., jj]
        sums.append(grp)
    cnt = 4.0 * h * w * group_size
    mean = sums[0] / cnt
    rstd = torch.rsqrt(sums[1] / cnt - mean * mean + eps)
    return (mean.repeat_interleave(group_size, 1),
            rstd.repeat_interleave(group_size, 1))


@pytest.mark.parametrize("b,h,ci,co", [(2, 32, 64, 32), (3, 16, 128, 64)])
def test_kernel_order_of_the_sums_gives_rows_stats(b, h, ci, co):
    g = torch.Generator().manual_seed(h)
    x = torch.randn(b, h, h, ci, generator=g)
    w = torch.randn(4, 4, ci, co, generator=g) * 0.05
    y = conv_transpose_2x(x, w, compute_dtype=torch.float32)
    _, s1, s2 = k1l.conv_rows_plain(x, w)
    want = k1l.rows_stats(s1, s2, 4 * h * h, group_size=16)
    got = _kernel_order_stats(y, k1l.MROWS // h, 16)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, rtol=2e-5, atol=1e-6)


def _ys_offset(par, m, w):
    """Element offset (bf16) of row m, parity par of a block's 8-channel
    chunk 0 in the staged tile: pixel pair P at 64 elements, its two
    pixels' halves swapped where P is odd (csrc: the ys store)."""
    pa, pb = par >> 1, par & 1
    il, j = m // w, m % w
    pair = (2 * il + pa) * w + j
    return pair * 64 + ((pb ^ (pair & 1)) * 32)


@pytest.mark.parametrize("w", [16, 32])
def test_unfolded_store_replays_unfold(w):
    """The staged tile written from the accumulator layout and read back
    16 bytes a lane in the kernel's order is the unfolded y of the block's
    rows; every slot is written once."""
    rt = k1l.MROWS // w
    yf = torch.randn(rt, w, 4 * k1l.NC)          # a block's folded tile
    ys = torch.full((k1l.YS_BYTES // 2,), float("nan"))
    for par in range(4):
        for m in range(k1l.MROWS):
            base = _ys_offset(par, m, w)
            for t in range(4):                   # a lane's 8 channels
                sl = slice(base + 8 * t, base + 8 * t + 8)
                assert torch.isnan(ys[sl]).all()
                ys[sl] = yf[m // w, m % w,
                            par * k1l.NC + 8 * t:par * k1l.NC + 8 * t + 8]
    out = torch.empty(2 * rt * 2 * w * k1l.NC)
    for idx in range(k1l.YS_BYTES // 16):        # the copy-out loop
        p, ch = idx >> 2, idx & 3
        pair = p >> 1
        src = pair * 64 + (((p & 1) ^ (pair & 1)) * 32) + ch * 8
        out[p * k1l.NC + ch * 8:p * k1l.NC + ch * 8 + 8] = ys[src:src + 8]
    want = k1l.unfold(yf[None])[0]
    assert torch.equal(out.reshape(2 * rt, 2 * w, k1l.NC), want)


@pytest.mark.parametrize("w", [16, 32])
def test_unfolded_store_is_free_of_bank_conflicts(w):
    """Each quarter warp of a 16-byte store (lanes 8q .. 8q+7: rows g, g+1
    of the m16 tile, chunks t = 0..3) writes eight distinct 16-byte bank
    groups, and so does each quarter warp of the copy-out's reads."""
    for par in range(4):
        for m0 in range(0, k1l.MROWS, 8):
            for q in range(4):
                groups = set()
                for lane in range(8 * q, 8 * q + 8):
                    g, t = lane >> 2, lane & 3
                    byte = 2 * (_ys_offset(par, m0 + g, w) + 8 * t)
                    groups.add(byte // 16 % 8)
                assert len(groups) == 8, (par, m0, q)
    for idx0 in range(0, k1l.YS_BYTES // 16, 8):
        groups = set()
        for idx in range(idx0, idx0 + 8):
            p, ch = idx >> 2, idx & 3
            pair = p >> 1
            groups.add((pair * 128 + (((p & 1) ^ (pair & 1)) * 64)
                        + ch * 16) // 16 % 8)
        assert len(groups) == 8


def test_plain_stage_residuals_are_the_plain_pieces():
    """On the CPU the entry runs the plain stage; its residuals are the
    folded conv and ``rows_stats`` of its sums, and no kernel launches."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 16, 16, 32, generator=g)
    w = torch.randn(4, 4, 32, 32, generator=g) * 0.05
    gamma = 1 + 0.1 * torch.randn(32, generator=g)
    beta = 0.1 * torch.randn(32, generator=g)
    n = obs.counters["k1l.fwd_launches"]
    y, yf, mu, rstd = k1l.upsample_block_rows(x, w, gamma, beta,
                                              group_size=8, residuals=True)
    assert obs.counters["k1l.fwd_launches"] == n
    yf_p, s1, s2 = k1l.conv_rows_plain(x, w)
    mu_p, rstd_p = k1l.rows_stats(s1, s2, 4 * 16 * 16, group_size=8)
    assert torch.equal(yf, yf_p) and torch.equal(mu, mu_p)
    assert torch.equal(rstd, rstd_p)
    assert torch.equal(y, k1l.upsample_block_rows(x, w, gamma, beta,
                                                  group_size=8))
    assert torch.equal(y, k1l.normalize(yf_p, mu_p, rstd_p, gamma, beta))


def test_entry_refuses_other_devices():
    x = torch.empty(2, 32, 32, 64, device="meta")
    w = torch.empty(4, 4, 64, 32, device="meta")
    g = torch.empty(32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k1l.upsample_block_rows(x, w, g, g)
    with pytest.raises(ValueError, match="CUDA"):
        k1l.upsample_block_rows(x, w, g, g, residuals=True)
