"""K2 fused's plan on the CPU: the weight pack against the HWIO weight
element by element, the shared-memory layout at every shape the kernel
takes, the two blocks' halves of the channels, the bulk-copy sizes, and
the kernel's GEMM index math replayed with PyTorch ops.

The CUDA kernel itself is held to its plain version on the card
(tests/test_torch_cuda.py); here its formulas (kernels/critic_grad.py
mirrors them: passes, smem_layout, pack_weights_plain) are replayed: which
weight lands where in a block's stream, which grid row an ldmatrix lane
reads at each K step, which output position an accumulator row holds.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from levelgan_torch.config import PRESET_NAMES, preset
from levelgan_torch.kernels import critic_grad as k2f
from levelgan_torch.models.critic import critic_channels
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (M0, channels, group size): the five card cases of tests/test_torch_cuda.py
CARD_CASES = [(16, (64, 128, 256), 16), (8, (64, 128), 16),
              (16, (64, 128, 256), 16), (8, (64, 128), 8),
              (16, (64, 64, 128), 8)]
SHAPES = sorted({(m0, ch) for m0, ch, _ in CARD_CASES})


def _preset_shapes():
    out = []
    for name in PRESET_NAMES:
        m = preset(name).model
        if k2f.fused_supported(m):
            chans = tuple(critic_channels(m))
            out.append((name, m.level_size // 2, chans, m.group_size))
    return out


def _accepted_shapes():
    """Every (M0, channels) the shape rule and the previous one-block
    kernel's shared memory (f32 normalised values, a ring of 2-4 chunks of
    rows padded to 72 bf16) admitted: the kernel still takes each."""
    def old_smem(m0, chans):
        n = len(chans) - 1
        off = sum((m0 // 2 ** i + 2) ** 2 * (c + 8) * 2
                  for i, c in enumerate(chans))
        off += sum((m0 // 2 ** i) ** 2 * chans[i] * 4 for i in range(1, n + 1))
        cmax, depth = max(chans), 4
        tail = 5 * cmax * 4
        while depth > 2 and off + depth * cmax * 144 + tail > k2f.MAX_SMEM:
            depth -= 1
        return off + depth * cmax * 144 + tail

    cs = range(64, 513, 64)
    out = []
    for n, m0 in ((1, 8), (2, 16)):
        for chans in (tuple(c) for c in np.ndindex(*(8,) * (n + 1))):
            chans = tuple(cs[i] for i in chans)
            tasks = max(max((m0 >> i) ** 2 // 16 * (chans[i] // 16),
                            (m0 >> i) ** 2 // 16 * (chans[i - 1] // 16))
                        for i in range(1, n + 1))
            if tasks <= k2f.MAX_TASKS and old_smem(m0, chans) <= k2f.MAX_SMEM:
                out.append((m0, chans))
    return out


def test_every_shape_the_previous_kernel_took_still_fits():
    shapes = _accepted_shapes()
    assert (16, (64, 128, 256)) in shapes and len(shapes) > 40
    for m0, chans in shapes:
        depth = k2f.ring_depth(m0, chans)
        assert 2 <= depth <= k2f.MAX_DEPTH
        assert k2f.smem_layout(m0, chans, depth)["total"] <= k2f.MAX_SMEM


@pytest.mark.parametrize("m0,chans,gs", CARD_CASES)
def test_shared_memory_at_the_card_cases(m0, chans, gs):
    depth = k2f.ring_depth(m0, chans)
    lay = k2f.smem_layout(m0, chans, depth)
    assert lay["total"] <= k2f.MAX_SMEM
    # every region 16-byte aligned (uint4 stores, ldmatrix rows, bulk copies)
    for key in ("part", "red", "stats"):
        assert lay[key] % 16 == 0
    assert all(o % 16 == 0 for o in lay["grid"] + lay["y"])
    assert lay["bars"] % 8 == 0
    if chans == (64, 128, 256):       # the wgan_gp_32 critic: >= 96 KB
        assert depth * k2f.CHUNK_BYTES >= 96 * 1024


@pytest.mark.parametrize("name,m0,chans,gs", _preset_shapes())
def test_shared_memory_at_the_fused_presets(name, m0, chans, gs):
    assert k2f.smem_layout(m0, chans, k2f.ring_depth(m0, chans))["total"] \
        <= k2f.MAX_SMEM


def test_fused_presets_include_wgan_gp_32():
    assert ("wgan_gp_32", 16, (64, 128, 256), 16) in _preset_shapes()


@pytest.mark.parametrize("m0,chans", _accepted_shapes()[::5]
                         + [(16, (64, 128, 256)), (8, (64, 128))])
def test_passes_cover_every_tile_and_step_once(m0, chans):
    """The warps' tasks (csrc: make_tasks) cover each (plane, M tile, 32
    columns) of a pass once per K group, the K groups split the steps, a warp
    has at most MAXT tasks, and a pass is a whole number of chunks."""
    for ps in k2f.passes(m0, chans):
        ntasks = ps["ntiles"] * ps["ksplit"]
        assert ntasks <= 4 * k2f.NCW
        assert ps["ksplit"] == 1 or ntasks <= k2f.NCW
        assert ps["steps"] % ps["ksplit"] == 0
        assert (ps["steps"] * ps["planes"] * ps["ng"]) % k2f.CHUNK_SUBS == 0
        seen = {}
        for warp in range(k2f.NCW):
            for i in range(4):
                tau = warp + i * k2f.NCW
                if tau >= ntasks:
                    continue
                tile = tau % ps["ntiles"]
                per = ps["planes"] * ps["ng"]
                key = (tile // per, (tile % per) // ps["ng"], tile % ps["ng"],
                       tau // ps["ntiles"])
                assert key not in seen
                seen[key] = warp
        assert len(seen) == ntasks


@pytest.mark.parametrize("m0,chans,gs", CARD_CASES)
def test_halves_cover_each_channel_once_and_no_group_straddles(m0, chans, gs):
    for c in chans[1:] + chans[:1]:
        nh = c // k2f.CS
        owner = np.full(c, -1)
        for r in range(k2f.CS):
            for ng in range(nh // k2f.SUB_ROWS):
                for n in range(k2f.SUB_ROWS):
                    ch = r * nh + ng * k2f.SUB_ROWS + n
                    assert owner[ch] == -1
                    owner[ch] = r
        assert (owner >= 0).all()
        groups = owner.reshape(-1, gs)
        assert (groups == groups[:, :1]).all()
        assert nh // gs <= k2f.GMAX


@pytest.mark.parametrize("m0,chans", SHAPES)
def test_bulk_copies_are_whole_16_byte_runs(m0, chans):
    assert k2f.CHUNK_BYTES % 16 == 0 and k2f.SUB_BYTES % 16 == 0
    elems = k2f.stream_elems(chans)
    assert (elems * 2) % k2f.CHUNK_BYTES == 0
    assert sum(p["chunks"] for p in k2f.passes(m0, chans)) * \
        k2f.CHUNK_BYTES == elems * 2
    lay = k2f.smem_layout(m0, chans, k2f.ring_depth(m0, chans))
    assert lay["ring"] % 128 == 0


def _weights(chans, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((4, 4, ci, co), generator=g)
            for ci, co in zip(chans[:-1], chans[1:])]


@pytest.mark.parametrize("m0,chans", SHAPES + [(8, (128, 192)),
                                               (16, (64, 128, 320))])
def test_pack_matches_the_hwio_weight_element_by_element(m0, chans):
    """Walk each block's stream with the kernel's own decoding (csrc:
    critic_trunk_pack_kernel): pass, sub-unit -> (step, plane, 32-column
    group), row n, stored unit p -> K unit p ^ (n % 8)."""
    ws = _weights(chans)
    got = k2f.pack_weights_plain(ws).float().numpy()
    assert got.shape == (k2f.CS, k2f.stream_elems(chans))
    wb = [w.to(torch.bfloat16).float().numpy() for w in ws]
    for r in range(k2f.CS):
        off = 0
        for ps in k2f.passes(m0, chans):
            w = wb[ps["layer"] - 1]
            ci, co = w.shape[2], w.shape[3]
            nsub = ps["chunks"] * k2f.CHUNK_SUBS
            sub, n, p, e = np.meshgrid(np.arange(nsub), np.arange(32),
                                       np.arange(8), np.arange(8),
                                       indexing="ij")
            per = ps["planes"] * ps["ng"]
            step, plane, ng = sub // per, (sub % per) // ps["ng"], sub % ps["ng"]
            tap, kc = step // ps["kch"], step % ps["kch"]
            k = kc * 64 + (p ^ (n % 8)) * 8 + e
            if ps["fwd"]:
                want = w[tap // 4, tap % 4, k, r * (co // 2) + ng * 32 + n]
            else:
                cy, cx, ry, rx = plane >> 1, plane & 1, tap >> 1, tap & 1
                want = w[1 - cy + 2 * ry, 1 - cx + 2 * rx,
                         r * (ci // 2) + ng * 32 + n, k]
            size = nsub * k2f.SUB_BYTES // 2
            np.testing.assert_array_equal(got[r, off:off + size],
                                          want.reshape(-1))
            off += size
        assert off == got.shape[1]


def _pos_of(m, mo):
    """csrc pos_of: rows of a 4 x 4 output taken as image rows 0, 2, 1, 3."""
    if mo == 4:
        return ((m >> 2) & 1) * 2 + ((m >> 3) & 1), m & 3
    return m // mo, m % mo


def _replay_pass(ps, stream, r, off, grid, wp):
    """The products of one block's pass as the kernel forms them: sub-units
    in stream order, each row of M gathered from the haloed grid [wp * wp, C]
    at its base position plus its step's offset.  Returns [planes, M, Nh]."""
    mo, kch = ps["mo"], ps["kch"]
    nh = ps["ng"] * 32
    out = torch.zeros(ps["planes"], mo * mo, nh, dtype=torch.float64)
    nsub = ps["chunks"] * k2f.CHUNK_SUBS
    subs = stream[r, off:off + nsub * 2048].double().reshape(nsub, 32, 8, 8)
    unswz = torch.arange(8)[None, :] ^ (torch.arange(32)[:, None] % 8)
    subs = torch.gather(subs, 2, unswz[None, :, :, None].expand(
        nsub, 32, 8, 8)).reshape(nsub, 32, 64)
    per = ps["planes"] * ps["ng"]
    for s in range(nsub):
        step, plane, ng = s // per, (s % per) // ps["ng"], s % ps["ng"]
        tap, kc = step // kch, step % kch
        cy, cx = plane >> 1, plane & 1
        for m in range(mo * mo):
            i, j = _pos_of(m, mo)
            if ps["fwd"]:
                pos = 2 * i * wp + 2 * j + (tap // 4) * wp + tap % 4
            else:
                pos = ((i + 1 + cy) * wp + j + 1 + cx
                       - ((tap >> 1) * wp + (tap & 1)))
            a = grid[pos, kc * 64:(kc + 1) * 64]
            out[plane, m, ng * 32:(ng + 1) * 32] += subs[s] @ a
    return out


@pytest.mark.parametrize("m0,chans", [(8, (64, 128)), (16, (64, 64, 128))])
def test_replayed_passes_give_the_conv_and_its_input_gradient(m0, chans):
    """Each block's forward pass gives its half of conv4x4s2(x), each
    reverse pass its half of the conv's input gradient, plane by plane."""
    ws = _weights(chans, seed=1)
    stream = k2f.pack_weights_plain(ws)
    g = torch.Generator().manual_seed(2)
    for r in range(k2f.CS):
        off = 0
        for ps in k2f.passes(m0, chans):
            w = ws[ps["layer"] - 1].to(torch.bfloat16).double()
            ci, co = w.shape[2], w.shape[3]
            mo = ps["mo"]
            side, c = (2 * mo, ci) if ps["fwd"] else (mo, co)
            x = torch.randn((side, side, c), generator=g, dtype=torch.float64)
            grid = torch.zeros((side + 2, side + 2, c), dtype=torch.float64)
            grid[1:-1, 1:-1] = x
            got = _replay_pass(ps, stream, r, off, grid.reshape(-1, c),
                               side + 2)
            xn = x.permute(2, 0, 1)[None]
            wt = w.permute(3, 2, 0, 1)
            if ps["fwd"]:
                want = F.conv2d(xn, wt, stride=2, padding=1)[0].permute(1, 2, 0)
                nh = co // 2
                for m in range(mo * mo):
                    i, j = _pos_of(m, mo)
                    torch.testing.assert_close(
                        got[0, m], want[i, j, r * nh:(r + 1) * nh])
            else:
                want = F.conv_transpose2d(xn, wt, stride=2, padding=1)[0]
                want = want.permute(1, 2, 0)
                nh = ci // 2
                for plane in range(4):
                    cy, cx = plane >> 1, plane & 1
                    for m in range(mo * mo):
                        u, v = _pos_of(m, mo)
                        torch.testing.assert_close(
                            got[plane, m],
                            want[2 * u + cy, 2 * v + cx, r * nh:(r + 1) * nh])
            off += ps["chunks"] * k2f.CHUNK_SUBS * 2048


def test_pack_weights_on_the_cpu_is_the_plain_pack():
    ws = _weights((64, 128, 256))
    assert torch.equal(k2f.pack_weights(ws), k2f.pack_weights_plain(ws))


def test_ring_depth_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        k2f.ring_depth(16, (512, 512, 512))


def _grid_row(m, mo, cy, cx, st, wp):
    """csrc grid_row: the haloed grid row that accumulator row m writes."""
    i, j = _pos_of(m, mo)
    return (st * i + cy + 1) * wp + st * j + cx + 1


@pytest.mark.parametrize("m0,chans", SHAPES)
def test_epilogue_stores_cover_every_interior_cell_once(m0, chans):
    """Each pass's epilogue (both blocks, the tasks of K group 0, 16 rows,
    the quad-transposed 16-byte stores of 8 channels) writes every interior
    (position, channel) of the grid it fills exactly once and no halo cell:
    a_l forward, the cotangent of a_{l-1} (or dy0) backward."""
    for ps in k2f.passes(m0, chans):
        lay = ps["layer"]
        side = ps["mo"] if ps["fwd"] else 2 * ps["mo"]
        c = chans[lay] if ps["fwd"] else chans[lay - 1]
        wp, nh = side + 2, c // k2f.CS
        hits = np.zeros((wp * wp, c), dtype=int)
        for r in range(k2f.CS):
            for tile in range(ps["ntiles"]):
                per = ps["planes"] * ps["ng"]
                mtile, plane, ng = tile // per, (tile % per) // ps["ng"], \
                    tile % ps["ng"]
                for row in range(16):
                    m = mtile * 16 + row
                    at = (_grid_row(m, ps["mo"], 0, 0, 1, wp) if ps["fwd"]
                          else _grid_row(m, ps["mo"], plane >> 1, plane & 1,
                                         2, wp))
                    for t in range(4):
                        c0 = r * nh + ng * 32 + 8 * t
                        hits[at, c0:c0 + 8] += 1
        hits = hits.reshape(wp, wp, c)
        assert (hits[1:-1, 1:-1] == 1).all()
        hits[1:-1, 1:-1] = 0
        assert not hits.any()
