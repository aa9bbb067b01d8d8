"""K1's tiling and packing on the CPU: the tile choosers at every preset's
stage shapes, the packed weight layouts against their index formulas, the
packed-weight cache, and the wrappers' shape rules.

The CUDA kernels themselves are held to their plain versions on the card
(tests/test_torch_cuda.py); here the layouts they read are replayed with
PyTorch ops in the kernels' own order (per parity, per tap, per chunk).
"""

import gc

import pytest
import torch

from levelgan_torch import obs
from levelgan_torch.config import PRESET_NAMES, preset
from levelgan_torch.kernels import upsample_block as k1
from levelgan_torch.models import Generator
from levelgan_torch.ops.blocks import (conv_transpose_2x,
                                       conv_transpose_2x_input_grad)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BATCHES = (1, 3, 64, 1024)


def _stages(name):
    """(input H, Ci, Co, group size) of each upsample stage of a preset."""
    m = preset(name).model
    return [(4 * 2 ** i, st.kernel.shape[2], st.kernel.shape[3], m.group_size)
            for i, st in enumerate(Generator(m).stages())]


def test_there_are_nine_presets():
    assert len(PRESET_NAMES) == 9


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("name", PRESET_NAMES)
def test_forward_tile_is_inside_the_budgets(name, b):
    for h, ci, co, gs in _stages(name):
        assert k1.fits(h, h) is (h * h <= 256)      # the dispatch rule
        if not k1.fits(h, h):
            with pytest.raises(ValueError):
                k1.fwd_tile(b, h, h, ci, co, gs)
            continue
        ns, ng, stages = k1.fwd_tile(b, h, h, ci, co, gs)
        assert 1 <= ns <= k1.FWD_MAX_SAMPLES
        assert ns * h * h <= k1.FWD_MAX_ROWS
        assert ng * gs == k1.NB
        assert 2 <= stages <= k1.MAX_STAGES
        assert k1.fwd_smem(h, h, ns, stages) <= k1.SMEM_MAX
        # f32 accumulators a thread: the block's 4 parities x rows x 32
        # channels over its 2 * rows threads
        rows = -(-ns * h * h // 64) * 64
        assert 4 * rows * k1.NB // (2 * rows) == k1.ACC_REGS <= 128
        assert 2 * rows <= 512


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("name", PRESET_NAMES)
def test_dx_tile_is_inside_the_budgets(name, b):
    for h, ci, co, _ in _stages(name):
        assert k1.dx_fits(h, h, ci, co)
        nsd, rt = k1.dx_tile(b, h, h, ci, co)
        assert nsd >= 1 and rt >= 1 and h % rt == 0
        assert nsd * rt * h <= k1.MROWS_DX
        assert nsd == 1 or rt == h            # several samples only whole
        assert k1.dx_smem(h, nsd, rt) <= k1.SMEM_MAX


def test_tiles_at_the_gumbel_64_shapes():
    """The export batch shares the taps over 16 / 4 / 1 samples; a training
    batch keeps enough blocks for the card."""
    shapes = [(4, 512, 256), (8, 256, 128), (16, 128, 64)]
    assert [k1.fwd_tile(1024, h, h, ci, co, 16)[:2]
            for h, ci, co in shapes] == [(16, 2), (4, 2), (1, 2)]
    assert [k1.fwd_tile(64, h, h, ci, co, 16)[0]
            for h, ci, co in shapes] == [4, 2, 1]
    assert k1.fwd_tile(3, 4, 4, 512, 256, 8)[:2] == (4, 4)
    assert [k1.dx_tile(64, h, h, ci, co)
            for h, ci, co in shapes] == [(8, 4), (2, 8), (1, 8)]
    assert k1.dx_tile(64, 4, 4, 256, 128) == (4, 4)         # wgan_gp_32 up0
    assert k1.dx_tile(64, 32, 32, 64, 32) == (1, 4)         # K1L bwd, up3


@pytest.mark.parametrize("sms", [1, 108, 132, 1000])
def test_tiles_follow_the_sm_count(sms):
    ns = [k1.fwd_tile(1024, 4, 4, 512, 256, 16, sms)[0]]
    ns.append(k1.fwd_tile(1024, 4, 4, 512, 256, 16, 10 * sms)[0])
    assert ns[0] >= ns[1] >= 4          # more SMs never mean larger blocks
    nsd = [k1.dx_tile(64, 4, 4, 512, 256, s)[0] for s in (sms, 10 * sms)]
    assert nsd[0] >= nsd[1] >= 1


def test_ring_depth():
    # a third buffer only where an SM gets one block for the whole call ...
    assert k1.ring_depth(lambda s: s * 50_000, 100, 16, 132) == 3
    assert k1.ring_depth(lambda s: s * 50_000, 133, 16, 132) == 2
    # ... the call has three steps, and three buffers fit; 0 if two do not
    assert k1.ring_depth(lambda s: s * 1000, 100, 2, 132) == 2
    assert k1.ring_depth(lambda s: s * 100_000, 100, 16, 132) == 2
    assert k1.ring_depth(lambda s: s * 120_000, 100, 16, 132) == 0
    assert k1.fwd_tile(1024, 4, 4, 512, 256, 16)[2] == 2
    assert k1.fwd_tile(64, 4, 4, 512, 256, 16)[2] == 3


@pytest.mark.parametrize("args", [
    (64, 4, 4, 48, 32, 16),      # ci not a multiple of 32
    (64, 4, 4, 64, 32, 4),       # group size
    (64, 4, 4, 64, 24, 16),      # co not a multiple of the group size
    (64, 32, 32, 64, 32, 16),    # H*W > 256: K1L's
    (64, 3, 3, 64, 32, 16)])     # H*W not a multiple of 16
def test_forward_tile_refuses_other_shapes(args):
    with pytest.raises(ValueError):
        k1.fwd_tile(*args)


@pytest.mark.parametrize("args", [(64, 3, 3, 64, 32), (64, 16, 16, 48, 64),
                                  (64, 16, 16, 64, 48)])
def test_dx_tile_refuses_other_shapes(args):
    with pytest.raises(ValueError):
        k1.dx_tile(*args)


@pytest.mark.parametrize("ci,co", [(64, 32), (32, 64), (96, 40), (64, 16)])
def test_pack_taps_chunks_layout(ci, co):
    g = torch.Generator().manual_seed(ci + co)
    w = torch.randn(4, 4, ci, co, generator=g)
    pk = k1.pack_taps_chunks(w)
    nb = -(-co // 32)
    assert pk.shape == (nb, ci // 32, 16, 32, 32)
    assert pk.dtype == torch.bfloat16 and pk.is_contiguous()
    wb = w.to(torch.bfloat16)
    for kh, kw, i, c in [(0, 0, 0, 0), (1, 2, 7, 5), (3, 3, ci - 1, co - 1),
                         (2, 1, 33 % ci, 9)]:
        assert pk[c // 32, i // 32, kh * 4 + kw, c % 32, i % 32] == wb[kh, kw,
                                                                      i, c]
    # round trip, and zeros for the channels beyond Co
    back = pk.permute(2, 1, 4, 0, 3).reshape(4, 4, ci, nb * 32)
    assert torch.equal(back[..., :co], wb)
    assert not bool(back[..., co:].any())


@pytest.mark.parametrize("ci,co", [(64, 32), (32, 64), (96, 64)])
def test_pack_taps_dx_layout(ci, co):
    g = torch.Generator().manual_seed(ci * co)
    w = torch.randn(4, 4, ci, co, generator=g)
    pk = k1.pack_taps_dx(w)
    assert pk.shape == (ci // 32, 4, co // 32, 4, 32, 32)
    assert pk.dtype == torch.bfloat16 and pk.is_contiguous()
    wb = w.to(torch.bfloat16)
    for a, b, r, s, i, c in [(0, 0, 0, 0, 0, 0), (1, 0, 0, 1, 7, 5),
                             (1, 1, 1, 1, ci - 1, co - 1),
                             (0, 1, 1, 0, 33 % ci, 40 % co)]:
        assert pk[i // 32, 2 * a + b, c // 32, 2 * r + s, i % 32,
                  c % 32] == wb[a + 2 * r, b + 2 * s, i, c]
    # round trip: [nb, a, b, kc, r, s, n, k] -> [r, a, s, b, nb, n, kc, k]
    back = pk.reshape(ci // 32, 2, 2, co // 32, 2, 2, 32, 32).permute(
        4, 1, 5, 2, 0, 6, 3, 7).reshape(4, 4, ci, co)
    assert torch.equal(back, wb)


@pytest.mark.parametrize("h,w_,ci,co", [(4, 4, 64, 40), (8, 8, 32, 32),
                                        (2, 8, 32, 64)])
def test_forward_from_packed_chunks_is_the_transposed_conv(h, w_, ci, co):
    """The kernel's loop order replayed on the CPU: per channel block, chunk,
    parity (a, b) and tap (r, s), the input window shifted by (a + r, b + s)
    times the packed tap (a + 2r) * 4 + b + 2s."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, h, w_, ci, generator=g).to(torch.bfloat16).float()
    w = torch.randn(4, 4, ci, co, generator=g)
    pk = k1.pack_taps_chunks(w).float()
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    y = torch.zeros(2, 2 * h, 2 * w_, pk.shape[0] * 32)
    for nb in range(pk.shape[0]):
        for kc in range(ci // 32):
            for a, b in k1.PARITIES:
                for r in (0, 1):
                    for s in (0, 1):
                        win = xp[:, a + r:a + r + h, b + s:b + s + w_,
                                 kc * 32:kc * 32 + 32]
                        tap = (a + 2 * r) * 4 + b + 2 * s
                        y[:, a::2, b::2, nb * 32:nb * 32 + 32] += (
                            win @ pk[nb, kc, tap].T)
    want = conv_transpose_2x(x, w.to(torch.bfloat16).float(),
                             compute_dtype=torch.float32)
    torch.testing.assert_close(y[..., :co], want, atol=1e-4, rtol=1e-4)
    assert not bool(y[..., co:].any())


@pytest.mark.parametrize("h,w_,ci,co", [(4, 4, 64, 32), (8, 8, 32, 64),
                                        (2, 8, 32, 32)])
def test_dx_from_packed_steps_is_the_input_gradient(h, w_, ci, co):
    """The dx kernel's loop order replayed on the CPU: per channel block,
    parity plane (a, b) with a one-position zero halo, chunk and tap
    (r, s), the window at offset (2 - a - r, 2 - b - s)."""
    g = torch.Generator().manual_seed(4)
    dy = torch.randn(2, 2 * h, 2 * w_, co, generator=g)
    w = torch.randn(4, 4, ci, co, generator=g)
    pk = k1.pack_taps_dx(w).float()
    dx = torch.zeros(2, h, w_, ci)
    for nb in range(ci // 32):
        for a, b in k1.PARITIES:
            plane = torch.nn.functional.pad(dy[:, a::2, b::2],
                                            (0, 0, 1, 1, 1, 1))
            for kc in range(co // 32):
                for r in (0, 1):
                    for s in (0, 1):
                        u, v = 2 - a - r, 2 - b - s
                        win = plane[:, u:u + h, v:v + w_,
                                    kc * 32:kc * 32 + 32]
                        dx[..., nb * 32:nb * 32 + 32] += (
                            win @ pk[nb, 2 * a + b, kc, 2 * r + s].T)
    want = conv_transpose_2x_input_grad(dy, w.to(torch.bfloat16).float())
    torch.testing.assert_close(dx, want, atol=1e-3, rtol=1e-4)


def test_m_rows_of_a_4x4_plane_cover_the_plane_once():
    """The kernels take the 16 rows of an M tile at a 4x4 plane as image
    rows 0, 2, 1, 3 (bank-conflict-free ldmatrix rows): a permutation."""
    seen = {(((p >> 2) & 1) * 2 + (p >> 3), p & 3) for p in range(16)}
    assert seen == {(i, j) for i in range(4) for j in range(4)}
    # the 8 rows of each ldmatrix matrix, as positions of the haloed 6-wide
    # grid, fall in 8 distinct 16-byte bank groups at an 80-byte pitch
    for half in (range(8), range(8, 16)):
        pos = [(((p >> 2) & 1) * 2 + (p >> 3)) * 6 + (p & 3) for p in half]
        assert len({q * k1.ROW_BYTES % 128 for q in pos}) == 8


def test_packed_is_kept_per_weight_version():
    k1._pack_cache.clear()
    w = torch.randn(4, 4, 32, 32)
    first = k1.packed(w, k1.pack_taps_chunks)
    assert k1.packed(w, k1.pack_taps_chunks) is first
    assert k1.packed(w.detach(), k1.pack_taps_chunks) is first   # same storage
    assert k1.packed(w, k1.pack_taps_dx) is not first            # by packing
    with torch.no_grad():
        w.mul_(2.0)                            # as an optimizer step does
    second = k1.packed(w, k1.pack_taps_chunks)
    assert second is not first
    assert torch.equal(second, k1.pack_taps_chunks(w))
    assert k1.packed(w, k1.pack_taps_chunks) is second


def test_packed_forgets_dead_weights_and_inference_tensors():
    k1._pack_cache.clear()
    w = torch.randn(4, 4, 32, 32)
    k1.packed(w, k1.pack_taps_chunks)
    key = next(iter(k1._pack_cache))
    del w
    gc.collect()
    assert k1._pack_cache[key][0]() is None      # the owner is gone ...
    w2 = torch.randn(4, 4, 32, 32)
    got = k1.packed(w2, k1.pack_taps_chunks)     # ... and is swept
    assert torch.equal(got, k1.pack_taps_chunks(w2))
    assert all(v[0]() is not None for v in k1._pack_cache.values())
    with torch.inference_mode():
        wi = torch.randn(4, 4, 32, 32)
        n = len(k1._pack_cache)
        assert torch.equal(k1.packed(wi, k1.pack_taps_dx),
                           k1.pack_taps_dx(wi))
        assert len(k1._pack_cache) == n
    for _ in range(3 * k1.PACK_CACHE_MAX):
        k1.packed(torch.randn(4, 4, 32, 32), k1.pack_taps_dx)
    assert len(k1._pack_cache) <= k1.PACK_CACHE_MAX


def test_packed_tells_a_strided_view_from_its_weight():
    """A transposed view shares pointer and shape with a square weight but
    is another weight: it must not be handed the first one's packing."""
    k1._pack_cache.clear()
    w = torch.randn(4, 4, 32, 32)
    wt = w.transpose(2, 3)
    first = k1.packed(w, k1.pack_taps_chunks)
    got = k1.packed(wt, k1.pack_taps_chunks)
    assert got is not first
    assert torch.equal(got, k1.pack_taps_chunks(wt))
    assert k1.packed(w, k1.pack_taps_chunks) is first


def test_packs_counts_the_misses_only():
    k1._pack_cache.clear()
    w = torch.randn(4, 4, 32, 32)
    obs.reset()
    for _ in range(3):
        k1.packed(w, k1.pack_taps_chunks)
    assert obs.counters["k1.packs"] == 1
    with torch.no_grad():
        w.add_(1.0)
    k1.packed(w, k1.pack_taps_chunks)
    assert obs.counters["k1.packs"] == 2
    with torch.inference_mode():
        wi = torch.randn(4, 4, 32, 32)
        k1.packed(wi, k1.pack_taps_chunks)
        k1.packed(wi, k1.pack_taps_chunks)
    assert obs.counters["k1.packs"] == 4


def test_generate_builds_its_generator_outside_inference_mode(monkeypatch):
    """``generate`` given a state_dict (as the export CLI gives it) must
    hold ordinary tensors, or ``packed`` would pack anew at every launch."""
    from levelgan_torch import export as texport
    from levelgan_torch.config import preset
    from levelgan_torch.models import Generator

    cfg = preset("toy_dcgan_16")
    src = Generator(cfg.model).init_params(torch.Generator().manual_seed(0))
    built = []
    make = texport.make_generator

    def spy(*args):
        built.append(make(*args))
        return built[-1]

    monkeypatch.setattr(texport, "make_generator", spy)
    levels = texport.generate(cfg, src.state_dict(), 4, batch_size=2,
                              device="cpu")
    assert levels.shape[0] == 4
    (gen,) = built
    assert not any(p.is_inference() for p in gen.parameters())
    assert not torch.is_inference_mode_enabled()


def test_wrappers_still_refuse_other_devices_and_run_plain_on_the_cpu():
    meta = dict(device="meta")
    x = torch.empty(2, 4, 4, 64, dtype=torch.bfloat16, **meta)
    w = torch.empty(4, 4, 64, 32, **meta)
    c = torch.empty(32, **meta)
    with pytest.raises(ValueError):
        k1.upsample_block_fwd(x, w, c, c)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 4, 4, 64, generator=g)
    w = torch.randn(4, 4, 64, 32, generator=g) * 0.05
    gamma, beta = torch.ones(32), torch.zeros(32)
    n = (obs.counters["k1.fwd_launches"], obs.counters["k1.bwd_launches"],
         obs.counters["k1l.bwd_launches"])
    y, ypre, mu, rstd = k1.upsample_block_fwd(x, w, gamma, beta,
                                              residuals=True)
    dx, dy, dgamma, dbeta = k1.upsample_block_bwd(w, gamma, beta, mu, rstd,
                                                  torch.ones_like(y), ypre)
    assert y.shape == (2, 8, 8, 32) and dx.shape == x.shape
    assert dy.shape == y.shape and dgamma.shape == dbeta.shape == (32,)
    # the plain versions launch nothing
    assert (obs.counters["k1.fwd_launches"], obs.counters["k1.bwd_launches"],
            obs.counters["k1l.bwd_launches"]) == n
