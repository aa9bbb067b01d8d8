"""Port kernels on the card: each CUDA kernel against its plain version.

Marked ``cuda``: these skip on hosts without an NVIDIA GPU.  On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import pytest
import torch

from levelgan_torch import obs

pytestmark = pytest.mark.cuda

# bf16 tolerance: 4 ulps relative plus 2^-6 absolute (see chip_smoke.py)
ATOL = RTOL = 2.0 ** -6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, ci, co, device, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn((b, h, h, ci), generator=g, device=device)
    w = torch.randn((4, 4, ci, co), generator=g, device=device) * 0.05
    gamma = 1 + 0.1 * torch.randn(co, generator=g, device=device)
    beta = 0.1 * torch.randn(co, generator=g, device=device)
    return x.to(torch.bfloat16), w, gamma, beta


def _assert_close(a, b):
    a, b = a.float(), b.float()
    assert torch.all((a - b).abs() <= ATOL + RTOL * b.abs()), \
        float((a - b).abs().max())


# the last three: the wgan_gp_32 stages (two groups per sample at up2)
@pytest.mark.parametrize("b,h,ci,co,gs", [(3, 4, 128, 64, 16),
                                          (2, 8, 64, 32, 8),
                                          (2, 16, 64, 64, 16),
                                          (4, 4, 256, 128, 16),
                                          (4, 8, 128, 64, 16),
                                          (4, 16, 64, 32, 16)])
def test_k1_matches_plain(cuda, b, h, ci, co, gs):
    from levelgan_torch.kernels import upsample_block as k1
    from levelgan_torch.ops.blocks import upsample_block
    x, w, gamma, beta = _inputs(b, h, ci, co, cuda)
    n = obs.counters["k1.fwd_launches"]
    y = k1.upsample_block_fwd(x, w, gamma, beta, group_size=gs)
    assert obs.counters["k1.fwd_launches"] == n + 1
    _assert_close(y, upsample_block(x, w, gamma, beta, group_size=gs))


# K1L stage shapes (H, Ci, Co): gumbel_64 up3, up2 as a second shape, and
# up3 at model.base_channels=128 (the backward's general kernel)
K1L_SHAPES = [(32, 64, 32), (16, 128, 64), (32, 128, 64)]


@pytest.mark.parametrize("h,ci,co", K1L_SHAPES)
@pytest.mark.parametrize("b", [2, 5])
def test_k1l_matches_plain(cuda, b, h, ci, co):
    from levelgan_torch.kernels import upsample_rows as k1l
    x, w, gamma, beta = _inputs(b, h, ci, co, cuda, seed=1)
    n = obs.counters["k1l.fwd_launches"]
    y = k1l.upsample_block_rows(x, w, gamma, beta)
    torch.cuda.synchronize()
    assert obs.counters["k1l.fwd_launches"] == n + 1
    _assert_close(y, k1l.upsample_block_rows_plain(x, w, gamma, beta))


def test_kernel_wrappers_raise_on_bad_shapes(cuda):
    from levelgan_torch.kernels import upsample_block as k1
    x, w, gamma, beta = _inputs(2, 4, 48, 32, cuda)   # ci not a multiple of 64
    with pytest.raises(ValueError):
        k1.upsample_block_fwd(x, w, gamma, beta)


def _rel_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


# a sum over many bf16 products (dx, dgamma, dbeta): max |diff| / max |ref|
SUM_TOL = 2.0 ** -6


@pytest.mark.parametrize("b,h,ci,co,gs", [(4, 4, 512, 256, 16),
                                          (4, 8, 256, 128, 16),
                                          (2, 16, 128, 64, 8),
                                          (4, 4, 256, 128, 16),
                                          (4, 8, 128, 64, 16),
                                          (4, 16, 64, 32, 16)])
def test_k1_bwd_matches_plain(cuda, b, h, ci, co, gs):
    from levelgan_torch.kernels import upsample_block as k1
    x, w, gamma, beta = _inputs(b, h, ci, co, cuda, seed=2)
    _, ypre, mu, rstd = k1.upsample_block_fwd(x, w, gamma, beta,
                                              group_size=gs, residuals=True)
    g = torch.randn(ypre.shape, device=cuda).to(torch.bfloat16)
    n = obs.counters["k1.bwd_launches"]
    got = k1.upsample_block_bwd(w, gamma, beta, mu, rstd, g, ypre,
                                group_size=gs)
    torch.cuda.synchronize()
    assert obs.counters["k1.bwd_launches"] == n + 1
    want = k1.upsample_block_bwd_plain(w, gamma, beta, mu, rstd, g, ypre,
                                       group_size=gs)
    for name, a, r in zip(("dx", "dy", "dgamma", "dbeta"), got, want):
        assert _rel_err(a, r) <= SUM_TOL, name


def _k1l_bwd_inputs(b, h, ci, co, device, seed, gs=16):
    """The K1L backward's inputs from the stage kernel with residuals: g,
    yf, mu, rstd, gamma, beta, w."""
    from levelgan_torch.kernels import upsample_rows as k1l
    x, w, gamma, beta = _inputs(b, h, ci, co, device, seed=seed)
    _, yf, mu, rstd = k1l.upsample_block_rows(x, w, gamma, beta,
                                              group_size=gs, residuals=True)
    g = torch.randn((b, 2 * h, 2 * h, co), device=device,
                    generator=torch.Generator(device).manual_seed(seed + 1))
    return g.to(torch.bfloat16), yf, mu, rstd, gamma, beta, w


def _assert_k1l_bwd_matches_plain(args, gs=16):
    """The K1L backward kernel against its plain chain: dx, dyf, dgamma and
    dbeta by SUM_TOL, one launch."""
    from levelgan_torch.kernels import upsample_rows as k1l
    n = obs.counters["k1l.bwd_launches"]
    got = k1l.upsample_rows_bwd(*args, group_size=gs)
    torch.cuda.synchronize()
    assert obs.counters["k1l.bwd_launches"] == n + 1
    want = k1l.upsample_rows_bwd_plain(*args, group_size=gs)
    for name, a, r in zip(("dx", "dyf", "dgamma", "dbeta"), got, want):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert _rel_err(a, r) <= SUM_TOL, name
    return got


@pytest.mark.parametrize("b,h,ci,co", [(2, 32, 64, 32), (2, 16, 128, 64),
                                       (2, 32, 128, 64), (3, 32, 64, 96)])
def test_k1l_bwd_matches_plain(cuda, b, h, ci, co):
    _assert_k1l_bwd_matches_plain(_k1l_bwd_inputs(b, h, ci, co, cuda, 3))


# K2 core's widths: the flattened input gradient at gumbel_64, wgan_gp_32
# and the 16x16 presets
K2_WIDTHS = (64 * 64 * 8, 32 * 32 * 8, 16 * 16 * 8)


@pytest.mark.parametrize("f", K2_WIDTHS)
@pytest.mark.parametrize("b", [1, 3, 64])
def test_norm_penalty_matches_plain(cuda, b, f):
    from levelgan_torch.kernels import gp_penalty as k2
    g2 = torch.randn((b, f), device=cuda) * 0.01
    ct = torch.randn(b, device=cuda)
    pen, norm = k2.norm_penalty_fwd(g2)
    pen_p, norm_p = k2.norm_penalty_fwd_plain(g2)
    torch.testing.assert_close(norm, norm_p, atol=0, rtol=1e-5)
    torch.testing.assert_close(pen, pen_p, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(k2.norm_penalty_bwd(g2, norm, ct),
                               k2.norm_penalty_bwd_plain(g2, norm_p, ct),
                               atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("f", K2_WIDTHS)
@pytest.mark.parametrize("b", [3, 64])
def test_norm_penalty_fwd_is_bit_reproducible(cuda, b, f):
    from levelgan_torch.kernels import gp_penalty as k2
    g2 = torch.randn((b, f), device=cuda)
    pen, norm = k2.norm_penalty_fwd(g2)
    again = k2.norm_penalty_fwd(g2)
    assert torch.equal(pen, again[0]) and torch.equal(norm, again[1])


@pytest.mark.parametrize("b, f", [(5, 32916), (64, 64 * 64 * 9),
                                  (64, 128 * 128 * 8), (2, 262148)])
def test_norm_penalty_at_rows_longer_than_a_chunk(cuda, b, f):
    """gumbel_64 with model.n_tiles=9 or model.level_size=128, a row that
    ends inside a chunk, and one of 65,537 float4s: the forward reads them
    in several chunks."""
    from levelgan_torch.kernels import gp_penalty as k2
    g2 = torch.randn((b, f), device=cuda) * 0.01
    ct = torch.randn(b, device=cuda)
    pen, norm = k2.norm_penalty_fwd(g2)
    pen_p, norm_p = k2.norm_penalty_fwd_plain(g2)
    torch.testing.assert_close(norm, norm_p, atol=0, rtol=1e-5)
    torch.testing.assert_close(pen, pen_p, atol=1e-6, rtol=1e-5)
    assert torch.equal(k2.norm_penalty_fwd(g2)[1], norm)
    torch.testing.assert_close(k2.norm_penalty_bwd(g2, norm, ct),
                               k2.norm_penalty_bwd_plain(g2, norm, ct),
                               atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("f", K2_WIDTHS)
def test_norm_penalty_bwd_takes_a_stride0_cotangent(cuda, f):
    from levelgan_torch.kernels import gp_penalty as k2
    g2 = torch.randn((64, f), device=cuda)
    _, norm = k2.norm_penalty_fwd(g2)
    ct0 = torch.full((), 1 / 64, device=cuda).expand(64)
    assert ct0.stride() == (0,)
    assert torch.equal(k2.norm_penalty_bwd(g2, norm, ct0),
                       k2.norm_penalty_bwd(g2, norm, ct0.contiguous()))


def test_norm_penalty_plans_that_do_not_fit_raise(cuda, monkeypatch):
    """A plan the C side refuses raises without counting a launch, and the
    next call runs."""
    from levelgan_torch.kernels import gp_penalty as k2
    g2 = torch.randn((4, 2048), device=cuda)
    pen, norm = k2.norm_penalty_fwd(g2)
    dg = k2.norm_penalty_bwd(g2, norm, torch.ones(4, device=cuda))
    n = (obs.counters["k2.fwd_launches"], obs.counters["k2.bwd_launches"])
    monkeypatch.setattr(k2, "fwd_plan", lambda *a: k2.FwdPlan(32, 3))
    monkeypatch.setattr(k2, "bwd_plan", lambda *a: k2.BwdPlan(1, 32))
    with pytest.raises(RuntimeError, match="norm_penalty_fwd"):
        k2.norm_penalty_fwd(g2)
    with pytest.raises(RuntimeError, match="norm_penalty_bwd"):
        k2.norm_penalty_bwd(g2, norm, torch.ones(4, device=cuda))
    assert (obs.counters["k2.fwd_launches"],
            obs.counters["k2.bwd_launches"]) == n
    monkeypatch.undo()
    assert torch.equal(k2.norm_penalty_fwd(g2)[0], pen)
    assert torch.equal(
        k2.norm_penalty_bwd(g2, norm, torch.ones(4, device=cuda)), dg)


def _trunk_inputs(b, m0, chans, has_gn, device, seed=4):
    g = torch.Generator(device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    pre = randn(b, m0, m0, chans[0])
    a0 = torch.where(pre >= 0, pre, 0.2 * pre)
    layers = [(0.05 * randn(4, 4, ci, co), 0.1 * randn(co),
               1 + 0.1 * randn(co) if has_gn else None,
               0.1 * randn(co) if has_gn else None)
              for ci, co in zip(chans[:-1], chans[1:])]
    return a0, layers, 0.05 * randn(4, 4, chans[-1])


# K2 fused, per sample (chip_smoke.py's rule): the two sides sum in another
# order, so now and then a GroupNorm output of the last trunk layer lands on
# the other side of zero, the LeakyReLU mask flips and a patch of that
# sample's dy0 moves by a few percent
FLIP_TOL = 0.1


def _assert_samples_close(got, want):
    diff = (got.float() - want.float()).abs()
    per = diff.amax(dim=tuple(range(1, diff.ndim))) / want.float().abs().max()
    assert float(per.max()) <= FLIP_TOL
    assert float(torch.quantile(per, 0.75, interpolation="higher")) <= SUM_TOL


@pytest.mark.parametrize("b,m0,chans,has_gn,gs", [
    (64, 16, (64, 128, 256), True, 16), (64, 8, (64, 128), True, 16),
    (8, 16, (64, 128, 256), False, 16), (8, 8, (64, 128), True, 8),
    (64, 16, (64, 64, 128), True, 8)],
    ids=["wgan_gp_32", "16x16", "32x32_nonorm", "16x16_gs8", "32x32_narrow"])
def test_k2_fused_matches_plain(cuda, b, m0, chans, has_gn, gs):
    from levelgan_torch.kernels import critic_grad as k2f
    a0, layers, head_w = _trunk_inputs(b, m0, chans, has_gn, cuda)
    a0 = a0.to(torch.bfloat16)
    n = obs.counters["k2f.launches"]
    got = k2f.critic_trunk_grad(a0, layers, head_w, group_size=gs)
    torch.cuda.synchronize()
    assert obs.counters["k2f.launches"] == n + 1
    assert got.shape == a0.shape and got.dtype == torch.bfloat16
    want = k2f.critic_trunk_grad_plain(a0, layers, head_w, group_size=gs)
    _assert_samples_close(got, want)
    # the border rows and columns are where a wrong tap offset shows
    for edge in (got[:, 0], got[:, -1], got[:, :, 0], got[:, :, -1]):
        assert bool(edge.float().abs().max() > 0)


def test_k2_fused_probe_stamps_every_phase(cuda):
    from levelgan_torch.kernels import critic_grad as k2f
    a0, layers, head_w = _trunk_inputs(4, 16, (64, 128, 256), True, cuda)
    probe = torch.zeros(10, dtype=torch.int64, device=cuda)
    got = k2f.critic_trunk_grad(a0.to(torch.bfloat16), layers, head_w,
                                probe=probe)
    want = k2f.critic_trunk_grad(a0.to(torch.bfloat16), layers, head_w)
    assert torch.equal(got, want)               # the probe changes nothing
    stamps = probe.tolist()
    assert len(k2f.phase_names(2)) == len(stamps) - 1
    assert all(b > a > 0 for a, b in zip(stamps, stamps[1:]))
    with pytest.raises(ValueError, match="probe"):
        k2f.critic_trunk_grad(a0.to(torch.bfloat16), layers, head_w,
                              probe=probe[:4])


def test_k2_fused_is_bit_reproducible_at_wgan_gp_32(cuda):
    from levelgan_torch.kernels import critic_grad as k2f
    a0, layers, head_w = _trunk_inputs(64, 16, (64, 128, 256), True, cuda,
                                       seed=7)
    a0 = a0.to(torch.bfloat16)
    first = k2f.critic_trunk_grad(a0, layers, head_w)
    assert torch.equal(k2f.critic_trunk_grad(a0, layers, head_w), first)


@pytest.mark.parametrize("b", [1, 3, 65])
def test_k2_fused_odd_batches(cuda, b):
    """One cluster of two blocks per sample: a batch of one, an odd batch,
    and one sample beyond the 64 that fill the card's SMs twice over."""
    from levelgan_torch.kernels import critic_grad as k2f
    a0, layers, head_w = _trunk_inputs(b, 16, (64, 128, 256), True, cuda,
                                       seed=8)
    a0 = a0.to(torch.bfloat16)
    got = k2f.critic_trunk_grad(a0, layers, head_w)
    _assert_samples_close(got, k2f.critic_trunk_grad_plain(a0, layers,
                                                           head_w))
    # each sample alone gives the same bits
    for i in (0, b - 1):
        assert torch.equal(k2f.critic_trunk_grad(a0[i:i + 1].contiguous(),
                                                 layers, head_w), got[i:i + 1])


@pytest.mark.parametrize("m0,chans", [(16, (64, 128, 256)), (8, (64, 128)),
                                      (16, (64, 64, 128))])
def test_k2_fused_pack_and_shared_memory_match_the_plain_plan(cuda, m0,
                                                              chans):
    from levelgan_torch.kernels import critic_grad as k2f
    ws = [torch.randn((4, 4, ci, co), device=cuda)
          for ci, co in zip(chans[:-1], chans[1:])]
    assert torch.equal(k2f.pack_weights(ws).cpu(),
                       k2f.pack_weights_plain([w.cpu() for w in ws]))
    lib = k2f._lib()
    c3 = list(chans) + [0] * (3 - len(chans))
    for depth in (2, k2f.ring_depth(m0, chans)):
        assert lib.critic_trunk_grad_smem(len(chans) - 1, m0, *c3, depth) == \
            k2f.smem_layout(m0, chans, depth)["total"]


def test_k2_fused_refused_cluster_launch_raises(cuda, monkeypatch):
    """A ring too deep for the shared memory: the launch is refused, the
    wrapper raises once, and the next call runs."""
    from levelgan_torch.kernels import critic_grad as k2f
    a0, layers, head_w = _trunk_inputs(4, 16, (64, 128, 256), True, cuda,
                                       seed=9)
    a0 = a0.to(torch.bfloat16)
    before = k2f.critic_trunk_grad(a0, layers, head_w)
    assert k2f.smem_layout(16, (64, 128, 256), 12)["total"] > k2f.MAX_SMEM
    n = obs.counters["k2f.launches"]
    monkeypatch.setattr(k2f, "ring_depth", lambda *a: 12)
    with pytest.raises(RuntimeError, match="critic_trunk_grad"):
        k2f.critic_trunk_grad(a0, layers, head_w)
    assert obs.counters["k2f.launches"] == n
    monkeypatch.undo()
    assert torch.equal(k2f.critic_trunk_grad(a0, layers, head_w), before)


def test_k2_fused_raises_for_f32_and_bad_shapes(cuda):
    from levelgan_torch.kernels import critic_grad as k2f
    a0, layers, head_w = _trunk_inputs(2, 8, (64, 128), True, cuda)
    n = obs.counters["k2f.launches"]
    with pytest.raises(ValueError, match="bf16"):
        k2f.critic_trunk_grad(a0, layers, head_w)            # f32 a0
    a0 = a0.to(torch.bfloat16)
    with pytest.raises(ValueError, match="group_size"):
        k2f.critic_trunk_grad(a0, layers, head_w, group_size=4)
    with pytest.raises(ValueError, match="trunk layers"):
        k2f.critic_trunk_grad(a0, layers * 2, head_w)
    narrow = _trunk_inputs(2, 8, (32, 64), True, cuda)
    with pytest.raises(ValueError, match="multiples of 64"):
        k2f.critic_trunk_grad(narrow[0].to(torch.bfloat16), *narrow[1:])
    assert obs.counters["k2f.launches"] == n


def test_fused_gp_matches_plain_gp_at_wgan_gp_32(cuda):
    """The fused GP's value and its gradient for every critic parameter
    against the plain GP, both in bf16 on the card."""
    from levelgan_torch.config import preset
    from levelgan_torch.kernels import critic_grad as k2f
    from levelgan_torch.models import Critic
    from levelgan_torch.ops.grad_penalty import gradient_penalty

    m = preset("wgan_gp_32").model
    critic = Critic(m).init_params(torch.Generator().manual_seed(0)).to(cuda)
    g = torch.Generator(cuda).manual_seed(1)
    shape = (16, m.level_size, m.level_size, m.n_tiles)
    real = torch.nn.functional.one_hot(
        torch.randint(0, m.n_tiles, shape[:3], generator=g, device=cuda),
        m.n_tiles).float()
    fake = torch.softmax(torch.randn(shape, generator=g, device=cuda), -1)
    eps = torch.rand((16, 1, 1, 1), generator=g, device=cuda)
    params = list(critic.parameters())
    n = obs.counters["k2f.launches"]
    val = k2f.gradient_penalty_fused(critic, real, fake, None, eps)
    grads = torch.autograd.grad(val, params, allow_unused=True)
    assert obs.counters["k2f.launches"] == n + 1
    ref = gradient_penalty(critic, real, fake, None, eps)
    ref_g = torch.autograd.grad(ref, params, allow_unused=True)
    assert abs(float(val.detach()) - float(ref.detach())) <= 0.02 * abs(
        float(ref.detach()))
    for (name, _), a, r in zip(critic.named_parameters(), grads, ref_g):
        if r is None:
            assert a is None or not bool(a.abs().max() > 0), name
        else:
            assert _rel_err(a, r) <= 0.05, name


def test_kernel_generator_backward_reaches_every_parameter(cuda):
    """Backward through the stage Functions gives every generator parameter
    a non-zero gradient.  The kernel and plain paths round to bf16 at
    different points over four stages, so each is held to an f32 copy of
    the generator: the kernels' gradient at most twice as far from it as
    the plain bf16 path's, plus 0.02 (chip_smoke.py's rule)."""
    import dataclasses

    from levelgan_torch.config import preset
    from levelgan_torch.models import Generator

    m = preset("gumbel_64").model
    gen = Generator(m).init_params(torch.Generator().manual_seed(0)).to(cuda)
    gen32 = Generator(dataclasses.replace(m, dtype="float32"))
    gen32.load_state_dict(gen.state_dict())
    gen32 = gen32.to(cuda)
    z = torch.randn((8, m.latent_dim), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    w = torch.randn((8, 64, 64, m.n_tiles), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(2))
    counts = (obs.counters["k1.bwd_launches"],
              obs.counters["k1l.bwd_launches"])
    params = list(gen.parameters())
    got = torch.autograd.grad((gen(z) * w).sum(), params)
    torch.cuda.synchronize()
    assert (obs.counters["k1.bwd_launches"] - counts[0],
            obs.counters["k1l.bwd_launches"] - counts[1]) == (3, 1)
    plain = torch.autograd.grad((gen(z, plain=True) * w).sum(), params)
    ref = torch.autograd.grad((gen32(z, plain=True) * w).sum(),
                              list(gen32.parameters()))
    for (name, _), a, p, r in zip(gen.named_parameters(), got, plain, ref):
        assert a is not None and bool(a.abs().max() > 0), name
        assert _rel_err(a, r) <= 2 * _rel_err(p, r) + 0.02, name


# ---- K1's tiles: ragged batches, sample independence, reproducibility -----

# per plane size: (H, Ci, Co); weights from randn are symmetric in no axis
K1_PLANES = {4: (4, 128, 64), 8: (8, 64, 64), 16: (16, 64, 32)}


def _k1_fwd_all(k1, x, w, gamma, beta, gs):
    return k1.upsample_block_fwd(x, w, gamma, beta, group_size=gs,
                                 residuals=True)


def _assert_fwd_matches_plain(k1, x, w, gamma, beta, gs):
    y, ypre, mu, rstd = _k1_fwd_all(k1, x, w, gamma, beta, gs)
    torch.cuda.synchronize()
    y_p, ypre_p, mu_p, rstd_p = k1.upsample_block_fwd_plain(
        x, w, gamma, beta, group_size=gs)
    _assert_close(y, y_p)
    _assert_close(ypre, ypre_p)
    torch.testing.assert_close(mu, mu_p, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(rstd, rstd_p, atol=1e-3, rtol=1e-3)
    assert torch.equal(
        y, k1.upsample_block_fwd(x, w, gamma, beta, group_size=gs))


@pytest.mark.parametrize("gs", [8, 16])
@pytest.mark.parametrize("h", [4, 8, 16])
def test_k1_fwd_ragged_batches_at_the_chosen_tile(cuda, h, gs):
    """B = 1, 3, one more than the largest NS, and 64, at the tile the
    wrapper chooses for each."""
    from levelgan_torch.kernels import upsample_block as k1
    _, ci, co = K1_PLANES[h]
    for b in (1, 3, 256 // (h * h) + 1, 64):
        x, w, gamma, beta = _inputs(b, h, ci, co, cuda, seed=10 + b)
        _assert_fwd_matches_plain(k1, x, w, gamma, beta, gs)


@pytest.mark.parametrize("gs", [8, 16])
@pytest.mark.parametrize("h,ns", [(4, 4), (4, 8), (4, 16), (8, 1), (8, 2),
                                  (8, 4), (16, 1)])
def test_k1_fwd_ragged_batches_at_every_tile(cuda, monkeypatch, h, ns, gs):
    """Every NS the chooser can return, forced, with B not a multiple of it
    (missing samples are zero-filled and never stored) and every ring
    depth that fits."""
    from levelgan_torch.kernels import upsample_block as k1
    _, ci, co = K1_PLANES[h]
    for stages in (2, 3):
        if k1.fwd_smem(h, h, ns, stages) > k1.SMEM_MAX:
            continue
        monkeypatch.setattr(k1, "fwd_tile",
                            lambda *a, st=stages: (ns, 32 // gs, st))
        for b in (1, 3, ns + 1):
            x, w, gamma, beta = _inputs(b, h, ci, co, cuda, seed=20 + b)
            _assert_fwd_matches_plain(k1, x, w, gamma, beta, gs)


@pytest.mark.parametrize("co,gs", [(48, 16), (40, 8), (16, 16)])
def test_k1_fwd_channels_beyond_a_block_are_masked(cuda, co, gs):
    from levelgan_torch.kernels import upsample_block as k1
    x, w, gamma, beta = _inputs(5, 8, 64, co, cuda, seed=30)
    _assert_fwd_matches_plain(k1, x, w, gamma, beta, gs)


def test_k1_fwd_shared_memory_formula_matches_the_source(cuda):
    from levelgan_torch.kernels import upsample_block as k1
    lib = k1._lib()
    for h, ns, stages in [(4, 16, 2), (4, 4, 3), (8, 4, 3), (16, 1, 2)]:
        assert lib.upsample_block_fwd_smem(h, h, ns, stages) == k1.fwd_smem(
            h, h, ns, stages)


def _k1_bwd_case(k1, b, h, ci, co, gs, device, seed):
    x, w, gamma, beta = _inputs(b, h, ci, co, device, seed=seed)
    _, ypre, mu, rstd = _k1_fwd_all(k1, x, w, gamma, beta, gs)
    g = torch.randn(ypre.shape, device=device,
                    generator=torch.Generator(device).manual_seed(seed + 1)
                    ).to(torch.bfloat16)
    return w, gamma, beta, mu, rstd, g, ypre


def _assert_bwd_matches_plain(k1, args, gs):
    got = k1.upsample_block_bwd(*args, group_size=gs)
    torch.cuda.synchronize()
    want = k1.upsample_block_bwd_plain(*args, group_size=gs)
    for name, a, r in zip(("dx", "dy", "dgamma", "dbeta"), got, want):
        assert _rel_err(a, r) <= SUM_TOL, name


@pytest.mark.parametrize("gs", [8, 16])
@pytest.mark.parametrize("h", [4, 8, 16])
def test_k1_bwd_ragged_batches_at_the_chosen_tile(cuda, h, gs):
    from levelgan_torch.kernels import upsample_block as k1
    _, ci, co = K1_PLANES[h]
    for b in (1, 3, 128 // (h * h) + 1, 64):
        args = _k1_bwd_case(k1, b, h, ci, co, gs, cuda, seed=40 + b)
        _assert_bwd_matches_plain(k1, args, gs)


@pytest.mark.parametrize("h,nsd", [(4, 1), (4, 2), (4, 4), (4, 8), (8, 1),
                                   (8, 2)])
def test_k1_bwd_ragged_batches_at_every_tile(cuda, monkeypatch, h, nsd):
    """Every sample count a dx block can take, forced, with B not a multiple
    of it."""
    from levelgan_torch.kernels import upsample_block as k1
    _, ci, co = K1_PLANES[h]
    monkeypatch.setattr(k1, "dx_tile", lambda *a: (nsd, h))
    for b in (1, 3, nsd + 1):
        args = _k1_bwd_case(k1, b, h, ci, co, 16, cuda, seed=50 + b)
        _assert_bwd_matches_plain(k1, args, 16)


@pytest.mark.parametrize("h", [4, 8, 16])
def test_k1_samples_are_independent(cuda, h):
    """Changing sample j leaves every other sample's y, ypre, mu, rstd, dx
    and dy bit-identical: no halo bleeds into a neighbour, no statistic is
    cut at the wrong row."""
    from levelgan_torch.kernels import upsample_block as k1
    _, ci, co = K1_PLANES[h]
    b, j = 7, 2
    x, w, gamma, beta = _inputs(b, h, ci, co, cuda, seed=60)
    x2 = x.clone()
    x2[j] = torch.randn(x[j].shape, device=cuda).to(torch.bfloat16)
    keep = [i for i in range(b) if i != j]
    one = _k1_fwd_all(k1, x, w, gamma, beta, 16)
    two = _k1_fwd_all(k1, x2, w, gamma, beta, 16)
    for name, a, c in zip(("y", "ypre", "mu", "rstd"), one, two):
        assert torch.equal(a[keep], c[keep]), name
        assert not torch.equal(a[j], c[j]), name
    _, ypre, mu, rstd = one
    g = torch.randn(ypre.shape, device=cuda).to(torch.bfloat16)
    g2, ypre2 = g.clone(), ypre.clone()
    g2[j] = torch.randn(g[j].shape, device=cuda).to(torch.bfloat16)
    ypre2[j] = two[1][j]
    dx, dy, _, _ = k1.upsample_block_bwd(w, gamma, beta, mu, rstd, g, ypre)
    dx2, dy2, _, _ = k1.upsample_block_bwd(w, gamma, beta, mu, rstd, g2,
                                           ypre2)
    for name, a, c in (("dx", dx, dx2), ("dy", dy, dy2)):
        assert torch.equal(a[keep], c[keep]), name
        assert not torch.equal(a[j], c[j]), name


@pytest.mark.parametrize("b,h", [(64, 4), (5, 8), (3, 16)])
def test_k1_is_bit_reproducible(cuda, b, h):
    """No atomics in K1: two calls give the same bits, forward and
    backward (dgamma / dbeta included)."""
    from levelgan_torch.kernels import upsample_block as k1
    _, ci, co = K1_PLANES[h]
    x, w, gamma, beta = _inputs(b, h, ci, co, cuda, seed=70)
    one = _k1_fwd_all(k1, x, w, gamma, beta, 16)
    two = _k1_fwd_all(k1, x, w, gamma, beta, 16)
    for name, a, c in zip(("y", "ypre", "mu", "rstd"), one, two):
        assert torch.equal(a, c), name
    _, ypre, mu, rstd = one
    g = torch.randn(ypre.shape, device=cuda).to(torch.bfloat16)
    args = (w, gamma, beta, mu, rstd, g, ypre)
    for name, a, c in zip(("dx", "dy", "dgamma", "dbeta"),
                          k1.upsample_block_bwd(*args),
                          k1.upsample_block_bwd(*args)):
        assert torch.equal(a, c), name


def test_k1_packed_weights_follow_in_place_updates(cuda):
    """The packed weight is kept per weight version: after an optimizer
    step on ``w`` the next forward and backward use the new values."""
    from levelgan_torch.kernels import upsample_block as k1
    x, w, gamma, beta = _inputs(4, 8, 64, 32, cuda, seed=80)
    w = torch.nn.Parameter(w)
    opt = torch.optim.SGD([w], lr=0.5)
    _, ypre, mu, rstd = _k1_fwd_all(k1, x, w, gamma, beta, 16)
    g = torch.randn(ypre.shape, device=cuda).to(torch.bfloat16)
    dx = k1.upsample_block_bwd(w.detach(), gamma, beta, mu, rstd, g, ypre)[0]
    w.grad = torch.randn_like(w)
    opt.step()                                   # in place, as in training
    out = _k1_fwd_all(k1, x, w, gamma, beta, 16)
    want = k1.upsample_block_fwd_plain(x, w.detach(), gamma, beta)
    assert not torch.equal(out[1], ypre)
    _assert_close(out[0], want[0])
    _assert_close(out[1], want[1])
    dx2 = k1.upsample_block_bwd(w.detach(), gamma, beta, mu, rstd, g, ypre)[0]
    assert not torch.equal(dx, dx2)
    assert _rel_err(dx2, k1.upsample_block_bwd_plain(
        w.detach(), gamma, beta, mu, rstd, g, ypre)[0]) <= SUM_TOL


@pytest.mark.parametrize("b", [1, 3, 5])
def test_k1l_bwd_matches_plain_at_odd_batches(cuda, b):
    _assert_k1l_bwd_matches_plain(_k1l_bwd_inputs(b, 32, 64, 32, cuda, 90))


def test_k1_fwd_probe_stamps_every_phase(cuda):
    from levelgan_torch.kernels import upsample_block as k1
    x, w, gamma, beta = _inputs(8, 8, 64, 32, cuda, seed=95)
    probe = torch.zeros(len(k1.FWD_PHASES) + 1, dtype=torch.int64,
                        device=cuda)
    got = k1.upsample_block_fwd(x, w, gamma, beta, probe=probe)
    assert torch.equal(got, k1.upsample_block_fwd(x, w, gamma, beta))
    stamps = probe.tolist()
    assert all(b >= a > 0 for a, b in zip(stamps, stamps[1:]))
    assert stamps[-1] > stamps[0]
    with pytest.raises(ValueError, match="probe"):
        k1.upsample_block_fwd(x, w, gamma, beta, probe=probe[:2])


def test_export_from_a_state_dict_packs_each_k1_weight_once(cuda):
    """``generate`` given a state_dict, as the export CLI gives it, packs a
    K1 weight once for all its batches, not once per launch."""
    from levelgan_torch.config import preset
    from levelgan_torch.export import generate
    from levelgan_torch.kernels import upsample_block as k1
    from levelgan_torch.models import Generator
    cfg = preset("toy_dcgan_16")
    gen = Generator(cfg.model).init_params(torch.Generator().manual_seed(0))
    n_k1 = sum(k1.fits(4 * 2 ** i, 4 * 2 ** i) for i in range(gen.n_stages))
    obs.reset()
    levels = generate(cfg, gen.state_dict(), 24, batch_size=4, device=cuda)
    assert levels.shape == (24, 16, 16)
    assert obs.counters["k1.fwd_launches"] == 6 * n_k1 and n_k1 > 0
    assert obs.counters["k1.packs"] == n_k1


def test_k1_packing_tells_a_transposed_weight_from_the_weight(cuda):
    from levelgan_torch.kernels import upsample_block as k1
    x, w, gamma, beta = _inputs(4, 8, 32, 32, cuda, seed=97)
    wt = w.transpose(2, 3)                 # same pointer, same shape
    first = k1.upsample_block_fwd(x, w, gamma, beta)
    got = k1.upsample_block_fwd(x, wt, gamma, beta)
    assert not torch.equal(got, first)
    _assert_close(got, k1.upsample_block_fwd_plain(
        x, wt.contiguous(), gamma, beta)[0])


# ---- K1L's stage kernel: clusters, persistent grid, residuals -------------

def _k1l_grid(k1l, device, h, ci, co):
    """(clusters the card holds, samples per wave) at a K1L shape."""
    csize, stages = k1l.stage_tile(h, h, ci, co, 16)
    maxc = k1l.max_clusters(device, csize, h, ci, stages)
    return maxc, maxc // (co // k1l.NC)


def _assert_k1l_residuals_match_plain(k1l, x, w, gamma, beta):
    y, yf, mu, rstd = k1l.upsample_block_rows(x, w, gamma, beta,
                                              residuals=True)
    torch.cuda.synchronize()
    yf_p, s1, s2 = k1l.conv_rows_plain(x, w)
    mu_p, rstd_p = k1l.rows_stats(s1, s2, 4 * x.shape[1] * x.shape[2])
    _assert_close(yf, yf_p)
    assert _rel_err(mu, mu_p) <= 1e-4 and _rel_err(rstd, rstd_p) <= 1e-4
    _assert_close(y, k1l.normalize(yf_p, mu_p, rstd_p, gamma, beta))
    assert torch.equal(y, k1l.upsample_block_rows(x, w, gamma, beta))


@pytest.mark.parametrize("h,ci,co", K1L_SHAPES)
def test_k1l_ragged_batches_across_the_persistent_grid(cuda, h, ci, co):
    """B = 1, 3, one more than a wave of clusters and two waves and three:
    the clusters of the last wave that have no sample store nothing."""
    from levelgan_torch.kernels import upsample_rows as k1l
    maxc, per = _k1l_grid(k1l, cuda, h, ci, co)
    assert maxc >= 1 and per >= 1
    for b in (1, 3, per + 1, 2 * per + 3):
        x, w, gamma, beta = _inputs(b, h, ci, co, cuda, seed=100 + b)
        _assert_k1l_residuals_match_plain(k1l, x, w, gamma, beta)


@pytest.mark.parametrize("gs", [8, 32])
def test_k1l_residuals_match_plain_at_other_group_sizes(cuda, gs):
    from levelgan_torch.kernels import upsample_rows as k1l
    x, w, gamma, beta = _inputs(3, 32, 64, 32, cuda, seed=110)
    y, yf, mu, rstd = k1l.upsample_block_rows(x, w, gamma, beta,
                                              group_size=gs, residuals=True)
    want = k1l.upsample_block_rows_plain(x, w, gamma, beta, group_size=gs,
                                         residuals=True)
    _assert_close(y, want[0])
    _assert_close(yf, want[1])
    assert _rel_err(mu, want[2]) <= 1e-4 and _rel_err(rstd, want[3]) <= 1e-4


@pytest.mark.parametrize("h,ci,co", K1L_SHAPES)
def test_k1l_is_bit_reproducible(cuda, h, ci, co):
    """No atomics: two calls give the same y, yf, mu and rstd bits."""
    from levelgan_torch.kernels import upsample_rows as k1l
    x, w, gamma, beta = _inputs(37, h, ci, co, cuda, seed=120)
    one = k1l.upsample_block_rows(x, w, gamma, beta, residuals=True)
    two = k1l.upsample_block_rows(x, w, gamma, beta, residuals=True)
    for name, a, c in zip(("y", "yf", "mu", "rstd"), one, two):
        assert torch.equal(a, c), name


@pytest.mark.parametrize("h,ci,co", K1L_SHAPES)
def test_k1l_samples_are_independent(cuda, h, ci, co):
    """Changing sample j leaves every other sample's outputs bit-identical:
    no cluster reads another sample's partials or rows."""
    from levelgan_torch.kernels import upsample_rows as k1l
    b, j = 9, 4
    x, w, gamma, beta = _inputs(b, h, ci, co, cuda, seed=130)
    x2 = x.clone()
    x2[j] = torch.randn(x[j].shape, device=cuda).to(torch.bfloat16)
    keep = [i for i in range(b) if i != j]
    one = k1l.upsample_block_rows(x, w, gamma, beta, residuals=True)
    two = k1l.upsample_block_rows(x2, w, gamma, beta, residuals=True)
    for name, a, c in zip(("y", "yf", "mu", "rstd"), one, two):
        assert torch.equal(a[keep], c[keep]), name
        assert not torch.equal(a[j], c[j]), name


def test_k1l_packed_weights_follow_in_place_updates(cuda):
    from levelgan_torch.kernels import upsample_rows as k1l
    x, w, gamma, beta = _inputs(4, 32, 64, 32, cuda, seed=140)
    w = torch.nn.Parameter(w)
    opt = torch.optim.SGD([w], lr=0.5)
    before = k1l.upsample_block_rows(x, w, gamma, beta)
    w.grad = torch.randn_like(w)
    opt.step()                                   # in place, as in training
    after = k1l.upsample_block_rows(x, w, gamma, beta)
    assert not torch.equal(after, before)
    _assert_close(after, k1l.upsample_block_rows_plain(x, w.detach(), gamma,
                                                       beta))


def test_k1l_shared_memory_formula_matches_the_source(cuda):
    from levelgan_torch.kernels import upsample_rows as k1l
    lib = k1l._lib()
    for w, ci, stages in [(32, 64, 3), (32, 64, 2), (16, 128, 2)]:
        assert lib.upsample_rows_stage_smem(w, ci, stages) == k1l.stage_smem(
            w, ci, stages)


def test_k1l_refused_cluster_launch_raises(cuda, monkeypatch):
    """A ring too deep for the shared memory: the occupancy query and the
    launch both fail, the wrapper raises, and the next call runs."""
    from levelgan_torch.kernels import upsample_rows as k1l
    x, w, gamma, beta = _inputs(2, 32, 64, 32, cuda, seed=150)
    assert k1l.stage_smem(32, 64, 8) > 232448
    monkeypatch.setattr(k1l, "stage_tile", lambda *a: (8, 8))
    with pytest.raises(RuntimeError):
        k1l.upsample_block_rows(x, w, gamma, beta)
    monkeypatch.setattr(k1l, "max_clusters", lambda *a: 16)
    with pytest.raises(RuntimeError, match="upsample_rows_stage"):
        k1l.upsample_block_rows(x, w, gamma, beta)
    monkeypatch.undo()
    _assert_close(k1l.upsample_block_rows(x, w, gamma, beta),
                  k1l.upsample_block_rows_plain(x, w, gamma, beta))


def test_k1l_refuses_shapes_outside_the_cluster_rule(cuda):
    from levelgan_torch.kernels import upsample_rows as k1l
    x, w, gamma, beta = _inputs(2, 64, 32, 32, cuda, seed=160)
    with pytest.raises(ValueError, match="cluster"):
        k1l.upsample_block_rows(x, w, gamma, beta)


# ---- K1L's backward kernel: clusters, persistent grid, batch sums ---------

@pytest.mark.parametrize("h,ci,co", K1L_SHAPES)
def test_k1l_bwd_one_wave_plus_one(cuda, h, ci, co):
    """One sample more than the card's clusters: a cluster takes a second
    sample, the others none, and the batch sums see every sample."""
    from levelgan_torch.kernels import upsample_rows as k1l
    general, rt, slots = k1l.bwd_plan(h, h, ci, co, 16)
    maxc = k1l.max_bwd_clusters(cuda, h, h, rt, ci, co, slots, general)
    assert maxc >= 1
    _assert_k1l_bwd_matches_plain(_k1l_bwd_inputs(maxc + 1, h, ci, co, cuda,
                                                  170))


@pytest.mark.parametrize("gs", [8, 32])
def test_k1l_bwd_matches_plain_at_other_group_sizes(cuda, gs):
    _assert_k1l_bwd_matches_plain(
        _k1l_bwd_inputs(3, 32, 64, 32, cuda, 175, gs=gs), gs=gs)


@pytest.mark.parametrize("h,ci,co", K1L_SHAPES)
def test_k1l_bwd_is_bit_reproducible(cuda, h, ci, co):
    """No atomics in the sums: two calls give the same dx, dyf, dgamma and
    dbeta bits."""
    from levelgan_torch.kernels import upsample_rows as k1l
    args = _k1l_bwd_inputs(37, h, ci, co, cuda, 180)
    one = k1l.upsample_rows_bwd(*args)
    two = k1l.upsample_rows_bwd(*args)
    for name, a, c in zip(("dx", "dyf", "dgamma", "dbeta"), one, two):
        assert torch.equal(a, c), name


def test_k1l_bwd_takes_a_non_contiguous_g(cuda):
    """g as an NCHW tensor's permute: the wrapper copies it, same bits."""
    from levelgan_torch.kernels import upsample_rows as k1l
    g, *rest = _k1l_bwd_inputs(4, 32, 64, 32, cuda, 185)
    g_nc = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not g_nc.is_contiguous() and torch.equal(g_nc, g)
    got = _assert_k1l_bwd_matches_plain((g_nc, *rest))
    for a, c in zip(got, k1l.upsample_rows_bwd(g, *rest)):
        assert torch.equal(a, c)


def test_k1l_bwd_shared_memory_formula_matches_the_source(cuda):
    from levelgan_torch.kernels import upsample_rows as k1l
    lib = k1l._lib()
    for args in [(32, 4, 64, 32, 4), (16, 4, 128, 64, 2), (16, 8, 128, 64, 3),
                 (64, 2, 32, 64, 8)]:
        assert lib.upsample_rows_bwd_smem(*args) == k1l.bwd_smem(*args)
    for w, ci, slots in [(32, 128, 3), (32, 64, 3), (128, 96, 4), (16, 32, 2)]:
        assert (lib.upsample_rows_bwd_general_smem(w, 128 // w, ci, slots)
                == k1l.bwd_general_smem(w, ci, slots))


def test_k1l_bwd_general_kernel_at_other_group_sizes_and_rings(cuda):
    """The general kernel with groups of 8 and 32 channels, and with its
    weight resident (Co = 32 at Ci = 128) as well as streamed."""
    from levelgan_torch.kernels import upsample_rows as k1l
    for gs, (h, ci, co) in [(8, (32, 128, 64)), (32, (32, 128, 32))]:
        general, _, slots = k1l.bwd_plan(h, h, ci, co, gs)
        assert general and (slots == co // 8) == (co == 32)
        _assert_k1l_bwd_matches_plain(
            _k1l_bwd_inputs(3, h, ci, co, cuda, 205, gs=gs), gs=gs)


@pytest.mark.parametrize("h,ci,co", K1L_SHAPES[:2])
def test_k1l_bwd_general_kernel_at_the_staged_shapes(cuda, monkeypatch, h,
                                                     ci, co):
    """The general kernel where the wrapper runs the staged one (its plan
    set by hand): the same function, and two calls give the same bits."""
    from levelgan_torch.kernels import upsample_rows as k1l
    rt, slots = k1l.bwd_general_tile(h, h, ci, co, 16)
    monkeypatch.setattr(k1l, "bwd_plan", lambda *a: (True, rt, slots))
    args = _k1l_bwd_inputs(5, h, ci, co, cuda, 215)
    one = _assert_k1l_bwd_matches_plain(args)
    for a, c in zip(one, k1l.upsample_rows_bwd(*args)):
        assert torch.equal(a, c)


def test_k1l_bwd_general_kernel_takes_no_probe(cuda):
    from levelgan_torch.kernels import upsample_rows as k1l
    args = _k1l_bwd_inputs(2, 32, 128, 64, cuda, 210)
    probe = torch.zeros(len(k1l.BWD_PHASES), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="probe"):
        k1l.upsample_rows_bwd(*args, probe=probe)


def test_k1l_bwd_refused_launch_raises(cuda, monkeypatch):
    """A ring too deep for the shared memory: the occupancy query and the
    launch both fail, the wrapper raises, and the next call runs."""
    from levelgan_torch.kernels import upsample_rows as k1l
    args = _k1l_bwd_inputs(2, 32, 64, 32, cuda, 190)
    assert k1l.bwd_smem(32, 4, 64, 32, 8) > 232448
    monkeypatch.setattr(k1l, "bwd_tile", lambda *a: (4, 8))
    with pytest.raises(RuntimeError):
        k1l.upsample_rows_bwd(*args)
    monkeypatch.setattr(k1l, "max_bwd_clusters", lambda *a: 16)
    n = obs.counters["k1l.bwd_launches"]
    with pytest.raises(RuntimeError, match="upsample_rows_bwd"):
        k1l.upsample_rows_bwd(*args)
    assert obs.counters["k1l.bwd_launches"] == n
    monkeypatch.undo()
    _assert_k1l_bwd_matches_plain(args)


def test_k1l_bwd_refuses_what_it_does_not_take(cuda):
    from levelgan_torch.kernels import upsample_rows as k1l
    g, yf, mu, rstd, gamma, beta, w = _k1l_bwd_inputs(2, 32, 64, 32, cuda,
                                                      195)
    with pytest.raises(ValueError, match="bf16 g"):
        k1l.upsample_rows_bwd(g.float(), yf, mu, rstd, gamma, beta, w)
    with pytest.raises(ValueError, match="yf"):
        k1l.upsample_rows_bwd(g, yf.float(), mu, rstd, gamma, beta, w)
    with pytest.raises(ValueError, match="mu"):
        k1l.upsample_rows_bwd(g, yf, mu[:1], rstd, gamma, beta, w)
    with pytest.raises(ValueError, match="groups"):
        k1l.upsample_rows_bwd(g, yf, mu, rstd, gamma, beta, w,
                              group_size=10)


def test_k1l_bwd_probe_times_every_phase(cuda):
    from levelgan_torch.kernels import upsample_rows as k1l
    args = _k1l_bwd_inputs(20, 32, 64, 32, cuda, 200)
    probe = torch.zeros(len(k1l.BWD_PHASES), dtype=torch.int64, device=cuda)
    got = k1l.upsample_rows_bwd(*args, probe=probe)
    for a, c in zip(got, k1l.upsample_rows_bwd(*args)):
        assert torch.equal(a, c)
    assert all(t > 0 for t in probe.tolist()), probe.tolist()
    with pytest.raises(ValueError, match="probe"):
        k1l.upsample_rows_bwd(*args, probe=probe[:2])


# the fused sampling head (kernels/sample_ids.py): bit for bit against its
# plain version, which is decode(sample_head(...))'s chain of operations
HEAD_SCALES = (0.01, 0.1, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0)


def _head_ids(logits, u, tau):
    from levelgan_torch.kernels import sample_ids as k
    n = obs.counters["head.launches"]
    got = k.gumbel_ids(logits, u, tau)
    assert obs.counters["head.launches"] == n + 1
    want = k.gumbel_ids_plain(logits, u, tau)
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("tau", [0.5, 0.7])
def test_fused_head_matches_plain_at_gumbel_64(cuda, tau):
    g = torch.Generator(cuda).manual_seed(23)
    for scale in HEAD_SCALES:
        logits = scale * torch.randn((1024, 64, 64, 8), generator=g,
                                     device=cuda)
        _head_ids(logits, torch.rand(logits.shape, generator=g, device=cuda),
                  tau)


@pytest.mark.parametrize("tau", [0.5, 0.7])
@pytest.mark.parametrize("t", [1, 2, 5, 8, 16, 23, 24, 32])
def test_fused_head_matches_plain_at_every_tile_count(cuda, t, tau):
    """Ragged tiles (1,221 and 32,768 + 3 pixels: neither a multiple of 4
    nor of a warp's 128), the crafted ties, both shared-memory plans."""
    from test_torch_sample_ids import _tied_rows
    g = torch.Generator(cuda).manual_seed(t)
    tl, tu = _tied_rows(t)
    for n in (1221, 32771):
        logits = torch.cat([3.0 * torch.randn((n, t), generator=g,
                                              device=cuda), tl.to(cuda)])
        u = torch.cat([torch.rand((n, t), generator=g, device=cuda),
                       tu.to(cuda)])
        _head_ids(logits, u, tau)
        _head_ids(logits[-6:].contiguous(), u[-6:].contiguous(), tau)


def test_export_generate_matches_the_plain_head(cuda):
    """``export.generate`` on the card: the ids of
    ``decode(sample_head(...))`` on the same seed's draws, one head launch
    a batch."""
    from levelgan_torch.config import preset
    from levelgan_torch.data.codec import decode
    from levelgan_torch.export import generate
    from levelgan_torch.models import Generator, sample_head
    cfg = preset("gumbel_64")
    m = cfg.model
    gen = Generator(m).init_params(torch.Generator().manual_seed(4)).to(cuda)
    n, batch = 2500, 1024
    before = obs.counters["head.launches"]
    levels = generate(cfg, gen, n, seed=77, batch_size=batch, device=cuda)
    assert obs.counters["head.launches"] == before + 3
    rng = torch.Generator(cuda).manual_seed(77)
    want = []
    with torch.inference_mode():
        for _ in range(3):
            z = torch.randn((batch, m.latent_dim), generator=rng, device=cuda)
            want.append(decode(sample_head(gen(z), "gumbel", m.tau_end,
                                           generator=rng)))
    assert (levels == torch.cat(want)[:n].cpu().numpy()).all()


@pytest.mark.parametrize("case", ["spatial", "noise", "plain", "softmax"])
def test_sample_ids_keeps_the_other_heads_on_the_plain_path(cuda, case):
    from levelgan_torch.data.codec import decode
    from levelgan_torch.models import sample_head, sample_ids
    g = torch.Generator(cuda).manual_seed(5)
    logits = 2.0 * torch.randn((4, 16, 16, 8), generator=g, device=cuda)
    head = "softmax" if case == "softmax" else "gumbel"
    structural = "spatial" if case == "spatial" else "none"
    noise = (torch.rand(logits.shape, generator=g, device=cuda)
             if case == "noise" else None)
    n = obs.counters["head.launches"]
    got = sample_ids(logits, head, 0.5, structural, noise=noise,
                     generator=torch.Generator(cuda).manual_seed(6),
                     plain=case == "plain")
    assert obs.counters["head.launches"] == n
    want = decode(sample_head(logits, head, 0.5, structural, noise=noise,
                              generator=torch.Generator(cuda).manual_seed(6)))
    assert torch.equal(got, want)


def test_gumbel_transform_matches_torch_for_every_draw(cuda, tmp_path):
    """``csrc/gumbel.cuh`` (the fused head's -log(-log(max(u, FLT_MIN))),
    built by this machine's nvcc) against ``gumbel_noise``'s chain in
    PyTorch's own kernels, bit for bit, on every value torch.rand draws
    (k * 2^-24, k < 2^24), and at a denormal, a negative u and the largest
    float below 1."""
    import ctypes
    import subprocess
    from levelgan_torch.kernels import build
    src = tmp_path / "gumbel_check.cu"
    src.write_text(
        '#include "gumbel.cuh"\n'
        "__global__ void noise(const float* u, float* g, int n) {\n"
        "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
        "  if (i < n) g[i] = gumbel::gumbel_noise(u[i]);\n"
        "}\n"
        'extern "C" int run(const void* u, void* g, int n, void* st) {\n'
        "  noise<<<(n + 255) / 256, 256, 0, (cudaStream_t)st>>>(\n"
        "      (const float*)u, (float*)g, n);\n"
        "  return (int)cudaGetLastError();\n"
        "}\n")
    lib = tmp_path / "gumbel_check.so"
    subprocess.run([build._nvcc(), build.ARCH, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-I", str(build.CSRC), "-o",
                    str(lib), str(src)], check=True)
    run = ctypes.CDLL(str(lib)).run
    run.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    tiny = torch.finfo(torch.float32).tiny
    u = torch.cat([torch.arange(2 ** 24, device=cuda,
                                dtype=torch.float32) * 2.0 ** -24,
                   torch.tensor([tiny / 4, -0.5, 1 - 2.0 ** -24],
                                device=cuda)])
    g = torch.empty_like(u)
    assert run(u.data_ptr(), g.data_ptr(), u.numel(),
               torch.cuda.current_stream().cuda_stream) == 0
    want = -torch.log(-torch.log(u.clamp_min(tiny)))
    assert torch.equal(g, want), int((g != want).sum())
