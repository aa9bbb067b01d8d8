"""K2 core's launch plans and summation order, replayed on the CPU, and the
penalty core against the JAX package's Pallas kernel (interpret mode).

``fwd_plan`` and ``bwd_plan`` are what the wrappers pass to the CUDA
kernels (``levelgan_torch/csrc/gp_penalty.cu``), so these tests replay
exactly what is launched: which float4s each thread of each block reads,
and the forward's fixed order of the sums (each thread in load order, a
warp-shuffle butterfly, the warps by a second butterfly).  The kernels
themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.kernels.gp_penalty import norm_penalty as j_norm_penalty
from levelgan_torch import obs
from levelgan_torch.kernels import gp_penalty as k2
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the flattened input gradient at gumbel_64, wgan_gp_32 and the 16x16 presets
WIDTHS = (64 * 64 * 8, 32 * 32 * 8, 16 * 16 * 8)
# rows longer than one chunk of the forward: gumbel_64 with model.n_tiles=9
# or model.level_size=128, and a row that ends inside a chunk
LONG_WIDTHS = (64 * 64 * 9, 128 * 128 * 8, 32768 + 4 * 37)
BATCHES = (1, 3, 34, 64)


def _fwd_reads(plan, n4):
    """[chunks * vec, threads] float4 indices of the row a forward thread
    loads, in its order of the sums, -1 where its load is masked (the
    kernel's index formula: chunk c, load j is row c * vec + j)."""
    chunks = max(1, -(-n4 // (plan.vec * plan.threads)))
    idx = (np.arange(chunks * plan.vec)[:, None] * plan.threads
           + np.arange(plan.threads)[None, :])
    return np.where(idx < n4, idx, -1)


def _bwd_reads(plan, n4):
    """chunk -> [BWD_VEC, threads] float4 indices a backward thread loads
    and stores, -1 where masked."""
    p4 = plan.threads * k2.BWD_VEC
    out = []
    for c in range(plan.chunks):
        idx = (c * p4 + np.arange(k2.BWD_VEC)[:, None] * plan.threads
               + np.arange(plan.threads)[None, :])
        out.append(np.where(idx < min((c + 1) * p4, n4), idx, -1))
    return out


def _covers_once(parts, n4):
    idx = np.concatenate([p.ravel() for p in parts])
    idx = idx[idx >= 0]
    np.testing.assert_array_equal(np.sort(idx), np.arange(n4))


def _butterfly(v):
    """The kernel's warp_sum on [..., 32] lanes: lane 0 after the xor tree."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v[..., 0]


def _replay_fwd(g2, plan):
    """The forward's sums in the kernel's order, in f32 (products rounded
    where the kernel fuses them into fmas)."""
    b, f = g2.shape
    n4 = f // 4
    rows = g2.reshape(b, n4, 4).astype(np.float32)
    idx = _fwd_reads(plan, n4)
    norms = []
    for row in rows:
        x = np.where((idx >= 0)[..., None], row[np.maximum(idx, 0)],
                     np.float32(0))                  # [loads, threads, 4]
        # four chains (x, y, z, w) in load order, then (x + y) + (z + w)
        c4 = np.zeros((4, plan.threads), np.float32)
        for j in range(len(x)):
            c4 = c4 + x[j].T * x[j].T
        s = (c4[0] + c4[1]) + (c4[2] + c4[3])
        warps = _butterfly(s.reshape(plan.threads // 32, 32))
        lanes = np.zeros(32, np.float32)
        lanes[:len(warps)] = warps
        total = _butterfly(lanes)
        norms.append(np.sqrt(np.float32(total + np.float32(1e-12))))
    return np.array(norms, np.float32)


@pytest.mark.parametrize("f", WIDTHS + LONG_WIDTHS)
@pytest.mark.parametrize("b", BATCHES)
def test_fwd_plan_covers_each_float4_once(b, f):
    """Every batch and every row length the wrapper is given, rows longer
    than a chunk included, gets a plan that reads each float4 once."""
    plan = k2.fwd_plan(b, f)
    assert plan.vec in k2.FWD_VECS
    assert 32 <= plan.threads <= k2.FWD_MAX_THREADS
    assert plan.threads % 32 == 0
    _covers_once([_fwd_reads(plan, f // 4)], f // 4)


@pytest.mark.parametrize("f", WIDTHS + LONG_WIDTHS)
@pytest.mark.parametrize("b", BATCHES)
def test_bwd_plan_covers_each_float4_once(b, f):
    plan = k2.bwd_plan(b, f)
    assert plan.threads == k2.BWD_MAX_THREADS
    assert plan.chunks == -(-f // (4 * k2.BWD_VEC * plan.threads))
    _covers_once(_bwd_reads(plan, f // 4), f // 4)


@pytest.mark.parametrize("f", WIDTHS)
def test_ragged_rows_are_covered_once(f):
    """A row that is not a multiple of a block, a chunk or a warp."""
    ragged = f + 4 * 37
    _covers_once([_fwd_reads(k2.fwd_plan(3, ragged), ragged // 4)],
                 ragged // 4)
    _covers_once(_bwd_reads(k2.bwd_plan(3, ragged), ragged // 4),
                 ragged // 4)


@pytest.mark.parametrize("f", WIDTHS + LONG_WIDTHS)
def test_fixed_order_sum_matches_plain(f):
    rng = np.random.default_rng(f)
    g2 = (rng.standard_normal((3, f)) * 0.01).astype(np.float32)
    want = k2.norm_penalty_fwd_plain(torch.from_numpy(g2))[1].numpy()
    np.testing.assert_allclose(_replay_fwd(g2, k2.fwd_plan(3, f)), want,
                               rtol=1e-6, atol=0)


def test_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match=r"\[1, 2147483648\]"):
        k2.fwd_plan(1, 2 ** 31)               # past the kernel's int F
    with pytest.raises(ValueError, match="65535"):
        k2.bwd_plan(65536, 8192)
    assert k2.fwd_plan(2, 2 ** 31 - 4) == k2.FwdPlan(512, 16)


@pytest.mark.parametrize("f", WIDTHS)
def test_norm_penalty_after_mean_matches_jax_vjp(f):
    """NormPenalty with the cotangent of the GP's ``.mean()`` against
    ``jax.vjp`` of the JAX package's Pallas-kernel ``norm_penalty``."""
    b = 3
    rng = np.random.default_rng(f)
    g2 = (rng.standard_normal((b, f)) * (2.0 / np.sqrt(f))).astype(
        np.float32)
    pen_j, vjp = jax.vjp(j_norm_penalty, jnp.asarray(g2))
    (dg_j,) = vjp(jnp.full((b,), 1.0 / b, jnp.float32))
    before = (obs.counters["k2.fwd_launches"],
              obs.counters["k2.bwd_launches"])
    x = torch.from_numpy(g2).requires_grad_()
    pen = k2.NormPenalty.apply(x)
    (dg,) = torch.autograd.grad(pen.mean(), x)
    # CPU: plain
    assert (obs.counters["k2.fwd_launches"],
            obs.counters["k2.bwd_launches"]) == before
    np.testing.assert_allclose(pen.detach().numpy(), np.asarray(pen_j),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(dg.numpy(), np.asarray(dg_j), atol=1e-7,
                               rtol=1e-5)


def test_norm_penalty_takes_a_stride0_cotangent():
    """``.sum()``'s backward hands NormPenalty a broadcast (stride 0)
    cotangent, which the backward takes as it is."""
    rng = np.random.default_rng(7)
    g2 = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    _, norm = k2.norm_penalty_fwd(g2)
    ct0 = torch.full((), 0.5).expand(4)
    assert ct0.stride() == (0,)
    torch.testing.assert_close(k2.norm_penalty_bwd(g2, norm, ct0),
                               k2.norm_penalty_bwd(g2, norm,
                                                   ct0.contiguous()),
                               rtol=0, atol=0)
    x = g2.clone().requires_grad_()
    (dg,) = torch.autograd.grad(k2.NormPenalty.apply(x).sum(), x)
    torch.testing.assert_close(dg, k2.norm_penalty_bwd(g2, norm,
                                                       torch.ones(4)))
