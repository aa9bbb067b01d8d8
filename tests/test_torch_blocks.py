"""Port parity: the plain upsample stage (K1 and K1L forms) and its pieces
against the JAX package, on the CPU in f32.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX Pallas kernels run in interpret mode, as tests/test_kernels.py runs
them; each such call costs seconds, so there is one per kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.kernels.upsample_block import upsample_block_pallas
from levelgan.kernels.upsample_rows import fold as jfold
from levelgan.kernels.upsample_rows import unfold as junfold
from levelgan.kernels.upsample_rows import upsample_block_rows_sm
from levelgan.ops import blocks as jblocks
from levelgan_torch import obs
from levelgan_torch.kernels import upsample_block as k1
from levelgan_torch.kernels import upsample_rows as k1l
from levelgan_torch.ops import blocks
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the tolerance tests/test_kernels.py holds the Pallas kernels to in f32
ATOL = RTOL = 1e-4


def _io(b, h, ci, co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, h, ci)).astype(np.float32)
    w = (rng.standard_normal((4, 4, ci, co)) * 0.1).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, co).astype(np.float32)
    beta = (rng.standard_normal(co) * 0.1).astype(np.float32)
    return x, w, gamma, beta


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_k1_stage_matches_jax_pallas():
    x, w, gamma, beta = _io(4, 4, 64, 32)
    y_j = np.asarray(upsample_block_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(gamma), jnp.asarray(beta),
        slope=0.2, group_size=8, compute_dtype=jnp.float32))
    before = obs.counters["k1.fwd_launches"]
    y_t = k1.upsample_block_fwd(*_t(x, w, gamma, beta), slope=0.2,
                                group_size=8).numpy()
    # CPU tensors take the plain version
    assert obs.counters["k1.fwd_launches"] == before
    assert y_t.shape == (4, 8, 8, 32)
    np.testing.assert_allclose(y_t, y_j, atol=ATOL, rtol=RTOL)


def test_k1l_stage_matches_jax_rows():
    x, w, gamma, beta = _io(4, 16, 32, 16)
    y_sm = upsample_block_rows_sm(
        jnp.transpose(jnp.asarray(x), (1, 2, 0, 3)), jnp.asarray(w),
        jnp.asarray(gamma), jnp.asarray(beta), group_size=8,
        compute_dtype=jnp.float32)
    y_j = np.asarray(jnp.transpose(y_sm, (2, 0, 1, 3)))
    before = obs.counters["k1l.fwd_launches"]
    y_t = k1l.upsample_block_rows(*_t(x, w, gamma, beta), slope=0.2,
                                  group_size=8).numpy()
    assert obs.counters["k1l.fwd_launches"] == before
    np.testing.assert_allclose(y_t, y_j, atol=ATOL, rtol=RTOL)


def test_k1l_pass1_folded_output_and_sums():
    """The conv's folded output and its per-channel sums (JAX layout), and
    the stage's residuals made from them: yf and the GroupNorm mean / rstd
    of the sums over all positions and parities."""
    x, w, gamma, beta = _io(2, 8, 16, 8, seed=3)
    y_j = np.asarray(jblocks.conv_transpose_2x(
        jnp.asarray(x), jnp.asarray(w), compute_dtype=jnp.float32))
    yf_j = np.asarray(jnp.transpose(
        jfold(jnp.transpose(jnp.asarray(y_j), (1, 2, 0, 3))), (2, 0, 1, 3)))
    yf, s1, s2 = k1l.conv_rows_plain(*_t(x, w))
    assert yf.shape == (2, 8, 8, 32)
    np.testing.assert_allclose(yf.numpy(), yf_j, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(s1.numpy(), y_j.sum(axis=(1, 2)),
                               atol=1e-3, rtol=RTOL)
    np.testing.assert_allclose(s2.numpy(), (y_j ** 2).sum(axis=(1, 2)),
                               atol=1e-3, rtol=RTOL)
    _, yf_s, mu, rstd = k1l.upsample_block_rows(*_t(x, w, gamma, beta),
                                                group_size=4, residuals=True)
    np.testing.assert_allclose(yf_s.numpy(), yf_j, atol=ATOL, rtol=RTOL)
    yg = y_j.reshape(2, -1, 2, 4)                # groups of 4 channels
    mean = yg.mean(axis=(1, 3))
    var = (yg ** 2).mean(axis=(1, 3)) - mean ** 2
    np.testing.assert_allclose(mu.numpy(), np.repeat(mean, 4, 1),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(rstd.numpy(),
                               np.repeat(1 / np.sqrt(var + 1e-5), 4, 1),
                               atol=ATOL, rtol=RTOL)


def test_fold_unfold_roundtrip_and_jax_layout():
    y = np.random.default_rng(0).standard_normal((3, 8, 6, 16)).astype(
        np.float32)
    yt = torch.from_numpy(y)
    assert torch.equal(k1l.unfold(k1l.fold(yt)), yt)
    # batch-major port == spatial-major JAX fold, up to the layout transpose
    f_j = np.array(jnp.transpose(
        jfold(jnp.transpose(jnp.asarray(y), (1, 2, 0, 3))), (2, 0, 1, 3)))
    np.testing.assert_array_equal(k1l.fold(yt).numpy(), f_j)
    u_j = np.asarray(jnp.transpose(
        junfold(jnp.transpose(jnp.asarray(f_j), (1, 2, 0, 3))), (2, 0, 1, 3)))
    np.testing.assert_array_equal(k1l.unfold(torch.from_numpy(f_j)).numpy(),
                                  u_j)


@pytest.mark.parametrize("c,group_size", [(32, 8), (32, 16), (24, 8), (8, 16)])
def test_group_norm_matches_jax(c, group_size):
    rng = np.random.default_rng(c + group_size)
    x = (rng.standard_normal((3, 5, 7, c)) * 2 + 0.5).astype(np.float32)
    g = rng.uniform(0.5, 1.5, c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    y_j = np.asarray(jblocks.group_norm(jnp.asarray(x), jnp.asarray(g),
                                        jnp.asarray(b), group_size))
    y_t = blocks.group_norm(*_t(x, g, b), group_size).numpy()
    np.testing.assert_allclose(y_t, y_j, atol=ATOL, rtol=RTOL)


def test_group_norm_rejects_bad_grouping():
    x = torch.zeros(2, 4, 4, 25)
    with pytest.raises(ValueError):
        blocks.group_norm(x, torch.ones(25), torch.zeros(25), 8)


@pytest.mark.parametrize("b,h,ci,co", [(2, 4, 16, 8), (1, 5, 8, 24)])
def test_conv_transpose_matches_jax(b, h, ci, co):
    x, w, _, _ = _io(b, h, ci, co, seed=b * h)
    y_j = np.asarray(jblocks.conv_transpose_2x(
        jnp.asarray(x), jnp.asarray(w), compute_dtype=jnp.float32))
    y_t = blocks.conv_transpose_2x(*_t(x, w), compute_dtype=torch.float32)
    np.testing.assert_allclose(y_t.numpy(), y_j, atol=ATOL, rtol=RTOL)


def test_plain_stage_matches_jax_xla_stage():
    x, w, gamma, beta = _io(2, 8, 32, 16, seed=7)
    y_j = np.asarray(jblocks.upsample_block_xla(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(gamma), jnp.asarray(beta),
        slope=0.2, group_size=8, compute_dtype=jnp.float32))
    y_t = blocks.upsample_block(*_t(x, w, gamma, beta), slope=0.2,
                                group_size=8, compute_dtype=torch.float32)
    np.testing.assert_allclose(y_t.numpy(), y_j, atol=ATOL, rtol=RTOL)


def test_leaky_relu_matches_jax():
    x = np.linspace(-3, 3, 101, dtype=np.float32)
    np.testing.assert_array_equal(
        blocks.leaky_relu(torch.from_numpy(x), 0.2).numpy(),
        np.asarray(jblocks.leaky_relu(jnp.asarray(x), 0.2)))


def test_dispatch_routes_gumbel64_stages():
    """Input sizes of gumbel_64's four stages: K1 for 4, 8, 16; K1L for 32."""
    assert [k1.fits(h, h) for h in (4, 8, 16, 32)] == [True, True, True, False]


def test_pack_taps_layout():
    w = torch.randn(4, 4, 64, 32)
    wt = k1.pack_taps(w)
    assert wt.shape == (16, 32, 64) and wt.dtype == torch.bfloat16
    for kh, kw, c, i in [(0, 0, 0, 0), (1, 2, 5, 7), (3, 3, 31, 63)]:
        assert wt[kh * 4 + kw, c, i] == w[kh, kw, i, c].to(torch.bfloat16)


def test_bf16_plain_stage_close_to_f32():
    x, w, gamma, beta = _io(2, 8, 64, 32, seed=11)
    xt, wt_, gt, bt = _t(x, w, gamma, beta)
    y32 = blocks.upsample_block(xt, wt_, gt, bt, compute_dtype=torch.float32)
    y16 = k1.upsample_block_fwd(xt.to(torch.bfloat16), wt_, gt, bt)
    assert y16.dtype == torch.bfloat16
    # bf16 keeps ~3 decimal digits; post-norm activations are O(1)
    np.testing.assert_allclose(y16.float().numpy(), y32.numpy(), atol=0.1)
