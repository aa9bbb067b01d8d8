"""Port parity: the differentiable upsample stages (K1 and K1L with their
backward kernels' plain versions) against the JAX package's custom VJPs,
on the CPU in f32.

Inputs and the output cotangent are made with numpy from a seed and handed
to both packages.  The JAX Pallas kernels run in interpret mode, as
tests/test_kernels.py runs them; each VJP costs seconds, so there is one
per kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.kernels.upsample_block import upsample_block_pallas
from levelgan.kernels.upsample_rows import upsample_block_rows_sm
from levelgan_torch import obs
from levelgan_torch.kernels import upsample_block as k1
from levelgan_torch.kernels import upsample_rows as k1l
from levelgan_torch.ops.blocks import conv_transpose_2x, upsample_block
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the tolerance tests/test_kernels.py holds the Pallas kernels to in f32
ATOL = RTOL = 1e-4


def _io(b, h, ci, co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, h, ci)).astype(np.float32)
    w = (rng.standard_normal((4, 4, ci, co)) * 0.1).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, co).astype(np.float32)
    beta = (rng.standard_normal(co) * 0.1).astype(np.float32)
    ct = rng.standard_normal((b, 2 * h, 2 * h, co)).astype(np.float32)
    return x, w, gamma, beta, ct


def _port_vjp(fn, x, w, gamma, beta, ct, group_size):
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w, gamma, beta)]
    y = fn.apply(*args, 0.2, group_size)
    (y * torch.from_numpy(ct)).sum().backward()
    return y.detach().numpy(), [a.grad.numpy() for a in args]


def _assert_grads(got, want):
    for name, g, j in zip(("dx", "dw", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(g, np.asarray(j), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_k1_vjp_matches_jax_pallas():
    x, w, gamma, beta, ct = _io(4, 4, 64, 32)

    def op(*a):
        return upsample_block_pallas(*a, slope=0.2, group_size=8,
                                     compute_dtype=jnp.float32)

    y_j, vjp = jax.vjp(op, *map(jnp.asarray, (x, w, gamma, beta)))
    want = vjp(jnp.asarray(ct))
    before = (obs.counters["k1.fwd_launches"], obs.counters["k1.bwd_launches"])
    y_t, got = _port_vjp(k1.UpsampleBlockFn, x, w, gamma, beta, ct, 8)
    # CPU: plain versions
    assert (obs.counters["k1.fwd_launches"],
            obs.counters["k1.bwd_launches"]) == before
    np.testing.assert_allclose(y_t, np.asarray(y_j), atol=ATOL, rtol=RTOL)
    _assert_grads(got, want)


def test_k1l_vjp_matches_jax_rows():
    x, w, gamma, beta, ct = _io(4, 16, 32, 16, seed=1)

    def op(x, *a):
        y = upsample_block_rows_sm(jnp.transpose(x, (1, 2, 0, 3)), *a,
                                   slope=0.2, group_size=8,
                                   compute_dtype=jnp.float32)
        return jnp.transpose(y, (2, 0, 1, 3))

    y_j, vjp = jax.vjp(op, *map(jnp.asarray, (x, w, gamma, beta)))
    want = vjp(jnp.asarray(ct))
    before = obs.counters["k1l.bwd_launches"]
    y_t, got = _port_vjp(k1l.UpsampleRowsFn, x, w, gamma, beta, ct, 8)
    assert obs.counters["k1l.bwd_launches"] == before
    np.testing.assert_allclose(y_t, np.asarray(y_j), atol=ATOL, rtol=RTOL)
    _assert_grads(got, want)


@pytest.mark.parametrize("fn", [k1.UpsampleBlockFn, k1l.UpsampleRowsFn],
                         ids=["K1", "K1L"])
@pytest.mark.parametrize("group_size", [4, 8])
def test_stage_function_gradcheck_f64(fn, group_size):
    """The plain forward/backward pair is the exact VJP (float64)."""
    rng = np.random.default_rng(group_size)
    args = [torch.from_numpy(a).requires_grad_() for a in (
        rng.standard_normal((2, 4, 4, 8)),
        rng.standard_normal((4, 4, 8, 8)) * 0.2,
        rng.uniform(0.5, 1.5, 8), rng.standard_normal(8) * 0.1)]
    assert torch.autograd.gradcheck(
        lambda *a: fn.apply(*a, 0.2, group_size), args, atol=1e-6)


@pytest.mark.parametrize("fn", [k1.UpsampleBlockFn, k1l.UpsampleRowsFn],
                         ids=["K1", "K1L"])
def test_stage_function_matches_autograd_of_plain_stage(fn):
    """Same value and gradients as autograd through ops.blocks.upsample_block
    (the stage the generator runs on the CPU), f32."""
    x, w, gamma, beta, ct = _io(2, 8, 16, 16, seed=4)
    y_t, got = _port_vjp(fn, x, w, gamma, beta, ct, 8)
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w, gamma, beta)]
    y = upsample_block(*args, slope=0.2, group_size=8,
                       compute_dtype=torch.float32)
    want = torch.autograd.grad((y * torch.from_numpy(ct)).sum(), args)
    np.testing.assert_allclose(y_t, y.detach().numpy(), atol=ATOL, rtol=RTOL)
    _assert_grads(got, [t.numpy() for t in want])


def test_k1_bwd_pieces_are_the_jax_residual_contract():
    """ypre is the pre-norm conv, mu/rstd its group statistics, dy the
    pre-norm cotangent that weight_grad contracts against x."""
    x, w, gamma, beta, ct = _io(2, 4, 16, 16, seed=5)
    xt, wt, gt, bt, ctt = map(torch.from_numpy, (x, w, gamma, beta, ct))
    y, ypre, mu, rstd = k1.upsample_block_fwd(xt, wt, gt, bt, group_size=8,
                                              residuals=True)
    conv = conv_transpose_2x(xt, wt, compute_dtype=torch.float32)
    np.testing.assert_allclose(ypre.numpy(), conv.numpy(), atol=ATOL)
    g = conv.reshape(2, -1, 2, 8)
    np.testing.assert_allclose(mu.numpy(), g.mean(dim=(1, 3)).repeat_interleave(
        8, 1).numpy(), atol=1e-5)
    dx, dy, _, _ = k1.upsample_block_bwd(wt, gt, bt, mu, rstd, ctt, ypre,
                                         group_size=8)
    xr, wr = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    conv_r = conv_transpose_2x(xr, wr, compute_dtype=torch.float32)
    want_dx, want_dw = torch.autograd.grad((conv_r * dy).sum(), (xr, wr))
    np.testing.assert_allclose(dx.numpy(), want_dx.numpy(), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(k1.weight_grad(xt, dy).numpy(),
                               want_dw.numpy(), atol=ATOL, rtol=RTOL)


def test_k1l_folded_grads_equal_the_merged_conv_grads():
    """dx from the folded cotangent and dw from its 9 shifted taps are the
    transposed conv's input and weight gradients."""
    x, w, _, _, ct = _io(2, 8, 16, 8, seed=6)
    xt, wt, dy = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(ct)
    xr, wr = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    conv = conv_transpose_2x(xr, wr, compute_dtype=torch.float32)
    want_dx, want_dw = torch.autograd.grad((conv * dy).sum(), (xr, wr))
    np.testing.assert_allclose(k1l.conv_rows_bwd_plain(k1l.fold(dy), wt).numpy(),
                               want_dx.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(k1l.weight_grad_folded(xt, k1l.fold(dy)).numpy(),
                               want_dw.numpy(), atol=ATOL, rtol=RTOL)


def test_pack_taps_bwd_layout():
    w = torch.randn(4, 4, 64, 32)
    wb = k1.pack_taps_bwd(w)
    assert wb.shape == (16, 64, 32) and wb.dtype == torch.bfloat16
    for kh, kw, i, c in [(0, 0, 0, 0), (1, 2, 7, 5), (3, 3, 63, 31)]:
        assert wb[kh * 4 + kw, i, c] == w[kh, kw, i, c].to(torch.bfloat16)


@pytest.mark.parametrize("h,ci,co,ok", [
    (4, 512, 256, True), (8, 256, 128, True), (16, 128, 64, True),
    (32, 64, 32, True), (16, 48, 64, False), (16, 64, 48, False),
    (3, 64, 32, False)])
def test_dx_tiling_rule_covers_gumbel64_stages(h, ci, co, ok):
    """gumbel_64's four stages (the first four rows) take the dx kernel."""
    assert k1.dx_fits(h, h, ci, co) is ok


def test_backward_wrappers_refuse_other_devices():
    meta = dict(device="meta")
    w = torch.empty(4, 4, 64, 32, **meta)
    c, bc = torch.empty(32, **meta), torch.empty(2, 32, **meta)
    g = torch.empty(2, 8, 8, 32, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError):
        k1.upsample_block_bwd(w, c, c, bc, bc, g, g)
    yf = torch.empty(2, 4, 4, 128, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError):
        k1l.upsample_rows_bwd(g, yf, bc, bc, c, c, w)
