"""Port parity: the fused critic-gradient path (K2 fused) against the JAX
package, on the CPU in f32 at small widths.

The JAX side runs its Pallas kernel in interpret mode (as its own tests do
on the CPU).  On the port's side CPU tensors take the kernel's plain version
(``critic_trunk_grad_plain``), which ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the CUDA kernel against on the card.
Inputs and parameters come from numpy seeds; Flax parameters cross through
``bridge.py``; the GP gets the interpolation eps that the JAX GP draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.config import PRESET_NAMES as J_PRESET_NAMES
from levelgan.config import ModelConfig as JModelConfig
from levelgan.config import preset as j_preset
from levelgan.kernels import critic_grad as jcg
from levelgan.kernels.gp_penalty import gradient_penalty_pallas
from levelgan.ops.grad_penalty import gradient_penalty as j_gradient_penalty
from levelgan_torch import obs
from levelgan_torch.config import ModelConfig, preset
from levelgan_torch.kernels import critic_grad as cg
from levelgan_torch.kernels import gp_penalty as k2
from levelgan_torch.models import Critic
from levelgan_torch.ops import grad_penalty as gp
from test_torch_critic_gp import B, _cfgs, _inputs, _j, _jax_gp, _models, _t
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-4, 1e-5      # f32 on both sides (tests/test_gp_kernel.py)


def _trunk_inputs(m0, chans, has_gn, seed):
    """a0 [B, m0, m0, c0], per-layer (w, b, gamma, beta), head_w [4, 4, cl],
    with weights that are not symmetric in any axis."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    a0 = f32(B, m0, m0, chans[0])
    layers = []
    for ci, co in zip(chans[:-1], chans[1:]):
        layers.append((f32(4, 4, ci, co, scale=0.1), f32(co, scale=0.1),
                       1 + f32(co, scale=0.2) if has_gn else None,
                       f32(co, scale=0.2) if has_gn else None))
    return a0, layers, f32(4, 4, chans[-1])


@pytest.mark.parametrize("m0,chans,has_gn,gs", [
    (8, (16, 32), True, 8), (16, (16, 32, 64), True, 8),
    (8, (16, 32), False, 8), (16, (16, 32, 64), False, 8),
    (8, (32, 64), True, 16)],
    ids=["16", "32", "16_nonorm", "32_nonorm", "16_gs16"])
def test_trunk_grad_plain_matches_jax_kernel(m0, chans, has_gn, gs):
    """(a) + (d): the plain version against ``_make_fused.run`` in interpret
    mode on the same a0 and parameters."""
    a0, layers, head_w = _trunk_inputs(m0, chans, has_gn, seed=m0 + gs)
    arch = tuple((ci, co, has_gn) for ci, co in zip(chans[:-1], chans[1:]))
    run = jcg._make_fused(m0, chans[0], arch, gs, 0.2, "float32")
    flat = []
    for w, b, gamma, beta in layers:
        flat += [jnp.asarray(w), jnp.asarray(b)[None, :]]
        if has_gn:
            flat += [jnp.asarray(gamma)[None, :], jnp.asarray(beta)[None, :]]
    want = run(jnp.transpose(jnp.asarray(a0), (1, 2, 0, 3)), flat,
               jnp.asarray(head_w)[:, :, None, :])
    want = np.transpose(np.asarray(want), (2, 0, 1, 3))
    before = obs.counters["k2f.launches"]
    got = cg.critic_trunk_grad(
        _t(a0), [tuple(_t(x) for x in lay) for lay in layers], _t(head_w),
        slope=0.2, group_size=gs)
    # a CPU tensor: the plain version
    assert obs.counters["k2f.launches"] == before
    assert got.shape == a0.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_trunk_grad_plain_is_autograd_of_the_trunk():
    """The explicit reverse chain equals autograd through the same trunk,
    border rows and columns included."""
    a0, layers, head_w = _trunk_inputs(16, (8, 16, 24), True, seed=3)
    layers = [tuple(_t(x).double() for x in lay) for lay in layers]
    a0, head_w = _t(a0).double(), _t(head_w).double()
    pre = a0.clone().requires_grad_()       # layer 0's pre-activation
    x = torch.where(pre >= 0, pre, 0.2 * pre)
    for w, b, gamma, beta in layers:
        y = cg._conv_down(x, w) + b
        co = y.shape[-1]
        yg = y.reshape(B, -1, co // 8, 8)
        mean = yg.mean(dim=(1, 3), keepdim=True)
        var = (yg * yg).mean(dim=(1, 3), keepdim=True) - mean * mean
        o = ((yg - mean) * torch.rsqrt(var + cg.EPS)).reshape(y.shape) \
            * gamma + beta
        x = torch.where(o >= 0, o, 0.2 * o)
    (want,) = torch.autograd.grad((x * head_w).sum(), pre)
    # leaky_relu(pre) has pre's sign, so the kernel's mask on a0 is pre's
    got = cg.critic_trunk_grad_plain(torch.where(a0 >= 0, a0, 0.2 * a0),
                                     layers, head_w, slope=0.2, group_size=8)
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-11)
    edge = want[:, [0, -1]].abs().max()     # the check covers the border
    assert float(edge) > 0


@pytest.mark.parametrize("level,kw", [
    (16, {}), (16, {"cond_dim": 4, "cond_mode": "concat"}), (32, {}),
    (16, {"norm": "none"})],
    ids=["16", "16_concat", "32", "16_nonorm"])
def test_critic_input_grad_matches_jax(level, kw):
    """(b) + (d): ``CriticInputGrad`` against ``make_critic_input_grad``,
    and against autograd through the port's critic."""
    jm, tm = _cfgs(level_size=level, **kw)
    params, _, critic = _models(jm, tm, seed=level)
    real, fake, cond = _inputs(jm, seed=7)
    x = 0.5 * (real + fake)
    want = np.asarray(jcg.make_critic_input_grad(jm)(params, _j(x), _j(cond)))
    got = cg.critic_input_grad(critic, _t(x), _t(cond))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    xt = _t(x).requires_grad_()
    (oracle,) = torch.autograd.grad(critic(xt, _t(cond)).sum(), xt)
    np.testing.assert_allclose(got.detach().numpy(), oracle.numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("level,kw", [
    (16, {}), (16, {"cond_dim": 4, "cond_mode": "concat"}), (32, {}),
    (16, {"norm": "none"})],
    ids=["16", "16_concat", "32", "16_nonorm"])
def test_fused_gp_value_and_double_backward_match_jax(level, kw):
    """(c) + (d): the fused GP's value and its gradient for every critic
    parameter against the JAX fused GP and the port's plain GP."""
    jm, tm = _cfgs(level_size=level, pallas_gp="fused", **kw)
    params, _, critic = _models(jm, tm, seed=level + 1)
    real, fake, cond = _inputs(jm, seed=9)
    key = jax.random.key(13)
    want, want_g = _jax_gp(jm, params, real, fake, cond,
                           jcg.make_gradient_penalty(jm), key)
    eps = np.array(jax.random.uniform(key, (B, 1, 1, 1), jnp.float32))
    names = [n for n, _ in critic.named_parameters()]
    plist = list(critic.parameters())

    fused = gp.make_gradient_penalty(tm)
    assert fused is cg.gradient_penalty_fused
    val = fused(critic, _t(real), _t(fake), _t(cond), _t(eps))
    grads = torch.autograd.grad(val, plist, allow_unused=True,
                                materialize_grads=True)
    plain = gp.gradient_penalty(critic, _t(real), _t(fake), _t(cond),
                                _t(eps))
    plain_g = torch.autograd.grad(plain, plist, allow_unused=True,
                                  materialize_grads=True)
    np.testing.assert_allclose(float(val.detach()), want, rtol=1e-4)
    np.testing.assert_allclose(float(val.detach()), float(plain.detach()),
                               rtol=1e-4)
    for n, g, pg in zip(names, grads, plain_g):
        j = want_g["discriminator/" + n.replace(".", "/")]
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-3, atol=1e-5,
                                   err_msg=n)
        np.testing.assert_allclose(g.numpy(), pg.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=n)


def test_fused_gp_gives_x_hat_and_cond_their_gradients():
    """The VJP's other two outputs against autograd through the critic."""
    jm, tm = _cfgs(cond_dim=4, cond_mode="concat")
    _, _, critic = _models(jm, tm, seed=4)
    real, fake, cond = _inputs(jm, seed=5)
    ct = torch.from_numpy(np.random.default_rng(0).standard_normal(
        real.shape).astype(np.float32))
    outs = []
    for fused in (True, False):
        x = _t(0.5 * (real + fake)).requires_grad_()
        c = _t(cond).requires_grad_()
        if fused:
            g = cg.critic_input_grad(critic, x, c)
        else:
            (g,) = torch.autograd.grad(critic(x, c).sum(), x,
                                       create_graph=True)
        outs.append(torch.autograd.grad((g * ct).sum(), (x, c)))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6)


def test_fused_gp_refuses_a_callable():
    _, tm = _cfgs()
    critic = Critic(tm).init_params(torch.Generator().manual_seed(0))
    x = torch.zeros(2, 16, 16, tm.n_tiles)
    with pytest.raises(TypeError, match="Critic module"):
        cg.gradient_penalty_fused(lambda a, c: critic(a, c), x, x)


def _grid():
    """``test_fused_gp_routing`` and
    ``test_fused_unsupported_for_projection_conditioning``'s configurations,
    plus what else the reject rules name."""
    small = dict(critic_base_channels=16, group_size=8, dtype="float32")
    return [
        dict(level_size=16, **small), dict(level_size=32, **small),
        dict(level_size=64, **small),
        dict(level_size=16, cond_dim=4, **small),
        dict(level_size=16, cond_dim=4, cond_mode="projection", **small),
        dict(level_size=32, dtype="float32"),       # full width f32: too big
        dict(level_size=32, dtype="bfloat16"),
        dict(level_size=16, critic_mbstd="input", **small),
        dict(level_size=16, critic_mbstd="trunk", **small),
        dict(level_size=16, norm="none", **small),
        dict(level_size=8, **small),
    ]


@pytest.mark.parametrize("kw", _grid(), ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items() if k not in (
        "critic_base_channels", "group_size")))
def test_fused_supported_and_picker_match_jax_grid(kw):
    """(e): the same manifest routes the same way in both packages."""
    jm, tm = JModelConfig(**kw), ModelConfig(**kw)
    assert cg.critic_arch(tm) == jcg._arch(jm)
    _check_routing(jm, tm)


@pytest.mark.parametrize("name", J_PRESET_NAMES)
def test_fused_supported_and_picker_match_jax_presets(name):
    jm, tm = j_preset(name).model, preset(name).model
    _check_routing(jm, tm)
    assert cg.fused_supported(tm) == (name in (
        "toy_dcgan_16", "wgan_gp_32", "wgan_gp_32_structural",
        "curriculum_16", "curriculum_16_joint"))


def _check_routing(jm, tm):
    want = jcg.fused_supported(jm)
    assert cg.fused_supported(tm) == want
    jf = dataclasses.replace(jm, pallas_gp="fused")
    tf = dataclasses.replace(tm, pallas_gp="fused")
    if want:
        assert callable(jcg.make_gradient_penalty(jf))
        assert gp.make_gradient_penalty(tf) is cg.gradient_penalty_fused
    else:
        with pytest.raises(ValueError, match="pallas_gp"):
            jcg.make_gradient_penalty(jf)
        with pytest.raises(ValueError, match="pallas_gp"):
            gp.make_gradient_penalty(tf)
    # 'core' is the K2 core in both; 'auto' differs by design (the port runs
    # its kernels on the card, see ops/grad_penalty.py)
    core = dataclasses.replace(jm, pallas_gp="core")
    assert jcg.make_gradient_penalty(core) is gradient_penalty_pallas
    assert jcg.make_gradient_penalty(jm) is j_gradient_penalty
    assert gp.make_gradient_penalty(
        dataclasses.replace(tm, pallas_gp="core")) is k2.gradient_penalty_core
    assert gp.make_gradient_penalty(tm) is k2.gradient_penalty_core


def test_critic_input_grad_gradcheck_f64():
    """(f): the op's backward (the double backward on the plain critic)
    against finite differences of its forward (the explicit reverse chain),
    in float64 at a tiny shape."""
    tm = ModelConfig(level_size=16, n_tiles=4, critic_base_channels=4,
                     group_size=2, dtype="float64", cond_dim=2,
                     cond_embed_dim=2, cond_mode="concat")
    critic = Critic(tm).double()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in critic.parameters():
            p.copy_(torch.from_numpy(0.3 * rng.standard_normal(p.shape)))
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 4))).requires_grad_()
    cond = torch.from_numpy(rng.uniform(0, 1, (2, 2))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, c, *ps: cg.CriticInputGrad.apply(critic, x, c, *ps),
        (x, cond, *critic.parameters()), eps=1e-6, atol=1e-6, rtol=1e-4)


def test_trunk_grad_wrapper_refuses_other_devices():
    a0 = torch.empty(2, 8, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cg.critic_trunk_grad(a0, [], torch.empty(4, 4, 64, device="meta"))
