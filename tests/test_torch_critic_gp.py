"""Port parity: the Critic (through the parameter bridge), the gradient
penalty (plain and K2 core) and the penalty core itself against the JAX
package, on the CPU in f32.

Flax params are initialised, perturbed with numpy noise (so GroupNorm's
scale and bias are not the identity), flattened as a checkpoint flattens
them and loaded into the port through ``critic_params_from_flat``.  The GP
gets the exact interpolation eps the JAX GP draws from its key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.config import ModelConfig as JModelConfig
from levelgan.kernels.gp_penalty import gradient_penalty_pallas
from levelgan.kernels.gp_penalty import norm_penalty as j_norm_penalty
from levelgan.models import Critic as JCritic
from levelgan.ops.grad_penalty import gradient_penalty as j_gradient_penalty
from levelgan_torch import obs
from levelgan_torch.bridge import critic_params_from_flat, critic_params_to_flat
from levelgan_torch.config import ModelConfig
from levelgan_torch.kernels import gp_penalty as k2
from levelgan_torch.models import Critic
from levelgan_torch.ops import grad_penalty as gp
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCORE_TOL = 1e-4   # f32 on both sides; the JAX Pallas-vs-XLA tolerance
B = 4


def _cfgs(**kw):
    m = {**dict(level_size=16, critic_base_channels=16, group_size=8,
                dtype="float32", cond_embed_dim=8), **kw}
    return JModelConfig(**m), ModelConfig(**m)


def _models(jm, tm, seed=0):
    x = jnp.zeros((2, jm.level_size, jm.level_size, jm.n_tiles))
    cond = jnp.zeros((2, jm.cond_dim)) if jm.cond_dim else None
    params = JCritic(jm).init(jax.random.key(seed), x, cond)["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    flat = {"discriminator/" + jax.tree_util.keystr(p, simple=True,
                                                    separator="/"):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    critic = Critic(tm)
    critic.load_state_dict(critic_params_from_flat(flat))
    return params, flat, critic


def _inputs(jm, seed=1):
    rng = np.random.default_rng(seed)
    shape = (B, jm.level_size, jm.level_size, jm.n_tiles)
    real = np.eye(jm.n_tiles, dtype=np.float32)[
        rng.integers(0, jm.n_tiles, shape[:3])]
    fake = rng.dirichlet(np.ones(jm.n_tiles), shape[:3]).astype(np.float32)
    cond = (rng.uniform(0, 1, (B, jm.cond_dim)).astype(np.float32)
            if jm.cond_dim else None)
    return real, fake, cond


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("kw", [
    {}, {"cond_dim": 4, "cond_mode": "projection"},
    {"cond_dim": 4, "cond_mode": "concat"}, {"critic_mbstd": "input"},
    {"critic_mbstd": "trunk"}, {"level_size": 32}],
    ids=["uncond", "projection", "concat", "mbstd_input", "mbstd_trunk",
         "level32"])
def test_critic_scores_match_jax(kw):
    jm, tm = _cfgs(**kw)
    params, _, critic = _models(jm, tm)
    real, fake, cond = _inputs(jm)
    for x in (real, fake):
        want = np.asarray(JCritic(jm).apply({"params": params}, _j(x),
                                            _j(cond)))
        with torch.no_grad():
            got = critic(_t(x), _t(cond)).numpy()
        assert got.shape == (B,)
        np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=SCORE_TOL)


def test_critic_mbstd_scale_matches_jax():
    jm, tm = _cfgs(critic_mbstd="input")
    params, _, critic = _models(jm, tm, seed=3)
    _, fake, _ = _inputs(jm)
    want = np.asarray(JCritic(jm).apply({"params": params}, _j(fake),
                                        mbstd_scale=0.25))
    with torch.no_grad():
        got = critic(_t(fake), None, 0.25).numpy()
    np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=SCORE_TOL)


def test_critic_names_and_bridge_roundtrip():
    jm, tm = _cfgs(cond_dim=4, cond_mode="projection")
    _, flat, critic = _models(jm, tm)
    assert set(critic_params_from_flat(flat)) == set(critic.state_dict())
    back = critic_params_to_flat(critic.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_critic_init_follows_flax_inits():
    _, tm = _cfgs()
    sd = Critic(tm).init_params(torch.Generator().manual_seed(0)).state_dict()
    assert "scale0" not in sd and torch.all(sd["scale1"] == 1)
    assert torch.all(sd["down0.bias"] == 0)
    assert abs(float(sd["down1.kernel"].std()) - 0.02) < 0.002


def _jax_gp(jm, params, real, fake, cond, impl, key):
    def d_apply(p, x, c):
        return JCritic(jm).apply({"params": p}, x, c)

    val, grads = jax.value_and_grad(
        lambda p: impl(d_apply, p, key, _j(real), _j(fake), _j(cond)))(params)
    return float(val), {
        "discriminator/" + jax.tree_util.keystr(p, simple=True, separator="/"):
        np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(
            grads)[0]}


@pytest.mark.parametrize("which", ["plain", "core"])
@pytest.mark.parametrize("kw", [{}, {"critic_mbstd": "input"}],
                         ids=["uncond", "mbstd_input"])
def test_gradient_penalty_matches_jax(which, kw):
    """Value and gradient w.r.t. the critic params (the double backward)."""
    jm, tm = _cfgs(**kw)
    params, _, critic = _models(jm, tm, seed=2)
    real, fake, cond = _inputs(jm, seed=4)
    key = jax.random.key(11)
    want, want_g = _jax_gp(jm, params, real, fake, cond, j_gradient_penalty,
                           key)
    # the eps interpolate() draws from the key
    eps = np.array(jax.random.uniform(key, (B, 1, 1, 1), jnp.float32))
    fn = gp.gradient_penalty if which == "plain" else k2.gradient_penalty_core
    val = fn(lambda x, c: critic(x, c), _t(real), _t(fake), _t(cond),
             _t(eps))
    names = [n for n, _ in critic.named_parameters()]
    # layer 0's bias reaches the input gradient only through LeakyReLU's
    # piecewise-constant slope: no graph edge, a zero gradient in JAX
    grads = torch.autograd.grad(val, list(critic.parameters()),
                                allow_unused=True, materialize_grads=True)
    assert abs(float(val.detach()) - want) <= 1e-4 * abs(want) + 1e-6
    for n, g in zip(names, grads):
        j = want_g["discriminator/" + n.replace(".", "/")]
        np.testing.assert_allclose(g.numpy(), j, atol=1e-4 * np.abs(j).max()
                                   + 1e-7, rtol=1e-4, err_msg=n)


def test_gradient_penalty_core_matches_jax_pallas_core():
    """The port's core GP against the JAX package's Pallas-core GP."""
    jm, tm = _cfgs()
    params, _, critic = _models(jm, tm, seed=5)
    real, fake, cond = _inputs(jm, seed=6)
    key = jax.random.key(2)
    want, _ = _jax_gp(jm, params, real, fake, cond, gradient_penalty_pallas,
                      key)
    eps = np.array(jax.random.uniform(key, (B, 1, 1, 1), jnp.float32))
    val = k2.gradient_penalty_core(lambda x, c: critic(x, c), _t(real),
                                   _t(fake), None, _t(eps))
    assert abs(float(val.detach()) - want) <= 1e-4 * abs(want) + 1e-6


def test_norm_penalty_fwd_bwd_match_jax_pallas():
    rng = np.random.default_rng(0)
    g2 = (rng.standard_normal((4, 512)) * 0.06).astype(np.float32)
    ct = rng.standard_normal(4).astype(np.float32)
    pen_j, vjp = jax.vjp(j_norm_penalty, jnp.asarray(g2))
    (dg_j,) = vjp(jnp.asarray(ct))
    before = (obs.counters["k2.fwd_launches"],
              obs.counters["k2.bwd_launches"])
    x = torch.from_numpy(g2).requires_grad_()
    pen = k2.NormPenalty.apply(x)
    (dg,) = torch.autograd.grad(pen, x, torch.from_numpy(ct))
    # CPU: plain
    assert (obs.counters["k2.fwd_launches"],
            obs.counters["k2.bwd_launches"]) == before
    np.testing.assert_allclose(pen.detach().numpy(), np.asarray(pen_j),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(dg.numpy(), np.asarray(dg_j), atol=1e-6,
                               rtol=1e-5)


def test_norm_penalty_gradcheck_f64():
    g2 = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 16))
                          * 0.3).requires_grad_()
    assert torch.autograd.gradcheck(k2.NormPenalty.apply, (g2,))


def test_norm_penalty_plain_pieces():
    g2 = torch.tensor([[3.0, 4.0], [0.0, 0.0]])
    pen, norm = k2.norm_penalty_fwd(g2)
    torch.testing.assert_close(norm, torch.tensor([5.0, 1e-6]))
    torch.testing.assert_close(pen, (norm - 1) ** 2)
    dg = k2.norm_penalty_bwd(g2, norm, torch.tensor([1.0, 1.0]))
    torch.testing.assert_close(dg[0], 2 * 4 / 5 * g2[0])


def test_interpolate_injected_and_drawn_eps():
    real, fake = torch.ones(3, 2, 2, 1), torch.zeros(3, 2, 2, 1)
    eps = torch.tensor([0.0, 0.5, 1.0]).reshape(3, 1, 1, 1)
    torch.testing.assert_close(gp.interpolate(real, fake, eps),
                               eps.expand(3, 2, 2, 1))
    a = gp.interpolate(real, fake, generator=torch.Generator().manual_seed(4))
    b = gp.interpolate(real, fake, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and bool(((a >= 0) & (a < 1)).all())


@pytest.mark.parametrize("choice,want", [
    ("auto", k2.gradient_penalty_core), ("core", k2.gradient_penalty_core),
    ("xla", gp.gradient_penalty)])
def test_gp_picker(choice, want):
    _, tm = _cfgs(pallas_gp=choice)
    assert gp.make_gradient_penalty(tm) is want


@pytest.mark.parametrize("kw,supported", [
    ({"level_size": 16}, True), ({"level_size": 32}, True),
    ({"level_size": 16, "cond_dim": 4, "cond_mode": "concat"}, True),
    ({"level_size": 64}, False),
    ({"level_size": 16, "cond_dim": 4, "cond_mode": "projection"}, False)],
    ids=["16", "32", "16_concat", "64", "16_projection"])
def test_gp_picker_fused_names_its_slice(kw, supported):
    """'fused' is the fused GP where the kernel serves the critic and a
    ``ValueError`` naming ``pallas_gp`` where it does not."""
    from levelgan_torch.kernels.critic_grad import gradient_penalty_fused
    _, tm = _cfgs(pallas_gp="fused", **kw)
    if supported:
        assert gp.make_gradient_penalty(tm) is gradient_penalty_fused
    else:
        with pytest.raises(ValueError, match="pallas_gp"):
            gp.make_gradient_penalty(tm)


def test_norm_penalty_wrappers_refuse_other_devices():
    g2 = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError):
        k2.norm_penalty_fwd(g2)
    with pytest.raises(ValueError):
        k2.norm_penalty_bwd(g2, torch.empty(2, device="meta"),
                            torch.empty(2, device="meta"))
