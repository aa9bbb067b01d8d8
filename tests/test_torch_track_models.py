"""Port parity: the track family's data, ops and models
(``levelgan_torch/track/{data,ops,models,render}.py``) against
``levelgan/track/`` on the CPU in f32, from the same NumPy-seeded inputs
and bridged Flax weights.

Tolerances: the corpus, the curvature histogram, the augment and the
renders are exact; features and the closure ops 1e-6 absolute (f32 sums
in another order); G and D forwards 1e-5 relative to the output's
largest value, their gradients 1e-4 (a 16-step GRU, a 3-layer conv
stack with GroupNorm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.config import preset as j_preset
from levelgan.track import data as j_data
from levelgan.track import models as j_models
from levelgan.track import ops as j_ops
from levelgan.track import render as j_render
from levelgan_torch.bridge import (critic_params_from_flat,
                                   generator_params_from_flat)
from levelgan_torch.config import Config
from levelgan_torch.track import data, ops, render
from levelgan_torch.track.models import TrackCritic, TrackGenerator
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, T = 4, 16
SMALL = {"model.n_segments": T, "model.rnn_hidden": 16,
         "model.critic_base_channels": 8, "model.group_size": 4,
         "model.latent_dim": 8, "model.dtype": "float32"}
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _flat(tree, prefix):
    return {f"{prefix}/" + jax.tree_util.keystr(p, simple=True, separator="/"):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _cfgs(**kw):
    jcfg = j_preset("racetrack_32").override(**SMALL, **kw)
    return jcfg, Config.from_dict(jcfg.to_dict())


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("n,t,seed", [(64, 32, 1234), (37, 16, 5)])
def test_corpus_and_dataset_equal_jax(n, t, seed):
    a = data.synthetic_tracks(n, t, seed=seed)
    np.testing.assert_array_equal(a, j_data.synthetic_tracks(n, t, seed=seed))
    np.testing.assert_array_equal(data.centerline(a), j_data.centerline(a))
    ds, jds = data.TrackDataset(a, seed=3), j_data.TrackDataset(a, seed=3)
    np.testing.assert_array_equal(ds.sample_at(7, 8), jds.sample_at(7, 8))
    np.testing.assert_array_equal(ds.tile_histogram(), jds.tile_histogram())


def test_device_histogram_equals_numpy_bit_for_bit():
    """Curvatures exactly on the f32 edges and at the clip bounds land in
    the NumPy histogram's bins.  The JAX package's device edges
    (``jnp.linspace``) differ from NumPy's in the last bit at 10 of 15
    edges, so its device histogram is held to the NumPy one (and here to
    the port's) on the corpus only, as ``tests/test_track_data.py`` holds
    it."""
    edges = data.curvature_edges(16)
    kappa = np.concatenate([edges, np.nextafter(edges, np.float32(1)),
                            np.float32([-data.KAPPA_MAX, data.KAPPA_MAX])])
    tracks = np.stack([kappa, np.zeros_like(kappa)], -1)[None]
    got = ops.curvature_hist_device(torch.from_numpy(tracks), 16).numpy()
    np.testing.assert_array_equal(got, data.curvature_histogram(tracks, 16))
    corpus = data.synthetic_tracks(16, T, seed=6)
    got = ops.curvature_hist_device(torch.from_numpy(corpus), 16).numpy()
    np.testing.assert_array_equal(got, data.curvature_histogram(corpus, 16))
    np.testing.assert_array_equal(
        got, np.asarray(j_ops.curvature_hist_device(jnp.asarray(corpus), 16)))


def test_augment_with_injected_shifts_and_flips_equals_jax():
    tracks = data.synthetic_tracks(8, T, seed=7)
    key = jax.random.key(11)
    k_shift, k_flip = jax.random.split(key)
    shifts = np.asarray(jax.random.randint(k_shift, (8,), 0, T))
    flips = np.asarray(jax.random.bernoulli(k_flip, 0.5, (8,)))
    assert flips.any() and not flips.all()
    want = np.asarray(j_ops.track_augment(key, jnp.asarray(tracks)))
    got = ops.track_augment(torch.from_numpy(tracks),
                            torch.tensor(shifts).long(),
                            torch.tensor(flips))
    np.testing.assert_array_equal(got.numpy(), want)


def test_track_features_match_jax():
    tracks = data.synthetic_tracks(8, T, seed=8)
    tracks[0, :3, 0] = 0.0              # sign 0: no flip either side
    np.testing.assert_allclose(
        ops.track_features(torch.from_numpy(tracks)).numpy(),
        np.asarray(j_ops.track_features(jnp.asarray(tracks))), atol=1e-6)


def _saturating_tracks():
    """Tracks with segments at +-KAPPA_MAX on the side their residual
    pushes toward: their headroom is 0, both passes leave them at the
    bound, and each pass's clip sits at a tie."""
    rng = np.random.default_rng(9)
    k = rng.uniform(-0.5, 0.55, (B, T)).astype(np.float32)
    k[0] = rng.uniform(0.0, 0.3, T)      # 0 < sum < 2 pi: pushed up
    k[0, :4] = data.KAPPA_MAX
    k[1] = rng.uniform(-0.3, 0.0, T)     # -2 pi < sum < 0: pushed down
    k[1, :4] = -data.KAPPA_MAX
    w = rng.uniform(0.1, 0.3, (B, T)).astype(np.float32)
    return np.stack([k, w], -1)


@pytest.mark.parametrize("case", ["saturating_one_pass", "generic"])
def test_closure_project_and_its_gradient_match_jax(case):
    """Forward and VJP against JAX.  ``saturating_one_pass``: segments at
    +-KAPPA_MAX whose residual pushes them further have headroom 0, stay
    at the bound, and the clip's derivative there is JAX's 0.5.  The
    second pass's residual is f32 rounding noise, so its sign (and with it
    whether a bound segment sits at a tie or moves by ~1e-8) follows the
    summation order of ``kappa.sum``: on saturating tracks the two
    packages' two-pass derivatives differ at the bound segments, in the
    reference as between any two orders, and are held on tracks that stay
    inside the bounds."""
    if case == "generic":
        tracks, iters = data.synthetic_tracks(B, T, seed=16), 2
        tracks[..., 0] *= 0.8
    else:
        tracks, iters = _saturating_tracks(), 1
    ct = np.random.default_rng(10).normal(size=tracks.shape).astype(
        np.float32)
    want, vjp = jax.vjp(lambda t: j_ops.closure_project(t, iters),
                        jnp.asarray(tracks))
    (want_g,) = vjp(jnp.asarray(ct))
    x = torch.from_numpy(tracks).requires_grad_()
    got = ops.closure_project(x, iters)
    (got_g,) = torch.autograd.grad(got, x, torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    kap = got.detach().numpy()[..., 0]
    if case != "generic":
        assert (kap[0, :4] == data.KAPPA_MAX).all()
        assert (kap[1, :4] == -data.KAPPA_MAX).all()
        # the two-pass forward agrees on them too
        np.testing.assert_allclose(
            ops.closure_project(torch.from_numpy(tracks)).numpy(),
            np.asarray(j_ops.closure_project(jnp.asarray(tracks))),
            atol=1e-6)
    np.testing.assert_allclose(np.abs(kap.sum(-1)), 2 * np.pi, atol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-5)


def test_clip_derivative_at_a_tie_is_jax_half():
    x = torch.tensor([-0.6, 0.6, 0.0, 0.7], requires_grad=True)
    (g,) = torch.autograd.grad(ops.clip(x, -0.6, 0.6).sum(), x)
    want = jax.grad(lambda v: jnp.clip(v, -0.6, 0.6).sum())(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    assert g.tolist() == [0.5, 0.5, 1.0, 0.0]


def test_closure_penalty_and_gradient_match_jax():
    tracks = _saturating_tracks()
    want, want_g = jax.value_and_grad(j_ops.closure_penalty)(
        jnp.asarray(tracks))
    x = torch.from_numpy(tracks).requires_grad_()
    got = ops.closure_penalty(x)
    (got_g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-6)


def _models(jcfg, cfg, seed=0):
    m = jcfg.model
    cond = jnp.zeros((2, m.cond_dim)) if m.cond_dim else None
    pg = j_models.TrackGenerator(m).init(
        jax.random.key(seed), jnp.zeros((2, m.latent_dim)), cond)["params"]
    pd = j_models.TrackCritic(m).init(
        jax.random.key(seed + 1), jnp.zeros((2, T, 2)), cond)["params"]
    gen = TrackGenerator(cfg.model)
    gen.load_state_dict(generator_params_from_flat(_flat(pg, "generator")))
    critic = TrackCritic(cfg.model)
    critic.load_state_dict(critic_params_from_flat(_flat(pd, "discriminator")))
    return pg, pd, gen, critic


def _grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        assert _rel(got[k], w) <= GRAD_TOL, (k, _rel(got[k], w))


G_CASES = {"plain": {}, "closure_in_model": {"model.closure_in_model": True},
           "conditional": {"model.cond_dim": 4}}


@pytest.mark.parametrize("case", list(G_CASES))
def test_generator_forward_and_parameter_gradients_match_jax(case):
    jcfg, cfg = _cfgs(**G_CASES[case])
    pg, _, gen, _ = _models(jcfg, cfg)
    rng = np.random.default_rng(12)
    z = rng.normal(size=(B, 8)).astype(np.float32)
    c = (rng.uniform(size=(B, 4)).astype(np.float32)
         if jcfg.model.cond_dim else None)
    ct = rng.normal(size=(B, T, 2)).astype(np.float32)
    jgen = j_models.TrackGenerator(jcfg.model)
    want, vjp = jax.vjp(lambda p: jgen.apply(
        {"params": p}, jnp.asarray(z), None if c is None else jnp.asarray(c)),
        pg)
    (want_g,) = vjp(jnp.asarray(ct))
    got = gen(torch.from_numpy(z), None if c is None else torch.from_numpy(c))
    assert _rel(got.detach().numpy(), want) <= FWD_TOL
    params = dict(gen.named_parameters())
    grads = torch.autograd.grad(got, list(params.values()),
                                torch.from_numpy(ct))
    _grads_close({f"generator/{k.replace('.', '/')}": g.numpy()
                  for k, g in zip(params, grads)},
                 _flat(want_g, "generator"))


@pytest.mark.parametrize("cond_dim", [0, 4])
def test_critic_forward_input_and_parameter_gradients_match_jax(cond_dim):
    jcfg, cfg = _cfgs(**{"model.cond_dim": cond_dim})
    _, pd, _, critic = _models(jcfg, cfg, seed=3)
    rng = np.random.default_rng(13)
    x = data.synthetic_tracks(B, T, seed=14)
    c = rng.uniform(size=(B, 4)).astype(np.float32) if cond_dim else None
    jc = None if c is None else jnp.asarray(c)
    jcrit = j_models.TrackCritic(jcfg.model)

    def score(p, xx):
        return jcrit.apply({"params": p}, xx, jc).sum()

    want = jcrit.apply({"params": pd}, jnp.asarray(x), jc)
    want_gp, want_gx = jax.grad(score, argnums=(0, 1))(pd, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = critic(xt, None if c is None else torch.from_numpy(c))
    assert _rel(got.detach().numpy(), want) <= FWD_TOL
    params = dict(critic.named_parameters())
    grads = torch.autograd.grad(got.sum(), [xt, *params.values()])
    assert _rel(grads[0].numpy(), want_gx) <= GRAD_TOL
    _grads_close({f"discriminator/{k.replace('.', '/')}": g.numpy()
                  for k, g in zip(params, grads[1:])},
                 _flat(want_gp, "discriminator"))


def test_fresh_models_have_the_flax_names_and_shapes():
    jcfg, cfg = _cfgs(**{"model.cond_dim": 4})
    pg, pd, _, _ = _models(jcfg, cfg)
    g = torch.Generator().manual_seed(0)
    gen = TrackGenerator(cfg.model).init_params(g)
    critic = TrackCritic(cfg.model).init_params(g)
    for module, tree, prefix in ((gen, pg, "generator"),
                                 (critic, pd, "discriminator")):
        want = {k: v.shape for k, v in _flat(tree, prefix).items()}
        got = {f"{prefix}/{k.replace('.', '/')}": tuple(v.shape)
               for k, v in module.state_dict().items()}
        assert got == want
    hr = gen.gru.hr.kernel.detach()
    torch.testing.assert_close(hr.t() @ hr, torch.eye(16), atol=1e-5,
                               rtol=0)
    assert float(gen.emit.kernel.std()) < 0.05


def test_render_equals_jax():
    tracks = data.synthetic_tracks(5, T, seed=15)
    np.testing.assert_array_equal(render.render_tracks_gray(tracks, 3, 64),
                                  j_render.render_tracks_gray(tracks, 3, 64))
