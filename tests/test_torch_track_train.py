"""Port parity: the track family's train steps (``levelgan_torch/track/
train.py``) against ``levelgan/track/train.py`` on the CPU in f32.

Each case runs the JAX step (its XLA GP, ``use_pallas=False``) and
reproduces its key derivation (``track/train.py:85-99, 145-148, 202-206``,
the augment's as ``track/ops.py:21-24``, the drivers' action keys as
``track/race.py:143``) to draw the same shifts, flips, z, GP eps,
exploration noise and action noise, and feeds them to the port's step
from the same parameters, drivers and baseline (the port's GP is
``'auto'``: the K2 core, whose wrapper runs its plain version on CPU
tensors).  Tolerances: every scalar metric at rtol 1e-4 (the drivers'
metrics too: the raced tracks agree to a few ulps and the actions with
them), the generated curvature histogram within one count moved between
neighbouring bins, the baseline at rtol 1e-5, and each parameter's change
within a tenth of its learning rate of the JAX step's (each Adam update
moves an element by about its lr, so this catches a sign flip or a missed
update).  One exception, for the critic: Adam's step lr * g / (|g| + 1e-8)
is ill-conditioned where |g| is near eps, and a GroupNorm bias whose
gradient cancels to ~1e-9 in one iteration moves by a fraction of lr
set by rounding noise.  The critic's Adam runs at b1 = 0, b2 = 0.9 over
two iterations, so its final moments give both gradients (mu = g2, nu =
0.09 g1^2 + 0.1 g2^2); where either is below ``ILL_G`` the element is
held within lr instead.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.api import make_step_fn as j_make_step_fn
from levelgan.config import preset as j_preset
from levelgan.track.train import create_track_curriculum_state as j_create_c
from levelgan.track.train import create_track_state as j_create
from levelgan.track.train import make_track_wgan_step as j_make_wgan
from levelgan_torch import api
from levelgan_torch.bridge import (agent_params_from_flat,
                                   critic_params_from_flat,
                                   generator_params_from_flat)
from levelgan_torch.config import Config
from levelgan_torch.track.models import TrackCritic, TrackGenerator
from levelgan_torch.track.race import DriverPolicy
from levelgan_torch.track.train import (make_track_curriculum_step,
                                        make_track_wgan_step)
from levelgan_torch.train.state import create_state
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, N_CRITIC, T, STEPS = 4, 2, 16, 8
LR = 1e-4
TINY = {"train.batch_size": B, "train.n_critic": N_CRITIC,
        "model.n_segments": T, "model.rnn_hidden": 16,
        "model.critic_base_channels": 8, "model.group_size": 4,
        "model.latent_dim": 8, "model.dtype": "float32",
        "curriculum.rollout_steps": STEPS, "data.corpus_size": 32}
CASES = {
    "racetrack_closure_in_model": ("racetrack_32", {}),
    "racetrack_w_closure": ("racetrack_32", {
        "model.closure_in_model": False, "train.w_closure": 0.5}),
    "racetrack_conditional": ("racetrack_32", {"model.cond_dim": 4}),
    "race_curriculum": ("race_curriculum_32", {}),
    "race_curriculum_closure_two_updates": ("race_curriculum_32", {
        "model.closure_in_model": True, "train.w_closure": 0.5,
        "curriculum.agent_updates_per_step": 2}),
}
START_STEP, BASELINE = 2, 0.25
ILL_G = 1e-6                 # |g| under which Adam's step is rounding noise


def _flat(tree, prefix):
    return {f"{prefix}/" + jax.tree_util.keystr(p, simple=True, separator="/"):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_draws(jcfg, state):
    """The draws the JAX track step makes from ``state.rng`` at
    ``state.step``."""
    m = jcfg.model
    base = jax.random.fold_in(state.rng, state.step)
    its = []
    for k in jax.random.split(jax.random.fold_in(base, 0), N_CRITIC):
        k_aug, k_z, k_eps = jax.random.split(k, 3)
        k_shift, k_flip = jax.random.split(k_aug)
        its.append({
            "shifts": _t(jax.random.randint(k_shift, (B,), 0, T)).long(),
            "flips": _t(jax.random.bernoulli(k_flip, 0.5, (B,))),
            "z": _t(jax.random.normal(k_z, (B, m.latent_dim), jnp.float32)),
            "eps": _t(jax.random.uniform(k_eps, (B, 1, 1), jnp.float32))})
    out = {"critic": its}
    if jcfg.train.loss == "wgan_gp":
        out["g"] = {"z": _t(jax.random.normal(
            jax.random.fold_in(base, 1), (B, m.latent_dim), jnp.float32))}
        return out
    k_z, k_expl, k_rs, k_rw = jax.random.split(jax.random.fold_in(base, 2), 4)

    def actions(key):
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.gumbel(k, (B, 9), jnp.float32))
            for k in jax.random.split(key, STEPS)]))

    out.update(
        g={"z": _t(jax.random.normal(k_z, (B, m.latent_dim), jnp.float32))},
        explore=_t(jax.random.normal(k_expl, (B, T))),
        rollout_strong=actions(k_rs), rollout_weak=actions(k_rw))
    return out


def port_state_from(cfg, j_state):
    """The port's state holding ``j_state``'s parameters (drivers and
    baseline too), step, and fresh optimizers (the JAX state's counts are
    0 too)."""
    m = cfg.model
    flat = {**_flat(j_state.generator, "generator"),
            **_flat(j_state.discriminator, "discriminator")}
    gen = TrackGenerator(m)
    gen.load_state_dict(generator_params_from_flat(flat))
    critic = TrackCritic(m)
    critic.load_state_dict(critic_params_from_flat(flat))
    agents = None
    if hasattr(j_state, "agent_strong"):
        agents = []
        for name in ("agent_strong", "agent_weak"):
            pol = DriverPolicy(10)
            pol.load_state_dict(agent_params_from_flat(
                _flat(getattr(j_state, name), name), name))
            agents.append(pol)
        agents = tuple(agents)
    state = create_state(cfg, "cpu", generator=gen, critic=critic,
                         agents=agents)
    state.step = int(j_state.step)
    if agents is not None:
        state.g_baseline = torch.tensor(float(j_state.g_baseline))
    return state


def _batch():
    rng = np.random.default_rng(3)
    from levelgan_torch.track.data import synthetic_tracks
    corpus = synthetic_tracks(16, T, seed=4)
    return corpus[rng.integers(0, 16, (N_CRITIC, B))]


@functools.lru_cache(maxsize=None)
def one_step(case):
    name, kw = CASES[case]
    jcfg = j_preset(name).override(**TINY, **kw)
    cfg = Config.from_dict(jcfg.to_dict())
    curriculum = jcfg.train.loss == "curriculum"
    j_state = (j_create_c if curriculum else j_create)(
        jcfg, jax.random.key(0))
    j_state = j_state.replace(step=jnp.int32(START_STEP))
    if curriculum:
        j_state = j_state.replace(g_baseline=jnp.float32(BASELINE))
    batch = _batch()
    j_step, _ = j_make_step_fn(jcfg)
    j_new, j_met = jax.jit(j_step)(j_state, jnp.asarray(batch))
    state = port_state_from(cfg, j_state)
    make = make_track_curriculum_step if curriculum else make_track_wgan_step
    state, met = make(cfg)(state, torch.from_numpy(batch),
                           noise=jax_draws(jcfg, j_state))
    return jcfg, j_state, j_new, j_met, state, met


def _port_flat(state):
    out = {}
    for field, prefix in (("generator", "generator"),
                          ("critic", "discriminator"), ("g_ema", "g_ema"),
                          ("agent_strong", "agent_strong"),
                          ("agent_weak", "agent_weak")):
        if hasattr(state, field):
            out.update({f"{prefix}/{k.replace('.', '/')}": v.detach().numpy()
                        for k, v in getattr(state, field).state_dict().items()})
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_one_track_step_matches_jax(case):
    jcfg, j_state, j_new, j_met, state, met = one_step(case)
    cur = jcfg.curriculum
    curriculum = jcfg.train.loss == "curriculum"
    assert state.step == START_STEP + 1
    assert set(met) == set(j_met)
    hist = met["gen_hist"].numpy() - np.asarray(j_met["gen_hist"])
    assert hist.sum() == 0 and np.abs(hist).sum() <= 2, hist
    for k in set(met) - {"gen_hist"}:
        np.testing.assert_allclose(float(met[k]), float(j_met[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert state.opt_d.count == N_CRITIC and state.opt_g.count == 1
    trees = ["generator", "discriminator"]
    lrs = {"generator": LR, "discriminator": LR, "g_ema": LR}
    if curriculum:
        np.testing.assert_allclose(float(state.g_baseline),
                                   float(j_new.g_baseline), rtol=1e-5)
        updates = max(1, cur.agent_updates_per_step)
        assert state.opt_as.count == int(j_new.opt_as[0].count) == updates
        trees += ["agent_strong", "agent_weak"]
        lrs.update(agent_strong=cur.agent_lr, agent_weak=cur.weak_agent_lr)
    before = {k: v for t in trees for k, v in _flat(getattr(j_state, t),
                                                    t).items()}
    want = {k: v for t in trees + ["g_ema"]
            for k, v in _flat(getattr(j_new, t), t).items()}
    got = _port_flat(state)
    assert set(got) == set(want)
    assert (jcfg.train.beta1, jcfg.train.beta2, N_CRITIC) == (0.0, 0.9, 2)
    mu = _flat(j_new.opt_d[0].mu, "discriminator")
    nu = _flat(j_new.opt_d[0].nu, "discriminator")
    for k, w in want.items():
        lr = lrs[k.split("/")[0]]
        old = before[k.replace("g_ema/", "generator/")]
        tol = np.full(w.shape, lr / 10)
        if k in mu:
            g1_sq = (nu[k] - 0.1 * mu[k] ** 2) / 0.09
            tol[(np.abs(mu[k]) < ILL_G) | (g1_sq < ILL_G ** 2)] = lr
        assert (np.abs((got[k] - old) - (w - old)) <= tol).all(), k


def _cfg(name, **kw):
    return Config.from_dict(j_preset(name).override(**TINY, **kw).to_dict())


def test_refusals_match_jax():
    """``loss='gan'`` on a track model and ``train.w_presence`` on the
    track WGAN-GP step raise as in the JAX package; ``'fused'`` raises
    (the fused kernel mirrors the tile critic only)."""
    jcfg = j_preset("racetrack_32").override(**TINY, **{"train.loss": "gan"})
    with pytest.raises(ValueError, match="track family supports"):
        j_make_step_fn(jcfg)
    with pytest.raises(ValueError, match="track family supports"):
        api.train(Config.from_dict(jcfg.to_dict()), device="cpu",
                  echo=False)
    jcfg = j_preset("racetrack_32").override(**TINY, **{
        "train.w_presence": 1.0})
    for make in (j_make_wgan, make_track_wgan_step):
        with pytest.raises(ValueError, match="w_presence is tile-family"):
            make(jcfg if make is j_make_wgan
                 else Config.from_dict(jcfg.to_dict()))
    for name in ("racetrack_32", "race_curriculum_32"):
        fused = _cfg(name, **{"model.pallas_gp": "fused"})
        make = (make_track_wgan_step if name == "racetrack_32"
                else make_track_curriculum_step)
        with pytest.raises(ValueError, match="family='track'"):
            make(fused)


def test_api_train_runs_both_presets_and_disables_the_quality_probe(
        tmp_path, capsys):
    for name, keys in (("racetrack_32", ()), ("race_curriculum_32", (
            "g_gan", "g_rl", "drivability", "drivability_weak", "skill_gap",
            "crashes", "laps", "agent_entropy"))):
        cfg = _cfg(name, **{"io.out_dir": str(tmp_path / name),
                            "train.steps": 2, "io.log_every": 1,
                            "io.quality_every": 1})
        res = api.train(cfg, device="cpu")
        assert "io.quality_every is tile-family only" in capsys.readouterr(
        ).out
        for k in ("d_loss", "g_loss", "gp", "wdist", "kl", *keys):
            assert np.isfinite(res["metrics"][k]), k
        assert "solvable_frac" not in res["metrics"]
