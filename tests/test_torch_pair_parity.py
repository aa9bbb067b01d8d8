"""BASELINE's mbstd pair held to the JAX package over many steps and in
bf16, on the CPU.

The pair is ``wgan_gp_32`` with ``train.w_presence=10`` and
``model.critic_mbstd=input`` (BASELINE.md, round 3): the relaxed softmax
head's sample feeds the presence prior (soft counts, soft maxima, the
straight-through spread) and the critic's per-position minibatch-stddev
channel, over the fakes and over the GP's interpolates.  Both packages
start from the JAX package's initial weights (bridged), the port gets the
JAX step's draws at every step (``test_torch_train._jax_draws``), and each
side carries its own step counter, Adams, learning-rate schedule and G EMA
from one step to the next.

(a) ``K`` whole WGAN-GP steps in f32 at small widths for the pair, each of
its two knobs alone, the control (neither), the pair with the plain GP
(``model.pallas_gp='xla'`` against ``'auto'``, which takes the K2 core's
plain version on the CPU) and the pair with every schedule on (cosine lr,
the mbstd anneal, the excess-hinge ramp): every step's losses, and after
step ``K`` every parameter, both Adams' moments and the EMA.
(b) One step of the pair and of the control in bf16: the dtype at each
boundary of the pair's step equals JAX's, the values hold at bf16
tolerances.
(c) The bf16 forward of G and D rounds where the JAX program rounds: the
LeakyReLU slope in the activation dtype, and each conv / Dense bias added
after the product is rounded.  JAX is run op by op here (no jit): under
jit XLA may keep f32 across a bf16 cast inside a fusion, so the step of
(b) holds the port to the compiled step only at bf16 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from levelgan.config import preset as j_preset
from levelgan.data.dataset import synthetic_corpus
from levelgan.models import Critic as JCritic
from levelgan.models import Generator as JGenerator
from levelgan.models import sample_head as j_sample_head
from levelgan.ops.grad_penalty import interpolate as j_interpolate
from levelgan.ops.presence import presence_penalty as j_presence_penalty
from levelgan.train.gan import prepare_real as j_prepare_real
from levelgan.train.state import create_state as j_create_state
from levelgan.train.wgan_gp import make_wgan_gp_step as j_make_step
from levelgan_torch.bridge import (critic_params_from_flat,
                                   generator_params_from_flat)
from levelgan_torch.config import Config
from levelgan_torch.models import Critic, Generator, sample_head
from levelgan_torch.ops.grad_penalty import interpolate
from levelgan_torch.ops.presence import presence_penalty
from levelgan_torch.train import state as tstate
from levelgan_torch.train.gan import prepare_real
from levelgan_torch.train.wgan_gp import make_wgan_gp_step
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import _flat, _jax_draws

K = 16                      # consecutive steps held to JAX
B, N_CRITIC, LEVEL, LR = 8, 2, 16, 1e-4
SMALL = {"model.level_size": LEVEL, "model.base_channels": 16,
         "model.critic_base_channels": 16, "model.group_size": 8,
         "model.latent_dim": 8, "train.batch_size": B,
         "train.n_critic": N_CRITIC}
PAIR = {"train.w_presence": 10.0, "model.critic_mbstd": "input"}
# arm -> (overrides of both packages, overrides of the port only)
ARMS = {
    "pair": (PAIR, {}),
    "presence": ({"train.w_presence": 10.0}, {}),
    "mbstd": ({"model.critic_mbstd": "input"}, {}),
    "control": ({}, {}),
    "pair_plain_gp": (PAIR, {"model.pallas_gp": "xla"}),
    "pair_schedules": ({**PAIR, "train.lr_schedule": "cosine",
                        "train.steps": K, "train.mbstd_anneal_start": 4,
                        "train.mbstd_anneal_steps": 8,
                        "train.mbstd_anneal_floor": 0.25,
                        "train.presence_excess": 1.0,
                        "train.presence_excess_start": 2,
                        "train.presence_excess_ramp": 8}, {}),
}
METRICS = ("d_loss", "gp", "wdist", "g_loss", "presence")
# f32: a metric within METRIC_RTOL of JAX's (denominator at least
# METRIC_FLOOR) at every step, check_one_step_matches_jax's rtol; after K
# steps every parameter and EMA element within PARAM_ATOL (lr / 10 in all,
# not a step), each Adam moment within MOMENT_RTOL of its tensor's largest
# |value|; and each arm's deviation of each kind within DRIFT_FACTOR of the
# control's, or under DRIFT_FLOOR, a quarter of the bound (the rounding of
# f32 sums taken in another order, too small for a ratio to mean anything)
METRIC_RTOL, METRIC_FLOOR = 1e-4, 1e-3
PARAM_ATOL = LR / 10
MOMENT_RTOL = 1e-3
DRIFT_FACTOR = 10.0
DRIFT_FLOOR = {"metrics": METRIC_RTOL / 4, "params": PARAM_ATOL / 4,
               "ema": PARAM_ATOL / 4, "mu": MOMENT_RTOL / 4,
               "nu": MOMENT_RTOL / 4}
# bf16, one step: a metric within BF16_RTOL * |JAX| + BF16_ATOL * the
# score scale (the initial critic's mean |score| over the step's first
# real batch); the share of
# parameter elements whose update differs from JAX's by more than lr / 10
# (Adam's first update is lr * sign(g), so a gradient near zero whose sign
# the rounding flips moves by 2 lr) under BF16_FLIP_SHARE, and the pair's
# within DRIFT_FACTOR of the control's
BF16_RTOL, BF16_ATOL = 2.0 ** -5, 2.0 ** -6
BF16_FLIP_SHARE = 0.05
# the JAX program's roundings, op by op: the critic's score within
# FWD_RTOL of JAX's, each generator stage's output bf16-equal to JAX's on
# at least FWD_EQUAL of its elements (the rest one rounding apart where f32
# sums in another order land on the other side of a bf16 tie)
FWD_RTOL, FWD_EQUAL = 1e-5, 0.999
# and the critic's input gradient within GRAD_ATOL of its largest |value|
# (one bf16 rounding of a cotangent, 2^-8 relative, carried by a few ops)
GRAD_ATOL = 2.0 ** -6


def _jcfg(arm, dtype="float32"):
    both, _ = ARMS[arm]
    return j_preset("wgan_gp_32").override(
        **{**SMALL, "model.dtype": dtype, **both})


def _port_cfg(jcfg, arm):
    return Config.from_dict(jcfg.override(**ARMS[arm][1]).to_dict())


def _port_state(cfg, flat):
    gen, critic = Generator(cfg.model), Critic(cfg.model)
    gen.load_state_dict(generator_params_from_flat(flat))
    critic.load_state_dict(critic_params_from_flat(flat))
    return tstate.create_state(cfg, "cpu", generator=gen, critic=critic)


def _port_named(module, prefix):
    return {f"{prefix}/{k.replace('.', '/')}": v
            for k, v in module.named_parameters()}


def _j_init(jcfg):
    """The JAX package's initial state from key 0 (one jit: Flax's init
    run op by op compiles each primitive on its own, seconds a config)."""
    return jax.jit(lambda key: j_create_state(jcfg, key))(jax.random.key(0))


_JAX_RUNS: dict = {}
_DEVIATIONS: dict = {}


def _jax_run(key, dtype="float32", steps=K):
    """The JAX package's run of ``key``'s config: the initial parameters,
    the batches, each step's draws and metrics, the final state (one jit
    of the step, reused across the steps)."""
    if (key, dtype, steps) in _JAX_RUNS:
        return _JAX_RUNS[key, dtype, steps]
    jcfg = _jcfg(key, dtype)
    state = _j_init(jcfg)
    state0 = state
    flat = {**_flat(state.generator, "generator"),
            **_flat(state.discriminator, "discriminator")}
    ids = synthetic_corpus(steps * N_CRITIC * B, LEVEL, seed=3).reshape(
        steps, N_CRITIC, B, LEVEL, LEVEL)
    step = jax.jit(j_make_step(jcfg))
    draws, metrics = [], []
    for k in range(steps):
        draws.append(_jax_draws(jcfg, state))
        state, met = step(state, jnp.asarray(ids[k]))
        metrics.append({m: float(v) for m, v in met.items()
                        if m in METRICS})
    run = {"jcfg": jcfg, "flat": flat, "ids": ids, "draws": draws,
           "metrics": metrics, "state0": state0, "state": state}
    _JAX_RUNS[key, dtype, steps] = run
    return run


def _port_run(arm, run):
    """The port's steps from the JAX run's start, with its draws."""
    cfg = _port_cfg(run["jcfg"], arm)
    state = _port_state(cfg, run["flat"])
    step = make_wgan_gp_step(cfg)
    metrics = []
    for ids, noise in zip(run["ids"], run["draws"]):
        state, met = step(state, torch.from_numpy(ids), noise=noise)
        metrics.append({m: float(v) for m, v in met.items()
                        if m in METRICS})
    return state, metrics


def _moments(opt, module, prefix):
    named = _port_named(module, prefix)
    return {slot: {k: opt.state[p][name].numpy() for k, p in named.items()}
            for slot, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}


def _metric_dev(got, want):
    return max(abs(g[m] - w[m]) / max(abs(w[m]), METRIC_FLOOR)
               for g, w in zip(got, want) for m in w)


def _deviation(arm):
    """The port's deviation from JAX over the K steps of ``arm``."""
    if arm in _DEVIATIONS:
        return _DEVIATIONS[arm]
    run = _jax_run("pair" if arm == "pair_plain_gp" else arm)
    state, metrics = _port_run(arm, run)
    assert state.step == K
    assert [set(m) for m in metrics] == [set(m) for m in run["metrics"]]
    js = run["state"]
    assert int(js.step) == K
    dev = {"metrics": _metric_dev(metrics, run["metrics"])}
    for kind, prefix, module, tree in (
            ("params", "generator", state.generator, js.generator),
            ("params", "discriminator", state.critic, js.discriminator),
            ("ema", "generator", state.g_ema, js.g_ema)):
        want = _flat(tree, prefix)
        got = {k: v.detach().numpy() for k, v in _port_named(
            module, prefix).items()}
        assert set(got) == set(want)
        dev[kind] = max(dev.get(kind, 0.0), max(
            float(np.abs(got[k] - w).max()) for k, w in want.items()))
    for opt, module, prefix, jopt in (
            (state.opt_g, state.generator, "generator", js.opt_g),
            (state.opt_d, state.critic, "discriminator", js.opt_d)):
        assert opt.count == int(jopt[0].count)
        got = _moments(opt, module, prefix)
        for slot in ("mu", "nu"):
            want = _flat(getattr(jopt[0], slot), prefix)
            dev[slot] = max(dev.get(slot, 0.0), max(
                float(np.abs(got[slot][k] - w).max()
                      / max(np.abs(w).max(), 1e-30))
                for k, w in want.items()))
    _DEVIATIONS[arm] = dev
    return dev


@pytest.mark.parametrize("arm", list(ARMS))
def test_k_steps_hold_to_jax(arm):
    """K consecutive f32 steps: every step's losses, then every parameter,
    Adam moment and EMA element, at the bounds above and within
    DRIFT_FACTOR of the control's deviation."""
    dev, ctl = _deviation(arm), _deviation("control")
    assert dev["metrics"] <= METRIC_RTOL, dev
    assert dev["params"] <= PARAM_ATOL and dev["ema"] <= PARAM_ATOL, dev
    assert dev["mu"] <= MOMENT_RTOL and dev["nu"] <= MOMENT_RTOL, dev
    for kind, d in dev.items():
        assert d <= max(DRIFT_FACTOR * ctl[kind], DRIFT_FLOOR[kind]), (
            kind, dev, ctl)


# ---- bf16 ---------------------------------------------------------------

def _bf16_step(arm):
    """One bf16 step of ``arm`` on each side: (port metrics, JAX metrics,
    the parameter updates of each side, the score scale: the initial
    critic's mean |score| over the step's first real batch)."""
    run = _jax_run(arm, "bfloat16", steps=1)
    cfg = _port_cfg(run["jcfg"], arm)
    state = _port_state(cfg, run["flat"])
    ids = torch.from_numpy(run["ids"][0])
    with torch.no_grad():
        real, _ = prepare_real(cfg, ids[0],
                               run["draws"][0]["critic"][0]["elements"])
        scale = float(state.critic(real).float().abs().mean())
    before = {**_port_named(state.generator, "generator"),
              **_port_named(state.critic, "discriminator")}
    before = {k: v.detach().clone().numpy() for k, v in before.items()}
    state, met = make_wgan_gp_step(cfg)(state, ids, noise=run["draws"][0])
    got = {**_port_named(state.generator, "generator"),
           **_port_named(state.critic, "discriminator")}
    js = run["state"]
    want = {**_flat(js.generator, "generator"),
            **_flat(js.discriminator, "discriminator")}
    d_got = {k: got[k].detach().numpy() - before[k] for k in want}
    d_want = {k: want[k] - before[k] for k in want}
    return ({m: float(v) for m, v in met.items() if m in METRICS},
            run["metrics"][0], d_got, d_want, scale)


def _flip_share(d_got, d_want):
    n = sum(v.size for v in d_want.values())
    return sum(int((np.abs(d_got[k] - w) > LR / 10).sum())
               for k, w in d_want.items()) / n


@pytest.mark.parametrize("arm", ["pair", "control"])
def test_bf16_step_holds_to_jax(arm):
    """The compiled JAX step in bf16 against the port's: the losses at bf16
    tolerance, and few parameter updates apart (a rounding that flips a
    near-zero gradient's sign), the pair's share within DRIFT_FACTOR of the
    control's."""
    got, want, d_got, d_want, scale = _bf16_step(arm)
    assert set(got) == set(want)
    for m, w in want.items():
        assert abs(got[m] - w) <= BF16_RTOL * abs(w) + BF16_ATOL * scale, (
            m, got, want, scale)
    share = _flip_share(d_got, d_want)
    assert share <= BF16_FLIP_SHARE, share
    if arm == "pair":
        _, _, c_got, c_want, _ = _bf16_step("control")
        assert share <= DRIFT_FACTOR * max(_flip_share(c_got, c_want),
                                           1.0 / sum(v.size for v in
                                                     d_want.values()))


# ---- the dtype at each boundary of the pair's bf16 step -----------------

def _dt(t):
    return str(t.dtype).removeprefix("torch.")


def _leaves(tree, out):
    if isinstance(tree, torch.Tensor):
        out.append((tuple(tree.shape), _dt(tree)))
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _leaves(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _leaves(t, out)
    return out


class _TorchOps(TorchDispatchMode):
    """Every ATen operation run: (name, [(shape, dtype)] in, out)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((func.overloadpacket.__name__,
                         _leaves((args, kwargs or {}), []),
                         _leaves(out, [])))
        return out


def _jax_ops(fn, *args):
    """Every primitive of ``fn``'s jaxpr, sub-jaxprs flattened in program
    order: (name, [(shape, dtype)] in, out)."""
    ops = []

    def walk(jaxpr):
        for e in jaxpr.eqns:
            subs = [getattr(v, "jaxpr", v) for v in e.params.values()
                    if hasattr(v, "eqns") or hasattr(v, "jaxpr")]
            if subs:
                for s in subs:
                    walk(s)
                continue
            ops.append((e.primitive.name,
                        [(tuple(v.aval.shape), str(v.aval.dtype))
                         for v in e.invars if hasattr(v, "aval")],
                        [(tuple(v.aval.shape), str(v.aval.dtype))
                         for v in e.outvars]))

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return ops


def _mbstd_boundary(ops, concat, n_tiles):
    """(the map [H, W] before its cast, the map channel concatenated to
    the input): the dtype of the last [H, W] value before the
    concatenation that appends the channel, and of that channel."""
    at = next(i for i, (name, _, outs) in enumerate(ops)
              if name == concat and outs[0][0][-1] == n_tiles + 1)
    before = [outs[0][1] for _, _, outs in ops[:at]
              if outs and outs[0][0] == (LEVEL, LEVEL)][-1]
    return before, ops[at][1][1][1]


def _presence_chans(ops, reduce_sum):
    """The dtype of the presence prior's ``chans``: the operand of its
    first sum over the cells ([B, H, W, 2] -> [B, 2])."""
    return next(ins[0][1] for name, ins, outs in ops
                if name == reduce_sum and outs[0][0] == (B, 2)
                and ins[0][0] == (B, LEVEL, LEVEL, 2))


def test_bf16_boundary_dtypes_equal_jax():
    """The pair's bf16 step: the logits, the softmax sample, the mbstd map
    before and after its cast to the activation dtype, the presence
    prior's ``chans``, x_hat and its input gradient in the GP, each in
    JAX's dtype, and each value at bf16 tolerance."""
    run = _jax_run("pair", "bfloat16", steps=1)
    jcfg = run["jcfg"]
    jm = jcfg.model
    cfg = _port_cfg(jcfg, "pair")
    state = _port_state(cfg, run["flat"])
    it = run["draws"][0]["critic"][0]
    j0 = run["state0"]
    ids = run["ids"][0][0]
    critic_j = JCritic(jm)

    @jax.jit
    def jax_side(j0, ids):
        """The first critic iteration's sample, x_hat and input gradient,
        from the step's own keys (``wgan_gp.py``'s derivation)."""
        base = jax.random.fold_in(j0.rng, j0.step)
        k_aug, k_z, k_s, k_eps = jax.random.split(jax.random.split(
            jax.random.fold_in(base, 0), N_CRITIC)[0], 4)
        z = jax.random.normal(k_z, (B, jm.latent_dim), jnp.float32)
        logits = JGenerator(jm).apply({"params": j0.generator}, z)
        fake = j_sample_head(k_s, logits, jm.head)
        real, _ = j_prepare_real(jcfg, k_aug, ids)
        x_hat = j_interpolate(k_eps, real, fake)
        grad = jax.grad(lambda x: critic_j.apply(
            {"params": j0.discriminator}, x).astype(jnp.float32).sum())(x_hat)
        return logits, fake, x_hat, grad, j_presence_penalty(fake)

    lj, fj, xj, gj, pj = jax_side(j0, jnp.asarray(ids))
    got, want = {}, {}
    # logits and the softmax sample
    with torch.no_grad():
        lp = state.generator(it["z"])
        fp = sample_head(lp, cfg.model.head, noise=it["noise"])
    want["logits"], got["logits"] = _dt(lj), _dt(lp)
    want["sample"], got["sample"] = _dt(fj), _dt(fp)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=0,
                               atol=BF16_RTOL * float(jnp.abs(lj).max()))
    np.testing.assert_allclose(fp.numpy(), np.asarray(fj), rtol=0,
                               atol=BF16_RTOL)
    # x_hat and its input gradient in the GP
    rp, _ = prepare_real(cfg, torch.from_numpy(ids), it["elements"])
    xp = interpolate(rp, fp, it["eps"]).requires_grad_(True)
    (gp,) = torch.autograd.grad(state.critic(xp).float().sum(), xp)
    want["x_hat"], got["x_hat"] = _dt(xj), _dt(xp)
    want["x_hat_grad"], got["x_hat_grad"] = _dt(gj), _dt(gp)
    np.testing.assert_allclose(xp.detach().numpy(), np.asarray(xj),
                               rtol=0, atol=BF16_RTOL)
    # per sample, as the GP reads it: the compiled step's gradient moves
    # elementwise by up to a tenth of its largest |value| from the same
    # program run op by op (XLA keeps some bf16 cotangents in f32), which
    # the port follows (test_bf16_forward_rounds_where_the_jax_program_rounds)
    np.testing.assert_allclose(
        torch.linalg.vector_norm(gp, dim=(1, 2, 3)).numpy(),
        np.sqrt(np.square(np.asarray(gj)).sum((1, 2, 3))), rtol=BF16_RTOL)
    # the mbstd map, traced in the critic's forward on x_hat
    want["mbstd_map"], want["mbstd_channel"] = _mbstd_boundary(
        _jax_ops(lambda x: critic_j.apply({"params": j0.discriminator}, x),
                 xj), "concatenate", jm.n_tiles)
    with _TorchOps() as rec, torch.no_grad():
        state.critic(xp.detach())
    got["mbstd_map"], got["mbstd_channel"] = _mbstd_boundary(
        rec.ops, "cat", jm.n_tiles)
    # the presence prior's chans, on the sample the G update scores
    want["presence_chans"] = _presence_chans(
        _jax_ops(j_presence_penalty, fj), "reduce_sum")
    with _TorchOps() as rec:
        pp = presence_penalty(fp)
    got["presence_chans"] = _presence_chans(rec.ops, "sum")
    np.testing.assert_allclose(float(pp), float(pj), rtol=BF16_RTOL)
    assert got == want
    assert want["mbstd_map"] == "float32" and want["mbstd_channel"] == (
        "bfloat16")


# ---- where the bf16 program rounds ----------------------------------------

def _perturbed(seed=1):
    """The pair's JAX-initialised weights moved off their init (non-zero
    biases, GN affines off one), so that every bias and scale takes
    part."""
    state = _jax_run("pair", "bfloat16", steps=1)["state0"]
    rng = np.random.default_rng(seed)

    def move(tree, s):
        return jax.tree_util.tree_map(
            lambda a: a + s * rng.standard_normal(a.shape).astype(a.dtype),
            tree)
    return move(state.generator, 0.05), move(state.discriminator, 0.01)


def test_bf16_forward_rounds_where_the_jax_program_rounds():
    """G and D in bf16 against the JAX modules run op by op: each generator
    stage (fed JAX's own input) bf16-equal on FWD_EQUAL of its elements,
    the critic's score within FWD_RTOL, its input gradient within
    GRAD_ATOL.  A slope of 0.2 in f32 instead of
    its bf16 rounding, or a bias added inside the conv before the one
    rounding, moves a quarter of a stage's elements and the score by
    about 1e-2."""
    jcfg = _jcfg("pair", "bfloat16")
    jm = jcfg.model
    cfg = _port_cfg(jcfg, "pair")
    pg, pd = _perturbed()
    flat = {**_flat(pg, "generator"), **_flat(pd, "discriminator")}
    gen, critic = Generator(cfg.model), Critic(cfg.model)
    gen.load_state_dict(generator_params_from_flat(flat))
    critic.load_state_dict(critic_params_from_flat(flat))
    rng = np.random.default_rng(2)
    z = rng.standard_normal((B, jm.latent_dim)).astype(np.float32)
    logits, inter = JGenerator(jm).apply({"params": pg}, jnp.asarray(z),
                                         capture_intermediates=True)
    inter = inter["intermediates"]

    def bits(t):
        return np.array(jnp.asarray(t).astype(jnp.float32))

    bf = torch.bfloat16
    with torch.no_grad():
        x = gen.seed(torch.from_numpy(z), bf)
        assert np.array_equal(x.float().numpy(), bits(
            inter["seed"]["__call__"][0]))
        stage_in = [torch.from_numpy(bits(inter[f"up{i - 1}"]["__call__"][0])
                                     ).to(bf) if i else None
                    for i in range(gen.n_stages)]
        from levelgan_torch.ops.blocks import group_norm, leaky_relu
        stage_in[0] = leaky_relu(group_norm(
            x.reshape(B, 4, 4, -1), gen.seed_scale, gen.seed_bias,
            jm.group_size), jm.leaky_slope).to(bf)
        for i, stage in enumerate(gen.stages()):
            y = stage(stage_in[i]).float().numpy()
            equal = np.mean(y == bits(inter[f"up{i}"]["__call__"][0]))
            assert equal >= FWD_EQUAL, (i, equal)
        last = torch.from_numpy(bits(
            inter[f"up{gen.n_stages - 1}"]["__call__"][0])).to(bf)
        equal = np.mean(gen.to_tiles(last, bf).float().numpy()
                        == bits(inter["to_tiles"]["__call__"][0]))
        assert equal >= FWD_EQUAL, equal
        fake = torch.softmax(torch.from_numpy(np.array(logits)), -1)
    x = fake.requires_grad_(True)
    score = critic(x)
    (grad,) = torch.autograd.grad(score.float().sum(), x)
    critic_j = JCritic(jm)
    want = np.asarray(critic_j.apply({"params": pd}, jnp.asarray(
        fake.detach().numpy())))
    np.testing.assert_allclose(score.detach().numpy(), want, rtol=FWD_RTOL,
                               atol=FWD_RTOL * np.abs(want).max())
    # the input gradient the GP penalises: the slope's rounding runs in
    # the backward too
    want = np.asarray(jax.grad(lambda v: critic_j.apply(
        {"params": pd}, v).astype(jnp.float32).sum())(jnp.asarray(
            fake.detach().numpy())))
    np.testing.assert_allclose(grad.numpy(), want, rtol=0,
                               atol=GRAD_ATOL * np.abs(want).max())


# ---- the whole runs' record ------------------------------------------------

def test_whole_runs_kl_window_and_jax_row(tmp_path):
    """``whole_runs.py record`` keeps a run's window KL at steps 1,000 to
    3,000 by 500 and its range over the last 1,000 steps, and compares a
    tagged run of the pair (a seed, dp=4) with the pair's JAX row."""
    import json

    import whole_runs

    path = tmp_path / "metrics.jsonl"
    with open(path, "w") as fh:
        for step in range(100, 3001, 100):
            fh.write(json.dumps({"step": step, "d_loss": 1.0}) + "\n")
            fh.write(json.dumps({"step": step, "kl": step / 1e4}) + "\n")
    got = whole_runs.kl_window(str(path), 3000)
    assert got["at"] == {str(s): s / 1e4 for s in whole_runs.KL_AT}
    assert got["last_1000"] == {"min": 0.21, "max": 0.3, "n": 10}
    assert whole_runs.kl_window(str(tmp_path / "none.jsonl"), 3000) is None
    for name in ("wgan_gp_32_mbin", "wgan_gp_32_mbin_dp4",
                 "wgan_gp_32_mbin_seed3", "wgan_gp_32_mbin_fixed_dp4"):
        assert whole_runs.jax_row_key(name) == "wgan_gp_32_mbin", name
    for name in ("wgan_gp_32", "toy_dcgan_16_seed1", "wgan_gp_32_mbinx"):
        assert whole_runs.jax_row_key(name) is None, name
