"""The two curricula in bf16 against the JAX package, on the CPU.

``race_curriculum_32`` and ``curriculum_16_joint`` train in
``model.dtype`` = bf16, and the K-step tests hold their f32 steps only
(``test_torch_track_steps.py``, ``test_torch_curriculum_steps.py``).
This holds the bf16 program, as ``test_torch_pair_parity.py`` holds the
mbstd pair's, at its tolerances:

(a) One bf16 step of each preset at a small width, from the JAX
package's initial state and with the JAX step's draws (the helpers of
``test_torch_track_train.py`` / ``test_torch_curriculum.py``), against
the compiled JAX step: every metric within ``BF16_RTOL * |JAX| +
BF16_ATOL * scale`` (the scale: the initial critic's mean |score| over
the step's first real batch), and the share of parameter elements (G, D
and both agents) whose update differs from JAX's by more than a tenth of
its module's learning rate under ``BF16_FLIP_SHARE``.
(b) The dtype at each boundary of the track models' bf16 forward equals
JAX's: the GRU's gates, its candidate, its state h, the emit Dense, each
1-D conv's product and bias, GroupNorm's statistics and output, the head,
and the critic's input gradient.
(c) The bf16 forward of ``TrackGenerator`` and ``TrackCritic`` at full
width (race_curriculum_32's) rounds where the JAX program rounds, against
the Flax modules run op by op: each GRU step (fed JAX's own state)
bf16-equal to Flax's ``GRUCell`` on at least ``FWD_EQUAL`` of its
elements, the emit on JAX's states within f32 rounding, each conv and
GroupNorm + LeakyReLU (fed JAX's own input) bf16-equal on ``FWD_EQUAL``,
and the head within ``FWD_RTOL``.  XLA computes the bf16 sigmoid as 1 /
(1 + exp(-x)) rounded op by op; ``torch.sigmoid`` rounds once, and two
gates in three then differ by a bf16 step (the GRU state in 29%).
(d) ``ops.blocks.sigmoid`` / ``tanh`` in bf16 bit-equal to JAX's, value
and gradient, on every bf16 value in [-20, 20].
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_curriculum as tc
import test_torch_track_train as tt
from levelgan.api import make_step_fn as j_make_step_fn
from levelgan.config import preset as j_preset
from levelgan.ops.blocks import leaky_relu as j_leaky_relu
from levelgan.track.data import synthetic_tracks
from levelgan.track.models import TrackCritic as JTrackCritic
from levelgan.track.models import TrackGenerator as JTrackGenerator
from levelgan.track.models import _group_norm_1d
from levelgan.track.train import create_track_curriculum_state as j_create_t
from levelgan.train.curriculum import create_curriculum_state as j_create_c
from levelgan_torch.bridge import (critic_params_from_flat,
                                   generator_params_from_flat)
from levelgan_torch.config import Config
from levelgan_torch.ops import blocks
from levelgan_torch.ops.blocks import group_norm, leaky_relu
from levelgan_torch.track.models import (TrackCritic, TrackGenerator,
                                         normalize_tracks)
from levelgan_torch.track.train import make_track_curriculum_step
from levelgan_torch.train.curriculum import make_curriculum_step
from test_torch_pair_parity import (BF16_ATOL, BF16_FLIP_SHARE, BF16_RTOL,
                                    FWD_EQUAL, FWD_RTOL, GRAD_ATOL, _dt,
                                    _jax_ops, _TorchOps)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BF16 = {"model.dtype": "bfloat16"}
# preset -> (test module with TINY, jax_draws, port_state_from; JAX state;
# port step)
PRESETS = {"race_curriculum_32": (tt, j_create_t, make_track_curriculum_step),
           "curriculum_16_joint": (tc, j_create_c, make_curriculum_step)}


def _batch(name):
    """The step's real batch [n_critic, B, ...] of ``name``."""
    if name == "race_curriculum_32":
        return tt._batch()
    rng = np.random.default_rng(3)
    return rng.integers(0, 8, size=(tc.N_CRITIC, tc.B, tc.LEVEL,
                                    tc.LEVEL)).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def bf16_step(name):
    """One bf16 step of ``name`` on each side: (port metrics, JAX metrics,
    each side's parameter updates, each parameter's learning rate, the
    score scale)."""
    mod, j_create, make = PRESETS[name]
    jcfg = j_preset(name).override(**{**mod.TINY, **BF16})
    cfg = Config.from_dict(jcfg.to_dict())
    j_state = j_create(jcfg, jax.random.key(0))
    batch = _batch(name)
    j_new, j_met = jax.jit(j_make_step_fn(jcfg)[0])(j_state,
                                                     jnp.asarray(batch))
    state = mod.port_state_from(cfg, j_state)
    with torch.no_grad():
        real = torch.from_numpy(batch[0])
        if name == "curriculum_16_joint":
            real = torch.nn.functional.one_hot(
                real.long(), cfg.model.n_tiles).float()
        scale = float(state.critic(real).float().abs().mean())
    trees = ("generator", "discriminator", "agent_strong", "agent_weak")
    before = {k: v for t in trees
              for k, v in mod._flat(getattr(j_state, t), t).items()}
    state, met = make(cfg)(state, torch.from_numpy(batch),
                           noise=mod.jax_draws(jcfg, j_state))
    got = mod._port_flat(state)
    want = {k: v for t in trees
            for k, v in mod._flat(getattr(j_new, t), t).items()}
    cur = jcfg.curriculum
    lrs = {"generator": jcfg.train.lr_g, "discriminator": jcfg.train.lr_d,
           "agent_strong": cur.agent_lr, "agent_weak": cur.weak_agent_lr}
    return ({m: v for m, v in met.items() if m != "gen_hist"},
            {m: v for m, v in j_met.items() if m != "gen_hist"},
            {k: got[k] - before[k] for k in want},
            {k: want[k] - before[k] for k in want},
            {k: lrs[k.split("/")[0]] for k in want}, scale)


@pytest.mark.parametrize("name", list(PRESETS))
def test_bf16_step_holds_to_jax(name):
    """The compiled JAX step in bf16 against the port's: each metric at bf16
    tolerance, and few parameter updates apart."""
    got, want, d_got, d_want, lrs, scale = bf16_step(name)
    assert set(got) == set(want)
    for m, w in want.items():
        g, w = float(got[m]), float(w)
        assert abs(g - w) <= BF16_RTOL * abs(w) + BF16_ATOL * scale, (
            m, g, w, scale)
    assert set(d_got) == set(d_want)
    n = sum(v.size for v in d_want.values())
    apart = sum(int((np.abs(d_got[k] - w) > lrs[k] / 10).sum())
                for k, w in d_want.items())
    assert apart / n <= BF16_FLIP_SHARE, (apart, n)


# ---- the dtype at each boundary of the track models' bf16 forward --------

# distinct sizes, so that each boundary is found by its shape
DB, DT, DH = tt.B, 16, 24
DTYPE_CFG = {"model.n_segments": DT, "model.rnn_hidden": DH,
             "model.latent_dim": 8, "model.critic_base_channels": 8,
             "model.group_size": 4, **BF16}
MATMULS = ("mm", "addmm", "bmm", "matmul", "linear", "dot_general")


def _first(ops, names, shapes, after=0):
    """The index of the first op at or after ``after`` named in ``names``
    whose output shape is in ``shapes``."""
    return next(i for i, (name, _, outs) in enumerate(ops)
                if i >= after and name in names and outs
                and outs[0][0] in shapes)


def _boundaries(ops, *, conv, gates, convert, channels, n_layers):
    """{boundary: dtype} over one side's trace of G then D: ``conv`` names
    the conv product's ops, ``gates`` the sigmoid's, ``convert`` the cast,
    ``channels`` each conv's output channels."""
    out = {}
    i = _first(ops, gates, {(DB, DH), (DB, 2 * DH)})
    out["gru_gate"] = ops[i][2][0][1]
    out["gru_tanh"] = sorted({o[0][1] for name, _, o in ops
                              if name == "tanh" and o[0][0] == (DB, DH)})
    i = next(i for i, (name, ins, _) in enumerate(ops)
             if name == convert and ins and ins[0][0] == (DB, DT, DH))
    out["gru_h"] = ops[i][1][0][1]
    i = _first(ops, MATMULS, {(DB, DT, 2), (DB * DT, 2)})
    out["emit"] = ops[i][2][0][1]
    t, at = DT, i
    for k in range(n_layers):
        t = -(-t // 2)
        shapes = {(DB, t, channels[k]), (DB * t, channels[k])}
        at = _first(ops, conv, shapes, at)
        out[f"conv{k}_product"] = ops[at][2][0][1]
        at = _first(ops, ("add",), {(DB, t, channels[k])}, at + 1)
        out[f"conv{k}_bias"] = ops[at][2][0][1]
        if k:
            at = _first(ops, ("rsqrt",), {o[0][0] for _, _, o in ops[at:]
                                          if o}, at)
            out[f"gn{k}_stats"] = ops[at][2][0][1]
            at = _first(ops, (convert,), {(DB, t, channels[k]),
                                          (DB, 1, t, channels[k])}, at)
            out[f"gn{k}_out"] = ops[at][2][0][1]
    out["head"] = ops[_first(ops, MATMULS, {(DB, 1)}, at)][2][0][1]
    return out


def test_bf16_boundary_dtypes_equal_jax():
    """G then D in bf16 on each side: the gates, the tanh, h, the emit, each
    conv's product and bias, GroupNorm's statistics and output, the head,
    and the critic's input gradient, each in JAX's dtype."""
    jcfg = j_preset("race_curriculum_32").override(**DTYPE_CFG)
    cfg = Config.from_dict(jcfg.to_dict())
    pg, pd, gen, critic = _models(jcfg, cfg, (0.0, 0.0))
    z = np.random.default_rng(2).standard_normal(
        (DB, jcfg.model.latent_dim)).astype(np.float32)
    jg, jd = JTrackGenerator(jcfg.model), JTrackCritic(jcfg.model)
    want = _boundaries(
        _jax_ops(lambda z: jd.apply({"params": pd}, jg.apply(
            {"params": pg}, z)), jnp.asarray(z)),
        conv=("conv_general_dilated",), gates=("logistic",),
        convert="convert_element_type", channels=(8, 16),
        n_layers=critic.n_layers)
    with _TorchOps() as rec, torch.no_grad():
        critic(gen(torch.from_numpy(z)))
    got = _boundaries(rec.ops, conv=MATMULS,
                      gates=("sigmoid", "reciprocal", "div"),
                      convert="_to_copy", channels=(8, 16),
                      n_layers=critic.n_layers)
    tracks = synthetic_tracks(DB, DT, seed=3).astype(np.float32)
    want["x_grad"] = str(jax.grad(lambda x: jd.apply(
        {"params": pd}, x).sum())(jnp.asarray(tracks)).dtype)
    x = torch.from_numpy(tracks).requires_grad_(True)
    (gx,) = torch.autograd.grad(critic(x).sum(), x)
    got["x_grad"] = _dt(gx)
    assert got == want
    assert want["gru_gate"] == want["gru_h"] == "bfloat16", want
    assert want["emit"] == want["head"] == "float32", want


# ---- where the bf16 track program rounds ----------------------------------

FULL_B = 16


def _models(jcfg, cfg, move=(0.05, 0.01)):
    """JAX-initialised G and D of ``jcfg`` moved off their init (non-zero
    biases, GroupNorm affines off one) by ``move`` (G, D) standard
    deviations, and the port's modules holding them."""
    m = jcfg.model
    pg = JTrackGenerator(m).init(jax.random.key(1),
                                 jnp.zeros((2, m.latent_dim)))["params"]
    pd = JTrackCritic(m).init(jax.random.key(2),
                              jnp.zeros((2, m.n_segments, 2)))["params"]
    rng = np.random.default_rng(5)

    def moved(tree, s):
        return jax.tree_util.tree_map(
            lambda a: a + s * rng.standard_normal(a.shape).astype(a.dtype),
            tree)
    pg, pd = moved(pg, move[0]), moved(pd, move[1])
    gen, critic = TrackGenerator(cfg.model), TrackCritic(cfg.model)
    gen.load_state_dict(generator_params_from_flat(tt._flat(pg, "generator")))
    critic.load_state_dict(critic_params_from_flat(
        tt._flat(pd, "discriminator")))
    return pg, pd, gen, critic


def _bits(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _full():
    jcfg = j_preset("race_curriculum_32")
    assert jcfg.model.dtype == "bfloat16"
    return (jcfg, Config.from_dict(jcfg.to_dict()),
            *_models(jcfg, Config.from_dict(jcfg.to_dict())))


def test_bf16_track_generator_rounds_where_the_jax_program_rounds():
    """race_curriculum_32's G in bf16 against Flax run op by op: the tracks
    within f32 rounding, h0 and each GRU step (fed JAX's own state)
    bf16-equal on FWD_EQUAL of their elements.  ``torch.sigmoid`` in the
    gates moves the tracks by ~1e-3 and the state in 29% of its elements."""
    jcfg, cfg, pg, _, gen, _ = _full()
    jm = jcfg.model
    z = np.random.default_rng(2).standard_normal(
        (FULL_B, jm.latent_dim)).astype(np.float32)
    want = JTrackGenerator(jm).apply({"params": pg}, jnp.asarray(z))
    with torch.no_grad():
        got = gen(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    bf, jbf = torch.bfloat16, jnp.bfloat16
    h = nn.tanh(nn.Dense(jm.rnn_hidden, dtype=jbf,
                         param_dtype=jnp.float32).apply(
        {"params": pg["init"]}, jnp.asarray(z).astype(jbf)))
    cell = nn.GRUCell(features=jm.rnn_hidden, dtype=jbf,
                      param_dtype=jnp.float32)
    pos = pg["pos_emb"].astype(jbf)
    with torch.no_grad():
        from levelgan_torch.ops.blocks import tanh
        h0 = tanh(gen.init(torch.from_numpy(z), bf))
        assert np.mean(h0.float().numpy() == _bits(h)) >= FWD_EQUAL
        x_i, w_h, b_hn = gen.gru_weights(bf)
        for t in range(jm.n_segments):
            h_next, _ = cell.apply({"params": pg["gru"]}, h, jnp.broadcast_to(
                pos[t][None], (FULL_B, pos.shape[1])))
            mine = gen.gru_step(torch.from_numpy(_bits(h)).to(bf), x_i[t],
                                w_h, b_hn)
            equal = np.mean(mine.float().numpy() == _bits(h_next))
            assert equal >= FWD_EQUAL, (t, equal)
            h = h_next


def test_bf16_track_critic_rounds_where_the_jax_program_rounds():
    """race_curriculum_32's D in bf16 against Flax run op by op: each conv
    and each GroupNorm + LeakyReLU (fed JAX's own input) bf16-equal on
    FWD_EQUAL of their elements, the head within FWD_RTOL, the input
    gradient within GRAD_ATOL of its largest |value|."""
    jcfg, cfg, _, pd, _, critic = _full()
    jm = jcfg.model
    tracks = synthetic_tracks(FULL_B, jm.n_segments, seed=3).astype(
        np.float32)
    score, inter = JTrackCritic(jm).apply(
        {"params": pd}, jnp.asarray(tracks), capture_intermediates=True)
    inter = inter["intermediates"]
    bf = torch.bfloat16
    with torch.no_grad():
        x = normalize_tracks(torch.from_numpy(tracks)).to(bf)
        for i in range(critic.n_layers):
            y = getattr(critic, f"down{i}")(x, bf)
            j = inter[f"down{i}"]["__call__"][0]
            equal = np.mean(y.float().numpy() == _bits(j))
            assert equal >= FWD_EQUAL, (i, equal)
            y = torch.from_numpy(_bits(j)).to(bf)
            if i > 0:
                y = group_norm(y, getattr(critic, f"scale{i}"),
                               getattr(critic, f"bias{i}"),
                               cfg.model.group_size)
                j = _group_norm_1d(j, pd[f"scale{i}"], pd[f"bias{i}"],
                                   jm.group_size)
            x = leaky_relu(y, jm.leaky_slope).to(bf)
            j = j_leaky_relu(j, jm.leaky_slope).astype(jnp.bfloat16)
            equal = np.mean(x.float().numpy() == _bits(j))
            assert equal >= FWD_EQUAL, (i, equal)
        head = critic.head(torch.from_numpy(_bits(j)).reshape(
            FULL_B, -1), torch.float32).squeeze(-1)
    want = np.asarray(nn.Dense(1).apply({"params": pd["head"]}, jnp.asarray(
        _bits(j)).reshape(FULL_B, -1))).squeeze(-1)
    np.testing.assert_allclose(head.numpy(), want, rtol=FWD_RTOL,
                               atol=FWD_RTOL * np.abs(want).max())
    np.testing.assert_allclose(np.asarray(want), np.asarray(score),
                               rtol=FWD_RTOL)
    xt = torch.from_numpy(tracks).requires_grad_(True)
    (grad,) = torch.autograd.grad(critic(xt).float().sum(), xt)
    want = np.asarray(jax.grad(lambda v: JTrackCritic(jm).apply(
        {"params": pd}, v).sum())(jnp.asarray(tracks)))
    np.testing.assert_allclose(grad.numpy(), want, rtol=0,
                               atol=GRAD_ATOL * np.abs(want).max())


@pytest.mark.parametrize("name", ["sigmoid", "tanh"])
def test_bf16_sigmoid_and_tanh_round_as_jax(name):
    """``ops.blocks.sigmoid`` / ``tanh`` on every bf16 value in [-20, 20]:
    the value and the gradient (a seeded cotangent) bit-equal to
    ``jax.nn.sigmoid`` / ``jnp.tanh`` and their VJPs in bf16 (torch's own
    sigmoid differs in 3% of the values, its derivatives in 44% / 34% of
    the gradients)."""
    bits = np.arange(2 ** 16, dtype=np.uint32) << 16
    x = bits.view(np.float32)
    x = x[np.isfinite(x) & (np.abs(x) <= 20)]
    g = np.random.default_rng(3).standard_normal(x.size).astype(np.float32)
    jf = {"sigmoid": jax.nn.sigmoid, "tanh": jnp.tanh}[name]
    jx, jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, g))
    y, vjp = jax.vjp(jf, jx)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    yt = getattr(blocks, name)(xt)
    (gt,) = torch.autograd.grad(yt, xt, torch.from_numpy(g).to(
        torch.bfloat16))
    assert yt.dtype == gt.dtype == torch.bfloat16
    np.testing.assert_array_equal(yt.detach().float().numpy(), _bits(y))
    np.testing.assert_array_equal(gt.float().numpy(), _bits(vjp(jg)[0]))
