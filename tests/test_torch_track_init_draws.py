"""The port's own initial states and random draws against the JAX package's.

Every parity test of the steps starts the port from the JAX package's
parameters and feeds it the JAX step's draws, so the parts that only a
whole run exercises are held here, by distribution, at full width:

- **Initial states** of ``race_curriculum_32`` (GRU emitter, 1-D conv
  critic, two MLP drivers) and ``curriculum_16_joint`` (tile G and D, two
  conv agents): JAX states from ``jax.random.key(i)`` through
  ``create_track_curriculum_state`` / ``create_curriculum_state``, port
  states from ``train.seed = i`` through ``train.state.create_state``, as
  ``api.train`` builds its state.  Each parameter leaf is pooled over as
  many states as give it ``N_VALUES`` values a side (at least ``N_MIN``
  states, at most ``N_MAX``): ``N_FULL`` whole states, and for the
  agents' small layers more agents from the initializer that
  ``create_*_state`` calls for them, on the same seeds' keys.  A leaf JAX initialises to a constant (zero
  biases, unit GroupNorm scales, zero FiLM kernels) equals it exactly;
  every other leaf passes a two-sample Kolmogorov-Smirnov test at
  ``ALPHA`` over the number of leaves, its std lies within ``STD_RTOL`` of
  JAX's, and its mean within the two-sided z bound at the same level of
  the difference's standard error.  The EMA is the generator, the Adam
  moments and counts are zero and the baseline is 0, exactly.
- **Each step's draws** of ``race_curriculum_32`` (the trainer's,
  ``api.step_inputs``) against ``levelgan/track/train.py``'s key
  derivation over ``STEPS`` steps: z of every critic iteration and of G,
  the GP's eps, the exploration draw, the two drivers' Gumbel action
  noise (the same three tests), the augment's shifts and flips (a
  chi-square test of the two samples' counts).
- **The real-batch indices** (``api.sample_batch``) uniform over the
  corpus, as ``levelgan/api.py``'s ``randint`` is: a chi-square test of
  each against uniform and of the two against each other.
- **The drivers' sampled actions**: for fixed logits drawn from a seed,
  the frequencies of ``argmax(gumbel_noise + logits)`` (``track/race.py``)
  against ``jax.random.categorical``'s over ``N_ACTIONS_DRAWS`` draws, by
  a chi-square test; and the Gumbel draws bounded below by
  -log(-log(tiny)) in every float dtype, as ``jax.random.gumbel``'s are.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from levelgan.config import preset as j_preset
from levelgan.env.agent import init_agent as j_init_agent
from levelgan.track.race import init_driver
from levelgan.track.train import create_track_curriculum_state as j_create_t
from levelgan.track.train import race_params
from levelgan.train.curriculum import create_curriculum_state as j_create_c
from levelgan_torch import api
from levelgan_torch.config import Config
from levelgan_torch.ops.gumbel import gumbel_noise
from levelgan_torch.train.state import create_state, init_agents
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ALPHA = 0.01
N_VALUES, N_MIN, N_MAX = 2 ** 14, 4, 256
N_FULL = 64                  # whole states a side
STD_RTOL = 0.03
CHUNK = 32                   # JAX states made by one vmapped call
PRESETS = {"race_curriculum_32": j_create_t,
           "curriculum_16_joint": j_create_c}
TREES = (("generator", "generator"), ("discriminator", "critic"),
         ("agent_strong", "agent_strong"), ("agent_weak", "agent_weak"))
STEPS = 32                   # train steps whose draws are pooled
INDEX_STEPS = 2048           # train steps whose real-batch indices are
N_ACTIONS_DRAWS = 2 ** 20


def _flat(tree, prefix):
    return {f"{prefix}/" + jax.tree_util.keystr(p, simple=True, separator="/"):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _z_bound(n_tests):
    return float(stats.norm.isf(ALPHA / n_tests / 2))


def _same_distribution(name, got, want, n_tests):
    """``got`` (port) and ``want`` (JAX) samples: two-sample KS at
    ALPHA / n_tests, the std within STD_RTOL, the mean within the z bound
    of its standard error."""
    got, want = np.ravel(got).astype(np.float64), np.ravel(want)
    want = want.astype(np.float64)
    p = stats.ks_2samp(got, want).pvalue
    assert p > ALPHA / n_tests, (name, "KS", p)
    sg, sw = got.std(), want.std()
    assert abs(sg / sw - 1.0) <= STD_RTOL, (name, "std", sg, sw)
    se = math.sqrt(sg ** 2 / got.size + sw ** 2 / want.size)
    assert abs(got.mean() - want.mean()) <= _z_bound(n_tests) * se, (
        name, "mean", got.mean(), want.mean(), se)


def _same_counts(name, got, want, n_tests):
    """Two samples of category counts: a chi-square test of homogeneity at
    ALPHA / n_tests."""
    table = np.stack([got, want]).astype(np.float64)
    table = table[:, table.sum(0) > 0]
    p = stats.chi2_contingency(table).pvalue
    assert p > ALPHA / n_tests, (name, p, got, want)


# ---- the initial states ---------------------------------------------------

def _port_state_flat(cfg, seed):
    state = create_state(cfg.override(**{"train.seed": seed}), "cpu")
    out = {}
    for prefix, field in TREES:
        out.update({f"{prefix}/{k.replace('.', '/')}": v.detach().numpy()
                    for k, v in getattr(state, field).state_dict().items()})
    return state, out


def _exact_faults(jax_state, port_state):
    """What is not exactly as at step 0 in JAX's first state and the
    port's: the EMA equal to G, zero Adam counts and moments, step 0,
    baseline 0."""
    faults = []
    ema, gen = _flat(jax_state.g_ema, "g"), _flat(jax_state.generator, "g")
    faults += [f"jax ema {k}" for k, v in ema.items()
               if not np.array_equal(v, gen[k])]
    for opt in ("opt_g", "opt_d", "opt_as", "opt_aw"):
        adam = getattr(jax_state, opt)[0]
        leaves = [adam.count, *jax.tree_util.tree_leaves((adam.mu, adam.nu))]
        faults += [f"jax {opt}"] * any(np.any(np.asarray(v)) for v in leaves)
        adam = getattr(port_state, opt)
        faults += [f"port {opt}"] * bool(adam.count or any(
            torch.any(t) for s in adam.state.values() for t in s.values()
            if isinstance(t, torch.Tensor)))
    faults += [k for k, v in port_state.g_ema.state_dict().items()
               if not torch.equal(v, port_state.generator.state_dict()[k])]
    faults += ["jax step / baseline"] * bool(
        np.any(np.asarray(jax_state.step))
        or np.any(np.asarray(jax_state.g_baseline)))
    faults += ["port step / baseline"] * bool(
        port_state.step or float(port_state.g_baseline))
    return faults


def _jax_agent_init(name, jcfg):
    """The agents' initializer that ``create_*_state`` calls, on the key it
    derives for each agent from ``jax.random.key(i)``."""
    if name == "race_curriculum_32":
        rp = race_params(jcfg)
        init = functools.partial(init_driver, p=rp)
    else:
        init = functools.partial(j_init_agent, m=jcfg.model)

    def agents(i):
        _, k_as, k_aw = jax.random.split(jax.random.key(i), 3)
        return {"agent_strong": init(k_as), "agent_weak": init(k_aw)}
    return jax.jit(jax.vmap(agents))


@functools.lru_cache(maxsize=None)
def initial_states(name):
    """(per leaf: the number of states pooled, JAX's values, the port's
    values), and the exact checks' failures.  The first N_FULL states of
    each side are whole states; a leaf that needs more (the agents' small
    layers) takes the rest from the agents' own initializer, as
    ``create_*_state`` calls it."""
    jcfg = j_preset(name)
    cfg = Config.from_dict(jcfg.to_dict())
    make = jax.jit(jax.vmap(lambda k: PRESETS[name](jcfg, k)))
    want, got = {}, {}
    for start in range(0, N_FULL, CHUNK):
        st = make(jax.vmap(jax.random.key)(jnp.arange(start, start + CHUNK)))
        if not start:
            first = jax.tree_util.tree_map(lambda a: a[0], st)
        for prefix, _ in TREES:
            for k, v in _flat(getattr(st, prefix), prefix).items():
                want.setdefault(k, []).extend(v)
    for seed in range(N_FULL):
        state, flat = _port_state_flat(cfg, seed)
        if not seed:
            faults = _exact_faults(first, state)
        for k, v in flat.items():
            got.setdefault(k, []).append(v)
    # a constant leaf is compared exactly over the whole states
    n_of = {k: N_FULL if np.all(np.asarray(v) == v[0].flat[0])
            else min(N_MAX, max(N_MIN, -(-N_VALUES // v[0].size)))
            for k, v in want.items()}
    more = max(n_of.values())
    if more > N_FULL:
        agents = _jax_agent_init(name, jcfg)(jnp.arange(N_FULL, more))
        for prefix in ("agent_strong", "agent_weak"):
            for k, v in _flat(agents[prefix], prefix).items():
                want[k].extend(v)
        for seed in range(N_FULL, more):
            for prefix, agent in zip(("agent_strong", "agent_weak"),
                                     init_agents(cfg, seed)):
                for k, v in agent.state_dict().items():
                    got[f"{prefix}/{k.replace('.', '/')}"].append(
                        v.detach().numpy())
    assert set(got) == set(want)
    assert all(n <= N_FULL or k.startswith("agent") for k, n in n_of.items())
    leaves = {k: (n, np.stack(want[k][:n]), np.stack(got[k][:n]))
              for k, n in n_of.items()}
    return leaves, faults


@pytest.mark.parametrize("name", list(PRESETS))
def test_initial_state_matches_jax_in_distribution(name):
    leaves, exact_faults = initial_states(name)
    assert not exact_faults, exact_faults
    n_tests = len(leaves)
    for k, (n, want, got) in leaves.items():
        assert got.shape == want.shape, (k, got.shape, want.shape)
        assert len(want) == n
        if np.all(want == want.reshape(-1)[0]):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            _same_distribution(k, got, want, n_tests)


# ---- each step's draws ------------------------------------------------------

def _jax_track_draws(jcfg, key, step):
    """``levelgan/track/train.py``'s draws of one race-curriculum step
    (``make_track_curriculum_step``, the critic scan, ``track_augment``,
    ``interpolate``, ``race_rollout``'s categorical as argmax of Gumbel
    noise plus the logits)."""
    m, t = jcfg.model, jcfg.train
    b, n_seg = t.batch_size, m.n_segments
    base = jax.random.fold_in(key, step)
    its = {"shifts": [], "flips": [], "z": [], "eps": []}
    for k in jax.random.split(jax.random.fold_in(base, 0), t.n_critic):
        k_aug, k_z, k_eps = jax.random.split(k, 3)
        k_shift, k_flip = jax.random.split(k_aug)
        its["shifts"].append(jax.random.randint(k_shift, (b,), 0, n_seg))
        its["flips"].append(jax.random.bernoulli(k_flip, 0.5, (b,)))
        its["z"].append(jax.random.normal(k_z, (b, m.latent_dim)))
        its["eps"].append(jax.random.uniform(k_eps, (b, 1, 1)))
    k_z, k_expl, k_rs, k_rw = jax.random.split(jax.random.fold_in(base, 2), 4)
    steps = jcfg.curriculum.rollout_steps

    def gumbel(k):
        return jax.vmap(lambda kt: jax.random.gumbel(kt, (b, 9)))(
            jax.random.split(k, steps))
    return {"shifts": jnp.stack(its["shifts"]),
            "flips": jnp.stack(its["flips"]),
            "z": jnp.concatenate([jnp.stack(its["z"]).reshape(-1),
                                  jax.random.normal(
                                      k_z, (b, m.latent_dim)).reshape(-1)]),
            "eps": jnp.stack(its["eps"]),
            "explore": jax.random.normal(k_expl, (b, n_seg)),
            "rollout": jnp.stack([gumbel(k_rs), gumbel(k_rw)])}


def _port_track_draws(cfg, corpus, step):
    _, noise = api.step_inputs(cfg, corpus, step, "cpu")
    its = noise["critic"]
    return {"shifts": torch.stack([i["shifts"] for i in its]),
            "flips": torch.stack([i["flips"] for i in its]),
            "z": torch.cat([*(i["z"].reshape(-1) for i in its),
                            noise["g"]["z"].reshape(-1)]),
            "eps": torch.stack([i["eps"] for i in its]),
            "explore": noise["explore"],
            "rollout": torch.stack([noise["rollout_strong"],
                                    noise["rollout_weak"]])}


@functools.lru_cache(maxsize=None)
def step_draws():
    jcfg = j_preset("race_curriculum_32")
    cfg = Config.from_dict(jcfg.to_dict())
    corpus = torch.zeros((16, cfg.model.n_segments, 2))
    draw = jax.jit(jax.vmap(functools.partial(_jax_track_draws, jcfg),
                            in_axes=(None, 0)))
    want = {k: np.asarray(v) for k, v in draw(
        jax.random.key(0), jnp.arange(STEPS)).items()}
    ports = [_port_track_draws(cfg, corpus, s) for s in range(STEPS)]
    got = {k: torch.stack([p[k] for p in ports]).numpy() for k in want}
    return jcfg, got, want


def test_step_draws_match_jax_in_distribution():
    jcfg, got, want = step_draws()
    m, t = jcfg.model, jcfg.train
    b = t.batch_size
    shapes = {"shifts": (STEPS, t.n_critic, b),
              "flips": (STEPS, t.n_critic, b),
              "z": (STEPS, (t.n_critic + 1) * b * m.latent_dim),
              "eps": (STEPS, t.n_critic, b, 1, 1),
              "explore": (STEPS, b, m.n_segments),
              "rollout": (STEPS, 2, jcfg.curriculum.rollout_steps, b, 9)}
    assert {k: v.shape for k, v in got.items()} == shapes
    assert {k: v.shape for k, v in want.items()} == shapes
    n_tests = len(shapes)
    assert got["shifts"].min() >= 0 and got["shifts"].max() < m.n_segments
    _same_counts("shifts", np.bincount(got["shifts"].ravel(),
                                       minlength=m.n_segments),
                 np.bincount(want["shifts"].ravel(), minlength=m.n_segments),
                 n_tests)
    _same_counts("flips", np.bincount(got["flips"].ravel().astype(int), None,
                                      2),
                 np.bincount(want["flips"].ravel().astype(int), None, 2),
                 n_tests)
    for k in ("z", "eps", "explore", "rollout"):
        _same_distribution(k, got[k], want[k], n_tests)
    assert 0.0 <= got["eps"].min() and got["eps"].max() < 1.0


def test_real_batch_indices_are_uniform_as_jax():
    """``api.sample_batch``'s indices over INDEX_STEPS train steps, and the
    JAX feed's (``levelgan/api.py``: ``randint`` under ``fold_in(seed key,
    step)``), each uniform over the corpus and alike."""
    jcfg = j_preset("race_curriculum_32")
    cfg = Config.from_dict(jcfg.to_dict())
    t, n = cfg.train, cfg.data.corpus_size
    corpus = torch.arange(n)
    got = np.bincount(np.concatenate([
        api.sample_batch(corpus, cfg, api.step_generator(cfg, s, "cpu"))
        .numpy().ravel() for s in range(INDEX_STEPS)]), minlength=n)
    key = jax.random.fold_in(jax.random.key(t.seed), 0x0DA7A)
    want = np.bincount(np.asarray(jax.jit(jax.vmap(
        lambda s: jax.random.randint(jax.random.fold_in(key, s),
                                     (t.n_critic, t.batch_size), 0, n)))(
        jnp.arange(INDEX_STEPS))).ravel(), minlength=n)
    assert got.sum() == want.sum() == INDEX_STEPS * t.n_critic * t.batch_size
    for counts in (got, want):
        assert stats.chisquare(counts).pvalue > ALPHA / 3
    _same_counts("indices", got, want, 3)


# ---- the drivers' sampled actions -----------------------------------------

def test_sampled_actions_match_jax_categorical():
    """argmax(gumbel_noise + logits) against ``jax.random.categorical``
    over N_ACTIONS_DRAWS draws of fixed logits (a driver's nine actions,
    drawn from a seed)."""
    logits = np.random.default_rng(7).standard_normal(9).astype(np.float32)
    lt = torch.from_numpy(logits)
    gen = torch.Generator().manual_seed(0)
    got = torch.argmax(gumbel_noise((N_ACTIONS_DRAWS, 9), generator=gen)
                       + lt, dim=-1)
    want = jax.random.categorical(jax.random.key(0), jnp.asarray(logits),
                                  shape=(N_ACTIONS_DRAWS,))
    got = np.bincount(got.numpy(), minlength=9)
    want = np.bincount(np.asarray(want), minlength=9)
    _same_counts("actions", got, want, 1)
    p = np.exp(logits.astype(np.float64) - logits.max())
    p /= p.sum()
    assert stats.chisquare(got, p * got.sum()).pvalue > ALPHA


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_gumbel_draws_are_bounded_below_as_jax(dtype):
    """U is drawn in [tiny, 1) in both packages, so a Gumbel draw is at
    least -log(-log(tiny)) of its dtype and finite; at bf16's 2^-8
    resolution an unclamped U of 0 (-inf) comes once in 256 draws."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    gen = torch.Generator().manual_seed(0)
    got = gumbel_noise((N_ACTIONS_DRAWS,), dtype=tdt, generator=gen)
    want = jax.random.gumbel(jax.random.key(0), (N_ACTIONS_DRAWS,), jdt)
    floor = -math.log(-math.log(float(torch.finfo(tdt).tiny)))
    for name, v in (("port", got.float().numpy()),
                    ("jax", np.asarray(want.astype(jnp.float32)))):
        assert np.isfinite(v).all(), name
        assert v.min() >= floor - 1e-3 * abs(floor), (name, v.min(), floor)
