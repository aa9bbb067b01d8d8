"""The port's START/GOAL repair (``levelgan_torch/ops/repair.py``) and the
repaired export against the JAX package on the CPU, in f32.

Uniform placement takes the JAX Gumbel draws as injected scores.  The
confidence scores are log-softmax values that two frameworks may round a
ulp apart, so a level may differ only where two of its candidate scores
(START, GOAL, the replacement tile's) lie within ``NEAR_TIE``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.export import make_generate_fn
from levelgan.export import unpack_levels as j_unpack_levels
from levelgan.ops.repair import ensure_start_goal as j_repair
from levelgan_torch import export as texport
from levelgan_torch.bridge import generator_params_from_flat
from levelgan_torch.config import GOAL, START, WALL
from levelgan_torch.env.solver import solvable, well_formed
from levelgan_torch.ops.repair import ensure_start_goal

from test_torch_export import _cfgs, _jax_params
from test_torch_solver import random_levels
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

NEAR_TIE = 1e-5


def near_tie_levels(ids, want, logits, placement):
    """Levels [B] whose repair may differ at a near-tie: a START or GOAL
    kept or placed by confidence whose score another cell's comes within
    NEAR_TIE of, or a demoted cell whose best two replacement tiles do.
    Uniform scores are the same numbers on both sides, and the ops applied
    to them (target bias, reach bonus) round alike, so only the
    log-softmax values can differ."""
    b = ids.shape[0]
    conf = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1)).reshape(
        b, -1, logits.shape[-1])
    blocked = conf.copy()
    blocked[..., [START, GOAL, WALL]] = -np.inf
    top2 = np.sort(blocked, -1)[..., -2:]
    flat_in, flat_out = ids.reshape(b, -1), want.reshape(b, -1)
    demoted = np.isin(flat_in, (START, GOAL)) & (flat_out != flat_in)
    tie = (demoted & (top2[..., 1] - top2[..., 0] < NEAR_TIE)).any(-1)
    if placement == "confidence":
        for tile in (START, GOAL):
            s = conf[..., tile]
            for i in range(b):
                for c in np.nonzero(flat_out[i] == tile)[0]:
                    gap = np.abs(np.delete(s[i], c) - s[i, c])
                    tie[i] |= bool((gap < NEAR_TIE).any())
    return tie


def _jax_scores(key, shape):
    k_s, k_g = jax.random.split(key)
    return (np.asarray(jax.random.gumbel(k_s, shape, jnp.float32)),
            np.asarray(jax.random.gumbel(k_g, shape, jnp.float32)))


def _levels_with_unreachable_goal(size=16):
    ids = np.zeros((2, size, size), np.uint8)
    ids[:, 5:8, 5:8] = WALL
    ids[:, 6, 6] = GOAL                 # walled in
    ids[0, 1, 1] = START
    ids[1, 1, 1] = ids[1, 12, 12] = START
    return ids


@pytest.mark.parametrize("placement,target", [
    ("confidence", False), ("uniform", False), ("uniform", True)])
@pytest.mark.parametrize("exactly_one", [False, True])
def test_ensure_start_goal_matches_jax(placement, exactly_one, target):
    ids = np.concatenate([random_levels(7, wall=0.3),
                          random_levels(8, wall=0.55, with_start=False),
                          _levels_with_unreachable_goal()])
    b = ids.shape[0]
    rng = np.random.default_rng(3)
    logits = (2.0 * rng.standard_normal((b, 16, 16, 8))).astype(np.float32)
    td = rng.uniform(0, 1, b).astype(np.float32) if target else None
    key = jax.random.key(11)
    want = np.asarray(j_repair(jnp.asarray(ids), jnp.asarray(logits),
                               key=key, placement=placement,
                               target_dist=td, exactly_one=exactly_one))
    scores = (_jax_scores(key, (b, 16 * 16)) if placement == "uniform"
              else None)
    got = ensure_start_goal(
        torch.from_numpy(ids), torch.from_numpy(logits), placement=placement,
        target_dist=None if td is None else torch.from_numpy(td),
        exactly_one=exactly_one,
        scores=None if scores is None else tuple(torch.tensor(x) for x in scores)).numpy()
    assert got.dtype == np.uint8 and got.shape == ids.shape
    tie = near_tie_levels(ids, want, logits, placement)
    assert tie.mean() < 0.1, "the check would exempt too many levels"
    same = (got == want).reshape(b, -1).all(-1)
    assert np.all(same | tie), np.nonzero(~same & ~tie)[0]
    wf = {k: v.numpy() for k, v in well_formed(torch.from_numpy(got)).items()}
    room = ~(ids == WALL).all(axis=(1, 2))     # all-WALL levels have none
    assert wf["has_start"][room].all() and wf["has_goal"][room].all()
    if exactly_one:
        assert wf["one_start"][room].all() and wf["one_goal"][room].all()
    # the existing walled-in GOAL stays, and stays unreachable
    assert got[-2, 6, 6] == GOAL
    assert not solvable(torch.from_numpy(got[-2:-1])).item()


def test_uniform_draws_from_the_generator_when_not_injected():
    ids = random_levels(5, wall=0.3)
    logits = torch.randn(ids.shape + (8,), generator=torch.Generator()
                         .manual_seed(0))
    a, b = (ensure_start_goal(torch.from_numpy(ids), logits,
                              placement="uniform", exactly_one=True,
                              generator=torch.Generator().manual_seed(4))
            for _ in range(2))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="target_dist"):
        ensure_start_goal(torch.from_numpy(ids), logits,
                          target_dist=torch.zeros(ids.shape[0]))


B = 8


def _cond_params(jcfg, seed=0):
    """A conditional generator's params (``_jax_params`` for cond_dim > 0)."""
    from levelgan.models import Generator as JGenerator
    m = jcfg.model
    params = JGenerator(m).init(jax.random.key(seed),
                                jnp.zeros((2, m.latent_dim)),
                                jnp.zeros((2, m.cond_dim)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.3 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    flat = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    return params, flat


@pytest.mark.parametrize("placement,exactly_one,cond_dim", [
    ("confidence", True, 0), ("uniform", False, 0), ("uniform", True, 4)])
def test_repaired_export_matches_jax_generate_fn(placement, exactly_one,
                                                 cond_dim):
    jcfg, tcfg = _cfgs()
    if cond_dim:
        over = {"model.cond_dim": cond_dim, "model.cond_embed_dim": 8}
        jcfg, tcfg = jcfg.override(**over), tcfg.override(**over)
    params, flat = _jax_params(jcfg) if not cond_dim else _cond_params(jcfg)
    m = jcfg.model
    key = jax.random.key(9)
    cond = (np.random.default_rng(1).uniform(0, 1, (B, cond_dim))
            .astype(np.float32) if cond_dim else None)
    fn = make_generate_fn(jcfg, B, pack=True, repair=True,
                          repair_placement=placement, exactly_one=exactly_one)
    want = np.asarray(fn(params, key, None if cond is None
                         else jnp.asarray(cond)))

    # the draws make_generate_fn takes from key
    from levelgan.models import Generator as JGenerator
    k_z, k_s = jax.random.split(key)
    z = np.asarray(jax.random.normal(k_z, (B, m.latent_dim), jnp.float32))
    logits = np.asarray(JGenerator(m).apply(
        {"params": params}, jnp.asarray(z),
        None if cond is None else jnp.asarray(cond)))
    noise = np.asarray(jax.random.gumbel(k_s, logits.shape, jnp.float32))
    scores = _jax_scores(jax.random.fold_in(key, 2), (B, m.level_size ** 2))

    gen = texport.make_generator(tcfg, generator_params_from_flat(flat), "cpu")
    got = texport.generate_batch(
        gen, tcfg, torch.from_numpy(z),
        None if cond is None else torch.from_numpy(cond),
        noise=torch.from_numpy(noise), pack=True, repair=True,
        repair_placement=placement, exactly_one=exactly_one,
        repair_scores=tuple(torch.tensor(x) for x in scores)).numpy()
    pert = np.sort(logits + noise, axis=-1)
    tie = ((pert[..., -1] - pert[..., -2]) < NEAR_TIE).reshape(B, -1).any(-1)
    raw = np.argmax(logits + noise, axis=-1).astype(np.uint8)
    tie |= near_tie_levels(raw, j_unpack_levels(want, m.level_size), logits,
                           placement)
    assert tie.mean() < 0.3
    same = (got == want).all(-1)
    assert np.all(same | tie)

    levels = texport.generate(tcfg, gen, B, z=z, noise=noise,
                              cond=None if cond is None else cond[0],
                              repair=True, repair_placement=placement,
                              exactly_one=exactly_one,
                              repair_scores=scores, device="cpu",
                              batch_size=4) if cond is None else None
    if levels is not None:
        ids_j = j_unpack_levels(want, m.level_size)
        assert np.all((levels == ids_j).reshape(B, -1).all(-1) | tie)
        assert solvable(torch.from_numpy(levels)).all()
