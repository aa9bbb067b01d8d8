"""Port parity: the structural-tile presence prior and the step that uses
it, against the JAX package on the CPU in f32.

``presence_penalty`` gets the same numpy samples on both sides; the whole
step is a small ``wgan_gp_32_structural`` (the spatial structural head, the
presence prior in the generator update) with ``model.pallas_gp='fused'``,
against the JAX step with ``use_pallas=True`` (its Pallas kernels in
interpret mode), through ``tests/test_torch_train.py``'s harness.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.config import TrainConfig as JTrainConfig
from levelgan.config import preset as j_preset
from levelgan.ops.presence import excess_weight_schedule as j_excess_schedule
from levelgan.ops.presence import presence_penalty as j_presence_penalty
from levelgan_torch.config import TrainConfig
from levelgan_torch.ops.presence import (excess_weight_schedule,
                                         presence_penalty)
from test_torch_train import B, N_CRITIC, check_one_step_matches_jax
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-5


def _sample(kind, seed, b=6, size=8, n_tiles=8):
    """A relaxed sample [b, size, size, n_tiles]: 'soft' is a softmax of
    random logits, 'collapsed' commits START and GOAL to the same two cells
    in every level (the spread hinge engages), 'doubled' has duplicate
    argmax-winning START cells (the excess hinge engages)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, size, size, n_tiles)) * 2.0
    if kind == "collapsed":
        logits[:, 1, 2, 2] += 12.0
        logits[:, 5, 6, 3] += 12.0
    if kind == "doubled":
        logits[:, 1, 2, 2] += 9.0
        logits[:, 3, 3, 2] += 8.0
        logits[::2, 6, 1, 2] += 7.0
        logits[:, 5, 6, 3] += 9.0
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("kind", ["soft", "collapsed", "doubled"])
@pytest.mark.parametrize("w_spread", [0.0, 1.0])
@pytest.mark.parametrize("w_excess", [0.0, 2.0])
def test_presence_penalty_value_and_grad_match_jax(kind, w_spread, w_excess):
    fake = _sample(kind, seed=len(kind))
    kw = dict(w_spread=w_spread, w_excess=w_excess, excess_band=0.5)
    want, want_g = jax.value_and_grad(
        lambda f: j_presence_penalty(f, **kw))(jnp.asarray(fake))
    x = torch.from_numpy(fake).requires_grad_()
    got = presence_penalty(x, **kw)
    (got_g,) = torch.autograd.grad(got, x)
    assert float(want) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=RTOL,
                               atol=1e-8)


def test_presence_penalty_vanishes_at_the_corpus_shape():
    """One one-hot START and GOAL per level, placed apart across levels."""
    fake = np.zeros((4, 8, 8, 8), np.float32)
    fake[..., 0] = 1.0
    for b in range(4):
        for tile, (i, j) in ((2, (b, 2 * b)), (3, (7 - b, b))):
            fake[b, i, j] = 0.0
            fake[b, i, j, tile] = 1.0
    assert float(presence_penalty(torch.from_numpy(fake))) == 0.0
    assert float(j_presence_penalty(jnp.asarray(fake))) == 0.0


@pytest.mark.parametrize("kw", [
    {}, {"presence_excess": 2.0},
    {"presence_excess": 2.0, "presence_excess_start": 100},
    {"presence_excess": 2.0, "presence_excess_start": 100,
     "presence_excess_ramp": 50},
    {"presence_excess": 3.0, "presence_excess_ramp": 40}],
    ids=["off", "static", "start", "start_ramp", "ramp"])
def test_excess_weight_schedule_matches_jax(kw):
    jt, tt = JTrainConfig(**kw), TrainConfig(**kw)
    for step in (0, 20, 99, 100, 110, 125, 150, 5000):
        np.testing.assert_allclose(excess_weight_schedule(tt, step),
                                   float(j_excess_schedule(jt, step)),
                                   rtol=RTOL)


@pytest.mark.parametrize("name,override,engaged", [
    ("wgan_gp_32_structural", {}, False),
    ("wgan_gp_32", {"train.w_presence": 10.0}, True)],
    ids=["structural", "softmax_head"])
def test_fused_step_with_presence_matches_jax(name, override, engaged):
    """One whole WGAN-GP step at small widths with ``pallas_gp='fused'``:
    the fused GP in the critic loop and the presence prior in the generator
    update.  ``wgan_gp_32_structural`` adds the spatial structural head,
    under which every level carries one START and one GOAL, so only the
    spread hinge is left and a random batch does not engage it; the softmax
    head of ``wgan_gp_32`` engages the count and concentration hinges."""
    jcfg = j_preset(name).override(**{
        "model.base_channels": 16, "model.critic_base_channels": 16,
        "model.group_size": 8, "model.latent_dim": 8,
        "model.dtype": "float32", "model.use_pallas": True,
        "model.pallas_gp": "fused", "train.batch_size": B,
        "train.n_critic": N_CRITIC, "train.steps": 10, **override})
    assert jcfg.train.w_presence == 10.0 and jcfg.model.level_size == 32
    met = check_one_step_matches_jax(jcfg, extra_metrics=("presence",))
    assert (float(met["presence"]) > 0) == engaged
