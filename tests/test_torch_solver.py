"""The port's flood-fill solver (``levelgan_torch/env``) against the JAX
package's ``env/solver.py`` and ``env/sim.py`` on the same levels: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.env import sim as jsim
from levelgan.env import solver as jsolver
from levelgan_torch.config import GOAL, START, WALL
from levelgan_torch.env import sim as tsim
from levelgan_torch.env import solver as tsolver
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def random_levels(seed, b=24, size=16, wall=0.3, with_start=True):
    """Levels with walls at density ``wall``, floor, hazards and coins,
    0-2 STARTs (none without ``with_start``) and 0-2 GOALs; the last
    level is all WALL."""
    rng = np.random.default_rng(seed)
    ids = np.where(rng.random((b, size, size)) < wall, WALL,
                   rng.choice([0, 4, 5, 6, 7], (b, size, size))).astype(np.uint8)
    for i in range(b):
        cells = rng.choice(size * size, 4, replace=False)
        n_s = rng.integers(0, 3) if with_start else 0
        n_g = rng.integers(0, 3)
        ids[i].reshape(-1)[cells[:n_s]] = START
        ids[i].reshape(-1)[cells[2:2 + n_g]] = GOAL
    ids[-1] = WALL
    return ids


@pytest.mark.parametrize("wall", [0.0, 0.2, 0.45, 0.7])
@pytest.mark.parametrize("with_start", [True, False])
def test_solver_matches_jax(wall, with_start):
    ids = random_levels(int(wall * 100) + with_start, wall=wall,
                        with_start=with_start)
    j, t = jnp.asarray(ids), torch.from_numpy(ids)
    np.testing.assert_array_equal(tsim.start_positions(t).numpy(),
                                  np.asarray(jsim.start_positions(j)))
    want = np.asarray(jsolver.reachable(j))
    np.testing.assert_array_equal(tsolver.reachable(t).numpy(), want)
    for every in (1, 5):
        got, steps = tsolver.reachable_steps(t, check_every=every)
        np.testing.assert_array_equal(got.numpy(), want)
        assert steps % every == 0
    np.testing.assert_array_equal(tsolver.solvable(t).numpy(),
                                  np.asarray(jsolver.solvable(j)))
    jwf = jsolver.well_formed(j)
    for k, v in tsolver.well_formed(t).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jwf[k]), k)
    assert not tsolver.reachable(t)[-1].any()      # the all-WALL level


def test_neighbors_do_not_wrap_and_pos_mask_matches_jax():
    m = torch.zeros(1, 5, 5, dtype=torch.bool)
    m[0, 0, 0] = True
    got = tsolver._neighbors(m)[0]
    assert got.sum() == 2 and got[0, 1] and got[1, 0]
    pos = np.array([[0, 0], [2, 3], [4, 4]], np.int32)
    np.testing.assert_array_equal(
        tsim._pos_mask(5, 5, torch.from_numpy(pos)).numpy(),
        np.asarray(jsim._pos_mask(5, 5, jnp.asarray(pos))))


def test_start_on_a_wall_and_centre_fallback_give_empty_masks():
    ids = np.zeros((2, 6, 6), np.uint8)
    ids[0, 3, 3] = WALL                 # no START: the centre is a wall
    ids[1, 1, 1] = START
    ids[1] = np.where(np.arange(36).reshape(6, 6) % 7 == 0, WALL, ids[1])
    ids[1, 1, 1] = START
    got = tsolver.reachable(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsolver.reachable(
        jnp.asarray(ids))))
    assert not got[0].any()
