"""Level solvability on the device: batched flood-fill reachability.

Port of ``levelgan/env/solver.py``.  The flood fill is wavefront dilation:
each step ORs the 4-neighbour shifts of the reached mask (zero-padded, no
wraparound) and ANDs passability, over the whole [B, H, W] batch at once.
The JAX package runs it to the batch-wide fixpoint under
``lax.while_loop``; here a convergence test costs a host sync, so the
mask is compared with its value ``check_every`` dilations earlier and the
loop stops when they are equal.  Dilations past the fixpoint change
nothing, so the result is the same mask exactly.

Semantics: WALL blocks, every other tile is passable (topological
reachability; the ice-slide kinematics of the environment are ignored).
"""

from __future__ import annotations

import torch

from levelgan_torch.config import GOAL, START, WALL
from levelgan_torch.env.sim import _pos_mask, start_positions

CHECK_EVERY = 16       # dilations between two convergence tests


def _neighbors(m: torch.Tensor) -> torch.Tensor:
    """[..., H, W] bool -> bool mask of the 4-neighbours of any True cell
    (zero-padded shifts: the wavefront never wraps around an edge)."""
    out = torch.zeros_like(m)
    out[..., 1:, :] |= m[..., :-1, :]
    out[..., :-1, :] |= m[..., 1:, :]
    out[..., :, 1:] |= m[..., :, :-1]
    out[..., :, :-1] |= m[..., :, 1:]
    return out


def reachable_steps(ids: torch.Tensor, check_every: int = CHECK_EVERY
                    ) -> tuple[torch.Tensor, int]:
    """(``reachable(ids)``, the number of dilations run)."""
    h, w = ids.shape[-2], ids.shape[-1]
    passable = ids != WALL
    reach = _pos_mask(h, w, start_positions(ids)) & passable
    steps = 0
    while True:
        before = reach
        for _ in range(check_every):
            reach = (reach | _neighbors(reach)) & passable
        steps += check_every
        if torch.equal(reach, before):       # one host sync per test
            return reach, steps


def reachable(ids: torch.Tensor) -> torch.Tensor:
    """[B, H, W] uint8 tile ids -> [B, H, W] bool: cells reachable from the
    start position (first START, else the centre) through non-WALL
    tiles."""
    return reachable_steps(ids)[0]


def solvable(ids: torch.Tensor) -> torch.Tensor:
    """[B, H, W] uint8 -> [B] bool: a GOAL tile is reachable from start."""
    return (reachable(ids) & (ids == GOAL)).any(dim=-1).any(dim=-1)


def well_formed(ids: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-level bools: ``has_start``/``has_goal`` (at least one) and
    ``one_start``/``one_goal`` (exactly one, the corpus invariant)."""
    n_start = (ids == START).sum(dim=(-2, -1))
    n_goal = (ids == GOAL).sum(dim=(-2, -1))
    return {"has_start": n_start > 0, "has_goal": n_goal > 0,
            "one_start": n_start == 1, "one_goal": n_goal == 1}
