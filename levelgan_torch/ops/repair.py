"""Export repair for decoded tile levels: ensure START and GOAL.

Port of ``levelgan/ops/repair.py`` (the design and its measurements are in
that module's note).  START goes to the best-scoring non-WALL cell, GOAL
to the best-scoring cell inside START's flood-fill reachable component
(``env.solver``), so a level that receives both placements is solvable by
construction; existing START/GOAL tiles are never moved.  With
``exactly_one`` duplicate START/GOAL tiles are demoted to the model's
next-best non-structural, non-WALL tile.

The masked argmax keeps the JAX semantics: the first index on ties, cell
0 on an all ``-inf`` row (``torch.argmax`` gives both); a one-hot of the
chosen cell is a compare with an ``arange``.  Uniform placement scores
are Gumbel draws, injected as ``scores=(start, goal)`` [B, H*W] (the
tests feed the JAX draws) or drawn from ``generator``, START's first.
"""

from __future__ import annotations

import torch

from levelgan_torch.config import GOAL, START, WALL
from levelgan_torch.env.sim import start_positions
from levelgan_torch.env.solver import reachable
from levelgan_torch.ops.gumbel import gumbel_noise

_NEG_INF = float("-inf")


def _at(pos: torch.Tensor, n: int) -> torch.Tensor:
    """[B] cell indices -> [B, n] bool one-hot."""
    return torch.arange(n, device=pos.device) == pos[:, None]


def _place_missing(flat_ids: torch.Tensor, conf_t: torch.Tensor, tile: int,
                   forbidden: torch.Tensor) -> torch.Tensor:
    """Place ``tile`` at argmax(conf_t) over the allowed cells in levels that
    lack it.  flat_ids uint8 [B, HW]; conf_t [B, HW]; forbidden bool
    [B, HW].  A level with every cell forbidden gets cell 0."""
    need = ~(flat_ids == tile).any(dim=-1)
    pos = torch.argmax(torch.where(forbidden, _NEG_INF, conf_t), dim=-1)
    at = _at(pos, flat_ids.shape[-1])
    return torch.where(need[:, None] & at, tile, flat_ids).to(flat_ids.dtype)


def _dedup(flat_ids: torch.Tensor, score: torch.Tensor, tile: int,
           repl: torch.Tensor) -> torch.Tensor:
    """Keep one ``tile`` cell per level (the argmax-``score`` one among the
    duplicates); every other ``tile`` cell becomes ``repl``."""
    mask = flat_ids == tile
    keep_pos = torch.argmax(torch.where(mask, score, _NEG_INF), dim=-1)
    keep = _at(keep_pos, flat_ids.shape[-1])
    return torch.where(mask & ~keep, repl, flat_ids)


def _cell_coords(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(h * w, dtype=torch.int32, device=device)
    return idx // w, idx % w


def ensure_start_goal(ids: torch.Tensor, logits: torch.Tensor, *,
                      placement: str = "confidence", target_dist=None,
                      exactly_one: bool = False, scores=None,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
    """uint8 ids [B, H, W] + generator logits [B, H, W, T] -> repaired ids.

    ``placement``: 'confidence' (the generator's most confident valid
    cell) or 'uniform' (a Gumbel-argmax sample over the valid cells: the
    corpus's own placement law).  ``target_dist`` [B] (uniform only): the
    requested normalised START->GOAL L1 distance, which biases START to
    cells that can reach it and GOAL to cells at it.  ``exactly_one``:
    also demote duplicate STARTs and GOALs (GOALs reachable from the kept
    START are kept first).
    """
    if placement not in ("confidence", "uniform"):
        raise ValueError(f"placement must be 'confidence'|'uniform', "
                         f"got {placement!r}")
    if target_dist is not None and placement != "uniform":
        raise ValueError("target_dist needs placement='uniform'")
    b, h, w = ids.shape
    flat = ids.reshape(b, -1)
    conf = torch.log_softmax(logits.float(), dim=-1).reshape(
        b, h * w, logits.shape[-1])
    if placement == "uniform":
        if scores is None:
            scores = tuple(gumbel_noise(flat.shape, device=ids.device,
                                        generator=generator)
                           for _ in range(2))
        score_start, score_goal = (s.to(torch.float32) for s in scores)
    else:
        score_start, score_goal = conf[..., START], conf[..., GOAL]
    rows, cols = _cell_coords(h, w, ids.device)

    if target_dist is not None:
        target_dist = torch.as_tensor(target_dist, dtype=torch.float32,
                                      device=ids.device)
        # START where the farthest corner still reaches the request
        maxd = (torch.maximum(rows, h - 1 - rows)
                + torch.maximum(cols, w - 1 - cols)).float() / (h + w)
        score_start = score_start - 32.0 * torch.relu(
            target_dist[:, None] - maxd[None])

    repl = None
    if exactly_one:
        blocked = conf.clone()
        blocked[..., [START, GOAL, WALL]] = _NEG_INF
        repl = torch.argmax(blocked, dim=-1).to(flat.dtype)
        flat = _dedup(flat, score_start, START, repl)

    # START: best passable cell (a wall would strand the agent)
    flat = _place_missing(flat, score_start, START, flat == WALL)

    if target_dist is not None:
        sp = start_positions(flat.reshape(ids.shape))
        d = ((rows[None] - sp[:, :1]).abs()
             + (cols[None] - sp[:, 1:]).abs()).float() / (h + w)
        score_goal = score_goal - 32.0 * (d - target_dist[:, None]).abs()

    # GOAL: best cell reachable from START.  Reachability is taken before
    # the GOAL dedup: dedup replacements are never WALL, nor were the GOALs
    # they replace, so it does not change.
    reach = reachable(flat.reshape(ids.shape)).reshape(b, -1)
    if exactly_one:
        flat = _dedup(flat, score_goal + 1e6 * reach.float(), GOAL, repl)
    is_start = flat == START
    connected = reach & ~is_start
    has_room = connected.any(dim=-1, keepdim=True)
    fallback = (flat != WALL) & ~is_start
    placeable = torch.where(has_room, connected, fallback)
    flat = _place_missing(flat, score_goal, GOAL, ~placeable)
    return flat.reshape(ids.shape)
