"""Batched playability environment: port of ``levelgan/env/sim.py``.

Agents play tile levels on a grid.  Per step (actions 0..3 = up, down,
left, right): a move into a WALL or off the grid stays in place; on ICE the
agent slides one more cell unless a WALL blocks it; SAND and HAZARD cost a
penalty; a COIN pays once (the taken-coins mask); GOAL pays and ends the
episode; every step costs the time penalty.  Finished episodes keep
stepping, frozen, with zero reward.  The start is the first START tile, else
the grid centre.

The JAX package looks tiles up by a dense masked sum and builds position
planes by iota compares, because gathers and scatters serialise on a TPU;
here they are ``torch.gather`` / ``scatter`` on the flattened grid, which
give the same integers.  ``rollout`` is a Python loop of T steps under
``torch.no_grad`` (gradients never go through the env); its action draws are
``argmax(gumbel + logits)``, as ``jax.random.categorical`` samples, from
injected Gumbel noise [T, B, 4] or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from levelgan_torch.config import COIN, GOAL, HAZARD, START, WALL
from levelgan_torch.data.dataset import ICE, SAND
from levelgan_torch.ops.gumbel import gumbel_noise

N_ACTIONS = 4


class EnvParams(NamedTuple):
    rollout_steps: int = 48
    gamma: float = 0.97
    step_penalty: float = 0.01
    hazard_penalty: float = 0.5
    sand_penalty: float = 0.02
    coin_reward: float = 0.2
    goal_reward: float = 1.0


# (dy, dx) of actions up, down, left, right
_DELTAS = ((-1, 0), (1, 0), (0, -1), (0, 1))


def env_tables(ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(the clamp bound [2] = (H-1, W-1), ``_DELTAS`` [4, 2]), int32 on
    ``ids``' device: made once per rollout and copied from pinned memory
    without a sync (a copy from pageable memory would synchronise the
    stream at every env step)."""
    h, w = ids.shape[-2:]
    t = torch.tensor([h - 1, w - 1, *(d for dd in _DELTAS for d in dd)],
                     dtype=torch.int32)
    if ids.is_cuda:
        t = t.pin_memory()
    t = t.to(ids.device, non_blocking=True)
    return t[:2], t[2:].view(4, 2)


def start_positions(ids: torch.Tensor) -> torch.Tensor:
    """[B, H, W] ids -> [B, 2] int32 start coords (first START, else the
    centre)."""
    b, h, w = ids.shape
    flat = (ids == START).reshape(b, -1)
    has_start = flat.any(dim=-1)
    # argmax takes no bool; on ties it gives the first index, as jnp's does
    idx = torch.argmax(flat.to(torch.uint8), dim=-1)
    y = torch.where(has_start, idx // w, h // 2)
    x = torch.where(has_start, idx % w, w // 2)
    return torch.stack([y, x], dim=-1).to(torch.int32)


def _pos_mask(h: int, w: int, pos: torch.Tensor) -> torch.Tensor:
    """[..., 2] int coords -> [..., H, W] bool one-hot position mask."""
    iy = torch.arange(h, dtype=torch.int32, device=pos.device)[:, None]
    ix = torch.arange(w, dtype=torch.int32, device=pos.device)[None, :]
    return ((iy == pos[..., 0, None, None])
            & (ix == pos[..., 1, None, None]))


def _cell(pos: torch.Tensor, w: int) -> torch.Tensor:
    """[B, 2] coords -> [B, 1] int64 flat cell index."""
    return (pos[:, 0].long() * w + pos[:, 1].long())[:, None]


def transition(ids: torch.Tensor, pos: torch.Tensor, action: torch.Tensor,
               coins_taken: torch.Tensor, done: torch.Tensor, p: EnvParams,
               tables: tuple[torch.Tensor, torch.Tensor] | None = None):
    """One env step for a batch: ids [B, H, W], pos [B, 2] int32, action
    [B], coins_taken [B, H, W] bool, done [B] bool -> (new_pos, reward f32,
    new_done, new_coins_taken).  ``tables`` is ``env_tables(ids)``, made
    here when not given."""
    b, h, w = ids.shape
    grid = ids.reshape(b, h * w)
    hi, deltas = env_tables(ids) if tables is None else tables
    delta = deltas[action.long()]

    def tile_at(q):
        return grid.gather(1, _cell(q, w))[:, 0]

    def clip(q):
        return torch.minimum(q.clamp_min(0), hi)

    prop = clip(pos + delta)
    blocked = tile_at(prop) == WALL
    new_pos = torch.where(blocked[:, None], pos, prop)
    # ice slide: one extra cell if standing on ICE and not blocked
    on_ice = tile_at(new_pos) == ICE
    prop2 = clip(new_pos + delta)
    slide = on_ice & (tile_at(prop2) != WALL)
    new_pos = torch.where(slide[:, None], prop2, new_pos)
    # frozen if already done
    new_pos = torch.where(done[:, None], pos, new_pos)

    cell = _cell(new_pos, w)
    tile = grid.gather(1, cell)[:, 0]
    coins = coins_taken.reshape(b, h * w)
    taken = coins.gather(1, cell)[:, 0]
    fresh_coin = (tile == COIN) & ~taken
    # the JAX expression's f32 operations, in its order
    reward = torch.full((b,), -p.step_penalty, dtype=torch.float32,
                        device=ids.device)
    reward = reward + p.goal_reward * (tile == GOAL).float()
    reward = reward - p.hazard_penalty * (tile == HAZARD).float()
    reward = reward - p.sand_penalty * (tile == SAND).float()
    reward = reward + p.coin_reward * fresh_coin.float()
    reward = torch.where(done, 0.0, reward)
    new_done = done | (tile == GOAL)
    new_coins = coins.scatter(1, cell, (taken | (fresh_coin & ~done))[:, None])
    return new_pos, reward, new_done, new_coins.reshape(b, h, w)


def make_obs(onehot: torch.Tensor, pos: torch.Tensor,
             coins_taken: torch.Tensor) -> torch.Tensor:
    """Policy observation [B, H, W, C+1]: the level one-hot with taken coins
    zeroed in the COIN channel, plus an agent-position plane."""
    b, h, w, _ = onehot.shape
    level = onehot.clone()
    level[..., COIN] *= 1.0 - coins_taken.to(onehot.dtype)
    plane = torch.zeros((b, h * w), dtype=onehot.dtype, device=onehot.device)
    plane.scatter_(1, _cell(pos, w), 1.0)
    return torch.cat([level, plane.reshape(b, h, w, 1)], dim=-1)


class Trajectory(NamedTuple):
    pos: torch.Tensor           # [T, B, 2] position BEFORE each action
    coins: torch.Tensor         # [T, B, H, W] taken mask BEFORE each action
    actions: torch.Tensor       # [T, B] int64
    rewards: torch.Tensor       # [T, B]
    active: torch.Tensor        # [T, B] 1.0 while the episode is not done
    returns: torch.Tensor       # [T, B] discounted reward-to-go
    total_return: torch.Tensor  # [B]
    reached: torch.Tensor       # [B] bool: goal reached within T


@torch.no_grad()
def rollout(policy, ids: torch.Tensor, onehot: torch.Tensor, p: EnvParams, *,
            noise: torch.Tensor | None = None,
            generator: torch.Generator | None = None) -> Trajectory:
    """Play a batch of levels for T steps with the stochastic ``policy``
    (``obs -> (action logits [B, 4], value [B])``).  ``noise`` is the
    Gumbel noise [T, B, 4] of the action draws, else drawn from
    ``generator``.  The T steps make no host sync: ``env_tables`` is made
    once, before them."""
    b, t_max = ids.shape[0], p.rollout_steps
    if noise is None:
        noise = gumbel_noise((t_max, b, N_ACTIONS), device=ids.device,
                             generator=generator)
    tables = env_tables(ids)
    pos = start_positions(ids)
    coins = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    done = torch.zeros((b,), dtype=torch.bool, device=ids.device)
    # the total return summed over t in order, as XLA sums it
    total = torch.zeros((b,), dtype=torch.float32, device=ids.device)
    steps = []
    for t in range(t_max):
        logits, _ = policy(make_obs(onehot, pos, coins))
        action = torch.argmax(noise[t] + logits, dim=-1)
        new_pos, reward, new_done, new_coins = transition(
            ids, pos, action, coins, done, p, tables)
        steps.append((pos, coins, action, reward, 1.0 - done.float()))
        total = total + reward
        pos, coins, done = new_pos, new_coins, new_done
    pos_t, coins_t, act_t, rew_t, active_t = (torch.stack(x)
                                              for x in zip(*steps))
    # g = r + gamma * g, rounded once to f32 as XLA's fused multiply-add
    # rounds it: the f64 product of two f32s is exact
    gamma = float(torch.tensor(p.gamma, dtype=torch.float32))
    g = torch.zeros((b,), dtype=torch.float32, device=ids.device)
    returns = [None] * t_max
    for t in reversed(range(t_max)):
        g = (rew_t[t].double() + gamma * g.double()).float()
        returns[t] = g
    return Trajectory(pos=pos_t, coins=coins_t, actions=act_t,
                      rewards=rew_t, active=active_t,
                      returns=torch.stack(returns),
                      total_return=total, reached=done)
