"""Batched race simulation: port of ``levelgan/track/race.py``.

Cars drive tracks in Frenet-frame coordinates: per car the arc position s
(in segments), the lateral offset d, the heading error psi, the speed v
and the laps completed.  A car crashes when |d| exceeds the local
half-width (it is put back inside and slowed).  Nine discrete actions:
steer {-1, 0, 1} x throttle {-1, 0, 1}.  The reward is arc progress per
step, less a step penalty and a crash penalty, plus a lap bonus.

``_seg_lookup`` and the observation's curvature preview take one value
per car from per-segment tables.  The JAX package contracts a one-hot mask
against the table (a dense sum that XLA fuses); here it is a ``gather``
of the same index, which gives the same value (the one-hot sum adds only
zeros to it).  The index is ``floor(s) % T`` with Python's modulo in both
packages.

``race_rollout`` draws the Gumbel action noise [T, B, 9] before its loop
(or takes it injected: the tests feed the JAX rollout's draws), so the T
steps make no host sync.  The discounted return g = r + gamma * g is
rounded once per step, as XLA's fused multiply-add rounds it, and the
total return sums the rewards in t order.  The dynamics run in f32 but
are not bit-equal to XLA's: its CPU ``sin`` / ``cos`` are approximations
of its own and it contracts multiply-adds, so the tests hold ``race_step``
and ``observe`` by a tolerance and rollouts with teacher-forced actions.

``DriverPolicy`` is the Flax MLP actor-critic (Dense 64, ReLU, Dense 64,
ReLU, heads 9 and 1) in f32, with the Flax names ``Dense_0 .. Dense_3``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from levelgan_torch.env.agent import lecun_normal
from levelgan_torch.models.generator import Dense
from levelgan_torch.ops.gumbel import gumbel_noise

OBS_DIM_BASE = 4
N_ACTIONS = 9


class RaceParams(NamedTuple):
    rollout_steps: int = 64
    dt: float = 0.5
    v_max: float = 1.2
    accel: float = 0.2
    steer_rate: float = 0.5
    drag: float = 0.05
    crash_penalty: float = 1.0
    lap_bonus: float = 5.0
    step_penalty: float = 0.005
    preview: int = 6          # upcoming curvature samples in the observation
    gamma: float = 0.99


class CarState(NamedTuple):
    s: torch.Tensor      # [B] arc position (units of segments)
    d: torch.Tensor      # [B] lateral offset
    psi: torch.Tensor    # [B] heading error
    v: torch.Tensor      # [B] speed
    laps: torch.Tensor   # [B] completed laps (float)


def init_cars(batch: int, device) -> CarState:
    z = torch.zeros((batch,), device=device)
    return CarState(s=z, d=z, psi=z, v=z, laps=z)


def _seg_index(s: torch.Tensor, t: int) -> torch.Tensor:
    return torch.clamp(torch.floor(s).to(torch.int64) % t, 0, t - 1)


def _seg_lookup(per_seg: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """per_seg [B, T], s [B] -> the value of the segment holding s."""
    return per_seg.gather(1, _seg_index(s, per_seg.shape[-1])[:, None])[:, 0]


def _window(per_seg: torch.Tensor, s: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n]: the values of the n segments from the one holding s on."""
    t = per_seg.shape[-1]
    idx0 = torch.floor(s).to(torch.int64)
    idx = (idx0[:, None] + torch.arange(n, device=s.device)[None, :]) % t
    return per_seg.gather(1, idx)


def observe(tracks: torch.Tensor, car: CarState, p: RaceParams
            ) -> torch.Tensor:
    """[B, 4 + preview] observation: speed, normalised offset, sin and cos
    of the heading error, then the next ``p.preview`` curvatures."""
    w_here = _seg_lookup(tracks[..., 1], car.s)
    return torch.cat([
        torch.stack([car.v, car.d / (w_here * 0.5 + 1e-6),
                     torch.sin(car.psi), torch.cos(car.psi)], dim=-1),
        _window(tracks[..., 0], car.s, p.preview)], dim=-1)


def race_step(tracks: torch.Tensor, car: CarState, action: torch.Tensor,
              p: RaceParams):
    """One dynamics step of every car; action [B] in [0, 9).  Returns
    (new car, reward [B], crashed [B] bool)."""
    kappa, width = tracks[..., 0], tracks[..., 1]
    t = kappa.shape[-1]
    steer = (action % 3).float() - 1.0
    accel = (action // 3).float() - 1.0

    k_here = _seg_lookup(kappa, car.s)
    v = torch.clamp(car.v + (p.accel * accel - p.drag * car.v) * p.dt,
                    0.0, p.v_max)
    psi = car.psi + (p.steer_rate * steer
                     - k_here * v * torch.cos(car.psi)) * p.dt
    ds = v * torch.cos(psi) * p.dt
    s_new = car.s + ds
    d = car.d + v * torch.sin(psi) * p.dt

    w_half = 0.5 * _seg_lookup(width, s_new)
    crashed = d.abs() > w_half
    d = torch.where(crashed, torch.sign(d) * w_half * 0.5, d)
    v = torch.where(crashed, 0.1 * v, v)
    psi = torch.where(crashed, 0.0, psi)

    wrap = s_new >= t
    lap = wrap.float()
    s_new = torch.where(wrap, s_new - t, s_new)

    reward = (ds - p.step_penalty - p.crash_penalty * crashed.float()
              + p.lap_bonus * lap)
    return (CarState(s=s_new, d=d, psi=psi, v=v, laps=car.laps + lap),
            reward, crashed)


class RaceTrajectory(NamedTuple):
    obs: torch.Tensor           # [T, B, obs_dim]
    actions: torch.Tensor       # [T, B] int64
    rewards: torch.Tensor       # [T, B]
    returns: torch.Tensor       # [T, B]
    active: torch.Tensor        # [T, B] (always 1: races run the horizon)
    total_return: torch.Tensor  # [B]
    progress: torch.Tensor      # [B] total arc progress incl. laps
    crashes: torch.Tensor       # [B] crash count


def discounted_returns(rewards: torch.Tensor, gamma: float) -> torch.Tensor:
    """g_t = r_t + gamma * g_{t+1} over [T, B], each step rounded once to
    f32, as XLA's fused multiply-add rounds it (the f64 product of two f32s
    is exact)."""
    gamma = float(torch.tensor(gamma, dtype=torch.float32))
    g = torch.zeros_like(rewards[0])
    out = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        g = (rewards[t].double() + gamma * g.double()).float()
        out[t] = g
    return torch.stack(out)


@torch.no_grad()
def race_rollout(policy, tracks: torch.Tensor, p: RaceParams, *,
                 noise: torch.Tensor | None = None,
                 actions: torch.Tensor | None = None,
                 generator: torch.Generator | None = None) -> RaceTrajectory:
    """Race ``policy`` (``obs -> (logits [B, 9], value [B])``) on tracks
    [B, T, 2] for ``p.rollout_steps`` steps.  Each action is the argmax of
    logits + Gumbel ``noise`` [steps, B, 9] (drawn from ``generator`` when
    not given); ``actions`` [steps, B] replaces the draws (teacher forcing:
    a test feeds the JAX trajectory's actions)."""
    b, steps = tracks.shape[0], p.rollout_steps
    if noise is None and actions is None:
        noise = gumbel_noise((steps, b, N_ACTIONS), device=tracks.device,
                             generator=generator)
    car = init_cars(b, tracks.device)
    total = torch.zeros((b,), device=tracks.device)
    crashes = torch.zeros((b,), device=tracks.device)
    obs_t, act_t, rew_t = [], [], []
    for t in range(steps):
        obs = observe(tracks, car, p)
        if actions is None:
            logits, _ = policy(obs)
            action = torch.argmax(noise[t] + logits, dim=-1)
        else:
            action = actions[t].to(torch.int64)
        car, reward, crashed = race_step(tracks, car, action, p)
        obs_t.append(obs)
        act_t.append(action)
        rew_t.append(reward)
        total = total + reward
        crashes = crashes + crashed.float()
    rewards = torch.stack(rew_t)
    return RaceTrajectory(
        obs=torch.stack(obs_t), actions=torch.stack(act_t), rewards=rewards,
        returns=discounted_returns(rewards, p.gamma),
        active=torch.ones_like(rewards), total_return=total,
        progress=car.laps * tracks.shape[1] + car.s, crashes=crashes)


class DriverPolicy(nn.Module):
    """obs [B, obs_dim] -> (action logits [B, 9], value [B]), f32."""

    def __init__(self, obs_dim: int, hidden: int = 64):
        super().__init__()
        self.Dense_0 = Dense(obs_dim, hidden)
        self.Dense_1 = Dense(hidden, hidden)
        self.Dense_2 = Dense(hidden, N_ACTIONS)
        self.Dense_3 = Dense(hidden, 1)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "DriverPolicy":
        """Flax's initializers, in parameter order: lecun_normal kernels,
        normal(0.01) for the two heads, zero biases."""
        for name, p in self.named_parameters():
            if name in ("Dense_2.kernel", "Dense_3.kernel"):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.01)
            elif name.endswith("kernel"):
                p.copy_(lecun_normal(tuple(p.shape), generator))
        return self

    def forward(self, obs):
        f32 = torch.float32
        x = F.relu(self.Dense_0(obs, f32))
        x = F.relu(self.Dense_1(x, f32))
        return self.Dense_2(x, f32), self.Dense_3(x, f32).squeeze(-1)


def init_driver(p: RaceParams, generator: torch.Generator) -> DriverPolicy:
    return DriverPolicy(OBS_DIM_BASE + p.preview).init_params(generator)
