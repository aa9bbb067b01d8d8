"""Policy-gradient agent: port of ``levelgan/env/agent.py``.

A small conv actor-critic over level observations (A2C-lite: advantage =
discounted return - V, an entropy bonus, a value head).  The update replays
a trajectory's stored states: the JAX package maps the policy over T with
``vmap``; here the T x B observations go through one policy forward.

``AgentPolicy`` is ``policy_apply`` (``policy(obs) -> (logits, value)``)
and keeps the Flax module's parameter names and layouts
(``Conv_0.kernel`` HWIO, ``Dense_0.kernel`` [in, out], ...), so its
``state_dict`` keys are the Flax paths with ``/`` written as ``.``.  Flax's
``padding='SAME'`` at stride 2 puts the odd pixel of padding at the high
end: a 3x3 kernel on an even size pads (0, 1), not (1, 1).  The agents'
optimizers are ``optax.adam(lr)`` at optax's defaults (b1 0.9, b2 0.999,
eps 1e-8) with a constant lr (``train.state.make_agent_optimizers``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from levelgan_torch.config import CurriculumConfig, ModelConfig
from levelgan_torch.dist import mesh
from levelgan_torch.env.sim import N_ACTIONS, Trajectory, make_obs
from levelgan_torch.models.generator import Dense


def lecun_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in (fan_in = all but the last
    dimension)."""
    w = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
    return w * (math.sqrt(1.0 / math.prod(shape[:-1])) / .87962566103423978)


def _half(n: int) -> int:
    """The output size of a SAME stride-2 conv over ``n`` pixels."""
    return -(-n // 2)


def _same_pad(n: int) -> tuple[int, int]:
    """Flax SAME padding of a 3x3 stride-2 conv over ``n`` pixels."""
    total = max((_half(n) - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


class ConvS2(nn.Module):
    """Flax ``nn.Conv(co, (3, 3), strides=(2, 2), padding='SAME')`` on
    NCHW; kernel HWIO [3, 3, ci, co]."""

    def __init__(self, ci: int, co: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(3, 3, ci, co))
        self.bias = nn.Parameter(torch.zeros(co))

    def forward(self, x):
        (t, b), (l, r) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
        return F.conv2d(F.pad(x, (l, r, t, b)),
                        self.kernel.permute(3, 2, 0, 1), self.bias, stride=2)


class AgentPolicy(nn.Module):
    """obs [B, H, W, C] -> (action logits [B, 4], value [B])."""

    def __init__(self, c_in: int, size: int, hidden: int = 64):
        super().__init__()
        self.Conv_0 = ConvS2(c_in, 32)
        self.Conv_1 = ConvS2(32, 64)
        side = _half(_half(size))
        self.Dense_0 = Dense(side * side * 64, hidden)
        self.Dense_1 = Dense(hidden, N_ACTIONS)
        self.Dense_2 = Dense(hidden, 1)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "AgentPolicy":
        """Flax's initializers: lecun_normal kernels (a normal truncated at
        two standard deviations, scaled to variance 1 / fan_in), normal(0.01)
        for the two heads, zero biases; drawn in parameter order."""
        for name, p in self.named_parameters():
            if not name.endswith("kernel"):
                continue
            if name.startswith(("Dense_1", "Dense_2")):
                w = torch.randn(p.shape, generator=generator) * 0.01
            else:
                w = lecun_normal(tuple(p.shape), generator)
            p.copy_(w)
        return self

    def forward(self, obs):
        x = F.relu(self.Conv_0(obs.permute(0, 3, 1, 2)))
        x = F.relu(self.Conv_1(x))
        # NHWC flatten, as the Flax module sees it
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x, torch.float32))
        return (self.Dense_1(x, torch.float32),
                self.Dense_2(x, torch.float32).squeeze(-1))


def init_agent(m: ModelConfig, generator: torch.Generator) -> AgentPolicy:
    return AgentPolicy(m.n_tiles + 1, m.level_size).init_params(generator)


def _a2c_terms(logits, value, actions, returns, active):
    """Per-timestep A2C terms from policy outputs (both losses share them)."""
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, actions[..., None]).squeeze(-1)
    adv = returns - value
    pg = -(logp * adv.detach()) * active
    vl = adv.square() * active
    ent = -(logp_all.exp() * logp_all).sum(-1) * active
    return pg, vl, ent


def _a2c_reduce(pg, vl, ent, active, cur: CurriculumConfig):
    """Sums over the active steps of the global batch: the denominator is
    summed over the data-parallel ranks, and each rank's sums are scaled by
    their number, so that the ranks' mean (of the gradients and of the
    logged terms) is the global ratio of sums."""
    denom = mesh.global_sum(active.sum()).clamp_min(1.0)
    n = mesh.world_size()
    pg_loss = pg.sum() / denom * n
    v_loss = vl.sum() / denom * n
    ent_mean = ent.sum() / denom * n
    loss = pg_loss + cur.value_coef * v_loss - cur.entropy_coef * ent_mean
    return loss, {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": ent_mean}


def a2c_loss(policy: AgentPolicy, onehot: torch.Tensor, traj: Trajectory,
             cur: CurriculumConfig):
    """The actor-critic loss over [T, B], the observations recomputed from
    (onehot, pos, coins): one policy forward over all T x B of them."""
    t, b = traj.actions.shape
    obs = make_obs(onehot.expand(t, *onehot.shape).reshape(
        t * b, *onehot.shape[1:]), traj.pos.reshape(t * b, 2),
        traj.coins.reshape(t * b, *traj.coins.shape[2:]))
    logits, value = policy(obs)
    pg, vl, ent = _a2c_terms(logits, value, traj.actions.reshape(-1),
                             traj.returns.reshape(-1),
                             traj.active.reshape(-1))
    return _a2c_reduce(pg, vl, ent, traj.active, cur)


def a2c_loss_from_obs(policy_fn, obs, actions, returns, active,
                      cur: CurriculumConfig):
    """The A2C loss over stored observations [T, B, ...] (env families whose
    observations are plain vectors)."""
    t, b = actions.shape
    logits, value = policy_fn(obs.reshape(t * b, *obs.shape[2:]))
    pg, vl, ent = _a2c_terms(logits, value, actions.reshape(-1),
                             returns.reshape(-1), active.reshape(-1))
    return _a2c_reduce(pg, vl, ent, active, cur)


def agent_update(policy: AgentPolicy, opt: torch.optim.Optimizer, onehot,
                 traj, cur: CurriculumConfig):
    """One A2C step of ``policy`` in place; returns (loss, aux)."""
    loss, aux = a2c_loss(policy, onehot, traj, cur)
    params = list(policy.parameters())
    for p, g in zip(params, mesh.all_reduce_grads(
            torch.autograd.grad(loss, params))):
        p.grad = g
    opt.step()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}
