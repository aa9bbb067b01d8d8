"""Train state: the two models, their optimizers, the G EMA and the step.

Port of ``levelgan/train/state.py``.  ``ScheduledAdam`` is
``torch.optim.Adam`` with optax's semantics: its update is
``lr * m_hat / (sqrt(v_hat) + eps)`` with eps 1e-8, as ``optax.adam``'s
is, and its learning rate follows the config's schedule counted in
optimizer updates (with cosine decay the critic's horizon is scaled by
``n_critic``, since it updates that many times per train step).
``ScheduledAdam.restore`` continues it from a checkpoint's count and
moments (``lio.checkpoint.load_checkpoint``).

For ``train.loss='curriculum'`` the state is a ``CurriculumState``: the
GAN state plus the REINFORCE baseline ``g_baseline`` (a 0-d f32 tensor)
and the strong and weak agents with their Adams (``optax.adam`` at its
defaults, constant lr).  ``create_state`` draws each agent from a
generator of its own, seeded by (seed, agent), after G and D.

The track family (``model.family='track'``) holds the same states over
its own models: ``TrackGenerator`` / ``TrackCritic``, and for the race
curriculum two ``DriverPolicy`` MLPs in the agents' places.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass

import numpy as np
import torch

from levelgan_torch import obs
from levelgan_torch.config import Config
from levelgan_torch.env.agent import init_agent
from levelgan_torch.models import Critic, Generator
from levelgan_torch.track.models import TrackCritic, TrackGenerator
from levelgan_torch.track.race import RaceParams, init_driver

ADAM_BETAS = (0.9, 0.999)    # optax.adam's defaults, the agents' Adams
_AGENT_TAG = 0xA6E7          # separates the agents' init streams


class ScheduledAdam(torch.optim.Adam):
    """Adam whose lr at update ``count`` is ``schedule(count)``."""

    def __init__(self, params, schedule, betas):
        super().__init__(params, lr=schedule(0), betas=betas, eps=1e-8)
        self.schedule = schedule
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        lr = self.schedule(self.count)
        for group in self.param_groups:
            group["lr"] = lr
        self.count += 1
        return super().step(closure)

    @torch.no_grad()
    def restore(self, count: int, moments: dict) -> None:
        """Continue after ``count`` updates with ``moments`` {param: (mu,
        nu)} (optax's ``mu`` / ``nu``): the schedule and the bias
        correction go on where they stopped.  At ``count`` 0 the state
        stays empty, as before a first update."""
        self.count = int(count)
        self.state.clear()
        if not self.count:
            return
        for p, (mu, nu) in moments.items():
            # "step" as Adam keeps it: a default-dtype scalar on the host
            self.state[p] = {
                "step": torch.tensor(float(self.count)),
                "exp_avg": mu.to(p.device, p.dtype).contiguous(),
                "exp_avg_sq": nu.to(p.device, p.dtype).contiguous()}


def lr_schedule(cfg: Config, base: float, updates_per_step: int = 1):
    """optax's schedule for ``train.lr_schedule``, as a function of the
    update count: constant, or cosine decay to 1% over steps * updates."""
    t = cfg.train
    if t.lr_schedule == "none":
        return lambda count: base
    if t.lr_schedule == "cosine":
        horizon = t.steps * updates_per_step

        def cosine(count):
            frac = min(count, horizon) / horizon
            return base * (0.99 * 0.5 * (1.0 + math.cos(math.pi * frac)) + 0.01)
        return cosine
    raise ValueError(f"unknown lr_schedule '{t.lr_schedule}'")


def make_optimizers(cfg: Config, gen: torch.nn.Module,
                    critic: torch.nn.Module):
    t = cfg.train
    d_updates = t.n_critic if t.loss in ("wgan_gp", "curriculum") else 1
    betas = (t.beta1, t.beta2)
    opt_g = ScheduledAdam(gen.parameters(), lr_schedule(cfg, t.lr_g), betas)
    opt_d = ScheduledAdam(critic.parameters(),
                          lr_schedule(cfg, t.lr_d, d_updates), betas)
    return opt_g, opt_d


def make_agent_optimizers(cfg: Config, strong: torch.nn.Module,
                          weak: torch.nn.Module):
    """``optax.adam(agent_lr)`` and ``optax.adam(weak_agent_lr)`` over the
    two agents (tile ``AgentPolicy`` or track ``DriverPolicy``)."""
    cur = cfg.curriculum
    return (ScheduledAdam(strong.parameters(), lambda _: cur.agent_lr,
                          ADAM_BETAS),
            ScheduledAdam(weak.parameters(), lambda _: cur.weak_agent_lr,
                          ADAM_BETAS))


@dataclass
class GANState:
    step: int
    generator: Generator | TrackGenerator
    critic: Critic | TrackCritic
    opt_g: ScheduledAdam
    opt_d: ScheduledAdam
    g_ema: Generator | TrackGenerator


@dataclass
class CurriculumState(GANState):
    g_baseline: torch.Tensor
    agent_strong: torch.nn.Module      # AgentPolicy / track DriverPolicy
    agent_weak: torch.nn.Module
    opt_as: ScheduledAdam
    opt_aw: ScheduledAdam


def model_classes(cfg: Config):
    """(generator class, critic class) of ``cfg``'s model family."""
    if cfg.model.family == "track":
        return TrackGenerator, TrackCritic
    return Generator, Critic


def init_agents(cfg: Config, seed: int):
    """Fresh (strong, weak) agents of ``cfg``'s family, each from a
    generator seeded by (seed, agent)."""
    def fresh(i):
        gen = torch.Generator().manual_seed(int(np.random.SeedSequence(
            [seed, _AGENT_TAG, i]).generate_state(1, np.uint64)[0]))
        if cfg.model.family == "track":
            return init_driver(RaceParams(), gen)
        return init_agent(cfg.model, gen)
    return fresh(0), fresh(1)


def create_state(cfg: Config, device, *, seed: int | None = None,
                 generator: torch.nn.Module | None = None,
                 critic: torch.nn.Module | None = None,
                 agents: tuple[torch.nn.Module, torch.nn.Module] | None = None
                 ) -> GANState:
    """Fresh models (the Flax initializers, from a generator seeded with
    ``seed``, default ``train.seed``) or the given ones, fresh optimizers,
    and ``g_ema`` a copy of G; for the curriculum loss also the baseline
    and the (strong, weak) ``agents``, fresh or given."""
    m = cfg.model
    seed = cfg.train.seed if seed is None else seed
    init = torch.Generator().manual_seed(seed)
    gen_cls, critic_cls = model_classes(cfg)
    if generator is None:
        generator = gen_cls(m).init_params(init)
    if critic is None:
        critic = critic_cls(m).init_params(init)
    generator, critic = generator.to(device), critic.to(device)
    opt_g, opt_d = make_optimizers(cfg, generator, critic)
    g_ema = copy.deepcopy(generator).requires_grad_(False)
    base = dict(step=0, generator=generator, critic=critic, opt_g=opt_g,
                opt_d=opt_d, g_ema=g_ema)
    if cfg.train.loss != "curriculum":
        return GANState(**base)
    if agents is None:
        agents = init_agents(cfg, seed)
    strong, weak = (a.to(device) for a in agents)
    opt_as, opt_aw = make_agent_optimizers(cfg, strong, weak)
    return CurriculumState(**base, g_baseline=torch.zeros((), device=device),
                           agent_strong=strong, agent_weak=weak,
                           opt_as=opt_as, opt_aw=opt_aw)


@torch.no_grad()
def update_ema(cfg: Config, ema: torch.nn.Module, params: torch.nn.Module,
               step: int) -> None:
    """In place: ema = d * ema + (1 - d) * params with the warm-up decay
    d = min(ema_decay, (1 + step) / (10 + step)); with ema_decay 0 the EMA
    is the live params."""
    d_max = cfg.train.ema_decay
    d = min(d_max, (1.0 + step) / (10.0 + step)) if d_max else 0.0
    d = float(torch.tensor(d, dtype=torch.float32))   # f32, as in JAX
    with obs.span("train.ema"):
        for e, p in zip(ema.parameters(), params.parameters()):
            e.mul_(d).add_(p, alpha=1.0 - d)
