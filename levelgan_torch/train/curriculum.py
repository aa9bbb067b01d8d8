"""Agent-in-the-loop adversarial curriculum step: port of
``levelgan/train/curriculum.py`` (``train.loss='curriculum'``).

Levels are scored by agents that play them, and the generator is trained
to make levels that are playable and that separate a strong agent from a
weak one, by REINFORCE on the agent-derived reward.  One step:

1. the ``n_critic`` WGAN-GP critic updates on real levels
   (``wgan_gp.make_critic_scan``, shared with the WGAN-GP step);
2. one generator forward and its Gumbel straight-through sample: the hard
   levels the agents play, and the fake of the G update below (the same
   draw, so the same levels);
3. both agents' T-step rollouts (``env.sim.rollout``, no gradient);
4. ``agent_updates_per_step`` A2C updates of each agent (the weak one
   learns slower);
5. the G update: -D(fake) against the updated critic (without the
   ``mbstd`` scale), plus the REINFORCE term: the per-cell log-probabilities
   of the sampled levels (weighted by the agents' dilated visits with
   ``cell_credit``) times the reward's advantage over an EMA baseline,
   scaled by 1 / level_size^2; the presence prior at the constant
   ``train.presence_excess``; then the baseline and the G EMA.

The reward is ``w_play * reached(strong) - w_anti * reached(weak) + w_gap *
(return_strong - return_weak)`` (the gap only on solvable levels with
``gap_on_solvable``) ``+ w_solvable * solvable`` (switched off once the
batch's solvable share reaches ``solvable_target`` < 1); the flood-fill
solver runs only when a term needs it.

Randomness, in the order ``draw_curriculum_noise`` draws it from one
``torch.Generator``: the critic iterations' draws and G's z and Gumbel
noise (``wgan_gp.draw_step_noise``), then the strong and the weak agent's
action noise [T, B, 4]; tests inject the JAX step's draws instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from levelgan_torch.config import Config
from levelgan_torch.data.codec import decode
from levelgan_torch.data.features import level_features
from levelgan_torch.dist import mesh
from levelgan_torch.env.agent import agent_update
from levelgan_torch.env.sim import N_ACTIONS, EnvParams, rollout
from levelgan_torch.env.solver import solvable
from levelgan_torch.lio.metrics import tile_histogram
from levelgan_torch.models import sample_head
from levelgan_torch.ops.grad_penalty import make_gradient_penalty
from levelgan_torch.ops.gumbel import gumbel_noise
from levelgan_torch.ops.presence import presence_penalty
from levelgan_torch.train.gan import (apply_grads, check_step_config,
                                     current_tau)
from levelgan_torch.train.state import CurriculumState, update_ema
from levelgan_torch.train.wgan_gp import draw_step_noise, make_critic_scan


def env_params(cfg: Config) -> EnvParams:
    cur = cfg.curriculum
    return EnvParams(rollout_steps=cur.rollout_steps, gamma=cur.gamma)


def draw_curriculum_noise(cfg: Config, n_critic: int, batch: int, device,
                          generator: torch.Generator | None = None) -> dict:
    """All random draws of one step: ``draw_step_noise``'s structure plus
    ``rollout_strong`` and ``rollout_weak``, the agents' Gumbel action
    noise [T, B, 4]."""
    noise = draw_step_noise(cfg, n_critic, batch, device, generator)
    shape = (cfg.curriculum.rollout_steps, batch, N_ACTIONS)
    for who in ("strong", "weak"):
        noise[f"rollout_{who}"] = gumbel_noise(shape, device=device,
                                               generator=generator)
    return noise


def _visit_credit(trajs, size: int) -> torch.Tensor:
    """Per-cell credit [B, H, W]: the cells either agent stood on, dilated
    by one cell (3x3 max), normalised to mean 1 over the cells."""
    b = trajs[0].pos.shape[1]
    visit = torch.zeros((b, size * size), device=trajs[0].pos.device)
    for traj in trajs:
        cells = traj.pos[..., 0].long() * size + traj.pos[..., 1].long()
        visit.scatter_(1, cells.t(), 1.0)
    # reduce_window(max, -inf, 3x3, SAME): max_pool2d pads with -inf
    dilated = F.max_pool2d(visit.reshape(b, 1, size, size), 3, 1, 1)[:, 0]
    return (dilated * (size * size)
            / (dilated.sum(dim=(1, 2), keepdim=True) + 1e-6))


def make_curriculum_step(cfg: Config, cond_scale: torch.Tensor | None = None):
    """The curriculum step: ``step_fn(state, batch_ids [n_critic, B, H, W],
    noise=None, generator=None) -> (state, metrics)``; ``noise`` is
    ``draw_curriculum_noise``'s structure, else drawn from ``generator``.
    ``cond_scale`` is accepted for the trainer's uniform call; the step has
    no cond-match term and ignores ``train.w_cond_match``, as the JAX step
    does."""
    m, t, cur = cfg.model, cfg.train, cfg.curriculum
    check_step_config(cfg)
    if m.head != "gumbel":
        # The REINFORCE term scores HARD discrete levels; with any other
        # head the critic/gan term would train on soft samples while the
        # agents play discrete ones: two different sample spaces
        raise ValueError(
            f"curriculum loss requires model.head='gumbel', got '{m.head}'")
    if m.structural_head != "none":
        raise ValueError("model.structural_head='spatial' is not supported "
                         "with the curriculum loss (REINFORCE log-prob "
                         "assumes per-cell channel sampling)")
    ep = env_params(cfg)
    critic_scan = make_critic_scan(cfg, make_gradient_penalty(m))
    use_solver = bool(cur.w_solvable or cur.gap_on_solvable)

    def step_fn(state: CurriculumState, batch_ids: torch.Tensor, noise=None,
                generator: torch.Generator | None = None):
        if batch_ids.ndim != 4:
            raise ValueError("curriculum expects batch ids "
                             "[n_critic, B, H, W]")
        bsz = batch_ids.shape[1]
        if noise is None:
            noise = draw_curriculum_noise(cfg, batch_ids.shape[0], bsz,
                                          batch_ids.device, generator)
        tau = current_tau(cfg, state.step)

        # ---- 1. critic updates on real corpus levels ----------------------
        it = critic_scan(state, batch_ids, noise["critic"])

        # ---- 2. one generator forward: the levels and G's fake ------------
        gen, critic = state.generator, state.critic
        cond_g = level_features(batch_ids[-1]) if m.cond_dim else None
        logits = gen(noise["g"]["z"], cond_g)
        fake = sample_head(logits, m.head, tau, m.structural_head,
                           noise=noise["g"]["noise"])
        # the hard Gumbel-ST sample is one-hot: it is the level's encoding
        level_onehot = fake.detach().float()
        level_ids = decode(level_onehot)

        # ---- 3. both agents play the levels -------------------------------
        traj_s = rollout(state.agent_strong, level_ids, level_onehot, ep,
                         noise=noise["rollout_strong"])
        traj_w = rollout(state.agent_weak, level_ids, level_onehot, ep,
                         noise=noise["rollout_weak"])

        # ---- 4. agent updates (A2C replay) --------------------------------
        for _ in range(max(1, cur.agent_updates_per_step)):
            _, s_aux = agent_update(state.agent_strong, state.opt_as,
                                    level_onehot, traj_s, cur)
        for _ in range(max(1, cur.agent_updates_per_step)):
            agent_update(state.agent_weak, state.opt_aw, level_onehot,
                         traj_w, cur)

        # ---- 5. the reward, then the generator update ---------------------
        play_s = traj_s.reached.float()
        play_w = traj_w.reached.float()
        gap = traj_s.total_return - traj_w.total_return
        sol = solvable(level_ids).float() if use_solver else None
        gap_term = gap * sol if cur.gap_on_solvable else gap
        level_reward = (cur.w_play * play_s - cur.w_anti * play_w
                        + cur.w_gap * gap_term)
        if cur.w_solvable:
            w_sol = cur.w_solvable
            if cur.solvable_target < 1.0:
                # the ceiling: off once the batch is solvable enough
                w_sol = w_sol * (mesh.global_mean(sol)
                                 < cur.solvable_target).float()
            level_reward = level_reward + w_sol * sol
        advantage = level_reward - state.g_baseline
        credit = (_visit_credit((traj_s, traj_w), m.level_size)
                  if cur.cell_credit else None)

        gan_term = -critic(fake, cond_g).mean()
        logp_cell = (F.log_softmax(logits, dim=-1) * level_onehot).sum(-1)
        if credit is not None:
            logp_cell = logp_cell * credit
        logp = logp_cell.sum(dim=(1, 2))
        rl_term = -(advantage * logp).mean() / (m.level_size ** 2)
        g_loss = gan_term + rl_term
        pres = None
        if t.w_presence:
            pres = presence_penalty(fake, w_spread=t.presence_spread,
                                    w_excess=t.presence_excess)
            g_loss = g_loss + t.w_presence * pres
        params = list(gen.parameters())
        apply_grads(params, torch.autograd.grad(g_loss, params), state.opt_g)
        state.g_baseline = (cur.g_baseline_decay * state.g_baseline
                            + (1 - cur.g_baseline_decay)
                            * mesh.global_mean(level_reward))
        update_ema(cfg, state.g_ema, gen, state.step)
        state.step += 1
        metrics = {
            **it, "g_loss": g_loss.detach(), "g_gan": gan_term.detach(),
            "g_rl": rl_term.detach(), "playability": play_s.mean(),
            "playability_weak": play_w.mean(),
            "return_strong": traj_s.total_return.mean(),
            "return_weak": traj_w.total_return.mean(),
            "skill_gap": gap.mean(), "agent_entropy": s_aux["entropy"],
            "tau": tau, "gen_hist": tile_histogram(level_ids, m.n_tiles)}
        if sol is not None:
            metrics["solvable_frac"] = sol.mean()
        if pres is not None:
            metrics["presence"] = pres.detach()
        return state, metrics

    return step_fn
