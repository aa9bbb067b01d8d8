"""Track-family train steps: port of ``levelgan/track/train.py``.

``make_track_wgan_step`` (``racetrack_32``): ``n_critic`` WGAN-GP critic
updates on real tracks, then one generator update against the updated
critic (with the ``train.w_closure`` prior when set) and the G EMA.
``make_track_curriculum_step`` (``race_curriculum_32``): the same critic
updates, then ONE generator forward whose mean tracks serve both the race
and the G update: exploration noise on the curvature (the REINFORCE
sample, scored unclipped; the drivers race it clipped to +-KAPPA_MAX),
both drivers' rollouts and A2C updates, and the generator's loss -D(mean)
plus the REINFORCE term on the drivers' reward, backward once.  Both steps
share ``make_track_critic_update``.

The gradient penalty follows ``model.pallas_gp`` as on the tile family
(``ops.grad_penalty.make_gradient_penalty``): ``'auto'`` takes the K2 core
kernels over g [B, T * 2], ``'fused'`` is refused (the fused kernel
mirrors the tile critic only).  A conditional model (``model.cond_dim``)
conditions both networks on ``track_features`` of each augmented real
batch, G's update on those of the last real batch, un-augmented.

Randomness, in the order ``draw_track_noise`` draws it from one
``torch.Generator``: per critic iteration the augment's shifts and flips,
z and the GP's eps; G's z; for the curriculum the exploration draw [B, T]
(a standard normal, scaled by EXPLORE_SIGMA in the step) and the strong
and the weak driver's Gumbel action noise [T, B, 9].  Tests inject the
JAX step's draws instead.
"""

from __future__ import annotations

import torch

from levelgan_torch.config import Config
from levelgan_torch.dist import mesh
from levelgan_torch.env.agent import a2c_loss_from_obs
from levelgan_torch.ops.grad_penalty import make_gradient_penalty
from levelgan_torch.ops.gumbel import gumbel_noise
from levelgan_torch.track.data import KAPPA_MAX, TrackDataset
from levelgan_torch.track.ops import (closure_penalty, curvature_hist_device,
                                      draw_augment, track_augment,
                                      track_features)
from levelgan_torch.track.race import N_ACTIONS, RaceParams, race_rollout
from levelgan_torch.train.gan import apply_grads
from levelgan_torch.train.state import (CurriculumState, GANState,
                                        update_ema)

EXPLORE_SIGMA = 0.05  # curvature exploration noise of the REINFORCE sample


def race_params(cfg: Config) -> RaceParams:
    return RaceParams(rollout_steps=cfg.curriculum.rollout_steps,
                      gamma=cfg.curriculum.gamma)


def draw_track_noise(cfg: Config, n_critic: int, batch: int, device,
                     generator: torch.Generator | None = None) -> dict:
    """All random draws of one step: ``{"critic": [per-iteration dict of
    shifts, flips, z, eps], "g": {"z"}}``, and for the curriculum loss
    ``explore`` [B, T], ``rollout_strong`` and ``rollout_weak`` [T, B, 9]."""
    m = cfg.model

    def z():
        return torch.randn((batch, m.latent_dim), device=device,
                           generator=generator)

    its = []
    for _ in range(n_critic):
        shifts, flips = draw_augment(batch, m.n_segments, device, generator)
        its.append({"shifts": shifts, "flips": flips, "z": z(),
                    "eps": torch.rand((batch, 1, 1), device=device,
                                      generator=generator)})
    out = {"critic": its, "g": {"z": z()}}
    if cfg.train.loss == "curriculum":
        out["explore"] = torch.randn((batch, m.n_segments), device=device,
                                     generator=generator)
        shape = (cfg.curriculum.rollout_steps, batch, N_ACTIONS)
        for who in ("strong", "weak"):
            out[f"rollout_{who}"] = gumbel_noise(shape, device=device,
                                                 generator=generator)
    return out


def make_track_critic_update(cfg: Config):
    """The n_critic critic updates of both track steps.  Returns
    ``run(state, batch [n_critic, B, T, 2], noises) -> metrics of the last
    iteration`` (d_loss, gp, wdist); the critic and its Adam are updated in
    place."""
    m, t = cfg.model, cfg.train
    gp_impl = make_gradient_penalty(m)

    def run(state: GANState, batch: torch.Tensor, noises) -> dict:
        gen, critic = state.generator, state.critic
        params = list(critic.parameters())
        if len(noises) != len(batch):
            raise ValueError(f"{len(batch)} critic batches but "
                             f"{len(noises)} noise draws")
        out = {}
        for real_raw, nz in zip(batch, noises):
            real = (track_augment(real_raw, nz["shifts"], nz["flips"])
                    if cfg.data.augment else real_raw)
            cond = track_features(real) if m.cond_dim else None
            with torch.no_grad():
                fake = gen(nz["z"], cond)
            wdist = critic(real, cond).mean() - critic(fake, cond).mean()
            gp = gp_impl(critic, real, fake, cond, nz["eps"])
            loss = -wdist + t.gp_lambda * gp
            apply_grads(params, torch.autograd.grad(loss, params),
                        state.opt_d)
            out = {"d_loss": loss.detach(), "gp": gp.detach(),
                   "wdist": wdist.detach()}
        return out

    return run


def _check_batch(batch: torch.Tensor, what: str) -> None:
    if batch.ndim != 4 or batch.shape[-1] != 2:
        raise ValueError(f"{what} expects tracks [n_critic, B, T, 2], got "
                         f"{tuple(batch.shape)}")


def make_track_wgan_step(cfg: Config, cond_scale=None):
    """The track WGAN-GP step: ``step_fn(state, batch [n_critic, B, T, 2]
    f32, noise=None, generator=None) -> (state, metrics)``; ``noise`` is
    ``draw_track_noise``'s structure, else drawn from ``generator``.
    ``cond_scale`` is accepted for the trainer's uniform call; the track
    steps have no cond-match term."""
    if cfg.train.w_presence:
        raise ValueError("train.w_presence is tile-family only "
                         "(structural-tile presence prior); track tracks "
                         "have no START/GOAL tiles")
    m, t = cfg.model, cfg.train
    critic_update = make_track_critic_update(cfg)

    def step_fn(state: GANState, batch: torch.Tensor, noise=None,
                generator: torch.Generator | None = None):
        _check_batch(batch, "the track wgan_gp step")
        if noise is None:
            noise = draw_track_noise(cfg, batch.shape[0], batch.shape[1],
                                     batch.device, generator)
        it = critic_update(state, batch, noise["critic"])
        gen, critic = state.generator, state.critic
        cond_g = track_features(batch[-1]) if m.cond_dim else None
        fake = gen(noise["g"]["z"], cond_g)
        g_loss = -critic(fake, cond_g).mean()
        clos = None
        if t.w_closure:
            clos = closure_penalty(fake)
            g_loss = g_loss + t.w_closure * clos
        params = list(gen.parameters())
        apply_grads(params, torch.autograd.grad(g_loss, params), state.opt_g)
        update_ema(cfg, state.g_ema, gen, state.step)
        state.step += 1
        metrics = {**it, "g_loss": g_loss.detach(),
                   "gen_hist": curvature_hist_device(fake.detach(),
                                                     TrackDataset.N_BINS)}
        if clos is not None:
            metrics["closure"] = clos.detach()
        return state, metrics

    return step_fn


def driver_update(policy, opt, traj, cur):
    """One A2C step of ``policy`` in place on its trajectory; returns the
    loss's aux (pg_loss, v_loss, entropy)."""
    loss, aux = a2c_loss_from_obs(policy, traj.obs, traj.actions,
                                  traj.returns, traj.active, cur)
    params = list(policy.parameters())
    apply_grads(params, torch.autograd.grad(loss, params), opt)
    return {k: v.detach() for k, v in aux.items()}


def reinforce_term(advantage: torch.Tensor, kappa_s: torch.Tensor,
                   mu: torch.Tensor, n_segments: int) -> torch.Tensor:
    """G's REINFORCE term: -(advantage * log p(kappa_s | mu)).mean() /
    n_segments, log p the Gaussian exploration's log-density (up to its
    constant) of the sampled curvatures [B, T] around the mean ``mu``."""
    logp = -0.5 * ((kappa_s - mu) / EXPLORE_SIGMA).square().sum(-1)
    return -(advantage * logp).mean() / n_segments


def make_track_curriculum_step(cfg: Config, cond_scale=None):
    """The race curriculum step: ``step_fn(state, batch [n_critic, B, T, 2]
    f32, noise=None, generator=None) -> (state, metrics)``; ``noise`` is
    ``draw_track_noise``'s structure, else drawn from ``generator``."""
    m, cur, t = cfg.model, cfg.curriculum, cfg.train
    rp = race_params(cfg)
    critic_update = make_track_critic_update(cfg)
    horizon = rp.rollout_steps * rp.v_max * rp.dt

    def step_fn(state: CurriculumState, batch: torch.Tensor, noise=None,
                generator: torch.Generator | None = None):
        _check_batch(batch, "the race curriculum step")
        if noise is None:
            noise = draw_track_noise(cfg, batch.shape[0], batch.shape[1],
                                     batch.device, generator)

        # ---- 1. critic (realism) updates ----------------------------------
        it = critic_update(state, batch, noise["critic"])

        # ---- 2. ONE generator forward: the mean tracks and their sample ---
        gen, critic = state.generator, state.critic
        cond_g = track_features(batch[-1]) if m.cond_dim else None
        mean_tracks = gen(noise["g"]["z"], cond_g)
        # the Gaussian sample is scored unclipped; the drivers race it
        # clipped to the physical curvature range
        kappa_s = mean_tracks[..., 0].detach() + EXPLORE_SIGMA * noise[
            "explore"]
        tracks = torch.stack([kappa_s.clamp(-KAPPA_MAX, KAPPA_MAX),
                              mean_tracks[..., 1].detach()], dim=-1)

        # ---- 3. both drivers race the sampled tracks ----------------------
        traj_s = race_rollout(state.agent_strong, tracks, rp,
                              noise=noise["rollout_strong"])
        traj_w = race_rollout(state.agent_weak, tracks, rp,
                              noise=noise["rollout_weak"])

        # ---- 4. driver A2C updates ----------------------------------------
        for _ in range(max(1, cur.agent_updates_per_step)):
            s_aux = driver_update(state.agent_strong, state.opt_as, traj_s,
                                  cur)
        for _ in range(max(1, cur.agent_updates_per_step)):
            driver_update(state.agent_weak, state.opt_aw, traj_w, cur)

        # ---- 5. ONE G update: adversarial + REINFORCE ---------------------
        drive_s = traj_s.progress / horizon
        drive_w = traj_w.progress / horizon
        gap = traj_s.total_return - traj_w.total_return
        reward = cur.w_play * drive_s - cur.w_anti * drive_w + cur.w_gap * gap
        advantage = reward - state.g_baseline
        gan_term = -critic(mean_tracks, cond_g).mean()
        rl_term = reinforce_term(advantage, kappa_s, mean_tracks[..., 0],
                                 m.n_segments)
        g_loss = gan_term + rl_term
        clos = None
        if t.w_closure:
            clos = closure_penalty(mean_tracks)
            g_loss = g_loss + t.w_closure * clos
        params = list(gen.parameters())
        apply_grads(params, torch.autograd.grad(g_loss, params), state.opt_g)
        state.g_baseline = (cur.g_baseline_decay * state.g_baseline
                            + (1 - cur.g_baseline_decay)
                            * mesh.global_mean(reward))
        update_ema(cfg, state.g_ema, gen, state.step)
        state.step += 1
        metrics = {
            **it, "g_loss": g_loss.detach(), "g_gan": gan_term.detach(),
            "g_rl": rl_term.detach(), "drivability": drive_s.mean(),
            "drivability_weak": drive_w.mean(), "skill_gap": gap.mean(),
            "crashes": traj_s.crashes.mean(),
            "laps": (traj_s.progress / m.n_segments).mean(),
            "agent_entropy": s_aux["entropy"],
            "gen_hist": curvature_hist_device(mean_tracks.detach(),
                                              TrackDataset.N_BINS)}
        if clos is not None:
            metrics["closure"] = clos.detach()
        return state, metrics

    return step_fn
