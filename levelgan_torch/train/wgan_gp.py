"""WGAN-GP train step, port of ``levelgan/train/wgan_gp.py``.

One step makes ``n_critic`` critic updates with the gradient penalty, then
one generator update and the G EMA.  The JAX package runs the critic
updates as a ``lax.scan`` inside one jit program; here they are a Python
loop (PyTorch runs eagerly).

Randomness per critic iteration: the D4 elements of the real batch, z, the
head's Gumbel noise and the GP's interpolation eps; for the generator
update z and the Gumbel noise.  All of it comes from ``draw_step_noise``
(one ``torch.Generator``) or is injected as the same structure, which is
how the tests feed the port the draws the JAX step makes from its keys.

In the critic loop the fake batch is made under ``torch.no_grad()`` (the
``stop_gradient`` of the JAX step), so the generator's stages run their
forward kernels without residuals there; in the generator update they run
as autograd Functions whose backward is the ported backward kernels.

Conditional models: the critic iterations score (and penalise) each real
batch under ``level_features`` of its augmented ids (``prepare_real``),
and G is conditioned on the features of the last real batch, un-augmented
(the features are D4-invariant), with the cond-match loss
(``train.w_cond_match``, ``gan.cond_match_loss``) on its expected
features.
"""

from __future__ import annotations

import torch

from levelgan_torch import obs
from levelgan_torch.config import Config
from levelgan_torch.data.codec import decode
from levelgan_torch.data.features import level_features
from levelgan_torch.lio.metrics import tile_histogram
from levelgan_torch.models import sample_head
from levelgan_torch.ops.grad_penalty import make_gradient_penalty
from levelgan_torch.ops.presence import (excess_weight_schedule,
                                         mbstd_scale_schedule,
                                         presence_penalty)
from levelgan_torch.train.gan import (apply_grads, check_cond_match,
                                     check_step_config, cond_match_loss,
                                     corpus_cond_scale,
                                     current_tau, head_noise, prepare_real)
from levelgan_torch.train.state import GANState, update_ema


def draw_step_noise(cfg: Config, n_critic: int, batch: int, device,
                    generator: torch.Generator | None = None) -> dict:
    """All random draws of one step: ``{"critic": [per-iteration dict of
    elements, z, noise, eps], "g": {z, noise}}``."""
    m = cfg.model

    def z():
        return torch.randn((batch, m.latent_dim), device=device,
                           generator=generator)

    its = [{"elements": torch.randint(0, 8, (batch,), device=device,
                                      generator=generator),
            "z": z(),
            "noise": head_noise(cfg, batch, device, generator),
            "eps": torch.rand((batch, 1, 1, 1), device=device,
                              generator=generator)}
           for _ in range(n_critic)]
    return {"critic": its,
            "g": {"z": z(), "noise": head_noise(cfg, batch, device,
                                                generator)}}


def make_critic_scan(cfg: Config, gp_impl):
    """The n_critic critic updates.  Returns ``run(state, batch_ids,
    noises) -> metrics of the last iteration`` (d_loss, gp, wdist); the
    critic and its optimizer are updated in place."""
    m, t = cfg.model, cfg.train

    def run(state: GANState, batch_ids: torch.Tensor, noises) -> dict:
        gen, critic = state.generator, state.critic
        tau = current_tau(cfg, state.step)
        ms = mbstd_scale_schedule(t, state.step)
        live = state.step >= t.freeze_critic_until
        params = list(critic.parameters())

        def d_apply(x, cond):
            return critic(x, cond, ms)

        # without an mbstd channel the scale is unused, and the GP gets the
        # module itself: the fused GP needs the critic's parameters
        gp_critic = d_apply if m.critic_mbstd else critic

        if len(noises) != len(batch_ids):
            raise ValueError(f"{len(batch_ids)} critic batches but "
                             f"{len(noises)} noise draws")
        out = {}
        for ids, nz in zip(batch_ids, noises):
            with obs.span("train.critic"):
                with obs.span("critic.fake"):
                    real, cond = prepare_real(cfg, ids, nz["elements"])
                    with torch.no_grad():
                        fake = sample_head(gen(nz["z"], cond), m.head, tau,
                                           m.structural_head,
                                           noise=nz["noise"])
                with obs.span("critic.loss"):
                    d_real = d_apply(real, cond)
                    d_fake = d_apply(fake, cond)
                    gp = gp_impl(gp_critic, real, fake, cond, nz["eps"])
                    wdist = d_real.mean() - d_fake.mean()
                    loss = -wdist + t.gp_lambda * gp
                if live:   # freeze_critic_until: params and Adam state held
                    with obs.span("critic.grad"):
                        grads = torch.autograd.grad(loss, params)
                    apply_grads(params, grads, state.opt_d)
            out = {"d_loss": loss.detach(), "gp": gp.detach(),
                   "wdist": wdist.detach()}
        return out

    return run


def make_wgan_gp_step(cfg: Config, cond_scale: torch.Tensor | None = None):
    """The WGAN-GP step: ``step_fn(state, batch_ids [n_critic, B, H, W],
    noise=None, generator=None) -> (state, metrics)``; ``noise`` is
    ``draw_step_noise``'s structure, else drawn from ``generator``.
    ``cond_scale`` is ``gan.corpus_cond_scale``'s (computed here when the
    cond-match loss needs it and none is given)."""
    m, t = cfg.model, cfg.train
    check_step_config(cfg)
    check_cond_match(cfg)
    if t.w_cond_match and cond_scale is None:
        cond_scale = corpus_cond_scale(cfg)
    critic_scan = make_critic_scan(cfg, make_gradient_penalty(m))

    def step_fn(state: GANState, batch_ids: torch.Tensor, noise=None,
                generator: torch.Generator | None = None):
        if batch_ids.ndim != 4:
            raise ValueError("wgan_gp expects batch ids [n_critic, B, H, W]")
        bsz = batch_ids.shape[1]
        if noise is None:
            noise = draw_step_noise(cfg, batch_ids.shape[0], bsz,
                                    batch_ids.device, generator)
        it = critic_scan(state, batch_ids, noise["critic"])

        # ---- generator update, against the updated critic --------------
        gen, critic = state.generator, state.critic
        ng = noise["g"]
        with obs.span("train.generator"):
            with obs.span("g.loss"):
                cond_g = level_features(batch_ids[-1]) if m.cond_dim else None
                logits = gen(ng["z"], cond_g)
                fake = sample_head(logits, m.head,
                                   current_tau(cfg, state.step),
                                   m.structural_head, noise=ng["noise"])
                g_loss = -critic(fake, cond_g,
                                 mbstd_scale_schedule(t, state.step)).mean()
                pres = cmatch = None
                if t.w_presence:
                    pres = presence_penalty(
                        fake, w_spread=t.presence_spread,
                        w_excess=excess_weight_schedule(t, state.step))
                    g_loss = g_loss + t.w_presence * pres
                if t.w_cond_match:
                    cmatch = cond_match_loss(logits, cond_g, cond_scale)
                    g_loss = g_loss + t.w_cond_match * cmatch
            params = list(gen.parameters())
            with obs.span("g.grad"):
                grads = torch.autograd.grad(g_loss, params)
            apply_grads(params, grads, state.opt_g)
        update_ema(cfg, state.g_ema, gen, state.step)
        state.step += 1
        metrics = {**it, "g_loss": g_loss.detach(),
                   "gen_hist": tile_histogram(decode(fake.detach()),
                                              m.n_tiles)}
        if pres is not None:
            metrics["presence"] = pres.detach()
        if cmatch is not None:
            metrics["cond_match"] = cmatch.detach()
        return state, metrics

    return step_fn
