"""The BCE GAN train step and the pieces both steps share.

Port of ``levelgan/train/gan.py``: ``prepare_real`` (augment, the
condition, the one-hot encode), ``current_tau``, ``corpus_cond_scale`` (the
cond-match loss's static per-dim scale) and ``make_gan_step``, the
non-saturating BCE step of ``toy_dcgan_16``.

One step updates D on reals (target 0.9, the DCGAN label smoothing) and on
a fake drawn from the pre-update G without gradient (the ``stop_gradient``
of the JAX step), with optional R1 on the reals; then G against the
updated D (target 1.0), with the presence prior and the cond-match loss
where the config asks for them, then the G EMA.  Its randomness, in the
order ``draw_gan_step_noise`` draws it from one ``torch.Generator``: the
D4 elements, z1, the head's Gumbel draws for D's fake, z2, the Gumbel
draws for G's fake; tests inject the JAX step's draws instead.  R1 is plain
autograd (``create_graph=True``), as the JAX package takes it with
``jax.grad`` outside any kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from levelgan_torch import obs
from levelgan_torch.config import Config
from levelgan_torch.data.augment import augment
from levelgan_torch.data.codec import decode, encode
from levelgan_torch.data.features import (batched_features, level_features,
                                          soft_level_features)
from levelgan_torch.dist import mesh
from levelgan_torch.lio.metrics import tile_histogram
from levelgan_torch.models import sample_head
from levelgan_torch.ops.gumbel import gumbel_noise, tau_schedule
from levelgan_torch.ops.presence import presence_penalty
from levelgan_torch.train.state import GANState, update_ema

LABEL_SMOOTH = 0.9           # D's target on reals


def prepare_real(cfg: Config, batch_ids: torch.Tensor,
                 elements: torch.Tensor):
    """(augment) -> features -> one-hot f32 encode, on the batch's device:
    (real, cond).  ``elements`` [B] are the step's D4 elements; ``cond``
    is ``level_features`` of the augmented ids (None unconditional)."""
    ids = augment(batch_ids, elements) if cfg.data.augment else batch_ids
    cond = level_features(ids) if cfg.model.cond_dim else None
    return encode(ids, cfg.model.n_tiles, dtype=torch.float32), cond


def current_tau(cfg: Config, step: int) -> float:
    m = cfg.model
    return tau_schedule(step, m.tau_start, m.tau_end, m.tau_anneal_steps)


def corpus_cond_scale(cfg: Config, levels: np.ndarray | None = None
                      ) -> torch.Tensor:
    """The cond-match loss's per-dim scale, f32 [cond_dim] on the host: the
    corpus-wide feature std (floored at 1e-3) over sqrt of
    ``train.cond_match_dim_weights``, from ``levels`` (the trainer's
    corpus), else from the corpus the config carves."""
    if levels is None:
        from levelgan_torch.data.dataset import LevelDataset
        levels = LevelDataset.from_config(cfg.data, cfg.model,
                                          seed=cfg.train.seed).levels
    feats = batched_features(level_features, np.asarray(levels),
                             device="cpu")
    scale = np.maximum(feats.std(axis=0), 1e-3)
    if cfg.train.cond_match_dim_weights:
        # per-dim residual weights folded into the scale:
        # residual / (scale / sqrt(w)) == w * residual^2 / scale^2
        w = np.array([float(x) for x in
                      cfg.train.cond_match_dim_weights.split(",")], np.float64)
        if w.size != scale.size:
            raise ValueError(
                f"train.cond_match_dim_weights needs {scale.size} values, "
                f"got {w.size}")
        scale = scale / np.sqrt(np.maximum(w, 1e-9))
    return torch.from_numpy(np.asarray(scale, np.float32))


def cond_match_loss(logits: torch.Tensor, cond: torch.Tensor,
                    cond_scale: torch.Tensor) -> torch.Tensor:
    """Mean squared standardised residual between the features expected
    under softmax(logits) (the per-cell tile marginal of both heads) and
    the condition the sample was drawn under."""
    probs = torch.softmax(logits.float(), dim=-1)
    scale = cond_scale.to(cond.device)
    return ((soft_level_features(probs) - cond) / scale).square().mean()


def check_step_config(cfg: Config) -> None:
    """The refusals every tile step shares."""
    m, t = cfg.model, cfg.train
    if m.family != "tile":
        raise NotImplementedError(
            "the tile steps do not train the track family: its steps are "
            "track/train.py's (api.train picks them by model.family)")
    if t.w_closure:
        raise ValueError("train.w_closure is track-family only "
                         "(heading-closure prior); tile levels have no "
                         "loop-closure invariant")


def check_cond_match(cfg: Config) -> None:
    """The refusal of the steps with a cond-match term (the curriculum step
    has none and ignores ``train.w_cond_match``, as in the JAX package)."""
    if cfg.train.w_cond_match and not cfg.model.cond_dim:
        raise ValueError("train.w_cond_match requires a conditional model "
                         "(model.cond_dim > 0): it matches the fake "
                         "sample's features to the requested condition")


def head_noise(cfg: Config, batch: int, device,
               generator: torch.Generator | None):
    """The Gumbel draws ``sample_head`` takes for this config (None for the
    noiseless heads; the (base, start, goal) triple for the spatial
    structural head)."""
    m = cfg.model
    if m.head != "gumbel":
        return None
    shape = (batch, m.level_size, m.level_size, m.n_tiles)
    base = gumbel_noise(shape, device=device, generator=generator)
    if m.structural_head != "spatial":
        return base
    cells = (batch, m.level_size * m.level_size)
    return (base, gumbel_noise(cells, device=device, generator=generator),
            gumbel_noise(cells, device=device, generator=generator))


def draw_gan_step_noise(cfg: Config, batch: int, device,
                        generator: torch.Generator | None = None) -> dict:
    """All random draws of one BCE GAN step: ``{elements, z1, noise1, z2,
    noise2}`` (D's fake from z1, G's from z2)."""
    m = cfg.model
    out = {"elements": torch.randint(0, 8, (batch,), device=device,
                                     generator=generator)}
    for i in (1, 2):
        out[f"z{i}"] = torch.randn((batch, m.latent_dim), device=device,
                                   generator=generator)
        out[f"noise{i}"] = head_noise(cfg, batch, device, generator)
    return out


def _bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy`` against a constant target,
    averaged, in f32."""
    x = logits.float()
    return F.binary_cross_entropy_with_logits(x, torch.full_like(x, target))


def apply_grads(params, grads, opt) -> None:
    """``opt``'s step on ``grads``, averaged over the data-parallel ranks
    first (one collective)."""
    for p, g in zip(params, mesh.all_reduce_grads(grads)):
        p.grad = g
    with obs.span("optim.adam"):
        opt.step()


def make_gan_step(cfg: Config, cond_scale: torch.Tensor | None = None):
    """The BCE GAN step: ``step_fn(state, batch_ids [B, H, W], noise=None,
    generator=None) -> (state, metrics)``; ``noise`` is
    ``draw_gan_step_noise``'s structure, else drawn from ``generator``.
    ``cond_scale`` is ``corpus_cond_scale``'s (computed here when the
    cond-match loss needs it and none is given)."""
    m, t = cfg.model, cfg.train
    check_step_config(cfg)
    check_cond_match(cfg)
    if t.w_cond_match and cond_scale is None:
        cond_scale = corpus_cond_scale(cfg)

    def step_fn(state: GANState, batch_ids: torch.Tensor, noise=None,
                generator: torch.Generator | None = None):
        if batch_ids.ndim != 3:
            raise ValueError("gan expects batch ids [B, H, W]")
        if noise is None:
            noise = draw_gan_step_noise(cfg, batch_ids.shape[0],
                                        batch_ids.device, generator)
        gen, critic = state.generator, state.critic
        tau = current_tau(cfg, state.step)
        real, cond = prepare_real(cfg, batch_ids, noise["elements"])

        # ---- D update, on a fake of the pre-update G ---------------------
        with torch.no_grad():
            fake = sample_head(gen(noise["z1"], cond), m.head, tau,
                               m.structural_head, noise=noise["noise1"])
        if t.r1_gamma > 0:
            real.requires_grad_(True)
        d_real = critic(real, cond)
        d_fake = critic(fake, cond)
        d_loss = _bce(d_real, LABEL_SMOOTH) + _bce(d_fake, 0.0)
        if t.r1_gamma > 0:
            # R1 on the reals: the input gradient of the summed scores
            (g,) = torch.autograd.grad(d_real.float().sum(), real,
                                       create_graph=True)
            r1 = g.float().square().sum(dim=tuple(range(1, g.ndim))).mean()
            d_loss = d_loss + 0.5 * t.r1_gamma * r1
        d_params = list(critic.parameters())
        apply_grads(d_params, torch.autograd.grad(d_loss, d_params),
                     state.opt_d)

        # ---- G update, against the updated D ------------------------------
        logits = gen(noise["z2"], cond)
        fake2 = sample_head(logits, m.head, tau, m.structural_head,
                            noise=noise["noise2"])
        g_loss = _bce(critic(fake2, cond), 1.0)
        pres = cmatch = None
        if t.w_presence:
            pres = presence_penalty(fake2, w_spread=t.presence_spread,
                                    w_excess=t.presence_excess)
            g_loss = g_loss + t.w_presence * pres
        if t.w_cond_match:
            cmatch = cond_match_loss(logits, cond, cond_scale)
            g_loss = g_loss + t.w_cond_match * cmatch
        g_params = list(gen.parameters())
        apply_grads(g_params, torch.autograd.grad(g_loss, g_params),
                     state.opt_g)
        update_ema(cfg, state.g_ema, gen, state.step)
        state.step += 1
        metrics = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                   "d_real": d_real.detach().mean(),
                   "d_fake": d_fake.detach().mean(),
                   "gen_hist": tile_histogram(decode(fake2.detach()),
                                              m.n_tiles)}
        if pres is not None:
            metrics["presence"] = pres.detach()
        if cmatch is not None:
            metrics["cond_match"] = cmatch.detach()
        return state, metrics

    return step_fn
