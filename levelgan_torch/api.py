"""Public API: ``train(cfg)``, the training entry point.

Port of ``levelgan/api.py:train`` for tile-family WGAN-GP models
(``gumbel_64``, ``wgan_gp_32``).  The corpus is built on the host once and
staged on the device; each step's batch indices [n_critic, B] are drawn on
the device from a ``torch.Generator`` seeded by (``train.seed``, step), and
the same generator then draws the step's noise (``draw_step_noise``), so a
step's randomness depends on nothing but the seed and the step.  Metrics
go to ``metrics.jsonl`` every ``io.log_every`` steps (with the window's
tile-histogram ``kl`` against the corpus and ``step_ms``), checkpoints
every ``io.ckpt_every`` steps and at the end, with the whole state (the
optimizers in optax's layout), so that the JAX package can load them.
Every ``io.quality_every`` steps a quality probe samples ``io.quality_n``
levels from the EMA generator and logs ``solvable_frac``,
``has_start_frac`` and ``has_goal_frac`` (the flood fill on the device;
three floats cross to the host); with ``io.keep_best`` the state of the
best ``solvable_frac`` so far is kept in ``ckpt_best/``.

The port runs eagerly on one device, so ``train.steps_per_dispatch`` (how
many jitted steps the JAX package scans per dispatch) has no meaning here
and is ignored, as are ``io.compile_cache`` (XLA's cache) and
``data.feed`` (the corpus is always on the device).

Not in this slice, each raising ``NotImplementedError`` rather than being
skipped: ``io.resume`` (reading the state back), ``io.render_every``
(PNG renders), ``io.profile`` and ``io.tensorboard``, the BCE GAN and
curriculum losses, conditional models and the track family.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from levelgan_torch.config import Config
from levelgan_torch.data.codec import decode
from levelgan_torch.data.dataset import LevelDataset
from levelgan_torch.device import resolve_device
from levelgan_torch.lio.checkpoint import save_checkpoint
from levelgan_torch.lio.metrics import MetricsLogger, kl_divergence
from levelgan_torch.lio.quality import playability
from levelgan_torch.models import sample_head
from levelgan_torch.train.state import create_state
from levelgan_torch.train.wgan_gp import make_wgan_gp_step

_DATA_TAG = 0x0DA7A          # separates the step streams from other seeds
_PROBE_TAG = 0x9B0BE         # the quality probe's stream


def _not_ported(cfg: Config) -> None:
    io, t, m = cfg.io, cfg.train, cfg.model
    later = [
        (io.resume, "io.resume needs the optimizer states read back from "
                    "the full-state checkpoint"),
        (io.render_every, "io.render_every (PNG renders during training) "
                          "comes with the full-state checkpoint and resume"),
        (io.profile, "io.profile (a profiler trace of the run) comes with "
                     "the full-state checkpoint and resume"),
        (io.tensorboard, "io.tensorboard comes with the full-state "
                         "checkpoint and resume"),
        (m.family != "tile", "the track family (track/)"),
        (t.loss == "gan", "the BCE GAN step (train/gan.py, toy_dcgan_16) is "
                          "the next training item"),
        (t.loss == "curriculum", "the curriculum step (train/curriculum.py "
                                 "with env/)"),
    ]
    for on, why in later:
        if on:
            raise NotImplementedError(f"not ported yet: {why}")
    if t.loss != "wgan_gp":
        raise ValueError(f"unknown loss '{t.loss}'")


def _seeded(device, *words) -> torch.Generator:
    seed = np.random.SeedSequence(list(words))
    return torch.Generator(device).manual_seed(
        int(seed.generate_state(1, np.uint64)[0]))


def step_generator(cfg: Config, step: int, device) -> torch.Generator:
    """The generator of train step ``step``: seeded by (train.seed, step)."""
    return _seeded(device, cfg.train.seed, _DATA_TAG, step)


def make_quality_probe(cfg: Config, n: int):
    """The training-time playability probe (``io.quality_every``):
    ``probe(gen, generator, cond=None)`` samples ``n`` fresh levels from
    ``gen`` as the export does and reduces them on the device to the
    solvable, has-START and has-GOAL shares (0-d tensors)."""
    m = cfg.model
    head = "gumbel" if m.head == "gumbel" else "argmax"

    @torch.no_grad()
    def probe(gen, generator: torch.Generator, cond=None) -> dict:
        dev = next(gen.parameters()).device
        z = torch.randn((n, m.latent_dim), generator=generator, device=dev)
        logits = gen(z, cond)
        ids = decode(sample_head(logits, head, tau=m.tau_end,
                                 structural=m.structural_head,
                                 generator=generator))
        shares = playability(ids)
        return {k: shares[k] for k in ("solvable_frac", "has_start_frac",
                                       "has_goal_frac")}

    return probe


def sample_batch(corpus: torch.Tensor, cfg: Config,
                 generator: torch.Generator) -> torch.Tensor:
    """Device-side batch ids [n_critic, B, H, W] from the staged corpus."""
    t = cfg.train
    idx = torch.randint(0, corpus.shape[0], (t.n_critic, t.batch_size),
                        device=corpus.device, generator=generator)
    return corpus[idx]


def save_state(ckpt_dir: str, state, cfg: Config, step: int,
               keep: int) -> str:
    """The full-state checkpoint of ``state`` at ``step``."""
    return save_checkpoint(ckpt_dir, state.generator, cfg, step,
                           critic=state.critic, g_ema=state.g_ema,
                           opt_g=state.opt_g, opt_d=state.opt_d, keep=keep)


def train(cfg: Config, *, device=None, echo: bool = True) -> dict:
    """Run training per ``cfg``; returns ``{checkpoint, kl, metrics}``
    (and ``best``, the ``ckpt_best/`` checkpoint, under ``io.keep_best``)."""
    _not_ported(cfg)
    dev = resolve_device(device)
    step_fn = make_wgan_gp_step(cfg)
    ds = LevelDataset.from_config(cfg.data, cfg.model, seed=cfg.train.seed)
    ref_hist = ds.tile_histogram(cfg.model.n_tiles)
    corpus = torch.from_numpy(ds.levels).to(dev)
    state = create_state(cfg, dev)
    ckpt_dir = os.path.join(cfg.io.out_dir, "ckpt")
    io, steps = cfg.io, cfg.train.steps

    def crossed(every: int, prev: int, cur: int) -> bool:
        return bool(every) and cur // every > prev // every

    logger = MetricsLogger(io.out_dir, echo=echo)
    if echo:
        n_g = sum(p.numel() for p in state.generator.parameters())
        n_d = sum(p.numel() for p in state.critic.parameters())
        print(f"[levelgan_torch] preset={cfg.preset} loss=wgan_gp "
              f"device={dev} G params={n_g:,} D params={n_d:,}")
    quality_probe = (make_quality_probe(cfg, io.quality_n)
                     if io.quality_every else None)
    # conditional probes ask for 0.25 in every feature, as the JAX package's
    probe_cond = (torch.full((io.quality_n, cfg.model.cond_dim), 0.25,
                             device=dev)
                  if io.quality_every and cfg.model.cond_dim else None)
    best_solvable, best = -1.0, None
    gen_hist = torch.zeros(cfg.model.n_tiles, device=dev)
    kl, last_metrics = float("nan"), {}
    t_last, last_i = time.monotonic(), 0
    try:
        for i in range(steps):
            rng = step_generator(cfg, i, dev)
            state, metrics = step_fn(state, sample_batch(corpus, cfg, rng),
                                     generator=rng)
            gen_hist += metrics.pop("gen_hist")
            if crossed(io.log_every, i, i + 1) or i + 1 == steps:
                kl = kl_divergence(gen_hist, ref_hist)     # syncs the device
                gen_hist.zero_()
                now = time.monotonic()
                last_metrics = logger.log(
                    i + 1, **metrics, kl=kl,
                    step_ms=1e3 * (now - t_last) / (i + 1 - last_i))
                t_last, last_i = now, i + 1
            if crossed(io.quality_every, i, i + 1):
                q = {k: float(v) for k, v in quality_probe(
                    state.g_ema, _seeded(dev, cfg.train.seed, _PROBE_TAG,
                                         i + 1), probe_cond).items()}
                logger.log(i + 1, **q)
                if io.keep_best and q["solvable_frac"] > best_solvable:
                    best_solvable = q["solvable_frac"]
                    best = save_state(os.path.join(io.out_dir, "ckpt_best"),
                                      state, cfg, i + 1, 1)
                    if echo:
                        print(f"[levelgan_torch] new best solvable_frac="
                              f"{best_solvable:.3f} -> {best}")
            if crossed(io.ckpt_every, i, i + 1) and i + 1 < steps:
                save_state(ckpt_dir, state, cfg, i + 1, io.keep_ckpts)
    finally:
        logger.close()
    final = save_state(ckpt_dir, state, cfg, state.step, io.keep_ckpts)
    out = {"checkpoint": final, "kl": kl, "metrics": last_metrics}
    if best is not None:
        out["best"] = best
    return out
