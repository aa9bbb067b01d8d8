"""Public API: ``train(cfg)``, the training entry point.

Port of ``levelgan/api.py:train`` for all nine presets.  Tile family
(``toy_dcgan_16``, ``wgan_gp_32``, ``wgan_gp_32_structural``,
``gumbel_64``, ``conditional_32``, ``curriculum_16``,
``curriculum_16_joint``): ``train.loss='gan'`` runs the BCE step
(``train/gan.py``) on batches [B, H, W], ``'wgan_gp'`` the WGAN-GP step
and ``'curriculum'`` the agent-in-the-loop step (``train/curriculum.py``)
on [n_critic, B, H, W].  Track family (``racetrack_32``,
``race_curriculum_32``): ``'wgan_gp'`` and ``'curriculum'`` run the track
steps (``track/train.py``) on f32 tracks [n_critic, B, T, 2]; ``'gan'``
raises, as in the JAX package, and the window's ``kl`` is the curvature
histogram's (``TrackDataset.N_BINS`` bins).  The corpus is built on the
host once and staged on the device; each step's batch indices are drawn
on the device from a ``torch.Generator`` seeded by (``train.seed``,
step), and the same generator then draws the step's noise, so a step's
randomness depends on nothing but the seed and the step, and a resumed
run consumes exactly the batches and draws an uninterrupted one would.  Metrics go to
``metrics.jsonl`` (appended to) every ``io.log_every`` steps (with the
window's tile-histogram ``kl`` against the corpus and ``step_ms``),
checkpoints every ``io.ckpt_every`` steps and at the end, with the whole
state (the optimizers in optax's layout), so that the JAX package can load
them.  Every ``io.quality_every`` steps (tile family; the track's probe is
disabled with the JAX package's message) a quality probe samples
``io.quality_n`` levels from the EMA generator and logs ``solvable_frac``,
``has_start_frac`` and ``has_goal_frac`` (the flood fill on the device;
three floats cross to the host); with ``io.keep_best`` the state of the
best ``solvable_frac`` so far is kept in ``ckpt_best/`` (the best starts
again from -1 after a resume, as in the JAX package).

Each step runs under ``step_mode``: every backward on the calling thread,
so that a run's bits do not depend on whether it is its process's first.

``io.resume``: ``'auto'`` restores the newest readable checkpoint of
``<out_dir>/ckpt`` (walking back past unreadable ones, raising when
checkpoints exist but none loads), a path restores that checkpoint.  The
loop starts at the restored step; cadences are boundary crossings, so a
resumed run logs and checkpoints at the steps an uninterrupted one does.
SIGTERM or SIGINT (handlers on the main thread only) requests a stop: the
step in flight finishes, an atomic checkpoint is written, the old handlers
come back and ``train`` returns with ``preempted``; a second signal is
re-raised.  ``io.debug_nans`` runs each step under
``torch.autograd.set_detect_anomaly`` (a backward that returns NaN raises)
and stops with ``FloatingPointError`` naming the first non-finite metric
of a step.

Data parallelism (``dist/mesh.py``): ``dist.dp`` ranks (0: every visible
card), over ``dist.num_processes`` hosts that meet at
``dist.coordinator_address``.  With more than one rank ``train`` builds
the kernels once, then starts one process a card (``mesh.launch``) and
returns rank 0's summary; a process that a launcher started joins its
group instead.  Each rank draws the global batch's indices and noise from
the step's generator, as one process does, and steps on its slice; the
steps all-reduce every update's gradients and make their batch statistics
global (the critic's minibatch stddev of ``model.critic_mbstd`` included,
through the gradient penalty's double backward), so a data-parallel step
computes the single-process step on the same global batch.  Only rank 0
writes checkpoints (after checking that every rank holds the same bits),
``metrics.jsonl`` and ``ckpt_best/``; metrics and the tile histogram are
reduced over the ranks at log points only.  A stop signal reaches every
rank (the launcher forwards it), and the ranks agree on the host, once a
step, to stop after the same step.

The port runs eagerly, so ``train.steps_per_dispatch`` (how many jitted
steps the JAX package scans per dispatch) has no meaning here and is
ignored, as are ``io.compile_cache`` (XLA's cache) and ``data.feed`` (the
corpus is always on the device).

On rank 0 only: ``io.render_every`` writes 16 levels (or tracks) of the
EMA generator, sampled at ``seed=step`` (condition 0.25 in every feature
of a conditional model), as ``levels_<step>.png`` (``tracks_<step>.png``)
in ``io.out_dir`` (a ``.npz`` beside the name where PIL is absent).
``io.profile`` records the port's own window (from the second step of
the run to its thirteenth) with ``torch.profiler``, CPU and CUDA
activities, into ``<io.profile_dir or out_dir/profile>/trace.json`` (a
Chrome trace) with the program's spans (``obs``: ``train.inputs`` and
``train.step`` a step, and the layers inside the step); a run that ends,
fails or is stopped inside the window writes the trace on its way out.
``io.tensorboard`` gives every logged scalar and the probe's to a
``SummaryWriter`` at ``out_dir/tb`` (JSONL only, with a notice, where
``tensorboard`` is not installed).
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import signal
import threading
import time

import numpy as np
import torch

from levelgan_torch import obs
from levelgan_torch.config import Config
from levelgan_torch.data.dataset import LevelDataset
from levelgan_torch.device import resolve_device
from levelgan_torch.dist import mesh
from levelgan_torch.lio.checkpoint import (all_checkpoints, load_checkpoint,
                                           save_checkpoint)
from levelgan_torch.lio.metrics import MetricsLogger, kl_divergence
from levelgan_torch.lio.quality import playability
from levelgan_torch.models import sample_ids
from levelgan_torch.track.data import TrackDataset
from levelgan_torch.track.train import (draw_track_noise,
                                        make_track_curriculum_step,
                                        make_track_wgan_step)
from levelgan_torch.train.curriculum import (draw_curriculum_noise,
                                             make_curriculum_step)
from levelgan_torch.train.gan import (corpus_cond_scale, draw_gan_step_noise,
                                      make_gan_step)
from levelgan_torch.train.state import create_state
from levelgan_torch.train.wgan_gp import draw_step_noise, make_wgan_gp_step

_DATA_TAG = 0x0DA7A          # separates the step streams from other seeds
_PROBE_TAG = 0x9B0BE         # the quality probe's stream
# io.profile's window: the trace starts once this many steps of the run
# are done and stops at the second
PROFILE_WINDOW = (1, 13)
RENDER_N = 16                # levels (or tracks) a render
_STEPS = {"gan": make_gan_step, "wgan_gp": make_wgan_gp_step,
          "curriculum": make_curriculum_step}
_TRACK_STEPS = {"wgan_gp": make_track_wgan_step,
                "curriculum": make_track_curriculum_step}


def _check_loss(cfg: Config) -> None:
    """The refusals of a family and loss with no step."""
    t, m = cfg.train, cfg.model
    if m.family == "track" and t.loss not in _TRACK_STEPS:
        raise ValueError(f"track family supports wgan_gp/curriculum, "
                         f"not '{t.loss}'")
    if t.loss not in _STEPS:
        raise ValueError(f"unknown loss '{t.loss}'")


def make_step_fn(cfg: Config, cond_scale=None):
    """The train step of ``cfg``'s family and loss, inside a ``train.step``
    span whose id is the number of the step it makes."""
    steps = _TRACK_STEPS if cfg.model.family == "track" else _STEPS
    inner = steps[cfg.train.loss](cfg, cond_scale=cond_scale)

    @functools.wraps(inner)
    def step_fn(state, *args, **kwargs):
        with obs.span("train.step", id=state.step + 1):
            return inner(state, *args, **kwargs)

    return step_fn


def make_dataset(cfg: Config):
    """The corpus of ``cfg``'s family (tile levels or tracks), carved on the
    host."""
    kind = TrackDataset if cfg.model.family == "track" else LevelDataset
    return kind.from_config(cfg.data, cfg.model, seed=cfg.train.seed)


@contextlib.contextmanager
def step_mode(debug_nans: bool = False):
    """The autograd settings a train step runs under: anomaly mode for
    ``io.debug_nans``, and every backward on the calling thread.  On the
    card autograd runs a backward on a worker thread of its own, and the
    nodes that the gradient penalty's double backward records there are
    ordered against the forward's by two per-thread counters; a process's
    first run then summed some parameter gradients in another order than
    its later runs did (measured on an H100, PERF.md §6).  On one
    thread the order is the forward's, in every run."""
    with torch.autograd.set_detect_anomaly(debug_nans), \
            torch.autograd.set_multithreading_enabled(False):
        yield


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
        ids = sample_ids(logits, head, tau=m.tau_end,
                         structural=m.structural_head, generator=generator)
        shares = playability(ids)
        return {k: shares[k] for k in ("solvable_frac", "has_start_frac",
                                       "has_goal_frac")}

    return probe


def sample_batch(corpus: torch.Tensor, cfg: Config,
                 generator: torch.Generator) -> torch.Tensor:
    """Device-side batch from the staged corpus: [n_critic, B, H, W] ids
    (or [n_critic, B, T, 2] tracks) for WGAN-GP and the curriculum,
    [B, H, W] for the BCE GAN."""
    t = cfg.train
    shape = ((t.batch_size,) if t.loss == "gan"
             else (t.n_critic, t.batch_size))
    idx = torch.randint(0, corpus.shape[0], shape, device=corpus.device,
                        generator=generator)
    return corpus[idx]


def draw_noise(cfg: Config, batch: torch.Tensor,
               generator: torch.Generator) -> dict:
    """All random draws of one step over ``batch`` (``sample_batch``'s), in
    the order the step would draw them itself."""
    t = cfg.train
    if cfg.model.family == "track":
        return draw_track_noise(cfg, t.n_critic, t.batch_size, batch.device,
                                generator)
    if t.loss == "gan":
        return draw_gan_step_noise(cfg, t.batch_size, batch.device,
                                   generator)
    draw = (draw_curriculum_noise if t.loss == "curriculum"
            else draw_step_noise)
    return draw(cfg, t.n_critic, t.batch_size, batch.device, generator)


def step_inputs(cfg: Config, corpus: torch.Tensor, step: int, device):
    """(batch, noise) of train step ``step`` on this rank: the global
    batch's indices and draws from ``step_generator``, then this rank's
    slice of each (``mesh.shard_tree``; the whole of them in one
    process)."""
    with obs.span("train.inputs", id=step + 1):
        rng = step_generator(cfg, step, device)
        batch = sample_batch(corpus, cfg, rng)
        noise = draw_noise(cfg, batch, rng)
        axis = 0 if cfg.train.loss == "gan" else 1
        return mesh.shard(batch, axis), mesh.shard_tree(noise)


def _state_tensors(state) -> dict:
    """Every tensor of ``state`` by name: the models' parameters and
    buffers, the optimizers' moments, the baseline."""
    out = {}
    for name, obj in vars(state).items():
        if isinstance(obj, torch.nn.Module):
            out.update({f"{name}.{k}": v
                        for k, v in obj.state_dict().items()})
        elif isinstance(obj, torch.optim.Optimizer):
            for i, p in enumerate(obj.state.values()):
                out.update({f"{name}.{i}.{k}": v for k, v in p.items()
                            if isinstance(v, torch.Tensor)})
        elif isinstance(obj, torch.Tensor):
            out[name] = obj
    return out


def save_state(ckpt_dir: str, state, cfg: Config, step: int,
               keep: int) -> str:
    """The full-state checkpoint of ``state`` at ``step`` (written by rank
    0, once every rank is shown to hold the same bits)."""
    diverged = mesh.same_on_every_rank(_state_tensors(state))
    if diverged:
        raise RuntimeError(f"data-parallel ranks hold different states at "
                           f"step {step}: {diverged[:8]}")
    extra = {}
    if hasattr(state, "agent_strong"):
        extra = {"g_baseline": state.g_baseline, "agents": {
            "agent_strong": (state.agent_strong, state.opt_as),
            "agent_weak": (state.agent_weak, state.opt_aw)}}
    return save_checkpoint(ckpt_dir, state.generator, cfg, step,
                           critic=state.critic, g_ema=state.g_ema,
                           opt_g=state.opt_g, opt_d=state.opt_d, keep=keep,
                           **extra)


def resume(cfg: Config, state, ckpt_dir: str, echo: bool = True):
    """``state`` restored per ``io.resume`` (unchanged when it is '')."""
    want = cfg.io.resume
    impl = cfg.train.prng_impl
    if want == "auto":
        candidates = all_checkpoints(ckpt_dir)
        for path in reversed(candidates):
            try:
                state = load_checkpoint(path, state, prng_impl=impl)[0]
            except Exception as e:   # corrupt or partial: try the older one
                print(f"[levelgan_torch] skipping unreadable checkpoint "
                      f"{path}: {e}")
                continue
            if echo:
                print(f"[levelgan_torch] resumed from {path}")
            return state
        if candidates:
            # an automated preemption loop must not restart from step 0
            raise RuntimeError(
                f"resume='auto': {len(candidates)} checkpoint(s) in "
                f"{ckpt_dir} but none loadable; refusing to silently "
                "restart from scratch (pass resume='' to force a fresh run)")
    elif want:
        if not os.path.isdir(want):
            raise FileNotFoundError(f"resume checkpoint not found: {want}")
        state = load_checkpoint(want, state, prng_impl=impl)[0]
        if echo:
            print(f"[levelgan_torch] resumed from {want}")
    return state


class _StopRequest:
    """SIGTERM / SIGINT request a stop (``self.requested``); a second signal
    restores the old handlers and re-raises.  Installed only on the main
    thread; ``restore`` puts the old handlers back.

    A rank that ``mesh.launch`` started (``launcher`` its pid) takes every
    signal as the one request (its launcher forwards a terminal's SIGINT
    that the rank got too, and kills the ranks at a second signal), and
    stops when its launcher is gone."""

    def __init__(self, launcher: int | None = None):
        self._requested = False
        self._launcher = launcher
        self._old = {}
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._old[sig] = signal.signal(sig, self._handle)

    @property
    def requested(self) -> bool:
        return self._requested or (self._launcher is not None
                                   and os.getppid() != self._launcher)

    def _handle(self, signum, frame):
        if self._requested and self._launcher is None:
            self.restore()
            signal.raise_signal(signum)
            return
        self._requested = True

    def restore(self):
        while self._old:
            sig, handler = self._old.popitem()
            signal.signal(sig, handler)


def _check_finite(step: int, metrics: dict) -> None:
    """``io.debug_nans``: stop at the first non-finite metric of a step."""
    for name, v in metrics.items():
        if name != "gen_hist" and not math.isfinite(float(v)):
            raise FloatingPointError(
                f"io.debug_nans: metric '{name}' is {float(v)} at step "
                f"{step}")


def train(cfg: Config, *, device=None, echo: bool = True) -> dict:
    """Run training per ``cfg``; returns ``{checkpoint, preempted, kl,
    metrics, rank}`` (and ``best``, the ``ckpt_best/`` checkpoint, under
    ``io.keep_best``).  With more than one rank (``dist``), rank 0's on
    the host that holds it, else this host's first rank's."""
    _check_loss(cfg)
    dev = resolve_device(device)
    if mesh.launched():
        if not mesh.active():
            mesh.join_from_env(dev.type)
        _check_mesh(cfg, mesh.world_size())
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return _train(cfg, dev, echo)
    plan = mesh.make_plan(cfg.dist, dev.type)
    _check_mesh(cfg, plan.world)
    if plan.world == 1 and plan.init_method is None:
        return _train(cfg, dev, echo)
    if plan.device_type == "cuda":      # once here, not in every rank
        from levelgan_torch.kernels import build
        build.build_all()
    return mesh.launch(train, (cfg,), {"device": dev.type, "echo": echo},
                       plan)[0]


def _check_mesh(cfg: Config, world: int) -> None:
    """The refusals of a mesh of ``world`` ranks."""
    d, b = cfg.dist.dp, cfg.train.batch_size
    if d and d != world:
        raise ValueError(f"dist.dp={d} but the mesh has {world} ranks")
    if b % world:
        raise ValueError(f"batch_size {b} not divisible by mesh size "
                         f"{world}")


def render_samples(cfg: Config, gen, step: int, dev) -> str:
    """``io.render_every``: ``RENDER_N`` samples of ``gen`` at
    ``seed=step`` drawn as one image in ``io.out_dir``; returns its
    path."""
    from levelgan_torch.cli.export import write_png
    from levelgan_torch.export import generate
    from levelgan_torch.track.render import write_track_png

    m = cfg.model
    cond = np.full(m.cond_dim, 0.25, np.float32) if m.cond_dim else None
    samples = generate(cfg, gen, RENDER_N, batch_size=RENDER_N, seed=step,
                       cond=cond, device=dev)
    kind = "tracks" if m.family == "track" else "levels"
    path = os.path.join(cfg.io.out_dir, f"{kind}_{step:08d}.png")
    (write_track_png if m.family == "track" else write_png)(path, samples,
                                                           cols=4)
    return path


def _tensorboard(cfg: Config, echo: bool):
    """``io.tensorboard``'s writer at ``out_dir/tb`` on rank 0, else
    None."""
    if not cfg.io.tensorboard or mesh.rank() != 0:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        if echo:
            print("[levelgan_torch] tensorboard requested but not "
                  "installed; JSONL metrics only")
        return None
    return SummaryWriter(os.path.join(cfg.io.out_dir, "tb"))


def _add_scalars(tb, step: int, record: dict) -> None:
    """A logged record's numbers (not its step) as TensorBoard scalars."""
    if tb is not None:
        for name, v in record.items():
            if isinstance(v, (int, float)) and name != "step":
                tb.add_scalar(name, v, step)


class _ProfileWindow:
    """``io.profile`` on rank 0: a ``torch.profiler`` trace from step
    ``start + PROFILE_WINDOW[0]`` done to step ``start +
    PROFILE_WINDOW[1]`` done, exported as a Chrome trace."""

    def __init__(self, cfg: Config, start: int, dev: torch.device):
        self.on = cfg.io.profile and mesh.rank() == 0
        self.first, self.last = (start + k for k in PROFILE_WINDOW)
        self.path = os.path.join(
            cfg.io.profile_dir or os.path.join(cfg.io.out_dir, "profile"),
            "trace.json")
        self._cuda = dev.type == "cuda"
        self._prof = None

    def before_step(self, done: int) -> None:
        if self.on and self._prof is None and done >= self.first:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self._cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()

    def after_step(self, done: int) -> None:
        if self._prof is not None and done >= self.last:
            self.close()

    def close(self) -> None:
        """Stop and write the trace (once; a no-op outside the window)."""
        if self._prof is None:
            return
        if self._cuda:
            torch.cuda.synchronize()
        prof, self._prof, self.on = self._prof, None, False
        prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        prof.export_chrome_trace(self.path)


def _train(cfg: Config, dev: torch.device, echo: bool) -> dict:
    """The training loop of this process (one rank of a mesh, or alone)."""
    rank = mesh.rank()
    echo = echo and rank == 0
    ds = make_dataset(cfg)
    track = cfg.model.family == "track"
    cond_scale = (corpus_cond_scale(cfg, ds.levels)
                  if cfg.train.w_cond_match and not track else None)
    step_fn = make_step_fn(cfg, cond_scale)
    # the window's kl: curvature bins for tracks, tile counts for levels
    ref_hist = (ds.tile_histogram() if track
                else ds.tile_histogram(cfg.model.n_tiles))
    corpus = torch.from_numpy(ds.tracks if track else ds.levels).to(dev)
    ckpt_dir = os.path.join(cfg.io.out_dir, "ckpt")
    state = resume(cfg, create_state(cfg, dev), ckpt_dir, echo)
    io, steps = cfg.io, cfg.train.steps
    quality_every = io.quality_every
    if quality_every and track:
        if echo:
            print("[levelgan_torch] io.quality_every is tile-family only "
                  "(track quality = curvature gate); probe disabled")
        quality_every = 0

    def crossed(every: int, prev: int, cur: int) -> bool:
        return bool(every) and cur // every > prev // every

    logger = MetricsLogger(io.out_dir, echo=echo)
    if echo:
        n_g = sum(p.numel() for p in state.generator.parameters())
        n_d = sum(p.numel() for p in state.critic.parameters())
        print(f"[levelgan_torch] preset={cfg.preset} loss={cfg.train.loss} "
              f"device={dev} dp={mesh.world_size()} G params={n_g:,} "
              f"D params={n_d:,} start step={state.step}", flush=True)
    quality_probe = (make_quality_probe(cfg, io.quality_n)
                     if quality_every else None)
    # conditional probes ask for 0.25 in every feature, as the JAX package's
    probe_cond = (torch.full((io.quality_n, cfg.model.cond_dim), 0.25,
                             device=dev)
                  if quality_every and cfg.model.cond_dim else None)
    best_solvable, best = -1.0, None
    gen_hist = torch.zeros(len(ref_hist), device=dev)
    kl, last_metrics = float("nan"), {}
    start = state.step
    t_last, last_i = time.monotonic(), start
    launcher = mesh.launcher_pid()
    stop = _StopRequest() if launcher is None else _StopRequest(launcher)
    stopped = False
    tb = _tensorboard(cfg, echo)
    profile = _ProfileWindow(cfg, start, dev)
    render = io.render_every if rank == 0 else 0
    try:
        for i in range(start, steps):
            if mesh.any_rank(stop.requested):
                stopped = True
                break
            profile.before_step(i)
            batch, noise = step_inputs(cfg, corpus, i, dev)
            with step_mode(io.debug_nans):
                state, metrics = step_fn(state, batch, noise=noise)
            if io.debug_nans:
                _check_finite(i + 1, metrics)
            gen_hist += metrics.pop("gen_hist")
            if crossed(io.log_every, i, i + 1) or i + 1 == steps:
                metrics, hist = mesh.reduce_for_log(metrics, gen_hist)
                kl = kl_divergence(hist, ref_hist)     # syncs the device
                gen_hist.zero_()
                now = time.monotonic()
                last_metrics = logger.log(
                    i + 1, **metrics, kl=kl,
                    step_ms=1e3 * (now - t_last) / (i + 1 - last_i))
                t_last, last_i = now, i + 1
                _add_scalars(tb, i + 1, last_metrics)
            if crossed(quality_every, i, i + 1):
                # every rank probes its (identical) EMA; rank 0 logs
                q = {k: float(v) for k, v in quality_probe(
                    state.g_ema, _seeded(dev, cfg.train.seed, _PROBE_TAG,
                                         i + 1), probe_cond).items()}
                logger.log(i + 1, **q)
                _add_scalars(tb, i + 1, q)
                if (io.keep_best and mesh.any_rank(
                        q["solvable_frac"] > best_solvable)):
                    best_solvable = q["solvable_frac"]
                    best = save_state(os.path.join(io.out_dir, "ckpt_best"),
                                      state, cfg, i + 1, 1)
                    if echo:
                        print(f"[levelgan_torch] new best solvable_frac="
                              f"{best_solvable:.3f} -> {best}")
            if crossed(render, i, i + 1):
                render_samples(cfg, state.g_ema, i + 1, dev)
            if crossed(io.ckpt_every, i, i + 1) and i + 1 < steps:
                save_state(ckpt_dir, state, cfg, i + 1, io.keep_ckpts)
            profile.after_step(i + 1)
    finally:
        # on every way out: the trace, the scalars, the handlers
        profile.close()
        stop.restore()
        if tb is not None:
            tb.close()
        logger.close()
    preempted = stopped and state.step < steps
    final = save_state(ckpt_dir, state, cfg, state.step, io.keep_ckpts)
    if preempted and echo:
        print(f"[levelgan_torch] preempted at step {state.step}; checkpoint "
              f"saved to {final}; resume with io.resume=auto")
    # a stop mid-window: the counts since the last log are the newest
    if float(gen_hist.sum()) > 0:
        kl = kl_divergence(mesh.reduce_for_log({}, gen_hist)[1], ref_hist)
    out = {"checkpoint": final, "preempted": preempted, "kl": kl,
           "metrics": last_metrics, "rank": rank}
    if best is not None:
        out["best"] = best
    return out
