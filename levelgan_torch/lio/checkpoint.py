"""Checkpoints in the FORMAT.md layout (port of ``levelgan/lio/checkpoint.py``).

One directory per checkpoint, ``step_XXXXXXXX/`` with ``arrays.npz`` (flat
keys) and ``manifest.json`` (format version, step, sorted key list, the
full config), written atomically: a ``.tmp_*`` sibling is written and
fsynced, then renamed into place.  The port writes the generator and the
step, and when given them the critic (``discriminator/...``), the G EMA
(``g_ema/...``) and the two optimizers: then the whole state that the JAX
package's ``flat_to_state`` reads, so that ``levelgan.lio.checkpoint.
load_checkpoint`` restores a port training checkpoint.  It reads the
generator (EMA first) from checkpoints that either package wrote.

The optimizers go in optax's ``adam`` layout: ``opt_g/0/{count,mu,nu}``
(``scale_by_adam``; torch's ``exp_avg`` / ``exp_avg_sq`` follow the same
recurrences as optax's ``mu`` / ``nu``), then, under a learning-rate
schedule, ``opt_g/1/count`` (``scale_by_schedule``); both counts are
``ScheduledAdam.count``.  ``rng`` is uint32 key data of the shape
``train.prng_impl`` implies (threefry2x32: 2 words, rbg: 4), drawn from the
run's seed and step: the JAX key stream cannot be reproduced in torch
anyway.  ``g_baseline`` is the curriculum's REINFORCE baseline (0 for the
other losses); a curriculum state also writes its agents
(``agent_strong/...``, ``agent_weak/...``) and their Adams (``opt_as/0/...``,
``opt_aw/0/...``: ``optax.adam`` with a constant lr, so no schedule count).

``load_checkpoint`` reads the whole state back into a ``GANState`` or a
``CurriculumState`` (the counterpart of the JAX package's
``load_checkpoint`` / ``flat_to_state``): from checkpoints that either
package wrote, since both share the layout.
A key the run's models lack, or a leaf of another shape (a checkpoint of
another model shape), is refused before anything is copied.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from levelgan_torch.bridge import (agent_params_to_flat,
                                   critic_params_to_flat,
                                   generator_params_from_flat,
                                   generator_params_to_flat)
from levelgan_torch.config import Config
from levelgan_torch.dist import mesh

FORMAT_VERSION = 1
# the curriculum's agents and the prefixes of their Adams
AGENT_OPTS = {"agent_strong": "opt_as", "agent_weak": "opt_aw"}
_STEP_DIR = re.compile(r"^step_(\d{8})$")
_KEY_WORDS = {"threefry2x32": 2, "rbg": 4}   # uint32 words of a key
_RNG_TAG = 0x5EED                            # separates the key's stream


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _adam_to_flat(opt: torch.optim.Optimizer, model: torch.nn.Module,
                 prefix: str, scheduled: bool) -> dict[str, np.ndarray]:
    """``opt``'s state over ``model``'s parameters in optax's ``adam``
    layout under ``prefix`` (see the module note); parameters without a
    step yet have zero moments."""
    count = np.asarray(opt.count, np.int32)
    flat = {f"{prefix}/0/count": count}
    for slot, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        moments = {}
        for key, p in model.named_parameters():
            m = opt.state.get(p, {}).get(name)
            moments[key] = torch.zeros_like(p) if m is None else m
        flat.update(generator_params_to_flat(moments, f"{prefix}/0/{slot}"))
    if scheduled:
        flat[f"{prefix}/1/count"] = count
    return flat


def _rng_key_data(cfg: Config, step: int) -> np.ndarray:
    """uint32 key data of the shape ``train.prng_impl`` implies, from the
    run's seed and step."""
    seed = np.random.SeedSequence([cfg.train.seed, _RNG_TAG, step])
    return seed.generate_state(_KEY_WORDS[cfg.train.prng_impl], np.uint32)


def save_checkpoint(ckpt_dir: str, generator: torch.nn.Module, cfg: Config,
                    step: int = 0, *, critic: torch.nn.Module | None = None,
                    g_ema: torch.nn.Module | None = None,
                    opt_g: torch.optim.Optimizer | None = None,
                    opt_d: torch.optim.Optimizer | None = None,
                    g_baseline: torch.Tensor | None = None,
                    agents: dict | None = None, keep: int = 0) -> str:
    """Atomically write ``ckpt_dir/step_XXXXXXXX``; returns the path.

    With ``critic``, ``opt_g`` and ``opt_d`` (``ScheduledAdam``s over the
    generator's and the critic's parameters) the checkpoint holds the full
    state; a curriculum state adds ``g_baseline`` and ``agents``
    ({``agent_strong`` / ``agent_weak``: (policy, its Adam)}).  ``keep >
    0`` deletes all but the newest ``keep`` step directories.

    Under data parallelism every rank calls it: rank 0 writes, and no rank
    returns before the checkpoint is in place.
    """
    if (opt_g is None) != (opt_d is None) or (opt_g is not None
                                              and critic is None):
        raise ValueError("a full-state checkpoint takes the critic and both "
                         "optimizers")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        if mesh.rank() == 0:
            _write(ckpt_dir, final, generator, cfg, step, critic, g_ema,
                   opt_g, opt_d, g_baseline, agents, keep)
    finally:
        mesh.barrier()
    return final


def _write(ckpt_dir, final, generator, cfg, step, critic, g_ema, opt_g,
           opt_d, g_baseline, agents, keep) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    name = os.path.basename(final)
    tmp = os.path.join(ckpt_dir, f".tmp_{name}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = generator_params_to_flat(generator.state_dict())
    if critic is not None:
        flat.update(critic_params_to_flat(critic.state_dict()))
    if g_ema is not None:
        flat.update(generator_params_to_flat(g_ema.state_dict(), "g_ema"))
    if opt_g is not None:
        scheduled = cfg.train.lr_schedule != "none"
        flat.update(_adam_to_flat(opt_g, generator, "opt_g", scheduled))
        flat.update(_adam_to_flat(opt_d, critic, "opt_d", scheduled))
        flat["rng"] = _rng_key_data(cfg, step)
        flat["g_baseline"] = (np.zeros((), np.float32) if g_baseline is None
                              else g_baseline.detach().float().cpu().numpy())
    for name, (policy, opt) in (agents or {}).items():
        flat.update(agent_params_to_flat(policy.state_dict(), name))
        flat.update(_adam_to_flat(opt, policy, AGENT_OPTS[name], False))
    flat["step"] = np.asarray(step, np.int32)
    arrays_path = os.path.join(tmp, "arrays.npz")
    np.savez(arrays_path, **flat)
    _fsync_file(arrays_path)
    manifest = {"format_version": FORMAT_VERSION, "step": step,
                "keys": sorted(flat), "config": cfg.to_dict()}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if keep > 0:
        for old in all_checkpoints(ckpt_dir)[:-keep]:
            shutil.rmtree(old, ignore_errors=True)


def all_checkpoints(ckpt_dir: str) -> list[str]:
    if not os.path.isdir(ckpt_dir):
        return []
    return [os.path.join(ckpt_dir, d) for d in sorted(os.listdir(ckpt_dir))
            if _STEP_DIR.match(d)
            and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))
            and os.path.exists(os.path.join(ckpt_dir, d, "arrays.npz"))]


def latest_checkpoint(ckpt_dir: str) -> str | None:
    ckpts = all_checkpoints(ckpt_dir)
    return ckpts[-1] if ckpts else None


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _module_leaves(module: torch.nn.Module, flat: dict, prefix: str):
    """(parameter, array) pairs of ``module`` from ``flat`` under ``prefix``,
    checked for presence and shape."""
    pairs = []
    for name, p in module.state_dict(keep_vars=True).items():
        key = f"{prefix}/{name.replace('.', '/')}"
        pairs.append((p, _leaf(flat, key, tuple(p.shape))))
    return pairs


def _leaf(flat: dict, key: str, shape: tuple) -> np.ndarray:
    if key not in flat:
        raise KeyError(f"checkpoint missing key '{key}'")
    arr = flat[key]
    if arr.shape != shape:
        raise ValueError(f"checkpoint key '{key}' shape {arr.shape} != "
                         f"expected {shape}")
    return arr


def load_checkpoint(path: str, state, *,
                    prng_impl: str = "threefry2x32") -> tuple[object, Config]:
    """Restore ``state`` (a ``GANState`` or ``CurriculumState``) in place
    from a full-state checkpoint directory; returns (state, the
    checkpoint's Config).

    Reads the three models (``g_ema`` falls back to the generator in
    checkpoints without an EMA), both optimizers with their counts and
    moments (``ScheduledAdam.restore``) and ``step``; a curriculum state
    also its agents, their Adams and ``g_baseline``; ``rng`` must have
    the shape ``prng_impl`` (the run's ``train.prng_impl``) implies.
    Every leaf is checked before any is copied, so a refused checkpoint
    leaves ``state`` as it was."""
    manifest = load_manifest(path)
    if manifest["format_version"] > FORMAT_VERSION:
        raise ValueError(f"checkpoint format {manifest['format_version']} "
                         f"newer than supported {FORMAT_VERSION}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    words = (_KEY_WORDS[prng_impl],)
    if flat["rng"].shape != words:
        raise ValueError(
            f"checkpoint rng key-data shape {flat['rng'].shape} != {words} "
            f"expected by train.prng_impl={prng_impl}; the checkpoint was "
            "written under a different prng_impl")
    ema = "g_ema" if any(k.startswith("g_ema/") for k in flat) else "generator"
    leaves = (_module_leaves(state.generator, flat, "generator")
              + _module_leaves(state.critic, flat, "discriminator")
              + _module_leaves(state.g_ema, flat, ema))
    opts = [(state.opt_g, state.generator, "opt_g"),
            (state.opt_d, state.critic, "opt_d")]
    curriculum = hasattr(state, "agent_strong")
    if curriculum:
        for name, prefix in AGENT_OPTS.items():
            policy = getattr(state, name)
            leaves += _module_leaves(policy, flat, name)
            opts.append((getattr(state, prefix), policy, prefix))
        baseline = _leaf(flat, "g_baseline", ())
    adams = []
    for opt, model, prefix in opts:
        count = int(_leaf(flat, f"{prefix}/0/count", ()))
        moments = {}
        for name, p in model.named_parameters():
            key = name.replace(".", "/")
            moments[p] = tuple(torch.from_numpy(np.array(_leaf(
                flat, f"{prefix}/0/{slot}/{key}", tuple(p.shape))))
                for slot in ("mu", "nu"))
        adams.append((opt, count, moments))
    with torch.no_grad():
        for p, arr in leaves:
            p.copy_(torch.from_numpy(np.array(arr, np.float32)))
    for opt, count, moments in adams:
        opt.restore(count, moments)
    if curriculum:
        state.g_baseline = torch.tensor(np.array(baseline, np.float32),
                                        device=state.g_baseline.device)
    state.step = int(flat["step"])
    return state, Config.from_dict(manifest["config"])


def load_generator_params(path: str) -> tuple[dict[str, torch.Tensor], Config]:
    """(generator params by ``state_dict`` name, Config) of a checkpoint."""
    manifest = load_manifest(path)
    if manifest["format_version"] > FORMAT_VERSION:
        raise ValueError(f"checkpoint format {manifest['format_version']} "
                         f"newer than supported {FORMAT_VERSION}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files
                if k.startswith(("generator/", "g_ema/"))}
    if not flat:
        raise KeyError(f"checkpoint {path!r} holds no generator arrays")
    return generator_params_from_flat(flat), Config.from_dict(manifest["config"])
