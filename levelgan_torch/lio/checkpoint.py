"""Checkpoints in the FORMAT.md layout (port of ``levelgan/lio/checkpoint.py``).

One directory per checkpoint, ``step_XXXXXXXX/`` with ``arrays.npz`` (flat
keys) and ``manifest.json`` (format version, step, sorted key list, the
full config), written atomically: a ``.tmp_*`` sibling is written and
fsynced, then renamed into place.  The port writes the fields it has so
far — the generator and the step — and reads the generator (EMA first)
from checkpoints that either package wrote.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from levelgan_torch.bridge import (generator_params_from_flat,
                                   generator_params_to_flat)
from levelgan_torch.config import Config

FORMAT_VERSION = 1
_STEP_DIR = re.compile(r"^step_(\d{8})$")


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(ckpt_dir: str, generator: torch.nn.Module, cfg: Config,
                    step: int = 0) -> str:
    """Atomically write ``ckpt_dir/step_XXXXXXXX``; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    final = os.path.join(ckpt_dir, name)
    tmp = os.path.join(ckpt_dir, f".tmp_{name}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = generator_params_to_flat(generator.state_dict())
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
    return final


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
