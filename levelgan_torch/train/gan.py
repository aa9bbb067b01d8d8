"""Shared pieces of the GAN steps, port of part of ``levelgan/train/gan.py``.

Only ``prepare_real`` and ``current_tau`` are ported; the BCE GAN step
(``make_gan_step``, ``toy_dcgan_16``) is a later slice.
"""

from __future__ import annotations

import torch

from levelgan_torch.config import Config
from levelgan_torch.data.augment import augment
from levelgan_torch.data.codec import encode
from levelgan_torch.ops.gumbel import tau_schedule


def prepare_real(cfg: Config, batch_ids: torch.Tensor,
                 elements: torch.Tensor):
    """(augment) -> one-hot f32 encode, on the batch's device: (real, cond).

    ``elements`` [B] are the step's D4 elements (``draw_step_noise`` draws
    them).  Conditional models need ``data/features.py``, which is not
    ported yet.
    """
    if cfg.model.cond_dim:
        raise NotImplementedError(
            "conditional training needs data/features.py (level_features), "
            "not ported yet")
    ids = augment(batch_ids, elements) if cfg.data.augment else batch_ids
    return encode(ids, cfg.model.n_tiles, dtype=torch.float32), None


def current_tau(cfg: Config, step: int) -> float:
    m = cfg.model
    return tau_schedule(step, m.tau_start, m.tau_end, m.tau_anneal_steps)
