"""Parameter bridge: JAX-layout generator arrays -> the port's parameters.

Input is either the flat ``arrays.npz`` mapping of a FORMAT.md checkpoint
(keys ``generator/...`` and, when the run tracked an EMA, ``g_ema/...``;
the EMA weights win, as the JAX package exports with them) or an
already-unprefixed flat mapping of the Flax param tree (``seed/kernel``,
``up0/film/bias``, ...).  The result maps the port's ``state_dict`` names
(``seed.kernel``, ``up0.film.bias``, ...) to f32 tensors.  No layout change
is needed: the port keeps the JAX package's HWIO and [in, out] layouts.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_PREFIXES = ("g_ema/", "generator/")


def _generator_subtree(flat: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Select the generator subtree (EMA first) and drop its prefix."""
    for prefix in _PREFIXES:
        sub = {k[len(prefix):]: v for k, v in flat.items()
               if k.startswith(prefix)}
        if sub:
            return sub
    return dict(flat)


def generator_params_from_flat(flat: Mapping[str, np.ndarray]
                               ) -> dict[str, torch.Tensor]:
    """Flat JAX-layout arrays -> ``{state_dict name: f32 tensor}``."""
    return {k.replace("/", "."): torch.from_numpy(np.array(v, np.float32))
            for k, v in _generator_subtree(flat).items()}


def generator_params_to_flat(state_dict: Mapping[str, torch.Tensor],
                             prefix: str = "generator") -> dict[str, np.ndarray]:
    """The inverse: port ``state_dict`` -> ``{prefix/flax/path: array}``."""
    return {f"{prefix}/{k.replace('.', '/')}":
            v.detach().float().cpu().numpy() for k, v in state_dict.items()}
