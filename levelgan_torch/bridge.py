"""Parameter bridge: JAX-layout arrays <-> the port's parameters.

Input is either the flat ``arrays.npz`` mapping of a FORMAT.md checkpoint
(keys ``generator/...`` and, when the run tracked an EMA, ``g_ema/...``;
the EMA weights win, as the JAX package exports with them) or an
already-unprefixed flat mapping of the Flax param tree (``seed/kernel``,
``up0/film/bias``, ...).  The result maps the port's ``state_dict`` names
(``seed.kernel``, ``up0.film.bias``, ...) to f32 tensors.  No layout change
is needed: the port keeps the JAX package's HWIO and [in, out] layouts.
The critic's arrays live under ``discriminator/...`` (``down0/kernel``,
``scale1``, ``head/kernel``, ...) and the curriculum's agents under
``agent_strong/...`` and ``agent_weak/...`` (``Conv_0/kernel``,
``Dense_2/bias``, ...); they map the same way.
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


def _params_from_flat(flat: Mapping[str, np.ndarray], prefix: str
                      ) -> dict[str, torch.Tensor]:
    """``prefix/...`` arrays (or an unprefixed flat tree) -> ``{state_dict
    name: f32 tensor}``."""
    sub = {k[len(prefix) + 1:]: v for k, v in flat.items()
           if k.startswith(prefix + "/")} or dict(flat)
    return {k.replace("/", "."): torch.from_numpy(np.array(v, np.float32))
            for k, v in sub.items()}


def critic_params_from_flat(flat: Mapping[str, np.ndarray]
                            ) -> dict[str, torch.Tensor]:
    """``discriminator/...`` arrays (or an unprefixed flat critic tree) ->
    ``{Critic state_dict name: f32 tensor}``."""
    return _params_from_flat(flat, "discriminator")


def critic_params_to_flat(state_dict: Mapping[str, torch.Tensor],
                          prefix: str = "discriminator"
                          ) -> dict[str, np.ndarray]:
    """The inverse: Critic ``state_dict`` -> ``{prefix/flax/path: array}``."""
    return generator_params_to_flat(state_dict, prefix)


def agent_params_from_flat(flat: Mapping[str, np.ndarray],
                           prefix: str = "agent_strong"
                           ) -> dict[str, torch.Tensor]:
    """``prefix/...`` agent arrays (or an unprefixed flat Flax agent tree)
    -> ``{AgentPolicy state_dict name: f32 tensor}``."""
    return _params_from_flat(flat, prefix)


def agent_params_to_flat(state_dict: Mapping[str, torch.Tensor],
                         prefix: str = "agent_strong"
                         ) -> dict[str, np.ndarray]:
    """The inverse: AgentPolicy ``state_dict`` -> ``{prefix/flax/path:
    array}``."""
    return generator_params_to_flat(state_dict, prefix)
