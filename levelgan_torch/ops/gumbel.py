"""Gumbel-softmax straight-through sampler + temperature schedule.

Port of ``levelgan/ops/gumbel.py``.  Randomness comes from an explicit
``torch.Generator``, or the caller injects the Gumbel draws themselves
(``noise=``), which is how the tests feed both packages the same numbers.
"""

from __future__ import annotations

import math

import torch


def gumbel_noise(shape, *, dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(U)) with U in [tiny, 1)."""
    u = torch.rand(shape, dtype=dtype, device=device, generator=generator)
    u = u.clamp_min(torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def gumbel_softmax(logits: torch.Tensor, tau, hard: bool = True, *,
                   dim: int = -1, noise: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Sample from a relaxed categorical over ``dim``.

    hard=True -> straight-through: forward value one-hot, gradient that of
    the tau-softened softmax.  hard=False -> the soft relaxed sample.
    """
    if noise is None:
        noise = gumbel_noise(logits.shape, dtype=logits.dtype,
                             device=logits.device, generator=generator)
    y_soft = torch.softmax((logits + noise.to(logits.dtype)) / tau, dim=dim)
    if not hard:
        return y_soft
    idx = torch.argmax(y_soft, dim=dim, keepdim=True)
    y_hard = torch.zeros_like(y_soft).scatter_(dim, idx, 1.0)
    return y_soft + (y_hard - y_soft).detach()


def tau_schedule(step, tau_start: float, tau_end: float,
                 anneal_steps: int) -> float:
    """Exponential tau anneal from tau_start to tau_end over anneal_steps."""
    if anneal_steps <= 0:
        return float(tau_end)
    frac = min(max(step / anneal_steps, 0.0), 1.0)
    return math.exp((1.0 - frac) * math.log(tau_start)
                    + frac * math.log(tau_end))
