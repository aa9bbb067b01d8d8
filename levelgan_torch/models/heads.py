"""Sampling heads: logits -> level tensor, per estimator.

Port of ``levelgan/models/heads.py``:
  'softmax' — soft relaxed level
  'gumbel'  — straight-through Gumbel-softmax (hard one-hot forward)
  'argmax'  — hard one-hot, no gradient (export / eval)

``structural='spatial'`` draws exactly one START and one GOAL cell from the
trunk's START/GOAL channels read as per-position logits, and composes them
with the non-structural tile sample (see the JAX module for the design).

Randomness: ``generator`` (a ``torch.Generator``) or injected Gumbel draws
``noise`` — a tensor shaped like ``logits`` for the plain heads, or the
triple ``(base [B,H,W,T], start [B,H*W], goal [B,H*W])`` for the spatial
head (the JAX head's three key splits, in order).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from levelgan_torch.config import GOAL, START
from levelgan_torch.ops.gumbel import gumbel_softmax

_NEG = -1e9  # additive logit mask; finite so masked softmax stays exact 0-mass


def sample_head(logits, head: str, tau=1.0, structural: str = "none", *,
                noise=None, generator: torch.Generator | None = None):
    if structural == "spatial":
        return _spatial_structural(logits, head, tau, noise, generator)
    return _plain_head(logits, head, tau, noise, generator)


def _one_hot(idx, n, like):
    return F.one_hot(idx, n).to(like.dtype)


def _plain_head(logits, head: str, tau, noise, generator):
    if head == "softmax":
        return torch.softmax(logits, dim=-1)
    if head == "gumbel":
        return gumbel_softmax(logits, tau, hard=True, noise=noise,
                              generator=generator)
    if head == "argmax":
        return _one_hot(torch.argmax(logits, dim=-1), logits.shape[-1], logits)
    raise ValueError(f"unknown head '{head}'")


def _spatial_select(lmap, head: str, tau, noise, generator):
    """One cell from per-position logits [B, H, W] -> map summing to 1."""
    b, h, w = lmap.shape
    flat = lmap.reshape(b, h * w)
    if head == "softmax":
        sel = torch.softmax(flat, dim=-1)
    elif head == "gumbel":
        sel = gumbel_softmax(flat, tau, hard=True, noise=noise,
                             generator=generator)
    elif head == "argmax":
        sel = _one_hot(torch.argmax(flat, dim=-1), h * w, lmap)
    else:
        raise ValueError(f"unknown head '{head}'")
    return sel.reshape(b, h, w)


def _spatial_structural(logits, head: str, tau, noise, generator):
    n_tiles = logits.shape[-1]
    if n_tiles <= max(START, GOAL):
        raise ValueError(f"structural_head='spatial' needs n_tiles > "
                         f"{max(START, GOAL)}, got {n_tiles}")
    n_base, n_s, n_g = noise if noise is not None else (None, None, None)

    chan = torch.arange(n_tiles, device=logits.device)
    struct_chan = (chan == START) | (chan == GOAL)
    base = _plain_head(torch.where(struct_chan, _NEG, logits), head, tau,
                       n_base, generator)

    s_map = _spatial_select(logits[..., START], head, tau, n_s, generator)
    g_logits = logits[..., GOAL]
    if head != "softmax":
        # the hard START cell is off-limits to GOAL
        g_logits = torch.where(s_map.detach() > 0.5, _NEG, g_logits)
    g_map = _spatial_select(g_logits, head, tau, n_g, generator)

    start_oh = F.one_hot(torch.tensor(START, device=logits.device),
                         n_tiles).to(logits.dtype)
    goal_oh = F.one_hot(torch.tensor(GOAL, device=logits.device),
                        n_tiles).to(logits.dtype)
    out = base * (1.0 - g_map[..., None]) + g_map[..., None] * goal_oh
    return out * (1.0 - s_map[..., None]) + s_map[..., None] * start_oh
