"""Structural-tile presence prior and its schedules, port of
``levelgan/ops/presence.py``.

``presence_penalty`` (``train.w_presence > 0``) is a hinge penalty on each
level's START and GOAL tiles, differentiable straight through the relaxed or
straight-through sample: count (``relu(target - sum_hw)^2``), concentration
(``relu(1 - max_hw)^2``), an optional straight-through excess hinge on
duplicate argmax winners, and a batch-level placement spread hinge.  The JAX
module's docstring gives the measured reason for each term; the arithmetic
here is the same, term by term.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from levelgan_torch.config import GOAL, START
from levelgan_torch.dist import mesh

STRUCTURAL_TILES = (START, GOAL)


def presence_penalty(fake: torch.Tensor, tiles=STRUCTURAL_TILES,
                     target: float = 1.0, w_spread: float = 1.0,
                     min_eff: float = 0.25, w_excess: float = 0.0,
                     excess_band: float = 0.0) -> torch.Tensor:
    """Mean hinge penalty on structural-tile presence.

    ``fake`` [B, H, W, n_tiles] is a relaxed or straight-through one-hot
    sample.  Returns the scalar
    ``mean_b,t [relu(target - sum_hw)^2 + relu(1 - max_hw)^2
    + w_excess * relu(winners - target - excess_band)^2]
    + w_spread * mean_t relu(min_eff - eff_t)^2``, where ``winners`` counts
    the cells whose argmax is the tile (forward) with the soft mass at the
    duplicate winning cells as the backward path, and ``eff_t`` is the
    inverse Simpson index of the batch's commitment-weighted placement
    marginal over min(B, HW) cells (hard argmax placement forward, soft
    normalised placement backward).
    """
    tile_idx = torch.as_tensor(tiles, device=fake.device)
    chans = fake[..., tile_idx].float()                       # [B,H,W,|t|]
    counts = chans.sum(dim=(1, 2))                            # [B, |t|]
    maxes = chans.amax(dim=(1, 2))
    per_level = (F.relu(target - counts).square()
                 + F.relu(1.0 - maxes).square())
    if w_excess:
        win_mask = (fake.argmax(dim=-1)[..., None] == tile_idx).float()
        extra_hard = F.relu(win_mask.sum(dim=(1, 2)) - target)
        wmass = chans * win_mask
        soft_extra = wmass.sum(dim=(1, 2)) - wmass.amax(dim=(1, 2))
        extra = extra_hard + soft_extra - soft_extra.detach()
        per_level = per_level + w_excess * F.relu(extra - excess_band).square()
    pen = per_level.mean()
    if w_spread:
        b = chans.shape[0]
        hw = chans.shape[1] * chans.shape[2]
        flat = chans.reshape(b, hw, -1)                       # [B, HW, |t|]
        wt = flat.amax(dim=1).detach()                        # [B, |t|]
        win = F.one_hot(flat.argmax(dim=1), hw).float().permute(0, 2, 1)
        # batch sums over the global batch (data parallelism)
        wsum = mesh.global_sum(wt.sum(dim=0)) + 1e-6
        m_hard = mesh.global_sum((win * wt[:, None, :]).sum(dim=0)) / wsum
        q = flat / (flat.sum(dim=1, keepdim=True) + 1e-6)
        m_soft = mesh.global_sum((q * wt[:, None, :]).sum(dim=0)) / wsum
        marginal = m_hard + m_soft - m_soft.detach()          # [HW, |t|]
        simpson = marginal.square().sum(dim=0)                # [|t|]
        eff = 1.0 / (min(b * mesh.world_size(), hw) * simpson + 1e-9)
        pen = pen + w_spread * F.relu(min_eff - eff).square().mean()
    return pen


def excess_weight_schedule(t, step: int) -> float:
    """Effective excess-hinge weight at ``step``: ``presence_excess``, or 0
    before ``presence_excess_start`` then a linear rise to it over
    ``presence_excess_ramp`` steps when a start or ramp is configured."""
    w = t.presence_excess
    if not w or not (t.presence_excess_start or t.presence_excess_ramp):
        return w
    frac = (step - t.presence_excess_start) / max(t.presence_excess_ramp, 1)
    return float(w) * min(max(frac, 0.0), 1.0)


def mbstd_scale_schedule(t, step: int) -> float | None:
    """Critic mbstd-channel multiplier at ``step``: None when the anneal is
    off, else a linear fade 1 -> ``mbstd_anneal_floor`` over
    [mbstd_anneal_start, mbstd_anneal_start + mbstd_anneal_steps)."""
    if not t.mbstd_anneal_steps:
        return None
    frac = (step - t.mbstd_anneal_start) / t.mbstd_anneal_steps
    frac = min(max(frac, 0.0), 1.0)
    return 1.0 - (1.0 - float(t.mbstd_anneal_floor)) * frac
