"""WGAN-GP gradient penalty: the plain oracle and the implementation picker.

Port of ``levelgan/ops/grad_penalty.py``.  ``gradient_penalty`` is
``E[(||grad_x_hat D(x_hat)||_2 - 1)^2]`` with the inner gradient taken
with ``create_graph=True``, so the penalty is differentiable w.r.t. the
critic's parameters (the double backward).  It is the plain form of
``kernels.gp_penalty.gradient_penalty_core`` and the reference it is held
to.  A critic here is a callable ``critic(x, cond) -> [B]`` scores.

The picker (``make_gradient_penalty``) follows ``model.pallas_gp``:

- ``'auto'`` and ``'core'``: the K2 core kernels
  (``kernels.gp_penalty``) around the plain inner gradient;
- ``'xla'``: the plain GP;
- ``'fused'``: the fused critic-gradient kernel with the K2 core around it
  (``kernels.critic_grad.gradient_penalty_fused``) where
  ``fused_supported`` holds, ``ValueError`` where it does not, as in the
  JAX package (and for the track family's critic, whose JAX step takes
  the core GP whatever ``pallas_gp`` says).  This GP takes the ``Critic``
  module, not any callable.

In the JAX package ``'auto'`` resolves to the XLA GP from a TPU v5e
measurement (``levelgan/kernels/critic_grad.py:434-449``).  That
measurement does not carry over to the card, and the port runs its kernels
on the card as it does for K1, so ``'auto'`` takes the core kernels here;
``chip_smoke.py`` prints both GP times so that the choice can be revisited
with the card's numbers.  On CPU tensors the kernels' wrappers run their
plain versions, so every choice computes the same function.
"""

from __future__ import annotations

import torch


def interpolate(real: torch.Tensor, fake: torch.Tensor,
                eps: torch.Tensor | None = None, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """x_hat = eps*real + (1-eps)*fake with per-sample eps ~ U[0, 1).

    ``eps`` [B, 1, ..., 1] is injected, or drawn from ``generator``.
    """
    if eps is None:
        eps = torch.rand((real.shape[0],) + (1,) * (real.ndim - 1),
                         dtype=real.dtype, device=real.device,
                         generator=generator)
    return eps * real + (1.0 - eps) * fake


def gradient_penalty(critic, real: torch.Tensor, fake: torch.Tensor,
                     cond=None, eps: torch.Tensor | None = None, *,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
    """The plain GP.  With ``model.critic_mbstd`` set the scores couple
    through the batch, so the input gradient of their sum gains
    cross-sample terms.  Under data parallelism they span the global
    batch: the critic's statistic is ``mesh.global_var``, whose
    ``global_sum`` all-reduces run again in this gradient's backward
    (summing every rank's cotangents) and in the double backward."""
    x_hat = interpolate(real, fake, eps, generator=generator)
    x_hat.requires_grad_(True)
    score = critic(x_hat, cond).float().sum()
    (g,) = torch.autograd.grad(score, x_hat, create_graph=True)
    sq = g.float().square().sum(dim=tuple(range(1, g.ndim)))
    return (torch.sqrt(sq + 1e-12) - 1.0).square().mean()


def make_gradient_penalty(mcfg):
    """The GP implementation for ``mcfg.pallas_gp`` (see the module
    docstring); signature-compatible with ``gradient_penalty``."""
    choice = mcfg.pallas_gp
    if choice == "xla":
        return gradient_penalty
    if choice in ("auto", "core"):
        from levelgan_torch.kernels.gp_penalty import gradient_penalty_core
        return gradient_penalty_core
    if choice == "fused":
        from levelgan_torch.kernels.critic_grad import (
            fused_supported, gradient_penalty_fused)
        if mcfg.family == "track":
            raise ValueError(
                "model.pallas_gp='fused' mirrors the tile critic only: "
                "fused_supported is False for family='track' (its 1-D conv "
                "critic); use 'core' or 'auto'")
        if not fused_supported(mcfg):
            raise ValueError(
                "model.pallas_gp='fused' but the fused critic-gradient "
                "kernel does not support this critic shape; use 'core' or "
                "'auto'")
        return gradient_penalty_fused
    raise ValueError(f"unknown model.pallas_gp {choice!r}")
