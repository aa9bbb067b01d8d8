"""Critic / discriminator, port of ``levelgan/models/critic.py``.

x [B, H, W, n_tiles] (one-hot or soft) (+ cond [B, cond_dim]) -> [B] score.
A conv mirror of the generator: 4x4 stride-2 SAME convs down to 4x4,
GroupNorm (skipped on layer 0) and LeakyReLU, then a Dense head on the
NHWC-flattened features.  Conditioning: 'concat' broadcasts the condition
embedding as extra input channels; 'projection' adds
<W_p emb(c), sum_hw phi(x)> at the head.  ``critic_mbstd``: '' (off),
'trunk' (one across-batch stddev scalar as an extra trunk channel) or
'input' (a per-position across-batch stddev map as an extra input
channel), scaled by ``mbstd_scale`` when given.  Under data parallelism
the across-batch statistic is the global batch's (``mesh.global_var``),
as the JAX package's sharded ``var(axis=0)`` is; every rank's critic
takes it at the same point of every call.

Parameters keep the Flax names and f32 layouts (``down{i}.kernel`` HWIO,
``scale{i}``/``bias{i}``, ``head.kernel`` [in, 1], ``cond_embed``,
``cond_proj``), so ``state_dict`` keys are the Flax paths with ``/``
written as ``.``.  Activations run in ``cfg.dtype``; the head in at least f32.
Everything is plain PyTorch (cuDNN convolutions on the card) and twice
differentiable, as the gradient penalty needs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from levelgan_torch.config import ModelConfig
from levelgan_torch.device import torch_dtype
from levelgan_torch.dist import mesh
from levelgan_torch.models.generator import Dense
from levelgan_torch.ops.blocks import group_norm, leaky_relu, up


def critic_channels(cfg: ModelConfig) -> list[int]:
    n = int(math.log2(cfg.level_size // 4))
    if 4 * 2 ** n != cfg.level_size:
        raise ValueError(f"level_size must be 4*2^k, got {cfg.level_size}")
    return [min(cfg.critic_base_channels * 2 ** i, cfg.max_channels)
            for i in range(n)]


class Conv4x4s2(nn.Module):
    """Flax ``nn.Conv(ch, (4, 4), strides=2, padding='SAME')`` on NHWC:
    SAME at stride 2 on an even size pads one on each side.  The bias is
    added to the output rounded to ``dtype``, as Flax adds it."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(4, 4, c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x, dtype):
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype),
                     self.kernel.permute(3, 2, 0, 1).to(dtype),
                     stride=2, padding=1)
        return y.permute(0, 2, 3, 1) + self.bias.to(dtype)


class Critic(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        chans = critic_channels(cfg)
        c_in = cfg.n_tiles + (1 if cfg.critic_mbstd == "input" else 0)
        if cfg.cond_dim:
            self.cond_embed = Dense(cfg.cond_dim, cfg.cond_embed_dim)
            if cfg.cond_mode == "concat":
                c_in += cfg.cond_embed_dim
        self.n_layers = len(chans)
        for i, ch in enumerate(chans):
            self.add_module(f"down{i}", Conv4x4s2(c_in, ch))
            if i > 0 and cfg.norm != "none":
                self.register_parameter(f"scale{i}",
                                        nn.Parameter(torch.ones(ch)))
                self.register_parameter(f"bias{i}",
                                        nn.Parameter(torch.zeros(ch)))
            c_in = ch
        feat = 4 * 4 * (chans[-1] + (1 if cfg.critic_mbstd == "trunk" else 0))
        self.head = Dense(feat, 1)
        if cfg.cond_dim and cfg.cond_mode == "projection":
            self.cond_proj = Dense(cfg.cond_embed_dim, chans[-1])

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Critic":
        """The Flax initializers: normal(0.02) kernels, zero biases, unit
        GroupNorm scales."""
        for name, p in self.named_parameters():
            if name.endswith("kernel"):
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device) * 0.02)
        return self

    def forward(self, x, cond=None, mbstd_scale=None):
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        x = x.to(dtype)
        if cfg.critic_mbstd == "input":
            # per-position across-batch stddev, mean over tile channels
            mbmap = torch.sqrt(mesh.global_var(x.float())
                               + 1e-8).mean(-1)                 # [H, W]
            if mbstd_scale is not None:
                mbmap = mbmap * mbstd_scale
            x = torch.cat([x, mbmap[None, :, :, None].to(dtype).expand(
                *x.shape[:3], 1)], dim=-1)

        emb = None
        if cfg.cond_dim:
            if cond is None:
                raise ValueError("conditional critic called without cond")
            emb = leaky_relu(self.cond_embed(cond, dtype), cfg.leaky_slope)
            if cfg.cond_mode == "concat":
                x = torch.cat([x, emb[:, None, None, :].expand(
                    *x.shape[:3], emb.shape[-1])], dim=-1)

        for i in range(self.n_layers):
            x = getattr(self, f"down{i}")(x, dtype)
            if i > 0 and cfg.norm != "none":
                x = group_norm(x, getattr(self, f"scale{i}"),
                               getattr(self, f"bias{i}"),
                               cfg.group_size).to(dtype)
            x = leaky_relu(x, cfg.leaky_slope)

        phi = x                              # [B, 4, 4, chans[-1]]
        if cfg.critic_mbstd == "trunk":
            mb = torch.sqrt(mesh.global_var(x.float()) + 1e-8).mean()
            if mbstd_scale is not None:
                mb = mb * mbstd_scale
            x = torch.cat([x, mb.to(dtype).expand(*x.shape[:3], 1)], dim=-1)
        # NHWC flatten, as the Flax head sees it
        feat = up(x.reshape(x.shape[0], -1))
        score = self.head(feat, feat.dtype).squeeze(-1)
        if cfg.cond_dim and cfg.cond_mode == "projection":
            pooled = phi.float().sum(dim=(1, 2))
            proj = self.cond_proj(emb.float(), torch.float32)
            score = score + (proj * pooled).sum(-1)
        return score
