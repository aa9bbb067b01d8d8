"""DCGAN-style tile-level Generator, port of ``levelgan/models/generator.py``.

z (+ condition) -> seed Dense -> reshape 4x4 (NHWC) -> GroupNorm + LeakyReLU
-> upsample stages -> 3x3 ``to_tiles`` conv -> logits [B, H, W, n_tiles] f32.

Parameters keep the JAX package's names and f32 layouts (HWIO conv
kernels, [in, out] Dense kernels), so ``state_dict`` keys are the Flax
paths with ``/`` written as ``.``; activations run in ``cfg.dtype``.

Each stage on a CUDA tensor launches a hand-written kernel, whatever
``cfg.use_pallas`` says: K1 (``kernels.upsample_block``) where its
(sample, group) tile fits, else K1L (``kernels.upsample_rows``).  On a CPU
tensor, or with ``plain=True``, every stage runs the plain
``ops.blocks.upsample_block``, which mirrors the JAX package's default
(XLA) stage.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from levelgan_torch.config import ModelConfig
from levelgan_torch.device import torch_dtype
from levelgan_torch.kernels import upsample_block as k1
from levelgan_torch.kernels import upsample_rows as k1l
from levelgan_torch.ops.blocks import group_norm, leaky_relu, upsample_block


def generator_stages(cfg: ModelConfig) -> list[int]:
    """Per-stage output channels, 4x4 seed -> level_size. 16->2, 32->3, 64->4."""
    n = int(math.log2(cfg.level_size // 4))
    if 4 * 2 ** n != cfg.level_size:
        raise ValueError(f"level_size must be 4*2^k, got {cfg.level_size}")
    return [min(cfg.base_channels * 2 ** (n - 1 - i), cfg.max_channels)
            for i in range(n)]


class Dense(nn.Module):
    """Flax ``nn.Dense``: kernel [in, out], bias [out]; computes in ``dtype``."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x, dtype):
        return F.linear(x.to(dtype), self.kernel.to(dtype).t(),
                        self.bias.to(dtype))


class Conv3x3(nn.Module):
    """Flax ``nn.Conv`` 3x3 SAME on NHWC; kernel HWIO [3, 3, Ci, Co]."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(3, 3, c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x, dtype):
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype),
                     self.kernel.permute(3, 2, 0, 1).to(dtype),
                     self.bias.to(dtype), padding=1)
        return y.permute(0, 2, 3, 1)


class UpsampleStage(nn.Module):
    """ConvTranspose(4x4, s2) + GroupNorm + LeakyReLU as one op, with an
    optional post-activation FiLM modulation of the stage output."""

    def __init__(self, c_in: int, out_ch: int, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.kernel = nn.Parameter(torch.empty(4, 4, c_in, out_ch))
        self.scale = nn.Parameter(torch.ones(out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        if cfg.cond_dim:
            self.film = Dense(cfg.cond_embed_dim, 2 * out_ch)

    def forward(self, x, film=None, *, plain: bool = False):
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        x = x.contiguous()
        kw = dict(slope=cfg.leaky_slope, group_size=cfg.group_size)
        if x.is_cuda and not plain:
            stage = (k1.upsample_block_fwd if k1.fits(x.shape[1], x.shape[2])
                     else k1l.upsample_block_rows)
            y = stage(x, self.kernel, self.scale, self.bias, **kw)
        else:
            y = upsample_block(x, self.kernel, self.scale, self.bias,
                               compute_dtype=dtype, **kw)
        if film is not None:
            # FiLM: per-sample, per-channel modulation; zero-init = identity
            g_mod, b_mod = self.film(film, dtype).chunk(2, dim=-1)
            y = y * (1.0 + g_mod[:, None, None, :]) + b_mod[:, None, None, :]
        return y.to(dtype)


class Generator(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        chans = generator_stages(cfg)
        z_dim = cfg.latent_dim
        if cfg.cond_dim:
            self.cond_embed = Dense(cfg.cond_dim, cfg.cond_embed_dim)
            z_dim += cfg.cond_embed_dim
        self.seed = Dense(z_dim, 4 * 4 * chans[0])
        self.seed_scale = nn.Parameter(torch.ones(chans[0]))
        self.seed_bias = nn.Parameter(torch.zeros(chans[0]))
        out_chans = chans[1:] + [max(cfg.base_channels // 2, cfg.n_tiles * 2)]
        c_in = chans[0]
        self.n_stages = len(out_chans)
        for i, oc in enumerate(out_chans):
            self.add_module(f"up{i}", UpsampleStage(c_in, oc, cfg))
            c_in = oc
        self.to_tiles = Conv3x3(c_in, cfg.n_tiles)

    def stages(self) -> list[UpsampleStage]:
        return [getattr(self, f"up{i}") for i in range(self.n_stages)]

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Generator":
        """The Flax initializers: normal(0.02) kernels (zeros for FiLM),
        zero biases, unit GroupNorm scales."""
        for name, p in self.named_parameters():
            if name.endswith("kernel"):
                if name.endswith("film.kernel"):
                    p.zero_()
                else:
                    p.copy_(torch.randn(p.shape, generator=generator,
                                        device=generator.device) * 0.02)
        return self

    def forward(self, z, cond=None, *, plain: bool = False):
        """z [B, latent_dim] (+ cond [B, cond_dim]) -> logits [B,H,W,n_tiles].

        ``plain=True`` runs every stage's plain version even on the card
        (the reference the kernels are checked against).
        """
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        film = None
        if cfg.cond_dim:
            if cond is None:
                raise ValueError("conditional generator called without cond")
            film = leaky_relu(self.cond_embed(cond, dtype), cfg.leaky_slope)
            z = torch.cat([z.float(), film.float()], dim=-1)
        c0 = self.seed_scale.shape[0]
        x = self.seed(z, dtype).reshape(z.shape[0], 4, 4, c0)
        x = leaky_relu(group_norm(x, self.seed_scale, self.seed_bias,
                                  cfg.group_size), cfg.leaky_slope).to(dtype)
        for stage in self.stages():
            x = stage(x, film, plain=plain)
        return self.to_tiles(x, dtype).float()
