"""Track-family models: port of ``levelgan/track/models.py``.

``TrackGenerator``: z (+ cond) -> tracks [B, T, 2] = (curvature, width), a
GRU decoder whose hidden state starts from z and whose inputs are learned
per-step position embeddings.  ``TrackCritic``: tracks -> [B] scores, a
strided 1-D conv stack with GroupNorm.  Both compute in ``cfg.dtype``
(bf16 for the presets) with f32 parameters; the emitter's output layer and
the critic's head run in f32, as in the JAX package.

Parameters keep the Flax names and layouts, so ``state_dict`` keys are the
Flax paths with ``/`` written as ``.``: ``init``, ``pos_emb``,
``gru.{ir,iz,in,hr,hz,hn}``, ``emit``, ``cond_embed`` for G (Dense kernels
[in, out]); ``down{i}`` (1-D conv kernels WIO [5, Ci, Co]), ``scale{i}`` /
``bias{i}``, ``head``, ``cond_embed`` for D.

The GRU is Flax's ``GRUCell`` under ``nn.scan``, written as a loop of
plain ops (not ``torch.nn.GRU``, whose gates keep f32 and which is not the
function the JAX package computes):

    r = sigmoid(ir(x) + hr(h)),  z = sigmoid(iz(x) + hz(h))
    n = tanh(in(x) + r * hn(h)),  h' = (1 - z) * n + z * h

(``hr`` and ``hz`` without bias), every Dense output and gate rounded to
``cfg.dtype``; in bf16 the gates' sigmoid is XLA's, 1 / (1 + exp(-x))
rounded op by op, and the sigmoid and tanh take JAX's derivatives
(``ops.blocks.sigmoid`` / ``tanh``).  The inputs are ``pos_emb``
broadcast over the batch, so their three projections are computed once,
outside the loop; each step makes one matmul of h against the three
recurrent kernels side by side.

The critic's convs are Flax ``Conv((5,), strides=2, padding='SAME')``: on
an even length the SAME padding is (1, 2), not torch's symmetric 2.  Each
conv is written as one matmul over five strided slices of the padded
input (cuBLAS, whose backward sums in a fixed order) rather than cuDNN's
``conv1d``, whose weight-gradient algorithms may sum with atomics; the
double backward of the gradient penalty goes through it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from levelgan_torch.config import ModelConfig
from levelgan_torch.device import torch_dtype
from levelgan_torch.env.agent import lecun_normal
from levelgan_torch.models.generator import Dense
from levelgan_torch.ops.blocks import group_norm, leaky_relu, sigmoid, tanh
from levelgan_torch.track.data import KAPPA_MAX, WIDTH_MAX, WIDTH_MIN
from levelgan_torch.track.ops import closure_project

POS_DIM = 32                 # width of the GRU's position embeddings
CONV_K = 5                   # the critic's 1-D kernel


def orthogonal(n: int, generator: torch.Generator) -> torch.Tensor:
    """Flax's ``orthogonal`` initializer for a square [n, n] kernel."""
    q, r = torch.linalg.qr(torch.randn((n, n), generator=generator))
    return q * torch.sign(torch.diagonal(r))[None, :]


def normalize_tracks(tracks: torch.Tensor) -> torch.Tensor:
    """(kappa, width) -> roughly [-1, 1] channels for the critic."""
    kappa = tracks[..., 0] / KAPPA_MAX
    width = (tracks[..., 1] - WIDTH_MIN) / (WIDTH_MAX - WIDTH_MIN) * 2.0 - 1.0
    return torch.stack([kappa, width], dim=-1)


class _Linear(nn.Module):
    """A Flax Dense's parameters (kernel [in, out], optional bias)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))
        if bias:
            self.bias = nn.Parameter(torch.zeros(d_out))


class GRUParams(nn.Module):
    """Flax ``GRUCell``'s six Dense layers (``hr``, ``hz`` without bias)."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, _Linear(d_in, hidden))
        for name in ("hr", "hz"):
            self.add_module(name, _Linear(hidden, hidden, bias=False))
        self.add_module("hn", _Linear(hidden, hidden))


class TrackGenerator(nn.Module):
    """z [B, latent] (+ cond [B, cond_dim]) -> tracks [B, n_segments, 2]."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d_z = cfg.latent_dim
        if cfg.cond_dim:
            self.cond_embed = Dense(cfg.cond_dim, cfg.cond_embed_dim)
            d_z += cfg.cond_embed_dim
        self.init = Dense(d_z, cfg.rnn_hidden)
        self.pos_emb = nn.Parameter(torch.empty(cfg.n_segments, POS_DIM))
        self.gru = GRUParams(POS_DIM, cfg.rnn_hidden)
        self.emit = Dense(cfg.rnn_hidden, 2)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "TrackGenerator":
        """Flax's initializers, drawn in parameter order: lecun_normal
        Dense kernels, orthogonal recurrent kernels, normal(0.02)
        ``pos_emb`` and ``emit``, zero biases."""
        for name, p in self.named_parameters():
            if name in ("pos_emb", "emit.kernel"):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
            elif name in ("gru.hr.kernel", "gru.hz.kernel", "gru.hn.kernel"):
                p.copy_(orthogonal(p.shape[0], generator))
            elif name.endswith("kernel"):
                p.copy_(lecun_normal(tuple(p.shape), generator))
        return self

    def gru_weights(self, dt: torch.dtype):
        """(the input projections [T, 3H], which do not depend on h, the
        recurrent kernels side by side [H, 3H], ``hn``'s bias) in ``dt``."""
        g = self.gru
        g_in = getattr(g, "in")          # Flax's name, a Python keyword
        w_i = torch.cat([g.ir.kernel, g.iz.kernel, g_in.kernel], 1).to(dt)
        b_i = torch.cat([g.ir.bias, g.iz.bias, g_in.bias]).to(dt)
        x_i = (self.pos_emb.to(dt) @ w_i) + b_i
        w_h = torch.cat([g.hr.kernel, g.hz.kernel, g.hn.kernel], 1).to(dt)
        return x_i, w_h, g.hn.bias.to(dt)

    def gru_step(self, h: torch.Tensor, x_t: torch.Tensor, w_h: torch.Tensor,
                 b_hn: torch.Tensor) -> torch.Tensor:
        """One ``GRUCell`` step: h [B, H] and the step's input projections
        x_t [3H] -> h'."""
        hid = self.cfg.rnn_hidden
        gh = h @ w_h
        rz = sigmoid(x_t[:2 * hid] + gh[:, :2 * hid])
        r, zg = rz[:, :hid], rz[:, hid:]
        n = tanh(x_t[2 * hid:] + r * (gh[:, 2 * hid:] + b_hn))
        return (1.0 - zg) * n + zg * h

    def forward(self, z: torch.Tensor, cond=None) -> torch.Tensor:
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        if cfg.cond_dim:
            if cond is None:
                raise ValueError("conditional track generator needs cond")
            emb = leaky_relu(self.cond_embed(cond, dt), cfg.leaky_slope)
            z = torch.cat([z.float(), emb.float()], dim=-1)
        h = tanh(self.init(z, dt))
        x_i, w_h, b_hn = self.gru_weights(dt)
        hs = []
        for t in range(cfg.n_segments):
            h = self.gru_step(h, x_i[t], w_h, b_hn)
            hs.append(h)
        raw = self.emit(torch.stack(hs, dim=1).float(), torch.float32)
        kappa = KAPPA_MAX * torch.tanh(raw[..., 0])
        width = WIDTH_MIN + (WIDTH_MAX - WIDTH_MIN) * torch.sigmoid(raw[..., 1])
        out = torch.stack([kappa, width], dim=-1)
        if cfg.closure_in_model:
            out = closure_project(out)
        return out


def _same_pad(n: int) -> tuple[int, int]:
    """Flax SAME padding of a width-5 stride-2 conv over ``n`` positions:
    the odd one at the high end."""
    total = max((-(-n // 2) - 1) * 2 + CONV_K - n, 0)
    return total // 2, total - total // 2


class Conv5s2(nn.Module):
    """Flax ``nn.Conv(co, (5,), strides=(2,), padding='SAME')`` on NTC;
    kernel WIO [5, Ci, Co]."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(CONV_K, c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        b, t, c = x.shape
        t_out = -(-t // 2)
        x = F.pad(x.to(dtype), (0, 0, *_same_pad(t)))
        # the window of output u is padded positions 2u .. 2u + 4
        win = torch.stack([x[:, k:k + 2 * t_out - 1:2]
                           for k in range(CONV_K)], dim=2)
        y = win.reshape(b, t_out, CONV_K * c) @ self.kernel.reshape(
            CONV_K * c, -1).to(dtype)
        return y + self.bias.to(dtype)


class TrackCritic(nn.Module):
    """tracks [B, T, 2] (+ cond [B, cond_dim]) -> [B] scores."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        c_in = 2
        if cfg.cond_dim:
            self.cond_embed = Dense(cfg.cond_dim, cfg.cond_embed_dim)
            c_in += cfg.cond_embed_dim
        ch, t, i = cfg.critic_base_channels, cfg.n_segments, 0
        while t > 4:
            co = min(ch, cfg.max_channels)
            self.add_module(f"down{i}", Conv5s2(c_in, co))
            if i > 0 and cfg.norm != "none":
                self.register_parameter(f"scale{i}",
                                        nn.Parameter(torch.ones(co)))
                self.register_parameter(f"bias{i}",
                                        nn.Parameter(torch.zeros(co)))
            c_in, t, ch, i = co, -(-t // 2), ch * 2, i + 1
        self.n_layers = i
        self.head = Dense(t * c_in, 1)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "TrackCritic":
        """Flax's initializers, drawn in parameter order: normal(0.02)
        conv kernels, lecun_normal Dense kernels, zero biases, unit
        GroupNorm scales."""
        for name, p in self.named_parameters():
            if name.startswith("down") and name.endswith("kernel"):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
            elif name.endswith("kernel"):
                p.copy_(lecun_normal(tuple(p.shape), generator))
        return self

    def forward(self, tracks: torch.Tensor, cond=None) -> torch.Tensor:
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        x = normalize_tracks(tracks).to(dt)
        if cfg.cond_dim:
            if cond is None:
                raise ValueError("conditional track critic needs cond")
            emb = leaky_relu(self.cond_embed(cond, dt), cfg.leaky_slope)
            x = torch.cat([x, emb[:, None, :].expand(-1, x.shape[1], -1)],
                          dim=-1)
        for i in range(self.n_layers):
            x = getattr(self, f"down{i}")(x, dt)
            if i > 0 and cfg.norm != "none":
                x = group_norm(x, getattr(self, f"scale{i}"),
                               getattr(self, f"bias{i}"), cfg.group_size)
            x = leaky_relu(x, cfg.leaky_slope).to(dt)
        return self.head(x.reshape(x.shape[0], -1).float(),
                         torch.float32).squeeze(-1)
