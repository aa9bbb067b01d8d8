"""Tile family: generator, sampling head, critic, gradient penalty and the
WGAN-GP step with Adam and the generator's EMA, in plain float32.

Layouts: activations NHWC; conv kernels HWIO; Dense kernels [in, out].
The generator: z -> Dense -> 4x4xC0 -> GroupNorm -> LeakyReLU -> stages of
ConvTranspose(4x4, stride 2, SAME) + GroupNorm + LeakyReLU -> 3x3 SAME
conv -> logits.  The critic: 4x4 stride-2 SAME convs (GroupNorm from the
second on) with LeakyReLU, a Dense head on the NHWC-flattened 4x4 map.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.precision import exact

EPS_GN = 1e-5
EPS_GP = 1e-12
EPS_ADAM = 1e-8


def leaky_relu(x, slope):
    return torch.where(x >= 0, x, slope * x)


def group_norm(x, gamma, beta, group_size):
    """Per-sample GroupNorm of NHWC x over groups of ``group_size``
    channels (biased variance, eps 1e-5)."""
    b, c = x.shape[0], x.shape[-1]
    g = max(1, c // group_size)
    xg = x.reshape(b, -1, g, c // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    return ((xg - mean) / torch.sqrt(var + EPS_GN)).reshape(x.shape) * gamma + beta


def dense(x, kernel, bias, q=exact):
    return q(x) @ q(kernel) + bias


def conv_transpose_up2(x, kernel, q=exact):
    """ConvTranspose 4x4 stride 2 SAME, NHWC [B,H,W,Ci] -> [B,2H,2W,Co],
    kernel HWIO; the transposed conv of a spatially flipped kernel."""
    w = q(kernel).permute(2, 3, 0, 1).flip(2, 3)       # [Ci, Co, kh, kw]
    y = F.conv_transpose2d(q(x).permute(0, 3, 1, 2), w, stride=2, padding=1)
    return y.permute(0, 2, 3, 1)


def conv(x, kernel, bias, stride, padding, q=exact):
    y = F.conv2d(q(x).permute(0, 3, 1, 2), q(kernel).permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1) + bias


def generator_logits(p: dict, z, m: dict, q=exact):
    """z [B, latent] -> logits [B, H, W, n_tiles]."""
    slope, gs = m["leaky_slope"], m["group_size"]
    c0 = p["seed_scale"].shape[0]
    x = dense(z, p["seed.kernel"], p["seed.bias"], q)
    x = x.reshape(z.shape[0], 4, 4, c0)
    x = q(leaky_relu(group_norm(x, p["seed_scale"], p["seed_bias"], gs), slope))
    i = 0
    while f"up{i}.kernel" in p:
        y = conv_transpose_up2(x, p[f"up{i}.kernel"], q)
        y = group_norm(y, p[f"up{i}.scale"], p[f"up{i}.bias"], gs)
        x = q(leaky_relu(y, slope))
        i += 1
    return conv(x, p["to_tiles.kernel"], p["to_tiles.bias"], 1, 1, q)


def gumbel(u):
    """Gumbel draws from uniforms U in [0, 1): -log(-log(max(U, tiny)))."""
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def sample_ids(logits, g):
    """The Gumbel-max sample: argmax over tiles of logits + g."""
    return torch.argmax(logits + g, dim=-1)


def sample_gap(logits, g, ids):
    """How far each chosen tile's perturbed logit lies below the best one:
    max_k(logit_k + g_k) - (logit_id + g_id) >= 0, per cell."""
    y = logits + g
    return y.max(dim=-1).values - y.gather(-1, ids.long()[..., None])[..., 0]


def critic_score(p: dict, x, m: dict, q=exact):
    """x [B, H, W, n_tiles] (one-hot or relaxed) -> scores [B]."""
    slope, gs = m["leaky_slope"], m["group_size"]
    i = 0
    while f"down{i}.kernel" in p:
        x = conv(x, p[f"down{i}.kernel"], p[f"down{i}.bias"], 2, 1, q)
        if i > 0 and m.get("norm", "group") != "none":
            x = group_norm(x, p[f"scale{i}"], p[f"bias{i}"], gs)
        x = q(leaky_relu(x, slope))
        i += 1
    return dense(x.reshape(x.shape[0], -1), p["head.kernel"],
                 p["head.bias"], q)[:, 0]


def gradient_penalty(p, real, fake, eps, m, q=exact):
    """E[(||grad_x D(x_hat)|| - 1)^2], x_hat = eps real + (1 - eps) fake,
    differentiable in the critic's parameters (double backward)."""
    x_hat = (eps * real + (1.0 - eps) * fake).detach().requires_grad_(True)
    (g,) = torch.autograd.grad(critic_score(p, x_hat, m, q).sum(), x_hat,
                               create_graph=True)
    norm = torch.sqrt(g.reshape(g.shape[0], -1).square().sum(-1) + EPS_GP)
    return (norm - 1.0).square().mean()


def d4(ids, elements):
    """Per-sample D4 element e of [B, H, W] ids: flip W when e >= 4, then
    rotate by e % 4 quarter turns (numpy's rot90 sense)."""
    out = torch.empty_like(ids)
    for e in range(8):
        sel = elements == e
        if sel.any():
            x = ids[sel]
            if e >= 4:
                x = torch.flip(x, dims=(-1,))
            out[sel] = torch.rot90(x, k=e % 4, dims=(-2, -1))
    return out


def one_hot(ids, n):
    return F.one_hot(ids.long(), n).float()


def tau_at(step: int, m: dict) -> float:
    """The Gumbel temperature's exponential anneal."""
    if m["tau_anneal_steps"] <= 0:
        return float(m["tau_end"])
    frac = min(max(step / m["tau_anneal_steps"], 0.0), 1.0)
    return math.exp((1.0 - frac) * math.log(m["tau_start"])
                    + frac * math.log(m["tau_end"]))


def straight_through(logits, g, tau):
    """Hard one-hot forward, the tau-softened softmax's gradient."""
    soft = torch.softmax((logits + g) / tau, dim=-1)
    hard = one_hot(torch.argmax(soft, dim=-1), logits.shape[-1])
    return soft + (hard - soft).detach()


class Adam:
    """optax.adam: m, v moments, bias-corrected, lr * m_hat / (sqrt(v_hat)
    + eps), one state per named parameter."""

    def __init__(self, lr, b1, b2):
        self.lr, self.b1, self.b2, self.count = lr, b1, b2, 0
        self.m, self.v = {}, {}

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for k, g in grads.items():
            m = self.m.get(k, torch.zeros_like(g))
            v = self.v.get(k, torch.zeros_like(g))
            self.m[k] = m = self.b1 * m + (1.0 - self.b1) * g
            self.v[k] = v = self.b2 * v + (1.0 - self.b2) * g * g
            params[k] -= self.lr * (m / c1) / (torch.sqrt(v / c2) + EPS_ADAM)


def ema_decay(step: int, decay: float) -> float:
    """The EMA's warm-up decay min(decay, (1 + step) / (10 + step)), in
    float32."""
    d = min(decay, (1.0 + step) / (10.0 + step)) if decay else 0.0
    return float(torch.tensor(d, dtype=torch.float32))


class WganGp:
    """The WGAN-GP train step on plain parameter dicts (float32 copies).

    A step: ``n_critic`` critic updates, each on one real batch (D4
    augmented, one-hot), a fake from G without gradient, the scores and the
    penalty, loss = -(mean D(real) - mean D(fake)) + lambda GP; then one
    generator update, loss = -mean D(fake) through the straight-through
    sample; then the EMA of G.  ``noise`` per step: ``critic`` a list of
    {elements, z, noise (Gumbel draws), eps}, ``g`` {z, noise}.
    """

    def __init__(self, g_params: dict, d_params: dict, m: dict, t: dict,
                 q=exact):
        self.g = {k: v.detach().clone().float().requires_grad_(True)
                  for k, v in g_params.items()}
        self.d = {k: v.detach().clone().float().requires_grad_(True)
                  for k, v in d_params.items()}
        self.ema = {k: v.detach().clone() for k, v in self.g.items()}
        self.m, self.t, self.q, self.step_count = m, t, q, 0
        self.opt_g = Adam(t["lr_g"], t["beta1"], t["beta2"])
        self.opt_d = Adam(t["lr_d"], t["beta1"], t["beta2"])

    def step(self, batch_ids, noise) -> dict:
        m, t, q = self.m, self.t, self.q
        tau = tau_at(self.step_count, m)
        dkeys = list(self.d)
        out = {}
        for ids, nz in zip(batch_ids, noise["critic"]):
            real = one_hot(d4(ids, nz["elements"]), m["n_tiles"])
            with torch.no_grad():
                logits = generator_logits(self.g, nz["z"], m, q)
                fake = one_hot(sample_ids(logits, nz["noise"]), m["n_tiles"])
            wdist = (critic_score(self.d, real, m, q).mean()
                     - critic_score(self.d, fake, m, q).mean())
            gp = gradient_penalty(self.d, real, fake, nz["eps"], m, q)
            loss = -wdist + t["gp_lambda"] * gp
            grads = torch.autograd.grad(loss, [self.d[k] for k in dkeys])
            self.opt_d.update(self.d, dict(zip(dkeys, grads)))
            out["d_loss"] = float(loss.detach())
        ng = noise["g"]
        fake = straight_through(generator_logits(self.g, ng["z"], m, q),
                                ng["noise"], tau)
        g_loss = -critic_score(self.d, fake, m, q).mean()
        gkeys = list(self.g)
        grads = torch.autograd.grad(g_loss, [self.g[k] for k in gkeys])
        self.opt_g.update(self.g, dict(zip(gkeys, grads)))
        d = ema_decay(self.step_count, t["ema_decay"])
        with torch.no_grad():
            for k, e in self.ema.items():
                e.mul_(d).add_(self.g[k], alpha=1.0 - d)
        self.step_count += 1
        out["g_loss"] = float(g_loss.detach())
        return out
