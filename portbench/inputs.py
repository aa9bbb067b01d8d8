"""Inputs made from ``--seed``: sub-seeds, weights and corpora.

Everything is drawn on the device by a ``torch.Generator`` seeded from
(seed, purpose), in a few large calls: one normal draw for all the
parameters of a model, split into its leaves and scaled by kind.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# purposes of the sub-seeds: each stream is separate from the others
WEIGHTS_G, WEIGHTS_D, CORPUS, REQUEST, SAMPLE, TRAIN = 1, 2, 3, 4, 5, 6


def sub_seed(seed: int, *words: int) -> int:
    """A 63-bit seed from (seed, words): any non-negative ``seed``."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *words])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def device_generator(seed: int, device, *words: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(sub_seed(seed, *words))


def make_params(spec, seed: int, purpose: int, device) -> dict:
    """Random float32 parameters for ``spec`` ((name, shape, kind) rows):
    kernels N(0, 1 / fan_in), biases N(0, 0.1^2), GroupNorm gains
    1 + N(0, 0.1^2); one draw for the whole model."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    flat = torch.randn(sum(sizes), device=device,
                       generator=device_generator(seed, device, purpose))
    out, at = {}, 0
    for (name, shape, kind), n in zip(spec, sizes):
        x = flat[at:at + n].reshape(shape)
        at += n
        if kind == "kernel":
            x = x / math.sqrt(math.prod(shape[:-1]))
        elif kind == "bias":
            x = 0.1 * x
        elif kind == "scale":
            x = 1.0 + 0.1 * x
        out[name] = x.contiguous()
    return out


def tile_corpus(seed: int, n: int, side: int, n_tiles: int, device):
    """``n`` random levels of uint8 tile ids [n, side, side]."""
    return torch.randint(0, n_tiles, (n, side, side), dtype=torch.uint8,
                         device=device,
                         generator=device_generator(seed, device, CORPUS))
