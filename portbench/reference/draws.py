"""The random inputs of a WGAN-GP train step, drawn again from the seed.

The rule is the train loop's documented one: step ``s`` draws from one
``torch.Generator`` on the device, seeded with the first 64-bit word of
``numpy.random.SeedSequence([train_seed, 0x0DA7A, s])``, in this order:
the corpus rows ``randint(0, len(corpus), (n_critic, B))``; then for each
critic iteration the D4 elements ``randint(0, 8, (B,))``, z ``randn(B,
latent)``, the head's uniforms ``rand(B, H, W, n_tiles)`` and the
interpolation weights ``rand(B, 1, 1, 1)``; then the generator update's z
and uniforms.  Uniforms become Gumbel draws by ``tile.gumbel``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.tile import gumbel

DATA_TAG = 0x0DA7A


def step_generator(train_seed: int, step: int, device) -> torch.Generator:
    state = np.random.SeedSequence([train_seed, DATA_TAG, step])
    return torch.Generator(device).manual_seed(
        int(state.generate_state(1, np.uint64)[0]))


def wgan_gp_step(corpus, train_seed: int, step: int, m: dict, t: dict):
    """(batch ids [n_critic, B, H, W], noise) of step ``step``, as
    ``tile.WganGp.step`` takes them."""
    if m.get("structural_head") == "spatial":
        raise NotImplementedError("the spatial structural head draws more")
    dev = corpus.device
    rng = step_generator(train_seed, step, dev)
    b, n = t["batch_size"], t["n_critic"]
    cells = (b, m["level_size"], m["level_size"], m["n_tiles"])
    idx = torch.randint(0, corpus.shape[0], (n, b), device=dev, generator=rng)

    def z():
        return torch.randn((b, m["latent_dim"]), device=dev, generator=rng)

    def g():
        return gumbel(torch.rand(cells, device=dev, generator=rng))

    its = []
    for _ in range(n):
        it = {"elements": torch.randint(0, 8, (b,), device=dev,
                                        generator=rng)}
        it["z"] = z()
        it["noise"] = g()
        it["eps"] = torch.rand((b, 1, 1, 1), device=dev, generator=rng)
        its.append(it)
    g_z = z()
    return corpus[idx], {"critic": its, "g": {"z": g_z, "noise": g()}}
