"""The parameters of each model, by the port's ``state_dict`` names: shapes
from the configuration alone.  Kinds: ``kernel`` (a product's weight,
fan-in = every axis but the last), ``bias``, ``scale`` (a GroupNorm gain)."""

from __future__ import annotations

from portbench.counts import critic_layers, generator_channels


def tile_generator(m: dict) -> list[tuple[str, tuple, str]]:
    c = generator_channels(m)
    spec = [("seed.kernel", (m["latent_dim"], 16 * c[0]), "kernel"),
            ("seed.bias", (16 * c[0],), "bias"),
            ("seed_scale", (c[0],), "scale"),
            ("seed_bias", (c[0],), "bias")]
    for i, (ci, co) in enumerate(zip(c[:-1], c[1:])):
        spec += [(f"up{i}.kernel", (4, 4, ci, co), "kernel"),
                 (f"up{i}.scale", (co,), "scale"),
                 (f"up{i}.bias", (co,), "bias")]
    return spec + [("to_tiles.kernel", (3, 3, c[-1], m["n_tiles"]), "kernel"),
                   ("to_tiles.bias", (m["n_tiles"],), "bias")]


def tile_critic(m: dict) -> list[tuple[str, tuple, str]]:
    spec = []
    for i, (_, c_in, co) in enumerate(critic_layers(m)):
        spec += [(f"down{i}.kernel", (4, 4, c_in, co), "kernel"),
                 (f"down{i}.bias", (co,), "bias")]
        if i > 0 and m.get("norm", "group") != "none":
            spec += [(f"scale{i}", (co,), "scale"), (f"bias{i}", (co,), "bias")]
    return spec + [("head.kernel", (16 * co, 1), "kernel"),
                   ("head.bias", (1,), "bias")]

