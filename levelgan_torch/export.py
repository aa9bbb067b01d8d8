"""Level export: z -> G -> sample head -> decode -> bit-plane pack.

Port of ``levelgan/export.py`` for the tile family.  Everything up to the
packed bytes runs on the device; only the packed uint8 planes cross to the
host, where ``unpack_levels`` restores uint8 [n, H, W] levels.

Randomness: one ``torch.Generator`` on the device, seeded from ``seed``,
draws each batch's z and then its Gumbel noise.  ``generate`` also takes
injected ``z``/``noise`` (the tests feed it the JAX package's draws).

Not in this slice: the track family and export repair (``ops/repair.py``);
both raise ``NotImplementedError`` instead of being skipped.
"""

from __future__ import annotations

import numpy as np
import torch

from levelgan_torch.config import Config
from levelgan_torch.data.codec import decode
from levelgan_torch.device import resolve_device
from levelgan_torch.models import Generator, sample_head


def resolve_export_policy(cfg: Config, repair: bool | None = None,
                          repair_placement: str | None = None,
                          exactly_one: bool | None = None
                          ) -> tuple[bool, str, bool]:
    """Resolve (repair, placement, exactly_one); ``None`` reads ``cfg.io``."""
    if repair is None:
        repair = {"auto": cfg.model.family == "track",
                  "on": True, "off": False}[cfg.io.export_repair]
    if repair_placement is None:
        repair_placement = cfg.io.export_repair_placement
    if exactly_one is None:
        exactly_one = {"auto": bool(repair) and cfg.model.family == "tile",
                       "on": True, "off": False}[cfg.io.export_exactly_one]
    return bool(repair), repair_placement, bool(exactly_one)


def tile_bits(n_tiles: int) -> int:
    """Bits per tile id for the packed export wire format."""
    return max(1, (n_tiles - 1).bit_length())


def packed_bytes(model) -> int:
    """Packed bytes per level: H*W tiles at tile_bits() bits each."""
    return model.level_size * model.level_size * tile_bits(model.n_tiles) // 8


def pack_levels(ids: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 ids [B, H, W] -> bit planes [B, H*W*bits/8] on ids' device.

    Each group of 8 consecutive tiles becomes ``bits`` bytes; byte j holds
    bit j of each of the 8 tiles (tile k in bit position k).
    """
    b = ids.shape[0]
    grp = ids.reshape(b, -1, 8).to(torch.int32)
    weight = torch.bitwise_left_shift(
        torch.ones(8, dtype=torch.int32, device=ids.device),
        torch.arange(8, dtype=torch.int32, device=ids.device))
    planes = [(((grp >> j) & 1) * weight).sum(-1) for j in range(bits)]
    return torch.stack(planes, dim=-1).reshape(b, -1).to(torch.uint8)


def unpack_levels(packed: np.ndarray, level_size: int,
                  out: np.ndarray | None = None) -> np.ndarray:
    """Invert the bit-plane packing: [B, H*W*bits/8] -> uint8 [B, H, W]."""
    b = packed.shape[0]
    hw = level_size * level_size
    bits = packed.shape[1] * 8 // hw
    if out is None:
        out = np.empty((b, level_size, level_size), np.uint8)
    flat = out.reshape(b, hw)
    grp = packed.reshape(b, hw // 8, bits)
    for j in range(bits):
        plane = np.unpackbits(np.ascontiguousarray(grp[:, :, j]),
                              axis=1, bitorder="little")
        if j == 0:
            flat[:] = plane          # assignment: out may be uninitialised
        else:
            flat |= plane << j
    return out


def _export_head(cfg: Config) -> str:
    # a Gumbel-head model is a sampling model: export samples from it;
    # softmax-head models export their argmax (as the JAX package does)
    return "gumbel" if cfg.model.head == "gumbel" else "argmax"


def _check_slice(cfg: Config, repair: bool | None) -> None:
    if cfg.model.family != "tile":
        raise NotImplementedError(
            "track-family export is not ported yet (the track slice)")
    if resolve_export_policy(cfg, repair)[0]:
        raise NotImplementedError(
            "export repair (levelgan/ops/repair.py) is not ported yet; it "
            "lands with the export-repair slice — pass repair=False")


def _slice_noise(noise, lo, hi):
    if noise is None:
        return None
    if isinstance(noise, (tuple, list)):
        return tuple(n[lo:hi] for n in noise)
    return noise[lo:hi]


def make_generator(cfg: Config, params, device) -> Generator:
    """A Generator on ``device`` from a module or a ``state_dict`` mapping."""
    if isinstance(params, Generator):
        return params.to(device).eval()
    gen = Generator(cfg.model)
    gen.load_state_dict(params)
    return gen.to(device).eval()


@torch.inference_mode()
def generate_batch(gen: Generator, cfg: Config, z: torch.Tensor, cond=None, *,
                   noise=None, generator: torch.Generator | None = None,
                   pack: bool = False, plain: bool = False) -> torch.Tensor:
    """One batch on the device: uint8 ids [B, H, W], or packed planes."""
    logits = gen(z, cond, plain=plain)
    ids = decode(sample_head(logits, _export_head(cfg), tau=cfg.model.tau_end,
                             structural=cfg.model.structural_head,
                             noise=noise, generator=generator))
    return pack_levels(ids, tile_bits(cfg.model.n_tiles)) if pack else ids


def generate(cfg: Config, params, n: int, *, seed: int = 0,
             batch_size: int = 1024, cond=None, pack: bool | None = None,
             repair: bool | None = None, device=None, z=None,
             noise=None) -> np.ndarray:
    """Generate ``n`` tile levels -> host uint8 [n, H, W].

    ``params``: a ``Generator`` or its ``state_dict``.  ``pack=None``
    packs on the device when the vocabulary fits under 8 bits and H*W is a
    multiple of 8.  ``z`` [n, latent_dim] and ``noise`` (shaped as
    ``sample_head`` takes it, over n levels) replace the generator's draws.

    Only ``generate_batch`` runs under ``torch.inference_mode``: a generator
    built here from a ``state_dict`` holds ordinary tensors, whose version
    counters let the kernels keep their packed weights across the batches.
    """
    _check_slice(cfg, repair)
    dev = resolve_device(device)
    m = cfg.model
    hw_mult8 = (m.level_size ** 2) % 8 == 0
    if pack is None:
        pack = tile_bits(m.n_tiles) < 8 and hw_mult8
    elif pack and (tile_bits(m.n_tiles) >= 8 or not hw_mult8):
        raise ValueError("bit-plane packing needs n_tiles <= 128 and "
                         f"H*W % 8 == 0 (level_size={m.level_size})")
    batch_size = min(batch_size, n)
    gen = make_generator(cfg, params, dev)
    rng = torch.Generator(dev).manual_seed(seed)
    if cond is not None:
        cond = torch.as_tensor(np.asarray(cond, np.float32), device=dev)
        cond = cond.expand(batch_size, m.cond_dim)
    if z is not None:
        z = torch.as_tensor(np.asarray(z, np.float32), device=dev)
    if noise is not None:
        noise = (tuple(torch.as_tensor(np.asarray(x), device=dev)
                       for x in noise) if isinstance(noise, (tuple, list))
                 else torch.as_tensor(np.asarray(noise), device=dev))

    chunks = []
    for lo in range(0, n, batch_size):
        hi = lo + batch_size
        zb = (z[lo:hi] if z is not None else
              torch.randn((batch_size, m.latent_dim), generator=rng,
                          device=dev))
        cb = cond[:zb.shape[0]] if cond is not None else None
        out = generate_batch(gen, cfg, zb, cb,
                             noise=_slice_noise(noise, lo, hi),
                             generator=rng, pack=pack)
        chunks.append(out.to("cpu", non_blocking=dev.type == "cuda"))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    host = torch.cat(chunks).numpy()
    levels = (unpack_levels(host, m.level_size) if pack
              else host.reshape(-1, m.level_size, m.level_size))
    return levels[:n]
