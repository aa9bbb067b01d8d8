"""Level export: z -> G -> sample head -> decode -> repair -> pack.

Port of ``levelgan/export.py``.  Tile family: everything up to the uint8
ids (or their bit planes, ``pack=True``) runs on the device.  Track
family: z -> ``TrackGenerator`` -> (repair: the exact heading-closure
projection ``track.ops.closure_project``, on by the config's ``'auto'``)
-> f32 tracks [n, T, 2]; packing is refused.  The
host side is streamed as in the JAX package: each batch's D2H is issued
without blocking into pinned buffers, and the host unpacks (natively,
``native/unpack.c``) or copies batch i into one preallocated [n, H, W]
result while the later batches run on the card.

Randomness: one ``torch.Generator`` on the device, seeded from ``seed``,
draws each batch's z and then its Gumbel noise; the repair's uniform
placement draws from a second one (``repair_generator``).  ``generate``
also takes injected ``z``, ``noise`` and ``repair_scores`` (the tests feed
it the JAX package's draws).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from levelgan_torch import obs
from levelgan_torch.config import Config
from levelgan_torch.device import resolve_device
from levelgan_torch.models import Generator, sample_ids
from levelgan_torch.native.build import unpack_planes
from levelgan_torch.ops.repair import ensure_start_goal
from levelgan_torch.track.models import TrackGenerator
from levelgan_torch.track.ops import closure_project

# pack=None on the card: no.  Measured on one H100 (PERF.md): an unpacked
# 1024-level gumbel_64 batch crosses in 0.086 ms into pinned memory, while
# packing costs 0.3 ms of device time and the host unpack 0.7 ms (native)
PACK_ON_CUDA = False
STAGING = 3          # pinned host buffers of batches in flight


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
    """Invert the bit-plane packing: [B, H*W*bits/8] -> uint8 [B, H, W],
    by the native routine (``native/unpack.c``).  ``out`` may be
    uninitialised; both arrays must be C-contiguous."""
    b = packed.shape[0]
    bits = packed.shape[1] * 8 // (level_size * level_size)
    if out is None:
        out = np.empty((b, level_size, level_size), np.uint8)
    unpack_planes(np.ascontiguousarray(packed), bits, out)
    return out


def unpack_levels_plain(packed: np.ndarray, level_size: int,
                        out: np.ndarray | None = None) -> np.ndarray:
    """The NumPy form of ``unpack_levels`` (its plain version)."""
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


def _slice_noise(noise, lo, hi):
    if noise is None:
        return None
    if isinstance(noise, (tuple, list)):
        return tuple(n[lo:hi] for n in noise)
    return noise[lo:hi]


def _on(x, dev, dtype=None):
    """Host arrays (or tuples of them) as tensors on ``dev``."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(_on(t, dev, dtype) for t in x)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def make_generator(cfg: Config, params, device):
    """The family's generator (``Generator`` / ``TrackGenerator``) on
    ``device`` from a module or a ``state_dict`` mapping."""
    if isinstance(params, torch.nn.Module):
        return params.to(device).eval()
    gen = (TrackGenerator if cfg.model.family == "track"
           else Generator)(cfg.model)
    gen.load_state_dict(params)
    return gen.to(device).eval()


def resolve_pack(model, pack: bool | None, device: torch.device) -> bool:
    """Whether the export packs on the device.  ``None``: on the card
    ``PACK_ON_CUDA``; elsewhere when the vocabulary fits under 8 bits and
    H*W is a multiple of 8 (the JAX package's rule)."""
    fits = tile_bits(model.n_tiles) < 8 and (model.level_size ** 2) % 8 == 0
    if pack is None:
        return fits and (device.type != "cuda" or PACK_ON_CUDA)
    if pack and not fits:
        raise ValueError("bit-plane packing needs n_tiles <= 128 and "
                         f"H*W % 8 == 0 (level_size={model.level_size})")
    return bool(pack)


def repair_generator(seed: int, device) -> torch.Generator:
    """The stream of the repair scores, seeded from (seed, 2): the
    counterpart of the JAX export's ``fold_in(key, 2)``, so that repair
    does not move the z and noise draws."""
    s = np.random.SeedSequence([seed, 2]).generate_state(1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(s))


@torch.inference_mode()
def generate_batch(gen: Generator, cfg: Config, z: torch.Tensor, cond=None, *,
                   noise=None, generator: torch.Generator | None = None,
                   pack: bool = False, plain: bool = False,
                   repair: bool = False, repair_placement: str = "confidence",
                   exactly_one: bool = False, repair_scores=None,
                   repair_rng: torch.Generator | None = None) -> torch.Tensor:
    """One batch on the device: uint8 ids [B, H, W], or packed planes.

    ``repair`` applies ``ops.repair.ensure_start_goal`` (uniform placement
    on a conditional model honours the requested goal distance, cond dim
    3); its scores are ``repair_scores`` or drawn from ``repair_rng``.
    """
    with obs.span("export.generator"):
        logits = gen(z, cond, plain=plain)
    with obs.span("export.head"):
        ids = sample_ids(logits, _export_head(cfg), tau=cfg.model.tau_end,
                         structural=cfg.model.structural_head, noise=noise,
                         generator=generator, plain=plain)
        if repair:      # inside the head's span until it has its own
            target = (cond[:, 3] if repair_placement == "uniform"
                      and cond is not None and cfg.model.cond_dim >= 4
                      else None)
            ids = ensure_start_goal(ids, logits, placement=repair_placement,
                                    target_dist=target,
                                    exactly_one=exactly_one,
                                    scores=repair_scores,
                                    generator=repair_rng)
        return pack_levels(ids, tile_bits(cfg.model.n_tiles)) if pack else ids


@torch.inference_mode()
def generate_tracks_batch(gen: TrackGenerator, z: torch.Tensor, cond=None, *,
                          repair: bool = False) -> torch.Tensor:
    """One batch of f32 tracks [B, T, 2] on the device; ``repair`` closes
    each track's heading exactly (``closure_project``)."""
    with obs.span("export.generator"):
        tracks = gen(z, cond)
    return closure_project(tracks) if repair else tracks


class _HostSink:
    """Moves each batch into ``levels`` on the host.  On the card a batch's
    D2H runs on a copy stream into one of ``STAGING`` pinned buffers as soon
    as its kernels end, and the host unpacks (or copies) batch i while the
    later batches run; a buffer is reused only after the host has read it
    (the read is synchronous), and the host waits on the copy's event, not
    on the device."""

    def __init__(self, levels: np.ndarray, pack: bool, device: torch.device):
        self.levels, self.pack, self.dev = levels, pack, device
        self.side = levels.shape[-1]          # of a packed tile level
        if device.type == "cuda":
            self.copy_stream = torch.cuda.Stream(device)
            self.free = []
            self.pending = collections.deque()

    def _write(self, row: int, host: np.ndarray) -> None:
        k = host.shape[0]
        if self.pack:
            unpack_levels(host, self.side, out=self.levels[row:row + k])
        else:
            self.levels[row:row + k] = host.reshape((k,)
                                                    + self.levels.shape[1:])

    def put(self, row: int, out: torch.Tensor) -> None:
        with obs.span("export.put"):
            if self.dev.type != "cuda":
                self._write(row, out.numpy())
                return
            if not self.free:
                if len(self.pending) < STAGING:
                    self.free.append(torch.empty(out.shape, dtype=out.dtype,
                                                 pin_memory=True))
                else:
                    self._take()
            buf = self.free.pop()
            k = out.shape[0]
            self.copy_stream.wait_stream(torch.cuda.current_stream(self.dev))
            with torch.cuda.stream(self.copy_stream):
                buf[:k].copy_(out, non_blocking=True)
            out.record_stream(self.copy_stream)   # freed only after the copy
            self.pending.append((row, k, buf,
                                 self.copy_stream.record_event()))

    def _take(self) -> None:
        row, k, buf, done = self.pending.popleft()
        with obs.span("export.wait"):
            done.synchronize()
        self._write(row, buf[:k].numpy())
        self.free.append(buf)

    def drain(self) -> None:
        with obs.span("export.drain"):
            while self.dev.type == "cuda" and self.pending:
                self._take()


def generate(cfg: Config, params, n: int, *, seed: int = 0,
             batch_size: int = 1024, cond=None, pack: bool | None = None,
             repair: bool | None = None, repair_placement: str | None = None,
             exactly_one: bool | None = None, device=None, z=None,
             noise=None, repair_scores=None) -> np.ndarray:
    """Generate ``n`` tile levels -> host uint8 [n, H, W], or ``n`` tracks
    -> host f32 [n, T, 2] (track family: ``noise``, ``repair_placement``,
    ``exactly_one`` and ``repair_scores`` do not apply, ``pack=True`` is
    refused, ``repair`` is the closure projection).

    ``params``: a ``Generator`` / ``TrackGenerator`` or its
    ``state_dict``.  ``pack``: see ``resolve_pack``.  ``repair`` /
    ``repair_placement`` / ``exactly_one``: ``None`` reads the config
    policy (``resolve_export_policy``).  ``z``
    [n, latent_dim], ``noise`` (shaped as ``sample_head`` takes it, over n
    levels) and ``repair_scores`` ((start, goal) [n, H*W]) replace the
    draws of the seeded generators: z then the noise from one, the repair
    scores from another (``repair_generator``).

    Only ``generate_batch`` runs under ``torch.inference_mode``: a generator
    built here from a ``state_dict`` holds ordinary tensors, whose version
    counters let the kernels keep their packed weights across the batches.
    """
    track = cfg.model.family == "track"
    if track and pack:
        raise ValueError("pack=True is tile-family only; track export "
                         "returns float32 [n, T, 2] sequences")
    repair, placement, exactly_one = resolve_export_policy(
        cfg, repair, repair_placement, exactly_one)
    dev = resolve_device(device)
    m = cfg.model
    pack = False if track else resolve_pack(m, pack, dev)
    batch_size = min(batch_size, n)
    with obs.span("export.request", id=seed, device=False, n=n,
                  batch_size=batch_size):
        with obs.span("export.build", device=False):
            gen = make_generator(cfg, params, dev)
            rng = torch.Generator(dev).manual_seed(seed)
            repair_rng = (repair_generator(seed, dev) if repair and not track
                          else None)
            if cond is not None:
                cond = _on(cond, dev, torch.float32).expand(batch_size,
                                                            m.cond_dim)
            z, noise, repair_scores = (_on(z, dev, torch.float32),
                                       _on(noise, dev),
                                       _on(repair_scores, dev))
            n_batches = -(-n // batch_size)
            if track:
                out = np.empty((n_batches * batch_size, m.n_segments, 2),
                               np.float32)
            else:
                out = np.empty((n_batches * batch_size, m.level_size,
                                m.level_size), np.uint8)
            sink = _HostSink(out, pack, dev)
        for lo in range(0, n, batch_size):
            hi = lo + batch_size
            with obs.span("export.batch"):
                with obs.span("export.draw"):
                    zb = (z[lo:hi] if z is not None else
                          torch.randn((batch_size, m.latent_dim),
                                      generator=rng, device=dev))
                cb = cond[:zb.shape[0]] if cond is not None else None
                if track:
                    sink.put(lo, generate_tracks_batch(gen, zb, cb,
                                                       repair=repair))
                    continue
                sink.put(lo, generate_batch(
                    gen, cfg, zb, cb, noise=_slice_noise(noise, lo, hi),
                    generator=rng, pack=pack, repair=repair,
                    repair_placement=placement, exactly_one=exactly_one,
                    repair_scores=_slice_noise(repair_scores, lo, hi),
                    repair_rng=repair_rng))
        sink.drain()
    return out[:n]
