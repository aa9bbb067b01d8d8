"""The export driver: closed-loop requests through ``export.generate``.

One client sends requests of ``levels`` tile levels at batch ``batch``
(unpacked, no repair: the export CLI's default for tile levels), each with
its own seed, the next as the last one has returned its host array, as a
content pipeline calling the export does.  Set-up makes the generator's weights on the device from the seed, hands them
over as host tensors (as a checkpoint gives them to the export CLI) and
runs one warm-up request.  The window runs requests until ``--seconds``
have passed and ends when the last one begun has returned: the traffic's
``rate_metric`` is all levels over the window's time.

From each request one batch, drawn from the seed, is kept.  After the
window a sample of those batches is judged against the float32 reference,
which draws z and the head's uniforms again by the export's rule (one
``torch.Generator`` on the device seeded with the request's seed; each
batch z by ``randn``, then the Gumbel uniforms by ``rand``): the widest
gap by which a chosen tile's perturbed logit lies below the best
(``sample_gap``).
"""

from __future__ import annotations

import dataclasses
import sys
import time
import traceback

import numpy as np
import torch

from portbench import counts, inputs, trace
from portbench.harness import Outcome
from portbench.reference import params as ref_params
from portbench.reference import precision, tile


def run(ctx) -> Outcome:
    from levelgan_torch import export

    cfg, dev, tr = ctx.cfg, ctx.device, ctx.traffic
    m = dataclasses.asdict(cfg.model)
    n, bsz = tr["levels"], tr["batch"]
    n_batches = n // bsz
    if n % bsz:
        raise ValueError("levels must be a multiple of batch")
    t = time.monotonic()
    weights = inputs.make_params(ref_params.tile_generator(m), ctx.seed,
                                 inputs.WEIGHTS_G, dev)
    host_params = {k: v.cpu() for k, v in weights.items()}
    t = ctx.note("weights", t)

    def request(req_seed: int) -> np.ndarray:
        return export.generate(cfg, host_params, n, seed=req_seed,
                               batch_size=bsz, device=dev, repair=False)

    request(inputs.sub_seed(ctx.seed, inputs.REQUEST, 2 ** 31))  # warm-up
    _sync(dev)
    ctx.note("warm-up request", t)
    pick = np.random.default_rng(inputs.sub_seed(ctx.seed, inputs.SAMPLE))
    kept, attempted, failed, levels, took = [], 0, 0, 0, []
    t0 = time.monotonic()
    setup_s = t0 - ctx.started
    while time.monotonic() - t0 < ctx.seconds or attempted < tr.get(
            "min_requests", 1):
        req_seed = inputs.sub_seed(ctx.seed, inputs.REQUEST, attempted)
        b = int(pick.integers(n_batches))
        attempted += 1
        t = time.monotonic()
        try:
            out = request(req_seed)
            took.append(time.monotonic() - t)
        except Exception:       # a request that raised counts as failed
            traceback.print_exc(file=sys.stderr)
            failed += 1
            continue
        levels += n
        kept.append((req_seed, b, out[b * bsz:(b + 1) * bsz].copy()))
        del out
    window_s = time.monotonic() - t0

    t = time.monotonic()
    stretch = None
    if ctx.trace:
        reqs = tr.get("traced_requests", 1)

        def stretch_fn():
            for i in range(reqs):
                request(inputs.sub_seed(ctx.seed, inputs.REQUEST, 2 ** 31 + 1
                                        + i))
            _sync(dev)
        _, stretch = trace.profiled(stretch_fn, cuda=dev.type == "cuda")
        stretch.units = reqs * n_batches
        t = ctx.note("profiled stretch", t)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    record = {"platform": dev.type, "model": m, "traffic": tr, "batch": bsz,
              "window_s": window_s, "units": levels // bsz,
              "stretch": stretch,
              "flops_per_unit": bsz * counts.generator_flops(m)}
    checks = _check(ctx, m, weights, kept, bsz)
    ctx.note("comparison with the reference", t)
    return Outcome(end_to_end={tr["rate_metric"]: levels / window_s,
                               "setup_s": setup_s},
                   record=record, attempted=attempted, failed=failed,
                   checks=checks, memory_peak_bytes=peak, stretch=stretch,
                   details={"request_s": took})


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _draws(req_seed: int, b: int, bsz: int, m: dict, dev):
    """(z, uniforms) of batch ``b`` of a request: the export's stream
    replayed from its seed."""
    rng = torch.Generator(dev).manual_seed(req_seed)
    for _ in range(b + 1):
        z = torch.randn((bsz, m["latent_dim"]), generator=rng, device=dev)
        u = torch.rand((bsz, m["level_size"], m["level_size"], m["n_tiles"]),
                       generator=rng, device=dev)
    return z, u


@torch.no_grad()
def _check(ctx, m, weights, kept, bsz) -> dict:
    """The compared numbers over a sample of the kept batches."""
    dev = ctx.device
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    p = {k: v.float() for k, v in weights.items()}
    pick = np.random.default_rng(inputs.sub_seed(ctx.seed, inputs.SAMPLE, 1))
    n_check = min(len(kept), ctx.limits["check_batches"])
    chosen = sorted(pick.choice(len(kept), n_check, replace=False))
    q = precision.fp8 if ctx.control else precision.exact
    gap = 0.0
    with precision.strict_f32():
        for i in chosen:
            req_seed, b, got = kept[i]
            z, u = _draws(req_seed, b, bsz, m, dev)
            ref = tile.generator_logits(p, z, m)
            g = tile.gumbel(u)
            if ctx.control:    # the reference in fp8 in the program's place
                ids = tile.sample_ids(tile.generator_logits(p, z, m, q), g)
            else:
                ids = torch.as_tensor(got, device=dev).long()
            gap = max(gap, float(tile.sample_gap(ref, g, ids).max()))
    return {"sample_gap": gap}
