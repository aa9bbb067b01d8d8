"""The training driver: the preset's WGAN-GP step, driven as the CLI
drives it (``api.step_inputs``, then ``api.make_step_fn(cfg)``'s step under
``api.step_mode``), at the traffic's global batch.

Set-up makes G's and D's weights on the device from the seed, builds the
train state around them (``train.state.create_state``) and a corpus of
random tile ids on the device, seeds the step stream (``train.seed``) from
the seed, then drives the first ``check_steps`` steps through the same
step object and feed, keeping each step's losses, the first gradients as
the optimizers hold them after step 1 (β1 = 0, so Adam's first moment is
the last gradient), and the parameters and G's EMA after the last; then
``warm_steps`` more.  The window runs whole steps until ``--seconds``
have passed, reads the device only every ``io.log_every``
steps (losses and the generated tile histogram, as the CLI's log point
does) and ends with a device synchronisation: ``train_step_ms`` is the
window's time over its steps.

After the window the float32 reference (``reference.tile.WganGp``) follows
the checked steps from the same weights and corpus, on inputs it draws
again from the seed itself (``reference.draws``).  Each leaf's gap is
the gap of its norm from the reference's, over the larger of the
reference leaf's norm and the median leaf's.  Compared: of the first
gradient's norm the median leaf's gap (``median_grad_gap``; the worst
leaf's swings with the round-off of small leaves, PERF.md section 2), of
the parameters' change over the checked steps (``change_gap``) and of G's
EMA's change (``ema_gap``) the worst leaf's.  The worst leaf's gradient
gap and each step's losses are read beside them (``details``), not
compared.  Leaves whose reference gradient is under a thousandth of the
median leaf's (the critic head's bias) are left out: Adam moves them by
round-off alone.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch

from portbench import counts, inputs, trace
from portbench.harness import Outcome
from portbench.reference import draws
from portbench.reference import params as ref_params
from portbench.reference import precision
from portbench.reference.tile import WganGp

ZERO_GRAD = 1e-3       # a leaf under this share of the median leaf's gradient


def _host(tree: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def _first_moment(opt, module) -> dict:
    return {name: opt.state[p]["exp_avg"].detach().to("cpu", copy=True)
            for name, p in module.named_parameters()}


def run(ctx) -> Outcome:
    t0 = time.monotonic()
    from levelgan_torch import api
    from levelgan_torch.models import Critic, Generator
    from levelgan_torch.train.state import create_state
    t0 = ctx.note("imports of the train step", t0)

    tr, dev = ctx.traffic, ctx.device
    cfg = ctx.cfg.override(**{
        "train.batch_size": tr["batch"],
        "train.seed": inputs.sub_seed(ctx.seed, inputs.TRAIN)})
    m = dataclasses.asdict(cfg.model)
    t = dataclasses.asdict(cfg.train)
    w_g = inputs.make_params(ref_params.tile_generator(m), ctx.seed,
                             inputs.WEIGHTS_G, dev)
    w_d = inputs.make_params(ref_params.tile_critic(m), ctx.seed,
                             inputs.WEIGHTS_D, dev)
    corpus = inputs.tile_corpus(ctx.seed, tr["corpus"], m["level_size"],
                                m["n_tiles"], dev)
    _sync(dev)
    t0 = ctx.note("weights and corpus", t0)
    gen, critic = Generator(cfg.model), Critic(cfg.model)
    gen.load_state_dict(w_g)
    critic.load_state_dict(w_d)
    state = create_state(cfg, dev, generator=gen, critic=critic)
    step_fn = api.make_step_fn(cfg)
    t0 = ctx.note("train state and step", t0)

    def step(i):
        batch, noise = api.step_inputs(cfg, corpus, i, dev)
        with api.step_mode():
            return step_fn(state, batch, noise=noise)[1]

    losses, first = [], None
    for i in range(tr["check_steps"]):
        met = step(i)
        losses.append((float(met["d_loss"]), float(met["g_loss"])))
        if i == 0:
            first = {"g": _first_moment(state.opt_g, state.generator),
                     "d": _first_moment(state.opt_d, state.critic)}
    after = {"g": _host(dict(state.generator.named_parameters())),
             "d": _host(dict(state.critic.named_parameters())),
             "ema": _host(dict(state.g_ema.named_parameters()))}
    t0 = ctx.note("checked steps", t0)
    done = tr["check_steps"]
    for _ in range(tr["warm_steps"]):
        step(done)
        done += 1
    _sync(dev)
    ctx.note("warm steps", t0)

    log_every = cfg.io.log_every
    hist = torch.zeros(m["n_tiles"], device=dev)
    pending, bad, steps = [], 0, 0
    t0 = time.monotonic()
    setup_s = t0 - ctx.started
    while time.monotonic() - t0 < ctx.seconds or steps < tr.get(
            "min_steps", 1):
        met = step(done + steps)
        hist += met.pop("gen_hist")
        pending.append(torch.stack([met["d_loss"], met["g_loss"]]))
        steps += 1
        if steps % log_every == 0:
            bad += _read(pending, hist)
    bad += _read(pending, hist)
    _sync(dev)
    window_s = time.monotonic() - t0
    done += steps

    t0 = time.monotonic()
    stretch = None
    if ctx.trace:
        n = tr.get("traced_steps", 3)

        def stretch_fn():
            for i in range(n):
                step(done + i)
            _sync(dev)
        _, stretch = trace.profiled(stretch_fn, cuda=dev.type == "cuda")
        stretch.units = n
        t0 = ctx.note("profiled stretch", t0)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del state, corpus, step_fn
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    record = {"platform": dev.type, "model": m, "traffic": tr,
              "batch": t["batch_size"],
              "window_s": window_s, "units": steps, "stretch": stretch,
              "flops_per_unit": t["batch_size"] * counts.wgan_gp_step_flops(
                  m, t["n_critic"])}
    checks, details = _check(ctx, m, t, w_g, w_d, losses, first, after)
    ctx.note("comparison with the reference", t0)
    return Outcome(end_to_end={"train_step_ms": 1e3 * window_s / steps,
                               "setup_s": setup_s},
                   record=record, attempted=steps, failed=bad,
                   checks=checks, memory_peak_bytes=peak, stretch=stretch,
                   details=details)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _read(pending, hist) -> int:
    """A log point: the losses since the last one and the histogram cross
    to the host; returns the steps with a non-finite loss."""
    if not pending:
        return 0
    vals = torch.stack(pending)
    pending.clear()
    float(hist.sum())
    hist.zero_()
    return int((~torch.isfinite(vals)).any(-1).sum())


def _norms(tree: dict) -> dict:
    return {k: float(v.detach().float().norm()) for k, v in tree.items()}


def _leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """|prog - ref| / max(ref, median ref) of each kept leaf."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def _check(ctx, m, t, w_g, w_d, losses, first, after):
    dev = ctx.device
    b1 = t["beta1"]
    corpus = inputs.tile_corpus(ctx.seed, ctx.traffic["corpus"],
                                m["level_size"], m["n_tiles"], dev)
    train_seed = inputs.sub_seed(ctx.seed, inputs.TRAIN)
    with precision.strict_f32():
        # the reference, and the control in the program's place
        sides = [WganGp(w_g, w_d, m, t)]
        if ctx.control:
            sides.append(WganGp(w_g, w_d, m, t, precision.fp8))
        side_losses = [[] for _ in sides]
        side_first = [None for _ in sides]
        for i in range(len(losses)):
            batch, noise = draws.wgan_gp_step(corpus, train_seed, i, m, t)
            for j, side in enumerate(sides):
                r = side.step(batch, noise)
                side_losses[j].append((r["d_loss"], r["g_loss"]))
                if i == 0:      # Adam's first moments after step 1
                    side_first[j] = {"g": dict(side.opt_g.m),
                                     "d": dict(side.opt_d.m)}
    del corpus
    ref, ref_losses, ref_first = sides[0], side_losses[0], side_first[0]
    if ctx.control:
        losses, first = side_losses[1], side_first[1]
        after = {"g": sides[1].g, "d": sides[1].d, "ema": sides[1].ema}
    init = {"g": w_g, "d": w_d, "ema": w_g}
    ref_after = {"g": ref.g, "d": ref.d, "ema": ref.ema}
    # each step's critic and generator loss against the reference's, over
    # the largest |reference loss| of its kind: read, not compared (a gap
    # of small numbers where G's loss nears 0, swinging from seed to seed;
    # the first step's alone has no upper reading: PERF.md, section 6)
    loss_gaps = []
    for j in range(2):
        scale = max(abs(r[j]) for r in ref_losses)
        loss_gaps.append([abs(p[j] - r[j]) / scale
                          for p, r in zip(losses, ref_losses)])
    details = {"losses": losses, "ref_losses": ref_losses,
               "loss_gaps": loss_gaps,
               "loss_gap": max(max(g) for g in loss_gaps),
               "first_step_loss_gap": max(g[0] for g in loss_gaps)}
    out = {"change_gap": 0.0, "ema_gap": 0.0}
    grad_gaps = []
    for net in ("g", "d"):
        # the gradient the optimizer got: its first moment over (1 - beta1)
        rg = _norms({k: v / (1 - b1) for k, v in ref_first[net].items()})
        med = statistics.median(rg.values())
        keep = [k for k, v in rg.items() if v >= ZERO_GRAD * med]
        pg = _norms({k: v / (1 - b1) for k, v in first[net].items()})
        gg = _leaf_gaps(pg, rg, keep)
        grad_gaps += gg.values()
        details[f"grad_gaps.{net}"] = gg
        details[f"left_out.{net}"] = sorted(set(rg) - set(keep))
        # the change of the parameters and, for G, of its EMA
        for tree, name in ((net, "change_gap"),) + (
                (("ema", "ema_gap"),) if net == "g" else ()):
            pc = _norms({k: after[tree][k].float().to(dev) - init[tree][k]
                         for k in keep})
            rc = _norms({k: ref_after[tree][k].detach() - init[tree][k]
                         for k in keep})
            cg = _leaf_gaps(pc, rc, keep)
            out[name] = max(out[name], max(cg.values()))
            details[f"{name}s.{tree}"] = cg
    out["median_grad_gap"] = statistics.median(grad_gaps)
    details["grad_gap"] = max(grad_gaps)
    return out, details
