"""Faults planted in the timed path, for the control readings and tests.

Each is a context manager that breaks the program underneath the
harness's run, by patching the module attribute the path calls:

- ``altered_tile``: the export's batch comes out with one level's first
  tile's lowest bit flipped (an answer altered where it is produced);
- ``half_batch``: the train step sees only the first half of each batch
  (and of its draws), its means taken over that half;
- ``frozen_step``: the train step returns its state unchanged;
- ``frozen_ema``: the step leaves G's EMA unchanged;
- ``live_ema``: the step's EMA update uses the decay 0 (the EMA is the
  live parameters).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def altered_tile():
    from levelgan_torch import export

    def make(old):
        def generate_batch(*args, **kw):
            out = old(*args, **kw).clone()
            flat = out.reshape(-1)      # ids, or their bit planes
            flat[0] = flat[0] ^ 1
            return out
        return generate_batch
    return _patched(export, "generate_batch", make)


def _half(tree, axis):
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.narrow(axis, 0, tree.shape[axis] // 2)
    if isinstance(tree, dict):
        return {k: _half(v, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_half(v, axis) for v in tree)
    return tree


def half_batch():
    from levelgan_torch import api

    def make(old):
        def make_step_fn(cfg, *a, **kw):
            step = old(cfg, *a, **kw)

            def half_step(state, batch, noise=None, **k):
                return step(state, _half(batch, 1), noise=_half(noise, 0),
                            **k)
            return half_step
        return make_step_fn
    return _patched(api, "make_step_fn", make)


def frozen_step():
    from levelgan_torch import api

    def make(old):
        def make_step_fn(cfg, *a, **kw):
            step = old(cfg, *a, **kw)

            def frozen(state, batch, noise=None, **k):
                import torch
                kept = [(p, p.detach().clone()) for n in
                        ("generator", "critic", "g_ema")
                        for p in getattr(state, n).parameters()]
                state, metrics = step(state, batch, noise=noise, **k)
                with torch.no_grad():
                    for p, old in kept:
                        p.copy_(old)
                return state, metrics
            return frozen
        return make_step_fn
    return _patched(api, "make_step_fn", make)


def frozen_ema():
    from levelgan_torch.train import wgan_gp
    return _patched(wgan_gp, "update_ema",
                    lambda old: lambda cfg, ema, params, step: None)


def live_ema():
    from levelgan_torch.train import wgan_gp

    def make(old):
        def update_ema(cfg, ema, params, step):
            old(cfg.override(**{"train.ema_decay": 0.0}), ema, params, step)
        return update_ema
    return _patched(wgan_gp, "update_ema", make)


FAULTS = {"altered_tile": altered_tile, "half_batch": half_batch,
          "frozen_step": frozen_step, "frozen_ema": frozen_ema,
          "live_ema": live_ema}
