"""The trained agents' skill gap on generated against corpus levels: port
of ``levelgan/lio/skillgap.py``.

A curriculum checkpoint holds its strong and weak agent (tile family) or
driver (track family).  Both play ``n`` generated and ``n`` corpus levels
(or tracks) for the config's T steps; the report gives each set's mean
returns and playability and their gaps, and ``separation``: the
generated levels' return gap less the corpus's (positive: the generator's
levels separate the agents better than ordinary levels do).

Tile levels: ``env/sim.rollout`` on the encoded levels, playability the
share that reached GOAL.  Tracks: ``track/race.race_rollout``,
playability the mean progress / T (laps-equivalent) and the mean crash
count beside it.

Each level set runs on ``device`` with no host sync inside a rollout
(``env_tables`` is made once a rollout); only the summary floats cross to
the host, once a set.  The rollouts' Gumbel noise is drawn from a
``torch.Generator`` seeded by ``seed``, the same for both sets (the JAX
package draws both sets' from one key), or injected (``noise``).
"""

from __future__ import annotations

import numpy as np
import torch

from levelgan_torch.config import Config
from levelgan_torch.data.codec import encode
from levelgan_torch.device import resolve_device
from levelgan_torch.env.sim import N_ACTIONS as TILE_ACTIONS
from levelgan_torch.env.sim import rollout
from levelgan_torch.ops.gumbel import gumbel_noise
from levelgan_torch.track.race import N_ACTIONS as RACE_ACTIONS
from levelgan_torch.track.race import race_rollout
from levelgan_torch.track.train import race_params
from levelgan_torch.train.curriculum import env_params

AGENTS = ("strong", "weak")


def draw_rollout_noise(cfg: Config, batch: int, device,
                       seed: int = 0) -> dict[str, torch.Tensor]:
    """The two rollouts' Gumbel noise [T, batch, actions], strong then
    weak, from one generator seeded by ``seed``."""
    n = RACE_ACTIONS if cfg.model.family == "track" else TILE_ACTIONS
    rng = torch.Generator(device).manual_seed(seed)
    shape = (cfg.curriculum.rollout_steps, batch, n)
    return {who: gumbel_noise(shape, device=device, generator=rng)
            for who in AGENTS}


@torch.no_grad()
def play_levels(cfg: Config, state, levels: torch.Tensor,
                noise: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The two agents' results a level ([n] tensors on the set's device):
    ``return_*``, ``playable_*`` (reached GOAL, or progress / T) and, for
    tracks, ``crashes_*``."""
    agents = {"strong": state.agent_strong, "weak": state.agent_weak}
    out = {}
    if cfg.model.family == "track":
        rp = race_params(cfg)
        for who, policy in agents.items():
            traj = race_rollout(policy, levels, rp, noise=noise[who])
            out[f"return_{who}"] = traj.total_return
            out[f"playable_{who}"] = traj.progress / levels.shape[1]
            out[f"crashes_{who}"] = traj.crashes
        return out
    ep = env_params(cfg)
    onehot = encode(levels, cfg.model.n_tiles)
    for who, policy in agents.items():
        traj = rollout(policy, levels, onehot, ep, noise=noise[who])
        out[f"return_{who}"] = traj.total_return
        out[f"playable_{who}"] = traj.reached
    return out


def score_levels(cfg: Config, state, levels: torch.Tensor,
                 noise: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``play_levels``' means over the set (0-d tensors on its device)."""
    return {k: v.float().mean()
            for k, v in play_levels(cfg, state, levels, noise).items()}


def _score(cfg: Config, state, levels: np.ndarray, device, seed: int,
           noise) -> dict:
    x = torch.from_numpy(np.ascontiguousarray(levels)).to(device)
    if noise is None:
        noise = draw_rollout_noise(cfg, x.shape[0], device, seed)
    else:
        noise = {k: v.to(device) for k, v in noise.items()}
    means = score_levels(cfg, state, x, noise)
    # the one transfer of the set: its summary floats
    out = dict(zip(means, torch.stack(list(means.values())).tolist()))
    out["return_gap"] = out["return_strong"] - out["return_weak"]
    out["playable_gap"] = out["playable_strong"] - out["playable_weak"]
    return out


def skill_gap_report(cfg: Config, state, gen_levels: np.ndarray,
                     corpus_levels: np.ndarray, *, seed: int = 0,
                     device=None, noise=None) -> dict:
    """The skill gap of ``state``'s agents (a ``CurriculumState``) on the
    generated against the corpus levels (host arrays): ``{"generated",
    "corpus", "separation", "playable_separation"}``.  ``noise``:
    ``{"strong", "weak"}`` Gumbel noise [T, n, actions] for both sets (of
    the same size), else drawn from ``seed``."""
    if getattr(state, "agent_strong", None) is None:
        raise ValueError("checkpoint has no trained agents "
                         "(not a curriculum run)")
    dev = resolve_device(device)
    gen = _score(cfg, state, gen_levels, dev, seed, noise)
    corpus = _score(cfg, state, corpus_levels, dev, seed, noise)
    return {
        "generated": gen,
        "corpus": corpus,
        "separation": gen["return_gap"] - corpus["return_gap"],
        "playable_separation": gen["playable_gap"] - corpus["playable_gap"],
    }
