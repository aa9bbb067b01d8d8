"""Typed configuration tree + the named presets (the port's own copy).

A field-for-field copy of ``levelgan/config.py``: the same dataclasses, the
same presets and the same ``to_dict``/``from_dict``, so a checkpoint
manifest written by either package parses in the other.  The port keeps
its own copy instead of importing the JAX package.  Fields the port does
not read yet (training, curriculum, mesh) are kept so manifests round-trip.

Port notes: ``model.dtype`` is the activation dtype on the GPU (params stay
f32); ``model.use_pallas`` is carried for manifest compatibility only — the
port's stage kernels run on every CUDA tensor whatever it says.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


# Tile vocabulary shared by the synthetic corpus and the playability env.
EMPTY, WALL, START, GOAL, HAZARD, COIN = 0, 1, 2, 3, 4, 5
TILE_NAMES = ("empty", "wall", "start", "goal", "hazard", "coin", "sand", "ice")


@dataclass(frozen=True)
class ModelConfig:
    family: str = "tile"          # 'tile' (grid levels) | 'track' (race tracks)
    level_size: int = 16          # square H = W tile grid
    n_tiles: int = 8              # tile vocabulary size (one-hot channels)
    # track family (SURVEY.md R2's recurrent segment emitter):
    n_segments: int = 32          # segments per track
    rnn_hidden: int = 128         # GRU hidden width of the segment emitter
    latent_dim: int = 64
    base_channels: int = 64       # channels of the last (widest-resolution) G stage
    max_channels: int = 512
    norm: str = "group"           # 'group' (stateless, kernel-fusable) | 'none'
    group_size: int = 16          # channels per GroupNorm group
    leaky_slope: float = 0.2
    # Output head: 'softmax' (vanilla/wgan) or 'gumbel' (discrete ST sampling)
    head: str = "softmax"
    tau_start: float = 2.0        # Gumbel temperature anneal: tau_start -> tau_end
    tau_end: float = 0.5
    tau_anneal_steps: int = 2000
    # Conditioning (config 4): 0 = unconditional; >0 = feature-vector dim
    cond_dim: int = 0
    cond_embed_dim: int = 32
    # How the CRITIC consumes the condition (the generator always uses
    # embed+FiLM).  'concat' broadcasts the embedding to H x W and stacks it
    # as input channels — the reference-shaped choice, but every critic conv
    # in fwd/bwd/GP-double-bwd then pays for cond_embed_dim extra channels
    # at full resolution.  'projection' (Miyato & Koyama 2018) scores
    # D(x,c) = psi(phi(x)) + <W_p embed(c), sum_hw phi(x)>: the trunk stays
    # unconditional and the condition enters as one inner product at the
    # head — measured step-time numbers for both in BASELINE.md.
    cond_mode: str = "concat"
    critic_base_channels: int = 64
    # Minibatch-stddev feature in the critic (ProGAN, Karras et al. 2018):
    # batch statistics as an extra channel, making CROSS-SAMPLE collapse
    # visible to the adversarial game — the structural lever for the
    # measured placement collapse no per-sample critic can see
    # (BASELINE.md round 3).  '' = off (reference-shaped critic);
    # 'trunk' = one scalar (mean batch stddev of the 4x4 trunk features)
    # tiled at the trunk end — measured NOT to fix placement (position is
    # pooled away by then); 'input' = the per-POSITION batch stddev
    # (mean over tile channels) appended as an input channel, so "START
    # sits on the same cells in every fake level" is a spatially resolved
    # feature the real/fake boundary can use.  Note: couples per-sample
    # scores through the batch, so the WGAN-GP penalty's per-sample
    # gradient norms gain cross-terms (standard practice accepts this;
    # R1/BCE unaffected).
    critic_mbstd: str = ""
    # Track family only (round 4): apply the exact heading-closure
    # projection (track/ops.closure_project — differentiable: arithmetic +
    # clip) INSIDE TrackGenerator.__call__, so the critic and the
    # curriculum train on the same closed-loop distribution the export
    # path ships (raw-emitter closure_ok is 0.29-0.43 while export
    # projects to 1.0 — the critic otherwise trains on tracks export
    # never emits; BASELINE.md "Track-family quality").  False = round-3
    # behavior (projection at export only).
    closure_in_model: bool = False
    # Tile family only (round 5): 'spatial' realizes the corpus's
    # exactly-one START/GOAL invariant IN THE MODEL — the trunk's
    # structural channels become per-position logits from which ONE
    # START and ONE GOAL cell are drawn (spatial softmax / Gumbel-ST over
    # the H*W cells), composed differentiably with the non-structural
    # tile sample.  The tile-family analogue of track's closure_in_model:
    # the critic trains on the invariant-holding distribution export
    # ships, instead of approaching it through the presence-loss
    # transient (BASELINE.md round-5 fine-tune matrix: no excess/mbstd
    # schedule held KL + exactly-one + solvable + spread at once).
    # 'none' = round-4 behavior.  Composes with train.w_presence: the
    # count/concentration/excess hinges vanish by construction and only
    # the batch spread term stays active.
    structural_head: str = "none"
    dtype: str = "bfloat16"       # activation dtype on the device; params stay f32
    use_pallas: bool = False      # JAX package's kernel switch; ignored by the port
    # K2 gradient-penalty implementation when use_pallas=True:
    #   'auto'  — pick the fastest measured variant for this shape
    #   'fused' — stage-(c) fused critic-forward+input-grad kernel
    #   'core'  — stage-(b) penalty-core kernel around an XLA inner grad
    #   'xla'   — pure-XLA oracle path (K1 stays Pallas)
    pallas_gp: str = "auto"

    def __post_init__(self):
        if self.pallas_gp not in ("auto", "fused", "core", "xla"):
            raise ValueError(
                f"model.pallas_gp must be 'auto'|'fused'|'core'|'xla', "
                f"got {self.pallas_gp!r}")
        if self.cond_mode not in ("concat", "projection"):
            raise ValueError(
                f"model.cond_mode must be 'concat'|'projection', "
                f"got {self.cond_mode!r}")
        if str(self.critic_mbstd) in ("True", "False", "true", "false"):
            # the knob shipped briefly as a bool (round-3 history);
            # checkpoints saved with it must stay loadable
            object.__setattr__(
                self, "critic_mbstd",
                "trunk" if str(self.critic_mbstd).lower() == "true" else "")
        if self.critic_mbstd not in ("", "trunk", "input"):
            raise ValueError(
                f"model.critic_mbstd must be ''|'trunk'|'input', "
                f"got {self.critic_mbstd!r}")
        if self.closure_in_model and self.family != "track":
            raise ValueError("model.closure_in_model is track-family only "
                             "(heading-closure projection); tile grids have "
                             "no loop to close")
        if self.structural_head not in ("none", "spatial"):
            raise ValueError(
                f"model.structural_head must be 'none'|'spatial', "
                f"got {self.structural_head!r}")
        if self.structural_head == "spatial" and self.family != "tile":
            raise ValueError("model.structural_head is tile-family only "
                             "(START/GOAL cells); tracks have no tiles")


@dataclass(frozen=True)
class TrainConfig:
    loss: str = "gan"             # 'gan' (non-saturating BCE) | 'wgan_gp'
    batch_size: int = 64          # GLOBAL batch (sharded over the mesh)
    steps: int = 100
    lr_g: float = 2e-4
    lr_d: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    n_critic: int = 5             # critic updates per generator update (wgan_gp)
    gp_lambda: float = 10.0
    # R1 gradient penalty on reals for the BCE GAN (loss='gan'); 0 = off
    # (reference-default behavior). The plain BCE GAN oscillates on discrete
    # tile data; r1_gamma ~ 0.1-1.0 damps it (measured in BASELINE.md).
    r1_gamma: float = 0.0
    # Structural-tile presence prior on the generator (ops/presence.py):
    # hinge penalty on each level's expected START/GOAL count, differentiable
    # through the relaxed sample. 0 = off (reference-shaped objective). The
    # in-training fix for the rare-tile mode-drop the quality eval exposes
    # (BASELINE.md "Sample quality"); tile family only.
    w_presence: float = 0.0
    # Weight of the presence prior's batch-placement SPREAD term (round-3
    # fix for the measured positional collapse: concentration alone sends
    # structural chi2/dof 7.6 -> 846 — BASELINE.md "Sample quality").
    # Only active when w_presence > 0; 0 recovers the round-2 prior.
    presence_spread: float = 1.0
    # Weight of the presence prior's EXCESS hinge (round 4): penalize each
    # level's structural-tile mass beyond its single best cell
    # (relu(count - max)^2), enforcing the corpus's EXACTLY-one START/GOAL
    # invariant that the one-sided hinges leave free (measured ~1.7
    # STARTs/level, one_start_frac 0.017-0.073 — BASELINE.md round 3).
    # Only active when w_presence > 0; 0 recovers the round-3 prior.
    presence_excess: float = 0.0
    # ---- round-5 fine-tune transient levers (VERDICT r4 item 1).  The
    # round-4 phase schedule (mbstd pair -> excess fine-tune) reached the
    # first sub-150 in-training structural chi2 but its endpoints landed
    # mid-re-convergence of the mbstd/wdist phase; these ride the
    # transient out instead of stepping into it.
    # Step at which the excess hinge ENGAGES (0 = from the start) and the
    # linear ramp length over which its weight rises 0 -> presence_excess
    # after that (0 = step function, the round-4 behavior).
    presence_excess_start: int = 0
    presence_excess_ramp: int = 0
    # Linearly fade the critic's minibatch-stddev channel 1 -> floor over
    # [mbstd_anneal_start, +mbstd_anneal_steps) so the excess phase stops
    # re-triggering the mbstd critic's high-wdist response to structural
    # placement movement.  The floor holds a PARTIAL fade indefinitely
    # (0.0 = fade out entirely; measured round 5: a full fade trades the
    # pair's placement spread away like the no-mbstd cell).  0 steps =
    # off; wgan_gp loss only.
    mbstd_anneal_start: int = 0
    mbstd_anneal_steps: int = 0
    mbstd_anneal_floor: float = 0.0
    # Freeze the critic (params + opt state) before this step — a
    # stationary-critic window for the generator to adapt to the excess
    # objective inside.  Meaningful for resumed fine-tunes (set it above
    # the resume step); 0 = off; wgan_gp loss only.
    freeze_critic_until: int = 0
    # Conditioning feature-matching loss (round 3): L2 between the relaxed
    # fake sample's differentiable features (data/features.py
    # soft_level_features) and the condition it was generated under.  The
    # causality eval (tools/eval_cond) measured that the adversarial
    # pairing alone only teaches G the dominant feature (wall_frac) —
    # hazard/coin/goal_dist responses are nearly flat; this gives every
    # requested feature a direct pathwise gradient.  0 = off
    # (reference-shaped objective); conditional (cond_dim > 0) tile
    # models only.
    w_cond_match: float = 0.0
    # Per-dim multipliers on the cond-match residuals (round 4, the
    # training-side attempt at magnitude-true conditioning): comma-
    # separated floats, one per condition dim in data/features.py order
    # (wall_frac,hazard_frac,coin_frac,goal_dist), e.g. "1,8,8,4" boosts
    # the measured-attenuated dims.  "" = all 1.0 (round-3 objective).
    cond_match_dim_weights: str = ""
    # Heading-closure prior on the track generator (track/ops.py
    # closure_penalty): squared error between |sum of curvature| and 2*pi,
    # differentiable pathwise through the tanh-bounded curvature output.
    # 0 = off (reference-shaped objective). The in-training fix for the
    # GRU emitter's accumulated heading error (BASELINE.md "Track-family
    # quality": only ~29-43% of raw loops close); track family only.
    w_closure: float = 0.0
    seed: int = 0
    # Steps executed per device dispatch (lax.scan over the step fn).
    # >1 amortizes host->device dispatch latency; log/ckpt cadence is
    # rounded to multiples of this.
    steps_per_dispatch: int = 1
    # LR schedule: 'none' | 'cosine' (decay to lr*0.01 over `steps`) —
    # stabilizes the vanilla BCE GAN against late-training divergence.
    lr_schedule: str = "none"
    # EMA decay for the generator's export/eval weights (0 disables).
    ema_decay: float = 0.999
    # PRNG implementation for every key the framework creates.
    # 'threefry2x32' (default): layout-invariant randomness — the DP
    # bit-match-vs-single-device guarantee (tests/test_dist.py) holds.
    # 'rbg': XLA RngBitGenerator — measured 6.5x faster per 2M-element
    # gumbel draw on TPU v5e (125 -> 19 us; BASELINE.md round-2 notes);
    # random streams then depend on sharding layout, so cross-mesh-size
    # bit-reproducibility is not guaranteed (same-config determinism and
    # checkpoint resume remain exact).
    prng_impl: str = "threefry2x32"

    def __post_init__(self):
        if self.prng_impl not in ("threefry2x32", "rbg"):
            raise ValueError("train.prng_impl must be 'threefry2x32' or "
                             f"'rbg', got {self.prng_impl!r}")
        if self.w_presence < 0:
            raise ValueError(
                f"train.w_presence must be >= 0, got {self.w_presence}")
        if self.presence_excess < 0:
            raise ValueError(f"train.presence_excess must be >= 0, "
                             f"got {self.presence_excess}")
        if ((self.mbstd_anneal_steps or self.freeze_critic_until)
                and self.loss != "wgan_gp"):
            raise ValueError(
                "train.mbstd_anneal_steps / freeze_critic_until are "
                f"wgan_gp-only levers, got loss={self.loss!r}")
        if self.w_closure < 0:
            raise ValueError(
                f"train.w_closure must be >= 0, got {self.w_closure}")


@dataclass(frozen=True)
class DataConfig:
    corpus: str = "synthetic"     # 'synthetic' | path to .npz of uint8 levels
    # Batch feed path. 'device' (default): the whole corpus is staged into
    # HBM once and each train step samples its minibatch indices ON DEVICE
    # (stateless in (seed, step)), so a training dispatch carries NO per-step
    # host->device data at all — the logical end of the north star's
    # "on-device data pipeline". 'host': per-step uint8 batches are drawn on
    # the host and device_put (for out-of-core corpora; automatic fallback
    # when the corpus exceeds the device-staging budget).
    feed: str = "device"
    corpus_size: int = 4096
    corpus_seed: int = 1234
    augment: bool = True          # random D4 flip/rotate, on-device
    wall_density: float = 0.25    # synthetic corpus knobs
    hazard_rate: float = 0.04
    coin_rate: float = 0.06
    # Fraction of corpus levels whose hazard/coin rate multipliers draw
    # from the top quartile of the [0, 2] band (round 5: widens the
    # conditional family's achievable high-rate response band by making
    # high-rate levels common corpus events — data/dataset.py).  0.0 =
    # round-4 corpus, bit-identical.
    rate_oversample: float = 0.0

    def __post_init__(self):
        if self.feed not in ("device", "host"):
            raise ValueError(
                f"data.feed must be 'device' or 'host', got {self.feed!r}")
        if not 0.0 <= self.rate_oversample <= 1.0:
            raise ValueError(f"data.rate_oversample must be in [0, 1], "
                             f"got {self.rate_oversample}")


@dataclass(frozen=True)
class DistConfig:
    dp: int = 0                   # data-parallel size; 0 = all visible devices
    # Mesh axis names are fixed: ('data',). Batch is sharded on 'data';
    # params are replicated; XLA emits the ICI allreduce (SURVEY.md §2.4).
    # Multi-host (SPMD across slices over DCN): set coordinator_address and
    # num_processes; jax.distributed.initialize runs before the mesh is
    # built and the SAME program spans all hosts' chips.
    coordinator_address: str = ""   # e.g. "10.0.0.1:8476"; "" = single host
    num_processes: int = 1
    process_id: int = -1            # -1 = auto (TPU pods discover it)


@dataclass(frozen=True)
class CurriculumConfig:
    """Agent-in-the-loop adversarial curriculum (config 5, SURVEY.md R7-R9)."""
    rollout_steps: int = 48       # env steps per episode (lax.scan length)
    gamma: float = 0.97
    agent_lr: float = 3e-4
    weak_agent_lr: float = 3e-5   # weak agent learns slowly -> persistent skill gap
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    # Generator REINFORCE reward = w_play*playable(strong) - w_anti*playable(weak)
    #                             + w_gap*(return_strong - return_weak)
    #                             + w_solvable*solvable(level)
    w_play: float = 1.0
    w_anti: float = 0.5
    w_gap: float = 1.0
    # Deterministic solver reward (env/solver.py flood fill): unlike the
    # agent terms it is exact and variance-free, directly rewarding levels
    # whose START->GOAL path exists. 0 = off (reference-shaped reward).
    w_solvable: float = 0.0
    # Solvability reward CEILING (round 4, frontier item): when the batch
    # solvable fraction reaches this target the solvable reward switches
    # off, so the REINFORCE gradient stops pushing playability past the
    # point where it starts eroding skill separation (measured two-point
    # trade: solvable 0.920 at separation -0.168 vs 0.607 at +0.21 —
    # BASELINE.md round 3 / artifacts/quality_curriculum_full.json).
    # 1.0 = no ceiling (round-3 behavior).
    solvable_target: float = 1.0
    # Gate the skill-gap reward term on per-level solvability (round 4,
    # frontier item): reward (return_strong - return_weak) only on levels
    # the exact solver certifies — the direct objective form of
    # "solvable-but-discriminating".  Requires w_solvable > 0 or at least
    # traces the solver; False = round-3 reward shape.
    gap_on_solvable: bool = False
    g_baseline_decay: float = 0.9
    agent_updates_per_step: int = 1
    # Per-cell REINFORCE credit (round 3): weight each cell's logp by the
    # agents' dilated trajectory-visitation instead of spreading the
    # whole-level advantage uniformly over all H*W cells.  Cells the
    # episodes never came near contribute no score-function gradient, so
    # the G update stops paying variance for irrelevant cells — the
    # measured lever against the 0.866 un-repaired solvable ceiling
    # (BASELINE.md round-2 "measured limits"; whole-level credit was the
    # bottleneck).  Off by default (reference-shaped REINFORCE).
    cell_credit: bool = False


@dataclass(frozen=True)
class IOConfig:
    out_dir: str = "runs/default"
    ckpt_every: int = 500
    log_every: int = 25
    keep_ckpts: int = 3
    resume: str = ""              # '' | 'auto' | explicit checkpoint path
    profile: bool = False
    profile_dir: str = ""
    debug_nans: bool = False      # jax_debug_nans (SURVEY.md §5.2 debug mode)
    tensorboard: bool = False     # optional TB scalars (torch SummaryWriter)
    render_every: int = 0         # PNG grid of generated levels every k steps
    # Every k steps, sample fresh levels and log playability scalars
    # (solvable/has_start/has_goal fractions via the on-device flood-fill
    # solver, env/solver.py) into metrics.jsonl. 0 = off. Tile family only.
    quality_every: int = 0
    quality_n: int = 256          # levels per quality probe
    # Also keep the checkpoint with the best probe solvable_frac so far in
    # <out_dir>/ckpt_best (pruned to 1). Playability DECLINES over training
    # as the generator converges to corpus marginals where START/GOAL are
    # ~0.1% rare (measured curve: artifacts/quality_curve_cur_solv.jsonl,
    # 0.82 -> 0.59), so the last checkpoint is rarely the most playable one.
    # Requires quality_every > 0 (tile family).
    keep_best: bool = False
    # Persistent XLA compilation cache directory ('' = disabled; 'auto' =
    # <repo>/.xla_cache).  First compile of a preset costs 20-40s through
    # the dev relay — with pathological days observed at 600s+ — so the
    # cache is ON by default since round 3; warm runs start in seconds
    # (SURVEY.md §5.1 ergonomics; results unaffected — keyed on exact HLO).
    compile_cache: str = "auto"
    # ---- export/repair policy (round 5: factored out of api.py; the
    # measurement history behind each default is in BASELINE.md rounds 3-5).
    # export_repair: 'auto' resolves per family — tile OFF (exported
    # marginals stay loss-identical to the reference-shaped model that the
    # statistical-identity band gates), track ON (exact heading-closure
    # projection strictly dominates shipping raw non-closing loops).
    # Shipped production exports and gates_all's shipped path use
    # repair on + placement 'uniform' (the corpus's own placement law).
    export_repair: str = "auto"                   # 'auto' | 'on' | 'off'
    export_repair_placement: str = "confidence"   # 'confidence' | 'uniform'
    # Exactly-one START/GOAL enforcement whenever tile repair is active
    # (round 5): 'auto' = on — the corpus's exactly-one invariant ships by
    # construction (duplicate structural tiles demoted to the model's
    # next-best non-WALL tile, ops/repair.py). 'off' = round-4 behavior
    # (repair only places MISSING tiles, duplicates pass through).
    export_exactly_one: str = "auto"              # 'auto' | 'on' | 'off'

    def __post_init__(self):
        if self.keep_best and not self.quality_every:
            raise ValueError("io.keep_best requires io.quality_every > 0 "
                             "(the probe provides the selection metric)")
        if self.export_repair not in ("auto", "on", "off"):
            raise ValueError("io.export_repair must be 'auto'|'on'|'off', "
                             f"got {self.export_repair!r}")
        if self.export_repair_placement not in ("confidence", "uniform"):
            raise ValueError("io.export_repair_placement must be "
                             "'confidence'|'uniform', "
                             f"got {self.export_repair_placement!r}")
        if self.export_exactly_one not in ("auto", "on", "off"):
            raise ValueError("io.export_exactly_one must be 'auto'|'on'|"
                             f"'off', got {self.export_exactly_one!r}")


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    dist: DistConfig = field(default_factory=DistConfig)
    curriculum: CurriculumConfig = field(default_factory=CurriculumConfig)
    io: IOConfig = field(default_factory=IOConfig)
    preset: str = "custom"

    # ---- serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, dict):
                fields = {f.name: f for f in dataclasses.fields(tp)}
                kwargs = {}
                for k, v in val.items():
                    if k not in fields:
                        raise KeyError(f"unknown config key: {tp.__name__}.{k}")
                    ftype = fields[k].type
                    ftype = _resolve(ftype)
                    kwargs[k] = build(ftype, v)
                return tp(**kwargs)
            return val

        return build(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    # ---- overrides ---------------------------------------------------------
    def override(self, **dotted: Any) -> "Config":
        """Return a new Config with dotted-key overrides applied.

        ``cfg.override(**{"train.steps": 500, "model.use_pallas": True})``
        """
        d = self.to_dict()
        for key, value in dotted.items():
            node = d
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"unknown config section: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"unknown config key: {key}")
            node[leaf] = _coerce(type(node[leaf]), value)
        return Config.from_dict(d)


_TYPES = {
    "ModelConfig": ModelConfig, "TrainConfig": TrainConfig,
    "DataConfig": DataConfig, "DistConfig": DistConfig,
    "CurriculumConfig": CurriculumConfig, "IOConfig": IOConfig,
}


def _resolve(tp):
    if isinstance(tp, str):
        return _TYPES.get(tp, tp)
    return tp


def _coerce(tp, value):
    if value is None or isinstance(value, tp):
        return value
    if tp is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    return tp(value)


# ---- the five BASELINE.json presets ----------------------------------------

def preset(name: str) -> Config:
    """Named presets covering BASELINE.json's five configs (SURVEY.md §0)."""
    presets = {
        # 1. Toy DCGAN: 16x16 one-hot tile grid, batch 64, 100 steps.
        "toy_dcgan_16": Config(
            preset="toy_dcgan_16",
            model=ModelConfig(level_size=16),
            train=TrainConfig(loss="gan", batch_size=64, steps=100,
                              steps_per_dispatch=50),
        ),
        # 2. WGAN-GP on 32x32 tile levels (fused GP double-backward kernel).
        "wgan_gp_32": Config(
            preset="wgan_gp_32",
            model=ModelConfig(level_size=32),
            train=TrainConfig(loss="wgan_gp", batch_size=64, steps=2000,
                              steps_per_dispatch=50,
                              lr_g=1e-4, lr_d=1e-4, beta1=0.0, beta2=0.9),
        ),
        # 2b. WGAN-GP with the exactly-one structural invariant IN the
        # model (round 5): spatial START/GOAL head + Gumbel-ST tile
        # sampling + the batch spread hinge (the only presence term still
        # active under this head).  The measured operating point that
        # holds every quality property at once ON THE RAW SAMPLE PATH —
        # KL 0.0002, structural chi2/dof 1.6, solvable 0.96, exactly-one
        # 1.0 by construction, diversity corpus-identical — where no
        # presence-loss schedule ever did (BASELINE.md round-5 structural
        # head; artifacts/quality_sh_nombstd.json).
        "wgan_gp_32_structural": Config(
            preset="wgan_gp_32_structural",
            model=ModelConfig(level_size=32, head="gumbel",
                              structural_head="spatial"),
            train=TrainConfig(loss="wgan_gp", batch_size=64, steps=3000,
                              steps_per_dispatch=50, w_presence=10.0,
                              lr_g=1e-4, lr_d=1e-4, beta1=0.0, beta2=0.9),
        ),
        # 3. Gumbel-softmax discrete generator at 64x64, on-device pipeline.
        "gumbel_64": Config(
            preset="gumbel_64",
            model=ModelConfig(level_size=64, head="gumbel"),
            train=TrainConfig(loss="wgan_gp", batch_size=64, steps=5000,
                              steps_per_dispatch=50,
                              lr_g=1e-4, lr_d=1e-4, beta1=0.0, beta2=0.9),
        ),
        # 4. Conditional generator (difficulty/feature conditioning) + export CLI.
        # Round-4 default flip (VERDICT r3 weak 3, measured): projection
        # conditioning + the calibrated cond-match weight.  vs the concat
        # shape: 23% faster step (2.97 vs 3.85 ms), identity gate KL 0.0020
        # vs 0.0022 at matched chi2 (artifacts/validate_conditional_proj
        # .json, corpus-mean cond), and BETTER causality (min per-dim
        # r 0.954 vs 0.899, artifacts/eval_cond_32_proj.json).  The
        # reference-shaped concat path remains one override away
        # (--set model.cond_mode=concat --set train.w_cond_match=0).
        "conditional_32": Config(
            preset="conditional_32",
            model=ModelConfig(level_size=32, head="gumbel", cond_dim=4,
                              cond_mode="projection"),
            # Round-5 shipped knobs: the measured-attenuated dims'
            # cond-match residuals boosted (round-4 dim-boost) AND the
            # conditional corpus's high-hazard/high-coin quantiles
            # oversampled at the measured-best 0.3 dose — calibrated
            # user-space slopes wall 0.97 / hazard 0.78 / coin 0.87 /
            # goal 0.80 at identity KL 0.0021 (dose 0.5 SATURATES:
            # hazard 0.75 — BASELINE.md round 5, the recorded
            # dose-response).  Reference-shaped behavior: dim_weights ''
            # + rate_oversample 0.
            train=TrainConfig(loss="wgan_gp", batch_size=64, steps=5000,
                              steps_per_dispatch=50, w_cond_match=1.0,
                              cond_match_dim_weights="1,8,8,4",
                              lr_g=1e-4, lr_d=1e-4, beta1=0.0, beta2=0.9),
            data=DataConfig(rate_oversample=0.3),
        ),
        # 5. Agent-in-the-loop adversarial curriculum, data-parallel mesh.
        "curriculum_16": Config(
            preset="curriculum_16",
            model=ModelConfig(level_size=16, head="gumbel"),
            train=TrainConfig(loss="curriculum", batch_size=64, steps=3000,
                              n_critic=3, steps_per_dispatch=50,
                              lr_g=1e-4, lr_d=1e-4, beta1=0.0, beta2=0.9),
            curriculum=CurriculumConfig(),
        ),
        # 5b. The measured JOINT operating point of the solvability x
        # skill-separation frontier (BASELINE.md round-4 frontier table,
        # arm f7): solvable-reward ceiling + solver-gated gap reward +
        # w_gap=5 yields levels that are BOTH playable (solvable ~0.90
        # +- 0.01 across seeds) AND skill-separating (separation ~+0.20)
        # — the framework's signature capability one --preset away
        # (VERDICT r4 item 4).  curriculum_16 above stays
        # reference-shaped (agent-derived reward only).
        "curriculum_16_joint": Config(
            preset="curriculum_16_joint",
            model=ModelConfig(level_size=16, head="gumbel"),
            train=TrainConfig(loss="curriculum", batch_size=64, steps=3000,
                              n_critic=3, steps_per_dispatch=50,
                              w_presence=10.0,
                              lr_g=1e-4, lr_d=1e-4, beta1=0.0, beta2=0.9),
            curriculum=CurriculumConfig(cell_credit=True, w_solvable=2.0,
                                        solvable_target=0.9,
                                        gap_on_solvable=True, w_gap=5.0),
        ),
        # Extra model family (SURVEY.md R2 reconstruction): recurrent
        # segment-emitter race tracks + car-kinematics curriculum.
        # Round-4 default: closure projection INSIDE the forward, so the
        # critic trains on the closed-loop distribution export ships.
        # Measured A/B (artifacts/quality_track_cim.json vs the round-3
        # export-projection baseline): closure_ok 1.0 by construction,
        # curvature KL 0.052 vs 0.059, kappa-diversity 0.240 vs 0.259
        # (-7%; the in-training w_closure prior cost 2.5x).  The
        # curriculum preset keeps it OFF: one measured run showed a -32%
        # skill-separation cost there (BASELINE.md round 4).
        "racetrack_32": Config(
            preset="racetrack_32",
            model=ModelConfig(family="track", n_segments=32, latent_dim=32,
                              closure_in_model=True),
            train=TrainConfig(loss="wgan_gp", batch_size=64, steps=3000,
                              steps_per_dispatch=50,
                              lr_g=1e-4, lr_d=1e-4, beta1=0.0, beta2=0.9),
        ),
        "race_curriculum_32": Config(
            preset="race_curriculum_32",
            model=ModelConfig(family="track", n_segments=32, latent_dim=32),
            train=TrainConfig(loss="curriculum", batch_size=64, steps=3000,
                              n_critic=3, steps_per_dispatch=50,
                              lr_g=1e-4, lr_d=1e-4, beta1=0.0, beta2=0.9),
            curriculum=CurriculumConfig(rollout_steps=64),
        ),
    }
    if name not in presets:
        raise KeyError(f"unknown preset '{name}'; available: {sorted(presets)}")
    return presets[name]


PRESET_NAMES = ("toy_dcgan_16", "wgan_gp_32", "wgan_gp_32_structural",
                "gumbel_64",
                "conditional_32", "curriculum_16", "curriculum_16_joint",
                "racetrack_32", "race_curriculum_32")


def load_config(path: str | None = None, preset_name: str | None = None,
                overrides: dict[str, Any] | None = None) -> Config:
    """Build a Config from (preset | YAML/JSON file) + dotted overrides."""
    if path:
        with open(path) as f:
            text = f.read()
        try:
            d = json.loads(text)
        except json.JSONDecodeError:
            import yaml
            d = yaml.safe_load(text)
        cfg = Config.from_dict(d)
    elif preset_name:
        cfg = preset(preset_name)
    else:
        cfg = Config()
    if overrides:
        cfg = cfg.override(**overrides)
    return cfg
