#!/usr/bin/env python3
"""GPU smoke run of the levelgan_torch port: ``python3 chip_smoke.py``.

Needs one CUDA card (exits non-zero without one, and without the
``levelgan_torch`` package beside it).  Phases, each fatal on failure:

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ``levelgan_torch/csrc`` (parallel nvcc);
3. forward kernel parity + timing at each gumbel_64 stage shape,
   B = 1024, bf16: each kernel against its plain PyTorch version (max abs
   error against a stated bf16 tolerance), kernel / plain / library-call
   median times (CUDA events, warm-up excluded) and the roofline bound;
   for K1 also the chosen tile and the first block's phases; for the K1L
   stage (at up3 and at up2 as a second shape) its cluster and grid, its
   residual mode (yf, mu, rstd) against the plain version and two calls
   compared bit for bit; then the K1L stage as the generator calls it at
   B = 1024 and 64 beside the library chain, with the device kernels of one
   call by name (only the stage kernel may run); the fused sampling head
   (phase ``head``) at [1024, 64, 64, 8] f32: bit for bit against its
   plain version and ``decode(sample_head(...))``, its time beside its
   byte bound, the plain version's and the old chain's;
4. the export path: a gumbel_64 generator with seeded random weights is
   written as a FORMAT.md checkpoint and exported through the port's CLI
   (65,536 levels at batch 1024); the levels are checked, the kernels'
   launch counters must show every batch went through them, and one batch
   through the kernels is held against the plain path on the card; the
   warm export timed packed and unpacked (identical arrays; the default
   ``pack=None`` must take the faster), with each batch's device time,
   wall time, D2H and the native and NumPy unpack times;
   the repaired export (``--repair --exactly-one``, both placements): one
   START and one GOAL in every level, every level solvable by the port's
   solver unless it kept an unreachable GOAL of the raw sample, a NumPy
   BFS agreeing with the solver on 256 levels, the card's repair of a batch equal to the
   CPU's bit for bit, levels/s beside the unrepaired export, the solver's
   dilations and ms a batch, the quality report and KL gate against the
   corpus; the conditioned export (conditional_32 through the CLI with
   ``--cond``, ``--calibrated`` and the corpus-mean default: K1 on every
   stage, the kernel generator against the plain one with a cond); the
   racetrack_32 export (65,536 tracks through the CLI at batch 1024, the
   closure repair on the card: every track closed within CLOSURE_TOL and
   inside the physical ranges, no kernel launched, an f32 batch on the
   card against the CPU's), with tracks/s, a batch's CUDA-event span and
   its D2H;
5. a torch.profiler breakdown of one export batch (device time by kernel,
   the port's kernels and PyTorch's own, device idle share) and of a whole
   streamed ``generate()`` (kernels against wall, the D2H copies);
6. training kernel parity + timing at the training shapes (B = 64) of
   gumbel_64, wgan_gp_32 and toy_dcgan_16 (K1 at its two stages): K1
   forward, the K1L stage with residuals and
   K1 bwd (whole and by launch, on residuals from K1 forward; at gumbel_64
   up2 the dx launch also at several placements of its buffers) at every
   stage they serve,
   K1L bwd (the whole backward: dx, dyf, dgamma, dbeta on residuals from
   the stage kernel, two calls bit for bit; beside it gn_act_bwd_folded,
   dw and the whole UpsampleRowsFn.backward, the first block's phases, and
   the ATen operations of one backward call: exactly dw's and the
   wrapper's) at gumbel_64 up3 and up2, the general K1L bwd kernel at two
   shapes the staged one does not take and at gumbel_64 up3 beside the
   staged one (with the library chain's time), and K2
   fused (the critic trunk's forward and input gradient) at
   the 32x32 and 16x16 critics, with GroupNorm off and with group size 8
   (timed with its weight pack, as training calls it; the pack alone, its
   bits against ``pack_weights_plain``, the cluster, grid and ring, one
   sample alone, the L2 weight stream and the first block's phases);
   each against its plain version, with kernel / plain / library device
   times (CUDA events around calls queued behind a spin kernel,
   ``queued_ms``) and bounds; and the gradient-penalty implementations
   (plain, K2 core, fused) timed whole;
   then K2 core fwd / bwd on [64, 32768], [64, 8192], [64, 2048] and
   [64, 64] (the track critic's g, 32 segments x 2) f32
   against their plain versions (forward twice, bit for bit; backward
   also with a stride-0 cotangent), each with the launch floor of
   ``queued_ms``, its L2-cold time and its plan, and the ATen operations
   and device kernels of one ``NormPenalty.backward`` (only the kernel's
   output may be allocated);
7. the training paths through ``levelgan_torch.cli.train`` (corpus cut to
   256 levels): gumbel_64 for 10 steps (with the quality probe every 5
   steps and ``io.keep_best``, and ``io.render_every`` 5: two renders of
   the EMA through K1 fwd and the K1L stage), wgan_gp_32 with
   ``model.pallas_gp=fused`` for 30, wgan_gp_32_structural with it for
   10, toy_dcgan_16 (the BCE GAN step; the CLI's default preset, run
   without ``--preset``) for its 100, conditional_32 (the conditional
   WGAN-GP step with the cond-match loss) for 10, curriculum_16 (the
   curriculum step, K2 core, the quality probe every 5 steps) for 10 and
   curriculum_16_joint with the fused GP for 10, racetrack_32 and
   race_curriculum_32 for 10 each on their whole track corpus, each with
   checked
   metrics, checkpoint keys (the curriculum's agents, their Adams and the
   baseline too) and launch counters (and no call of the plain
   gn_act_bwd_folded on a CUDA tensor), then 1,024 levels exported from
   each checkpoint;
8. one critic iteration and one generator update through the kernels held
   against the plain path (``plain=True``, plain GP) on the same state,
   batch and noise, at gumbel_64 (K2 core) and at wgan_gp_32 (fused GP):
   the losses, the GP and the critic's gradients against the plain path,
   each side's generator gradients against an f32 copy of the generator;
   every generator parameter must get a non-zero gradient; then one whole
   curriculum_16 step through the kernels, through the plain path and
   through an f32 generator, from one state, batch and set of draws (the
   agents' action noise included): tiles, losses, generator gradients
   and the agents' updates (``curriculum_vs_plain``); then one whole
   racetrack_32 and one race_curriculum_32 step through the K2 core and
   through the plain GP from one state, batch and set of draws
   (``track_vs_plain``: losses, every critic update's and the generator's
   gradients, the drivers' updates by cosine);
9. the warm step time from a device-synchronised loop of the same step,
   and a torch.profiler breakdown of training steps (device time by kernel,
   idle share, host time by op), for gumbel_64, wgan_gp_32,
   curriculum_16, racetrack_32 and race_curriculum_32, the curricula with
   their two rollouts' host time and span and one rollout's device
   operations (the first rollout under ``set_sync_debug_mode('error')``);
9b. the pair_drift phase: BASELINE.md's mbstd pair (wgan_gp_32, the
    softmax head, ``train.w_presence=10``, ``model.critic_mbstd=input``,
    bf16) and its control trained 8 injected steps from one seeded state
    on the card and on the CPU; each step's loss deviations and the
    update's deviation at the end, the pair's held to PAIR_DRIFT_FACTOR
    times the control's (B cut to 16 where the CPU would take over 60 s,
    printed); the launches of each arm's card run; the pair's warm step;
9c. the race_drift phase: race_curriculum_32 at full width in bf16 and
    its f32 control, 8 injected steps from one seeded state on the card
    and on the CPU, read as pair_drift's arms (each arm held to its
    RACE_DRIFT_LIMITS), and three faults planted on the card side (a G-loss
    term dropped, the GRU sigmoid rounded once, the REINFORCE advantage 1%
    high), each reading printed on a line of its own (the first two must
    read above the bf16 limits), and cuBLAS's bf16 reductions in f32;
10. reproducibility: a fresh process runs 3 seeded gumbel_64 steps through
    ``api.train`` three times, and its first run must equal its later ones
    in every array (``first_run_check``); then two such runs here, by
    default and under ``torch.use_deterministic_algorithms``, compared
    array by array (and the first differing op named), under torch's own
    TF32 settings, as the CLI runs; then a 2-step run resumed for 1 step
    through ``io.resume=auto`` must equal the uninterrupted run of this
    process bit for bit, so must a CLI run in a fresh process, and a CLI
    run sent SIGTERM after its first step (it must exit 0 with a
    checkpoint before step 3) and finished by ``--resume auto`` must equal
    the uninterrupted CLI run; then racetrack_32 for 3 steps three times in
    a fresh process and twice here, every run equal to every other;
11. the gates phase: curriculum_16 through the CLI for 10 steps with
    ``io.render_every`` 5, ``io.profile`` and ``io.tensorboard`` (two
    renders, a trace naming the port's K1 fwd and K1 bwd kernels, the
    TensorBoard event files or the notice; launches counted); the skill
    gap of its checkpoint's agents on 1,024 repaired levels against 1,024
    corpus levels on the card and through the CPU path with the same
    injected noise (the four means within SKILL_TOL), one rollout under
    ``set_sync_debug_mode('error')``, its wall time; a progress GIF over
    its checkpoints; conditional_32 trained 10 steps, then ``cli/validate
    --fit-calibration`` (the causality gates, verdicts printed; the
    sweeps' wall time and levels/s; K1 fwd at its three stages); the
    native carver's 4,096 levels at 64x64 against the NumPy carver;
12. the data-parallel phase (``dp``): the path's kernels at a dp=4
    rank's batch (B = 16: curriculum_16, gumbel_64 and wgan_gp_32, the
    mbstd pair's shapes) against their plain versions, the launcher at
    world size 1 bit-equal to one process for each arm of ``DP_ARMS``
    (curriculum_16, gumbel_64, BASELINE.md's mbstd pair: wgan_gp_32 with
    ``train.w_presence=10`` and ``model.critic_mbstd=input``, and the
    trunk mode), and with two or more cards each arm at dp=N against
    dp=1, two dp=N runs bit for bit, and the warm step, the collectives a
    step and each rank's idle share;
13. print the ``kernels`` JSON line (the gates phase's launches under
    their paths' names), the card line, and the final
    ``{"ok": true, "device": ...}`` line.

``--phases`` runs a subset (for bring-up); only the full run prints the
contract lines.  ``--dp-arms`` runs a subset of the dp phase's arms
(``DP_ARMS``), as a four-card call of a slice that changes only some.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
L2_BYTES = 50 * 2 ** 20      # H100 SXM L2 cache
B = 1024                     # export batch
N_LEVELS = 65536
# bf16 tolerance of a stage output: 4 bf16 ulps relative plus 2^-6
# absolute.  The kernel normalises the f32 conv tile and rounds once; the
# plain version rounds the conv output to bf16 before GroupNorm, which
# alone moves a normalised value by ~2^-9 of its size.
ATOL, RTOL = 2.0 ** -6, 2.0 ** -6
# whole-generator check, kernels vs plain on the card, same z and noise
LOGIT_TOL = 0.05             # max |dlogit| / max |logit|
HEAD_SCALES = (0.01, 0.1, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0)  # the head's logits
TILE_AGREE = 0.97            # share of identical sampled tiles
# the export's pack=None must pick the faster path, within the spread of
# host-bound levels/s between runs of one tree (10-25%, PERF.md)
PACK_SLACK = 0.8
REPAIR_LEVELS = 16384        # levels per repaired export through the CLI
COND_LEVELS = 8192           # levels per conditional export through the CLI
KL_THRESHOLD = 0.01          # printed beside the KL (random weights fail it)
# training shapes and tolerances
B_TRAIN = 64                 # train.batch_size of every preset trained here
WARM_STEPS = 30
CORPUS_CUT = 256             # data.corpus_size for the smoke run (of 4096)
FUSED = ("--set", "model.pallas_gp=fused")
QUALITY_EVERY = 5            # the gumbel_64 run's quality probe, with keep_best
QUALITY = ("--set", f"io.quality_every={QUALITY_EVERY}", "--set",
           "io.keep_best=true")
RENDER_EVERY = 5             # io.render_every of gumbel_64 and the gates run
RENDER = ("--set", f"io.render_every={RENDER_EVERY}")
# the training paths: (preset, CLI overrides, steps)
TRAIN_RUNS = (("gumbel_64", QUALITY + RENDER, 10),
              ("wgan_gp_32", FUSED, 30),
              ("wgan_gp_32_structural", FUSED, 10), ("toy_dcgan_16", (), 100),
              ("conditional_32", (), 10), ("curriculum_16", QUALITY, 10),
              ("curriculum_16_joint", FUSED, 10), ("racetrack_32", (), 10),
              ("race_curriculum_32", (), 10))
TRACK_PRESETS = ("racetrack_32", "race_curriculum_32")
N_TRACKS = 65536             # tracks of the racetrack_32 export
CLOSURE_TOL = 1e-4           # | |sum kappa| - 2 pi | of a repaired track
# a card batch of f32 tracks against the CPU's, same weights and z (TF32
# off): max |diff| of the curvature
TRACK_TOL = 1e-4
REPRO_CORPUS = 64            # data.corpus_size of the repro phase's runs
REPRO_STEPS = 3              # train.steps of each of the repro phase's runs
# a sum over many bf16 products (dx, dgamma/dbeta): max |diff| / max |ref|
SUM_TOL = 2.0 ** -6
K2_TOL = 1e-5                # K2 core in f32: max rel error
# launches per training step (n_critic 5: five fakes and one generator
# update through the stages, five gradient penalties; no step samples
# through the fused head, which only the export and the probe take)
PER_STEP = {
    "gumbel_64": {"K1": 18, "K1L": 6, "K1 bwd": 3, "K1L bwd": 1,
                  "K2 core fwd": 5, "K2 core bwd": 5, "K2 fused": 0,
                  "head": 0},
    "wgan_gp_32": {"K1": 18, "K1L": 0, "K1 bwd": 3, "K1L bwd": 0,
                   "K2 core fwd": 5, "K2 core bwd": 5, "K2 fused": 5,
                   "head": 0},
}
PER_STEP["wgan_gp_32_structural"] = PER_STEP["wgan_gp_32"]
# the BCE step: D's fake and G's update through the two stages, no GP
PER_STEP["toy_dcgan_16"] = {"K1": 4, "K1L": 0, "K1 bwd": 2, "K1L bwd": 0,
                            "K2 core fwd": 0, "K2 core bwd": 0, "K2 fused": 0,
                            "head": 0}
# the projection critic takes the K2 core ('auto'; fused refuses it)
PER_STEP["conditional_32"] = {**PER_STEP["wgan_gp_32"], "K2 fused": 0}
# the dp phase's mbstd pair (wgan_gp_32 with model.critic_mbstd): 'auto'
# takes the K2 core, as the fused GP refuses an mbstd critic
PER_STEP["mbstd_pair"] = PER_STEP["conditional_32"]
# the curriculum (n_critic 3): three fakes and ONE generator forward (the
# levels the agents play are the G update's fake) through the two stages,
# the G update's backward, three GPs; the agents run no kernel of the port
PER_STEP["curriculum_16"] = {"K1": 8, "K1L": 0, "K1 bwd": 2, "K1L bwd": 0,
                             "K2 core fwd": 3, "K2 core bwd": 3,
                             "K2 fused": 0, "head": 0}
PER_STEP["curriculum_16_joint"] = {**PER_STEP["curriculum_16"],
                                   "K2 fused": 3}
# the track family: no upsample stage and no fused GP; the critic's GP is
# the K2 core over g [64, 32 * 2], once per critic iteration (n_critic 5 for
# racetrack_32, 3 for race_curriculum_32); the GRU emitter, the 1-D conv
# critic and the race sim are plain PyTorch ops
PER_STEP["racetrack_32"] = {"K1": 0, "K1L": 0, "K1 bwd": 0, "K1L bwd": 0,
                            "K2 core fwd": 5, "K2 core bwd": 5,
                            "K2 fused": 0, "head": 0}
PER_STEP["race_curriculum_32"] = {**PER_STEP["racetrack_32"],
                                  "K2 core fwd": 3, "K2 core bwd": 3}
# the curriculum's metrics besides d_loss, g_loss, gp, wdist
CURRICULUM_KEYS = ("g_gan", "g_rl", "playability", "playability_weak",
                   "return_strong", "return_weak", "skill_gap",
                   "agent_entropy")
TRACK_CURRICULUM_KEYS = ("g_gan", "g_rl", "drivability", "drivability_weak",
                         "skill_gap", "crashes", "laps", "agent_entropy")
# kernels vs plain curriculum step: the agents' parameter updates of the two
# sides point the same way (cosine of the two updates), though the levels
# they play differ where a bf16 rounding moves a tile's argmax
AGENT_COS = 0.9
# K2 fused against its plain version, per sample, max |diff| over the sample
# / max |ref| over the batch.  Both round to bf16 at the same points, but
# their f32 sums run in another order, so here and there a conv output
# rounds to the neighbouring bf16, and now and then that pushes a
# GroupNorm output of the last trunk layer across zero: the LeakyReLU mask
# flips, and a patch of that sample's dy0 moves by a few percent (measured
# 0.048 on 3 samples of 64 at the 32x32 critic, on an H100; both sides then
# sit 0.088 from the same chain without intermediate roundings).  So three
# samples in four must be within SUM_TOL, and every sample within FLIP_TOL.
FLIP_TOL = 0.1
# the fused GP against the plain GP in bf16: the kernel rounds the chain to
# bf16 where cuDNN's autograd does, but sums in another order
GP_TOL = 0.02                # |fused - plain| / |plain| of the GP value
# kernels vs plain training on the card (bf16 activations on both sides):
# each critic parameter's gradient, max |diff| / max |ref|, and each loss,
# |diff| / max(|ref|, 0.1)
GRAD_TOL = 0.05
LOSS_TOL = 0.05
# generator gradients through four bf16 stages, each side against an f32
# copy of the generator: kernels <= BF16_RATIO * plain bf16 + BF16_SLACK
BF16_RATIO, BF16_SLACK = 2.0, 0.02
SPIN_CYCLES = 20_000_000     # ~10 ms of SM clock: first spin of queued_ms
# the port's kernels in a profile, by name
OURS = ("upsample_block_fwd_kernel", "upsample_rows_stage_kernel", "k1_bwd_",
        "dx_gather_kernel", "upsample_rows_bwd_kernel", "norm_penalty_",
        "critic_trunk_grad_kernel")


# torch's TF32 settings at start-up (cuDNN, cuBLAS), which main() turns off
TORCH_TF32 = []


class SmokeFailure(RuntimeError):
    pass


def fail(msg: str):
    raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stage_shapes(cfg):
    """(name, input H, Ci, Co) of each upsample stage of the generator."""
    from levelgan_torch.models import Generator
    return [(f"up{i}", 4 * 2 ** i, st.kernel.shape[2], st.kernel.shape[3])
            for i, st in enumerate(Generator(cfg.model).stages())]


def stage_inputs(h, ci, co, device, seed, batch=B):
    import torch
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn((batch, h, h, ci), generator=g, device=device).to(
        torch.bfloat16)
    w = torch.randn((4, 4, ci, co), generator=g, device=device) * 0.02
    gamma = 1.0 + 0.1 * torch.randn(co, generator=g, device=device)
    beta = 0.1 * torch.randn(co, generator=g, device=device)
    return x, w, gamma, beta


def close(a, b) -> tuple[float, bool]:
    import torch
    a, b = a.float(), b.float()
    err = (a - b).abs()
    ok = bool(torch.all(err <= ATOL + RTOL * b.abs()))
    return float(err.max()), ok


def library_stage(x, w, gamma, beta, gs, slope):
    """The yardstick of a stage kernel (K1 fwd, the K1L stage): one chain
    of PyTorch calls for the same function, ``F.conv_transpose2d`` +
    ``F.group_norm`` + ``F.leaky_relu`` in bf16, NCHW."""
    import torch
    import torch.nn.functional as F
    bf16 = torch.bfloat16
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    w_t = w.permute(2, 3, 0, 1).flip(2, 3).to(bf16).contiguous()
    gamma16, beta16 = gamma.to(bf16), beta.to(bf16)

    def library():
        y = F.conv_transpose2d(x_nchw, w_t, stride=2, padding=1)
        y = F.group_norm(y, w.shape[-1] // gs, gamma16, beta16, 1e-5)
        return F.leaky_relu(y, slope)
    return library


def k1l_residuals_agree(k1l, x, w, gamma, beta, slope, gs, what) -> bool:
    """The K1L stage's residual mode against its plain version (yf by the
    bf16 rule, mu / rstd within 1e-4 of max |ref|, y equal to the export
    mode's), and two calls bit for bit."""
    import torch
    one = k1l.upsample_block_rows(x, w, gamma, beta, slope=slope,
                                  group_size=gs, residuals=True)
    two = k1l.upsample_block_rows(x, w, gamma, beta, slope=slope,
                                  group_size=gs, residuals=True)
    want = k1l.upsample_block_rows_plain(x, w, gamma, beta, slope=slope,
                                         group_size=gs, residuals=True)
    y_only = k1l.upsample_block_rows(x, w, gamma, beta, slope=slope,
                                     group_size=gs)
    torch.cuda.synchronize()
    yf_err, yf_ok = close(one[1], want[1])
    stats = max(rel_err(one[2], want[2]), rel_err(one[3], want[3]))
    same = all(torch.equal(a, c) for a, c in zip(one, two))
    same_y = torch.equal(one[0], y_only)
    print(f"  {what} residuals: yf max_abs_err={yf_err:.4g} ok={yf_ok}; "
          f"mu/rstd max rel err {stats:.3g} (tol 1e-4); two calls "
          f"bit-identical: {same}; y equal to the export mode's: {same_y}")
    return yf_ok and stats <= 1e-4 and same and same_y


def k1l_tile_line(b, h, ci, co, gs, device) -> str:
    """The K1L stage's launch: cluster, grid, threads, shared memory."""
    from levelgan_torch.kernels import upsample_rows as k1l
    csize, stages = k1l.stage_tile(h, h, ci, co, gs)
    maxc = k1l.max_clusters(device, csize, h, ci, stages)
    ncl = k1l.stage_grid(b, co, maxc)
    return (f"clusters of {csize} blocks (one per {k1l.MROWS // h} input "
            f"rows), {ncl} persistent clusters ({ncl * csize} blocks; the "
            f"card holds {maxc} at once), 256 threads and "
            f"{k1l.stage_smem(h, ci, stages)} bytes of shared memory a block, "
            f"a ring of {stages} chunks")


def bound_ms(flops: float, nbytes: float,
             peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_rows(prof):
    """Device-side records of a profile (kernels, copies, memsets), largest
    first.  The aten ops above them carry the same device time again, and
    so do the device spans of annotations such as ``Optimizer.step#...``
    (``is_user_annotation``): neither is summed."""
    from torch.autograd import DeviceType
    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                   and not e.is_user_annotation),
                  key=dev_us, reverse=True)


def queued_ms(fn, n: int = 20, flush=None) -> float:
    """Device time of one call of ``fn``, for microsecond kernels where
    CUDA events around one call would time the host's launch overhead: a
    spin kernel holds the stream while the host queues ``n`` calls, and
    CUDA events time those calls back to back.  If the spin ended before
    the host had queued them all, the spin is doubled and the run
    repeated; after the last try the time is kept with a note (it then
    includes some host time).  Device gaps between kernels are included
    (``launch_floor_ms`` is what that charges a kernel that does no work),
    and the result does not depend on torch.profiler's tracing.
    ``flush``, where given, is queued before each try's spin."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for attempt in range(5):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        hidden = not start.query()     # the spin still holds the stream
        end.record()
        end.synchronize()
        if hidden:
            return start.elapsed_time(end) / n
        cycles *= 2
    print(f"  note: host launches of {getattr(fn, '__name__', 'fn')} were "
          f"not hidden behind a {cycles // 2} cycle spin; time includes "
          "host time")
    return start.elapsed_time(end) / n


def launch_floor_ms() -> float:
    """The least that ``queued_ms`` reads for any kernel: a one-cycle spin
    (``torch.cuda._sleep(1)``) launched back to back."""
    import torch
    return queued_ms(lambda: torch.cuda._sleep(1))


def cold_ms(fn, inputs, n: int = 20) -> float:
    """``queued_ms`` of ``fn(*inputs)`` with its inputs in device memory,
    not in L2: every call (warm-up included) takes its own copy of
    ``inputs``, and twice L2's size is written over before the timed
    calls."""
    import itertools
    import torch
    copies = itertools.cycle([tuple(t.clone() for t in inputs)
                              for _ in range(n + 3)])
    scratch = torch.empty(2 * L2_BYTES // 4, device=inputs[0].device)
    return queued_ms(lambda: fn(*next(copies)), n, flush=scratch.zero_)


def profiled_ms(fn, n: int) -> float | None:
    """Summed device time of one call of ``fn`` by torch.profiler over
    ``n`` calls after warm-up, or None where the profiler recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(dev_us(e) for e in device_rows(prof))
    return total / 1e3 / n if total > 0 else None


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# each kernel's launch counter in ``obs.counters``, by its name here
COUNTERS = {"K1": "k1.fwd_launches", "K1L": "k1l.fwd_launches",
            "K1 bwd": "k1.bwd_launches", "K1L bwd": "k1l.bwd_launches",
            "K2 core fwd": "k2.fwd_launches",
            "K2 core bwd": "k2.bwd_launches", "K2 fused": "k2f.launches",
            "head": "head.launches"}


def reset_counts() -> None:
    from levelgan_torch import obs
    obs.reset()


def read_counts() -> dict:
    from levelgan_torch import obs
    return {k: obs.counters[n] for k, n in COUNTERS.items()}


def warm_card(device, seconds: float = 0.5) -> None:
    """Keep the card busy for a while: after the idle minutes of a build its
    clocks are down, and the first kernel timed would pay for that."""
    import torch
    a = torch.randn((4096, 4096), device=device, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a @ a
        torch.cuda.synchronize()


def kernel_parity(cfg, device):
    """Phase 3: per (kernel, stage) parity + timing records."""
    import torch
    from levelgan_torch.kernels import upsample_block as k1
    from levelgan_torch.kernels import upsample_rows as k1l
    from levelgan_torch.ops.blocks import upsample_block

    warm_card(device)
    gs = cfg.model.group_size
    slope = cfg.model.leaky_slope
    rows = []
    for i, (name, h, ci, co) in enumerate(stage_shapes(cfg)):
        x, w, gamma, beta = stage_inputs(h, ci, co, device, seed=100 + i)
        flops = 2.0 * (2 * h) * (2 * h) * 4 * ci * co * B
        library = library_stage(x, w, gamma, beta, gs, slope)
        kernels = ["K1"] if k1.fits(h, h) else ["K1L"]
        if name == "up2" and "K1L" not in kernels:
            kernels.append("K1L")    # K1L held at a second shape
        for kern in kernels:
            if kern == "K1":
                run = lambda **kw: k1.upsample_block_fwd(   # noqa: E731
                    x, w, gamma, beta, slope=slope, group_size=gs, **kw)
                plain = lambda: upsample_block(        # noqa: E731
                    x, w, gamma, beta, slope=slope, group_size=gs,
                    compute_dtype=torch.bfloat16)

                err, ok = close(run(), plain())
                nbytes = (x.numel() * 2 + 16 * ci * co * 2 + 2 * co * 4
                          + B * 4 * h * h * co * 2)
            else:
                def run():
                    return k1l.upsample_block_rows(x, w, gamma, beta,
                                                   slope=slope, group_size=gs)

                def plain():
                    return k1l.upsample_block_rows_plain(
                        x, w, gamma, beta, slope=slope, group_size=gs)

                err, ok = close(run(), plain())
                ok = ok and k1l_residuals_agree(k1l, x, w, gamma, beta, slope,
                                                gs, f"{kern} {name}")
                print("    " + k1l_tile_line(B, h, ci, co, gs, x.device))
                nbytes = (x.numel() * 2 + 16 * ci * co * 2 + 2 * co * 4
                          + B * 4 * h * h * co * 2)
            torch.cuda.synchronize()
            if not ok:
                fail(f"{kern} at {name} disagrees with its plain version "
                     f"(max abs err {err:.4g}, tol {ATOL}+{RTOL}*|ref|)")
            t_k = median_ms(run)
            t_p = median_ms(plain)
            t_l = median_ms(library)
            b_ms, b_by = bound_ms(flops, nbytes)
            rec = dict(kernel=kern, stage=name, shape=[B, h, h, ci, co],
                       max_abs_err=err, ms=t_k, plain_ms=t_p, library_ms=t_l,
                       bound_ms=b_ms, bound_by=b_by)
            print(f"  {kern} {name} B={B} {h}x{h}x{ci}->{2 * h}x{2 * h}x{co}: "
                  f"max_abs_err={err:.4g} ms={t_k:.4f} plain_ms={t_p:.4f} "
                  f"library_ms={t_l:.4f} bound_ms={b_ms:.4f} ({b_by})")
            if kern == "K1":
                print("    " + k1_fwd_split(B, h, ci, co, gs, w, run,
                                            median_ms))
            rows.append(rec)
    return rows


def k1l_stage_timing(cfg, device, batches=(B, B_TRAIN), calls=5):
    """The K1L stage as the generator calls it (``upsample_block_rows``) at
    gumbel_64's K1L stage: its time at the export batch (CUDA-event median of
    single calls) and at the training batch (``queued_ms``) beside the
    library chain, and the device kernels of one call by name
    (torch.profiler over ``calls`` calls).  Returns {batch: (ms, library
    ms, names of the device kernels)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from levelgan_torch.kernels import upsample_block as k1
    from levelgan_torch.kernels import upsample_rows as k1l

    gs, slope = cfg.model.group_size, cfg.model.leaky_slope
    name, h, ci, co = next(s for s in stage_shapes(cfg)
                           if not k1.fits(s[1], s[1]))
    out = {}
    for b in batches:
        x, w, gamma, beta = stage_inputs(h, ci, co, device, seed=150,
                                         batch=b)
        library = library_stage(x, w, gamma, beta, gs, slope)

        def run():
            return k1l.upsample_block_rows(x, w, gamma, beta, slope=slope,
                                           group_size=gs)

        timer = median_ms if b == B else queued_ms
        t_s, t_l = timer(run), timer(library)
        out[b] = (t_s, t_l)
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        out[b] += ([e.key for e in rows],)
        busy = sum(dev_us(e) for e in rows) / 1e3 / calls
        print(f"  K1L stage {name} B={b} (upsample_block_rows, "
              f"{'CUDA-event median' if b == B else 'queued_ms'}): "
              f"{t_s:.5f} ms; library chain {t_l:.5f} ms; by the profiler "
              f"{busy:.5f} ms of device time a call in {sum(e.count for e in rows) // calls} "
              "device ops:")
        for e in rows:
            print(f"    {dev_us(e) / 1e3 / calls:9.5f} ms  x{e.count // calls:<3d}"
                  f" {e.key[:100]}")
    return out


def k1_fwd_split(b, h, ci, co, gs, w, run, timer) -> str:
    """Where a K1 forward call's time goes: the chosen tile, the first
    block's phases by ``run(probe=...)``'s time stamps, and the packing of
    the weight (timed with ``timer``), which a call pays only after the
    weight changed."""
    import torch
    from levelgan_torch.kernels import upsample_block as k1
    sms = torch.cuda.get_device_properties(w.device).multi_processor_count
    ns, ng, stages = k1.fwd_tile(b, h, h, ci, co, gs, sms)
    threads = 2 * (-(-ns * h * h // 64) * 64)
    t_pack = timer(lambda: k1.pack_taps_chunks(w))
    probe = torch.zeros(len(k1.FWD_PHASES) + 1, dtype=torch.int64,
                        device=w.device)
    run(probe=probe)
    torch.cuda.synchronize()
    stamps = probe.tolist()
    return (f"tile (NS, NG, stages) = ({ns}, {ng}, {stages}): {threads} "
            f"threads and {k1.fwd_smem(h, h, ns, stages)} bytes of shared "
            f"memory a block, {-(-b // ns) * -(-co // k1.NB)} blocks; "
            "first block by phase (us): "
            + ", ".join(f"{ph} {(t1 - t0) / 1e3:.2f}" for ph, t0, t1 in zip(
                k1.FWD_PHASES, stamps, stamps[1:]))
            + f"; packing the weight (PyTorch ops, once per weight version, "
            f"not in ms) {t_pack:.5f} ms")


def head_kernel(cfg, device, batch=B):
    """The fused sampling head (``kernels/sample_ids.py``) at the export's
    batch: bit for bit against its plain version on logits N(0, s^2) for s
    in HEAD_SCALES and on a seeded gumbel_64 generator's own logits, with
    the kernel's device time on each (``queued_ms``); the routed head
    (``models.sample_ids``) against ``decode(sample_head(...))`` drawn from
    one seed, with its launch count; then, on the generator's logits, the
    device times (``queued_ms``) of the routed head (the uniforms'
    ``torch.rand`` and the kernel), the plain version on the same uniforms
    and the chain the export ran before (``library_ms``: its own ``rand``
    included), beside the byte bound."""
    import torch
    from levelgan_torch.data.codec import decode
    from levelgan_torch.kernels import sample_ids as k
    from levelgan_torch.models import Generator, sample_head, sample_ids
    m = cfg.model
    tau = m.tau_end
    shape = (batch, m.level_size, m.level_size, m.n_tiles)
    gen = torch.Generator(device).manual_seed(500)
    model = Generator(m).init_params(torch.Generator().manual_seed(0)).to(
        device)
    with torch.inference_mode():
        own = model(torch.randn((batch, m.latent_dim), generator=gen,
                                device=device))
    warm_card(device)
    ms = {}
    for scale in (*HEAD_SCALES, "generator"):
        logits = (own if scale == "generator" else
                  scale * torch.randn(shape, generator=gen, device=device))
        u = torch.rand(shape, generator=gen, device=device)
        got = k.gumbel_ids(logits, u, tau)
        want = k.gumbel_ids_plain(logits, u, tau)
        if not torch.equal(got, want):
            fail(f"the fused head differs from its plain version in "
                 f"{int((got != want).sum())} of {got.numel()} tiles "
                 f"(logits {scale}, tau {tau})")
        ms[scale] = queued_ms(lambda: k.gumbel_ids(logits, u, tau))

    def rng():
        return torch.Generator(device).manual_seed(9)

    reset_counts()
    routed = sample_ids(own, "gumbel", tau, generator=rng())
    launches = read_counts()["head"]
    chain = decode(sample_head(own, "gumbel", tau, generator=rng()))
    if not torch.equal(routed, chain) or launches != 1:
        fail(f"sample_ids: {int((routed != chain).sum())} tiles differ from "
             f"decode(sample_head(...)), {launches} head launches (want 1)")
    nbytes = 2 * own.numel() * 4 + routed.numel()
    bound, by = bound_ms(0.0, nbytes)
    r = rng()
    times = {
        "kernel": ms["generator"],
        "sample_ids": queued_ms(lambda: sample_ids(own, "gumbel", tau,
                                                   generator=r)),
        "plain": queued_ms(lambda: k.gumbel_ids_plain(own, u, tau)),
        "library": queued_ms(lambda: decode(sample_head(
            own, "gumbel", tau, generator=r)))}
    print(f"  [{', '.join(map(str, shape))}], tau {tau}: kernel == plain bit "
          f"for bit on logits N(0, s^2), s in {HEAD_SCALES}, and on a "
          "gumbel_64 generator's logits (std "
          f"{float(own.std()):.4g}); sample_ids == decode(sample_head(...)) "
          "from one seed, 1 launch")
    print("  kernel ms by logits: " + ", ".join(
        f"{s} {t:.5f}" for s, t in ms.items()))
    print(f"  on the generator's logits: kernel {times['kernel']:.5f} ms "
          f"against its bound {bound:.5f} ms ({by}: {nbytes:,} B), "
          f"{100 * bound / times['kernel']:.1f}% of the roofline; sample_ids "
          f"(rand + kernel) {times['sample_ids']:.5f} ms; plain "
          f"{times['plain']:.5f} ms; library_ms (decode(sample_head(...)), "
          f"rand included) {times['library']:.5f} ms")
    return times


def main_path(cfg, device, workdir, n_levels=N_LEVELS, batch=B):
    """Phase 4: export through the port's CLI with counted kernel launches."""
    import numpy as np
    import torch
    from levelgan_torch.cli import export as cli
    from levelgan_torch import obs
    from levelgan_torch.export import generate, generate_batch
    from levelgan_torch.kernels import upsample_block as k1
    from levelgan_torch.lio.checkpoint import save_checkpoint
    from levelgan_torch.models import Generator

    gen = Generator(cfg.model).init_params(torch.Generator().manual_seed(0))
    ckpt = save_checkpoint(os.path.join(workdir, "ckpt"), gen, cfg, step=0)
    out = os.path.join(workdir, "levels.npz")

    obs.reset()
    t0 = time.perf_counter()
    rc = cli.main(["--ckpt", ckpt, "--n", str(n_levels), "--batch",
                   str(batch), "--out", out, "--seed", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: read_counts()[k] for k in ("K1", "K1L", "head")}
    if rc != 0:
        fail(f"export CLI returned {rc}")

    levels = np.load(out)["levels"]
    m = cfg.model
    if levels.dtype != np.uint8 or levels.shape != (n_levels, m.level_size,
                                                    m.level_size):
        fail(f"levels {levels.dtype} {levels.shape} != uint8 "
             f"({n_levels}, {m.level_size}, {m.level_size})")
    if int(levels.max()) >= m.n_tiles:
        fail(f"tile id {int(levels.max())} >= n_tiles {m.n_tiles}")
    n_batches = -(-n_levels // batch)
    fits = [k1.fits(h, h) for _, h, _, _ in stage_shapes(cfg)]
    expect = {"K1": n_batches * sum(fits),
              "K1L": n_batches * (len(fits) - sum(fits)), "head": n_batches}
    if counts != expect:
        fail(f"kernel launches {counts} != expected {expect}")
    # the weights never change during an export: one packing per stage
    packs = obs.counters["k1.packs"]
    if packs != len(fits):
        fail(f"the export packed stage weights {packs} times, expected "
             f"{len(fits)} (once per stage)")
    hist = np.bincount(levels.reshape(-1), minlength=m.n_tiles) / levels.size
    print(f"  exported {n_levels} levels through the CLI in {wall:.3f} s "
          f"(wall, incl. checkpoint load and .npz write); launches {counts}; "
          f"tile histogram {np.round(hist, 4).tolist()}")

    # warm throughput of the same call the CLI makes (the generator built
    # from the checkpoint's state_dict inside generate), without file I/O,
    # packed and unpacked; the CLI's choice must be the faster one
    from levelgan_torch.export import resolve_pack
    obs.reset()
    lps = export_timing(cfg, device, n_levels, batch)
    chosen = resolve_pack(m, None, device)
    print(f"  the CLI exports with pack={chosen}: {lps[chosen]:.1f} levels/s "
          f"against {lps[not chosen]:.1f} (pack={not chosen}); "
          f"{obs.counters['k1.packs']} weight packings in the warm exports "
          "(one per stage a call: each call builds its generator from the "
          "state_dict)")
    if lps[chosen] < PACK_SLACK * lps[not chosen]:
        fail(f"the CLI's pack={chosen} is slower than pack={not chosen} by "
             f"more than the run-to-run spread ({PACK_SLACK})")
    gen = gen.to(device)

    # one batch through the kernels vs the plain path, same z and noise
    g = torch.Generator(device).manual_seed(7)
    z = torch.randn((batch, m.latent_dim), generator=g, device=device)
    from levelgan_torch.ops.gumbel import gumbel_noise
    noise = gumbel_noise((batch, m.level_size, m.level_size, m.n_tiles),
                         device=device, generator=g)
    with torch.inference_mode():
        lk = gen(z)
        lp = gen(z, plain=True)
        ids_k = generate_batch(gen, cfg, z, noise=noise)
        ids_p = generate_batch(gen, cfg, z, noise=noise, plain=True)
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        fail("non-finite logits")
    rel = float((lk - lp).abs().max() / lp.abs().max())
    agree = float((ids_k == ids_p).float().mean())
    print(f"  kernels vs plain generator on the card: max|dlogit|/max|logit|"
          f"={rel:.4g} (tol {LOGIT_TOL}), tile agreement={agree:.5f} "
          f"(>= {TILE_AGREE})")
    if rel > LOGIT_TOL or agree < TILE_AGREE:
        fail("kernel generator disagrees with the plain generator")
    return counts


def export_timing(cfg, device, n_levels=N_LEVELS, batch=B, reps=2):
    """Warm ``generate`` of ``n_levels`` levels with ``pack=True`` and
    ``pack=False``, alternating, ``reps`` rounds each (the arrays of the
    two must be identical), and per batch: the device time of one
    ``generate_batch`` (``queued_ms``), the wall time (whole call / batches),
    the D2H of one batch into pinned memory, and the host unpack of one
    packed batch by the NumPy form and the native one (where the package
    has it).  Uses only ``generate``, ``generate_batch`` and the unpackers,
    so it also times a tree without the streamed path.  Returns
    {pack: best levels/s}."""
    import numpy as np
    import torch
    from levelgan_torch import export as ex
    from levelgan_torch.models import Generator

    m = cfg.model
    params = Generator(cfg.model).init_params(
        torch.Generator().manual_seed(0)).state_dict()
    gen = ex.make_generator(cfg, params, device)
    n_batches = -(-n_levels // batch)
    lps = {True: [], False: []}
    levels = {}
    generate = ex.generate
    for pack in (True, False):          # warm-up: kernels, packings, pins
        generate(cfg, params, 2 * batch, seed=1, batch_size=batch,
                 device=device, pack=pack)
    for _ in range(reps):
        for pack in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            levels[pack] = generate(cfg, params, n_levels, seed=1,
                                    batch_size=batch, device=device,
                                    pack=pack)
            lps[pack].append(n_levels / (time.perf_counter() - t0))
    if not np.array_equal(levels[True], levels[False]):
        fail("packed and unpacked exports gave different levels")

    g = torch.Generator(device).manual_seed(3)
    z = torch.randn((batch, m.latent_dim), generator=g, device=device)
    plain_unpack = getattr(ex, "unpack_levels_plain", ex.unpack_levels)
    try:
        from levelgan_torch.native.build import unpack_planes
    except ImportError:
        unpack_planes = None
    for pack in (True, False):
        dev_ms = queued_ms(lambda: ex.generate_batch(          # noqa: B023
            gen, cfg, z, generator=g, pack=pack), n=10)
        out = ex.generate_batch(gen, cfg, z, generator=g, pack=pack)
        pinned = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        d2h = median_ms(lambda: pinned.copy_(out, non_blocking=True))
        wall = [1e3 / (v / n_levels) / n_batches for v in lps[pack]]
        line = (f"  pack={pack}: warm export "
                + " / ".join(f"{v:.1f}" for v in lps[pack])
                + f" levels/s ({n_levels} levels, batch {batch}); per batch: "
                f"device {dev_ms:.3f} ms, wall "
                + " / ".join(f"{v:.3f}" for v in wall)
                + f" ms, D2H of {out.numel()} bytes into pinned memory "
                f"{d2h:.3f} ms")
        if pack:
            host = pinned.numpy()
            dst = np.empty((batch, m.level_size, m.level_size), np.uint8)
            t_np = statistics.median(_host_ms(
                lambda: plain_unpack(host, m.level_size, out=dst))
                for _ in range(7))
            line += f", NumPy unpack {t_np:.3f} ms"
            if unpack_planes is not None:
                bits = host.shape[1] * 8 // (m.level_size ** 2)
                t_c = statistics.median(_host_ms(
                    lambda: unpack_planes(host, bits, dst)) for _ in range(7))
                line += f", native unpack {t_c:.3f} ms"
        print(line, flush=True)
    return {p: max(v) for p, v in lps.items()}


def bfs_solvable(level) -> bool:
    """An independent check of one level: breadth-first search from the
    first START (else the centre) through non-WALL cells to a GOAL."""
    from levelgan_torch.config import GOAL, START, WALL
    h, w = level.shape
    starts = list(zip(*(level == START).nonzero()))
    r, c = (int(starts[0][0]), int(starts[0][1])) if starts else (h // 2,
                                                                 w // 2)
    if level[r, c] == WALL:
        return False
    seen = {(r, c)}
    todo = collections.deque([(r, c)])
    while todo:
        r, c = todo.popleft()
        if level[r, c] == GOAL:
            return True
        for nr, nc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
            if (0 <= nr < h and 0 <= nc < w and (nr, nc) not in seen
                    and level[nr, nc] != WALL):
                seen.add((nr, nc))
                todo.append((nr, nc))
    return False


def export_repair(cfg, device, workdir, n_levels=REPAIR_LEVELS, batch=B):
    """Phase 4b: the repaired gumbel_64 export through the CLI under both
    placements with ``--exactly-one``; every level must hold exactly one
    START and one GOAL, and be solvable unless it kept an unreachable GOAL
    of the raw sample (repair never moves one; the port's solver on all,
    a NumPy BFS on 256 must agree with it); the card's repair of one batch must equal the CPU run of
    the same function on the same tensors; the solver's dilations and ms a
    batch, levels/s beside the unrepaired export, and the quality report
    and KL gate against the corpus."""
    import numpy as np
    import torch
    from levelgan_torch.cli import export as cli
    from levelgan_torch.config import GOAL
    from levelgan_torch.data.dataset import LevelDataset
    from levelgan_torch.env.solver import (CHECK_EVERY, reachable_steps,
                                           solvable, well_formed)
    from levelgan_torch.export import generate, generate_batch, make_generator
    from levelgan_torch.lio.checkpoint import save_checkpoint
    from levelgan_torch.lio.quality import quality_report
    from levelgan_torch.lio.stats import kl_gate, per_position_chi2
    from levelgan_torch.models import Generator
    from levelgan_torch.ops.repair import ensure_start_goal

    m = cfg.model
    gen0 = Generator(cfg.model).init_params(torch.Generator().manual_seed(0))
    ckpt = save_checkpoint(os.path.join(workdir, "ckpt_repair"), gen0, cfg)
    params = gen0.state_dict()
    data = cfg.data.__class__(**{**cfg.data.__dict__,
                                 "corpus_size": CORPUS_CUT})
    ref = LevelDataset.from_config(data, m, seed=cfg.train.seed).levels
    ref_counts = np.bincount(ref.reshape(-1), minlength=m.n_tiles)
    raw = generate(cfg, params, n_levels, seed=0, batch_size=batch,
                   device=device, repair=False)
    lps = {}
    for placement in ("confidence", "uniform"):
        out = os.path.join(workdir, f"repaired_{placement}.npz")
        if cli.main(["--ckpt", ckpt, "--n", str(n_levels), "--batch",
                     str(batch), "--out", out, "--seed", "0", "--repair",
                     "--repair-placement", placement,
                     "--exactly-one"]) != 0:
            fail(f"repaired export ({placement}) returned non-zero")
        levels = np.load(out)["levels"]
        t = torch.from_numpy(levels).to(device)
        wf = well_formed(t)
        sol = solvable(t).cpu().numpy()
        # the NumPy BFS on every unsolvable level and the first solvable ones
        pick = np.concatenate([np.nonzero(~sol)[0], np.nonzero(sol)[0]])[:256]
        bfs = np.array([bfs_solvable(levels[i]) for i in pick])
        # repair never moves an existing GOAL: an unsolvable level must keep
        # a GOAL the raw sample (the same seed, repair off) had, which no
        # reachable GOAL replaced
        bad = np.nonzero(~sol)[0]
        kept = all(raw[i][levels[i] == GOAL].item() == GOAL for i in bad)
        print(f"  {placement}: {n_levels} levels, one START "
              f"{int(wf['one_start'].sum())}, one GOAL "
              f"{int(wf['one_goal'].sum())}, solvable by the port's solver "
              f"{int(sol.sum())} (the {len(bad)} others keep an unreachable "
              f"GOAL of the raw sample: {kept}); the NumPy BFS agrees on "
              f"{int((bfs == sol[pick]).sum())} of {len(pick)}")
        if not (wf["one_start"].all() and wf["one_goal"].all() and kept
                and np.array_equal(bfs, sol[pick])):
            fail(f"repaired export ({placement}): a level without exactly one "
                 "START and GOAL, a placed GOAL that is unreachable, or the "
                 "solver disagrees with the BFS")
        rep = quality_report(levels, m.n_tiles, device=device)
        gate = kl_gate(levels, ref_counts, m.n_tiles, KL_THRESHOLD)
        chi2 = per_position_chi2(levels, ref, m.n_tiles,
                                 {"structural": (2, 3)})
        print(f"    quality {json.dumps(rep)}; kl_gate against the "
              f"{CORPUS_CUT}-level corpus {json.dumps(gate)}; chi2/dof "
              f"{chi2['chi2_per_dof_mean']:.4g}, structural "
              f"{chi2['chi2_per_dof_structural']:.4g} (random weights: the "
              "gates are printed, not held)")
        for rep_on in (False, True):
            generate(cfg, params, 2 * batch, seed=1, batch_size=batch,
                     device=device, repair=rep_on, repair_placement=placement)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate(cfg, params, n_levels, seed=1, batch_size=batch,
                     device=device, repair=rep_on, repair_placement=placement,
                     exactly_one=rep_on)
            lps[(placement, rep_on)] = n_levels / (time.perf_counter() - t0)
        print(f"    warm export {lps[(placement, True)]:.1f} levels/s "
              f"repaired, {lps[(placement, False)]:.1f} unrepaired "
              f"({n_levels} levels, batch {batch})")

    # one batch: the card's repair against the CPU's, bit for bit; the
    # solver's dilations and time on the card
    gen = make_generator(cfg, params, device)
    g = torch.Generator(device).manual_seed(11)
    z = torch.randn((batch, m.latent_dim), generator=g, device=device)
    with torch.inference_mode():
        logits = gen(z)
        ids = generate_batch(gen, cfg, z, generator=g)
    scores = tuple(torch.rand((batch, m.level_size ** 2), generator=g,
                              device=device) for _ in range(2))
    target = torch.rand(batch, generator=g, device=device)
    for placement, td in (("confidence", None), ("uniform", None),
                          ("uniform", target)):
        for one in (False, True):
            kw = dict(placement=placement, exactly_one=one, scores=scores)
            with torch.inference_mode():       # as the export runs it
                on_card = ensure_start_goal(ids, logits, target_dist=td, **kw)
                on_cpu = ensure_start_goal(
                    ids.cpu(), logits.cpu(),
                    target_dist=None if td is None else td.cpu(),
                    **{**kw, "scores": tuple(x.cpu() for x in scores)})
            if not torch.equal(on_card.cpu(), on_cpu):
                fail(f"repair on the card differs from the CPU's "
                     f"({placement}, exactly_one={one}, target "
                     f"{td is not None})")
    print("  one batch repaired on the card equals the CPU run bit for bit "
          "(confidence, uniform, uniform with target_dist; exactly_one off "
          "and on)")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, steps = reachable_steps(ids)
        times.append(1e3 * (time.perf_counter() - t0))
    rep_ms = []
    for placement in ("confidence", "uniform"):
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ensure_start_goal(ids, logits, placement=placement,
                              exactly_one=True, scores=scores)
            torch.cuda.synchronize()
            rep_ms.append(1e3 * (time.perf_counter() - t0))
    print(f"  solver on one {batch}-level batch: {steps} dilations (a test "
          f"every {CHECK_EVERY}), {statistics.median(times):.3f} ms (wall, median of "
          f"5); the whole repair {statistics.median(rep_ms[:5]):.3f} ms "
          f"confidence, {statistics.median(rep_ms[5:]):.3f} ms uniform")
    return lps


def export_cond(device, workdir, n_levels=COND_LEVELS, batch=B):
    """Phase 4c: conditional_32 with seeded random weights through the
    CLI with ``--cond``, with ``--calibrated`` (a calibration JSON written
    here) and with the corpus-mean default (``data.corpus_size`` cut to
    ``CORPUS_CUT``); K1 runs on all three stages (3 launches a batch); the
    kernel generator against the plain one with a cond."""
    import numpy as np
    import torch
    from levelgan_torch.cli import export as cli
    from levelgan_torch.config import preset
    from levelgan_torch.data.dataset import LevelDataset
    from levelgan_torch.data.features import (FEATURE_NAMES,
                                              corpus_mean_cond,
                                              level_features)
    from levelgan_torch.export import generate_batch, make_generator
    from levelgan_torch.lio.calibration import (apply_calibration,
                                                fit_from_sweeps,
                                                save_calibration)
    from levelgan_torch.lio.checkpoint import save_checkpoint
    from levelgan_torch.models import Generator

    cfg = preset("conditional_32").override(**{
        "data.corpus_size": CORPUS_CUT})
    m = cfg.model
    gen0 = Generator(m).init_params(torch.Generator().manual_seed(0))
    ckpt = save_checkpoint(os.path.join(workdir, "ckpt_cond"), gen0, cfg)
    internal = np.linspace(-1.0, 1.0, 9)
    cal = fit_from_sweeps(FEATURE_NAMES, {
        "hazard_frac": {"internal": internal,
                        "realized": 0.03 * internal + 0.05},
        "goal_dist": {"internal": internal,
                      "realized": 0.3 * internal + 0.4}})
    save_calibration(ckpt, cal)
    req = "0.25,0.06,0.07,0.5"
    n_batches = -(-n_levels // batch)
    feats = {}
    for name, extra in (("--cond", ["--cond", req]),
                        ("--cond --calibrated", ["--cond", req,
                                                 "--calibrated"]),
                        ("corpus-mean default", [])):
        out = os.path.join(workdir, "cond.npz")
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(["--ckpt", ckpt, "--n", str(n_levels), "--batch",
                       str(batch), "--out", out, "--seed", "0", *extra])
        wall = time.perf_counter() - t0
        counts = {k: read_counts()[k] for k in ("K1", "K1L")}
        if rc != 0:
            fail(f"conditional export ({name}) returned {rc}")
        levels = np.load(out)["levels"]
        if (levels.shape != (n_levels, m.level_size, m.level_size)
                or int(levels.max()) >= m.n_tiles):
            fail(f"conditional export ({name}): {levels.shape} max "
                 f"{int(levels.max())}")
        if counts != {"K1": 3 * n_batches, "K1L": 0}:
            fail(f"conditional export ({name}) launches {counts}, expected "
                 f"K1 {3 * n_batches} (3 stages x {n_batches} batches)")
        feats[name] = level_features(torch.from_numpy(levels).to(
            device)).mean(0).cpu().numpy()
        print(f"  {name}: {n_levels} levels in {wall:.3f} s (wall, corpus "
              f"and checkpoint load included), launches {counts}, realized "
              f"features {np.round(feats[name], 4).tolist()}")
    ds = LevelDataset.from_config(cfg.data, m, seed=cfg.train.seed)
    mean = corpus_mean_cond(cfg, ds, device)
    want = apply_calibration(cal, np.array([float(x) for x in
                                            req.split(",")], np.float32))
    print(f"  the corpus-mean cond ({CORPUS_CUT} levels, data.corpus_size "
          f"cut from 4096) {np.round(mean, 4).tolist()}; the calibrated "
          f"request {req} -> {np.round(want, 4).tolist()}")

    gen = make_generator(cfg, gen0.state_dict(), device)
    g = torch.Generator(device).manual_seed(7)
    z = torch.randn((batch, m.latent_dim), generator=g, device=device)
    cond = torch.as_tensor(want, device=device).expand(batch, m.cond_dim)
    from levelgan_torch.ops.gumbel import gumbel_noise
    noise = gumbel_noise((batch, m.level_size, m.level_size, m.n_tiles),
                         device=device, generator=g)
    with torch.inference_mode():
        lk = gen(z, cond)
        lp = gen(z, cond, plain=True)
        ids_k = generate_batch(gen, cfg, z, cond, noise=noise)
        ids_p = generate_batch(gen, cfg, z, cond, noise=noise, plain=True)
    rel = float((lk - lp).abs().max() / lp.abs().max())
    agree = float((ids_k == ids_p).float().mean())
    print(f"  kernels vs plain conditional generator on the card: "
          f"max|dlogit|/max|logit|={rel:.4g} (tol {LOGIT_TOL}), tile "
          f"agreement={agree:.5f} (>= {TILE_AGREE})")
    if not (torch.isfinite(lk).all() and rel <= LOGIT_TOL
            and agree >= TILE_AGREE):
        fail("the conditional kernel generator disagrees with the plain one")


def _host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def profile_export(cfg, device, batches=4):
    """Phase 5: where one export batch's time goes (torch.profiler device
    time by kernel, device busy share) on the path ``generate`` takes
    (``pack=None``); the host's D2H and unpack are timed by
    ``export_timing``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from levelgan_torch import obs
    from levelgan_torch.export import (generate_batch, make_generator,
                                       resolve_pack)
    from levelgan_torch.models import Generator

    m = cfg.model
    # the generator as generate() makes it for the CLI: from a state_dict
    gen = make_generator(cfg, Generator(cfg.model).init_params(
        torch.Generator().manual_seed(0)).state_dict(), device)
    g = torch.Generator(device).manual_seed(3)
    zs = [torch.randn((B, m.latent_dim), generator=g, device=device)
          for _ in range(batches + 1)]
    pack = resolve_pack(m, None, device)
    generate_batch(gen, cfg, zs[-1], generator=g, pack=pack)   # warm-up
    torch.cuda.synchronize()
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for z in zs[:batches]:
            generate_batch(gen, cfg, z, generator=g, pack=pack)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / batches
    packs = obs.counters["k1.packs"]
    if packs:
        fail(f"{packs} weight packings in {batches} warm export batches")

    rows = device_rows(prof)
    if not rows:
        print("  profiler recorded no device kernels: breakdown not measured")
        return
    busy_ms = sum(dev_us(e) for e in rows) / 1e3 / batches
    print(f"  per batch ({B} levels, pack={pack}): wall {wall_ms:.3f} ms "
          f"(profiled), "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in rows[:24]:
        print(f"    {dev_us(e) / 1e3 / batches:8.3f} ms  x{e.count // batches:<3d}"
              f" {e.key[:90]}")
    ours = sum(dev_us(e) for e in rows if any(o in e.key for o in OURS))
    native = [e for e in rows if "at::native" in e.key]
    print(f"  of that: the port's kernels {ours / 1e3 / batches:.3f} ms; "
          f"PyTorch's own kernels (at::native) {len(native)} kinds, "
          f"{sum(e.count for e in native) // batches} launches, "
          f"{sum(dev_us(e) for e in native) / 1e3 / batches:.3f} ms")

    # the whole streamed generate(): device busy against its wall time
    from levelgan_torch.export import generate
    params = gen.state_dict()
    n = 8 * B
    generate(cfg, params, n, seed=2, batch_size=B, device=device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(cfg, params, n, seed=2, batch_size=B, device=device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = device_rows(prof)
    copies = sum(dev_us(e) for e in rows if "Memcpy" in e.key) / 1e3
    busy = sum(dev_us(e) for e in rows if "Memcpy" not in e.key) / 1e3
    print(f"  the whole generate() of {n} levels (pack={pack}): wall "
          f"{wall_ms:.3f} ms (profiled), kernels {busy:.3f} ms, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}; D2H copies {copies:.3f} ms "
          "on the copy engine beside them")


def errs_of(names, got, want, tol):
    """name -> (max abs err, max |diff| / max |ref|, tolerance of the
    latter)."""
    return {n: (float((a.float() - r.float()).abs().max()), rel_err(a, r),
                tol) for n, a, r in zip(names, got, want)}


def record(rows, config, kern, stage, shape, errs, run, plain, library,
           flops, nbytes, peak=PEAK_BF16_FLOPS):
    """Fail unless the kernel agreed with its plain version (``errs``), then
    time kernel, plain and library call (``queued_ms``) and append the
    record."""
    import torch
    bad = {k: v for k, v in errs.items() if v[1] > v[2]}
    torch.cuda.synchronize()
    if bad:
        fail(f"{kern} at {config} {stage} disagrees with its plain version: "
             + ", ".join(f"{k} max rel err {v[1]:.4g} > {v[2]:.4g}"
                         for k, v in bad.items()))
    t_k, t_p, t_l = queued_ms(run), queued_ms(plain), queued_ms(library)
    b_ms, b_by = bound_ms(flops, nbytes, peak)
    rows.append(dict(config=config, kernel=kern, stage=stage, shape=shape,
                     max_abs_err=max(v[0] for v in errs.values()),
                     max_rel_err=max(v[1] for v in errs.values()), ms=t_k,
                     plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                     bound_by=b_by))
    print(f"  {kern} {stage} {shape}: "
          + " ".join(f"{k} abs {v[0]:.4g} rel {v[1]:.3g} (tol {v[2]:.3g})"
                     for k, v in errs.items())
          + f"; ms={t_k:.5f} plain_ms={t_p:.5f} library_ms={t_l:.5f} "
          f"bound_ms={b_ms:.5f} ({b_by})")


def train_kernel_parity(cfg, device, rows, b=B_TRAIN, fwd_only=False):
    """Phase 6: the training-path kernels at ``cfg``'s training shapes
    (B = 64; another ``b`` records them under ``<preset>_b<b>``), each
    against its plain version, with kernel / plain /
    library device times (``queued_ms``) and bounds, K1 forward included
    (the export phase holds it at B = 1024 only).  gumbel_64 also holds K1L
    bwd at a second shape (up2).  ``fwd_only``: the forward kernels alone,
    for a path that only samples."""
    import torch
    import torch.nn.functional as F
    from levelgan_torch.kernels import upsample_block as k1
    from levelgan_torch.kernels import upsample_rows as k1l
    from levelgan_torch.ops.blocks import upsample_block

    gs, slope = cfg.model.group_size, cfg.model.leaky_slope
    bf16 = torch.bfloat16
    name_cfg = cfg.preset if b == B_TRAIN else f"{cfg.preset}_b{b}"
    first = name_cfg == "gumbel_64"

    for i, (name, h, ci, co) in enumerate(stage_shapes(cfg)):
        x, w, gamma, beta = stage_inputs(h, ci, co, device, seed=200 + i,
                                         batch=b)
        gen = torch.Generator(device).manual_seed(300 + i)
        flops = 32.0 * b * h * h * ci * co        # the dx contraction
        wt_lib = w.permute(2, 3, 0, 1).flip(2, 3).to(bf16).contiguous()
        fits = k1.fits(h, h)
        kernels = [] if fwd_only else ["K1 bwd"] if fits else ["K1L bwd"]
        if first and name == "up2":
            kernels.append("K1L bwd")    # K1L bwd held at a second shape
        kernels.insert(0, "K1" if fits else "K1L")
        for kern in kernels:
            if kern == "K1L":
                # the stage as training runs it: with its residuals
                k1l_training_row(rows, name_cfg, name, x, w, gamma, beta,
                                 slope, gs, flops)
                continue
            if kern == "K1":
                library = library_stage(x, w, gamma, beta, gs, slope)

                def run(**kw):
                    return k1.upsample_block_fwd(x, w, gamma, beta,
                                                 slope=slope, group_size=gs,
                                                 **kw)

                def plain():
                    return upsample_block(x, w, gamma, beta, slope=slope,
                                          group_size=gs, compute_dtype=bf16)

                y_k, y_p = run(), plain()
                err, ok = close(y_k, y_p)
                if not ok:
                    fail(f"K1 at {name_cfg} {name} disagrees with its plain "
                         f"version (max abs err {err:.4g}, tol "
                         f"{ATOL}+{RTOL}*|ref|)")
                errs = errs_of(("y",), (y_k,), (y_p,), SUM_TOL)
                record(rows, name_cfg, kern, name, [b, h, h, ci, co], errs,
                       run, plain, library, flops,
                       x.numel() * 2 + 16 * ci * co * 2 + 2 * co * 4
                       + b * 4 * h * h * co * 2)
                print("    " + k1_fwd_split(b, h, ci, co, gs, w, run,
                                            queued_ms))
                continue
            if kern == "K1 bwd":
                _, ypre, mu, rstd = k1.upsample_block_fwd(
                    x, w, gamma, beta, slope=slope, group_size=gs,
                    residuals=True)
                g = torch.randn(ypre.shape, generator=gen,
                                device=device).to(bf16)

                def run():
                    return k1.upsample_block_bwd(w, gamma, beta, mu, rstd, g,
                                                 ypre, slope=slope,
                                                 group_size=gs)

                def plain():
                    return k1.upsample_block_bwd_plain(
                        w, gamma, beta, mu, rstd, g, ypre, slope=slope,
                        group_size=gs)

                # one autograd call of the library chain for the same stage:
                # dx, dgamma, dbeta (dw is outside the kernel, as in JAX),
                # built inline so that its tensors live until the next
                # stage's: what a row leaves alive moves the later rows'
                # buffers, and K1 bwd's dx launch reads up to 16% slower
                # with its packed weight elsewhere (``placement_line``)
                xl = x.permute(0, 3, 1, 2).contiguous().requires_grad_()
                gl = gamma.to(bf16).requires_grad_()
                bl = beta.to(bf16).requires_grad_()
                yl = F.leaky_relu(F.group_norm(
                    F.conv_transpose2d(xl, wt_lib, stride=2, padding=1),
                    co // gs, gl, bl, 1e-5), slope)
                gl_ct = g.permute(0, 3, 1, 2).contiguous()

                def library():
                    return torch.autograd.grad(yl, (xl, gl, bl), gl_ct,
                                               retain_graph=True)

                errs = errs_of(("dx", "dy", "dgamma", "dbeta"), run(),
                               plain(), SUM_TOL)
                nbytes = (3 * g.numel() * 2 + b * h * h * ci * 2
                          + 16 * ci * co * 2 + 2 * b * co * 4 + 4 * co * 4)
            else:
                # the whole backward on residuals from the stage kernel
                _, yf, mu, rstd = k1l.upsample_block_rows(
                    x, w, gamma, beta, slope=slope, group_size=gs,
                    residuals=True)
                g = torch.randn((b, 2 * h, 2 * h, co), generator=gen,
                                device=device).to(bf16)
                args = (g, yf, mu, rstd, gamma, beta, w)

                def run():
                    return k1l.upsample_rows_bwd(*args, slope=slope,
                                                 group_size=gs)

                def plain():
                    return k1l.upsample_rows_bwd_plain(*args, slope=slope,
                                                       group_size=gs)

                library = library_stage_bwd(x, wt_lib, gamma, beta, g, gs,
                                            slope)
                got = run()
                same = all(torch.equal(a, c) for a, c in zip(got, run()))
                print(f"  K1L bwd {name}: two calls bit-identical: {same}")
                if not same:
                    fail(f"K1L bwd at {name_cfg} {name}: two calls differ")
                errs = errs_of(("dx", "dyf", "dgamma", "dbeta"), got,
                               plain(), SUM_TOL)
                # g and yf in, dyf and dx out, the packed weight, the
                # statistics and the affine in, dgamma / dbeta out
                nbytes = (3 * yf.numel() * 2 + b * h * h * ci * 2
                          + 16 * ci * co * 2 + 2 * b * co * 4 + 4 * co * 4)
            record(rows, name_cfg, kern, name, [b, h, h, ci, co], errs, run,
                   plain, library, flops, nbytes)
            if kern == "K1L bwd":
                k1l_bwd_parts(x, args, slope, gs)
            if kern == "K1 bwd":
                # the call's two launches, each alone
                gn_args = (g, ypre, mu, rstd, gamma, beta, slope, gs)
                dy_k, s1_k, s2_k = k1.bwd_gn_pass(*gn_args)
                t_gn = queued_ms(lambda: k1.bwd_gn_pass(*gn_args))
                t_dx = queued_ms(lambda: k1.bwd_dx_pass(dy_k, w, s1_k, s2_k))
                tile = k1.dx_tile(b, h, h, ci, co, torch.cuda.
                                  get_device_properties(device).
                                  multi_processor_count)
                print(f"    of that: the GroupNorm pass {t_gn:.5f} ms, the dx "
                      f"GEMM with dgamma / dbeta {t_dx:.5f} ms at tile (nsd, "
                      f"rt) = {tile}, {k1.dx_smem(h, *tile)} bytes of shared "
                      "memory a block")
                if first and name == "up2":
                    # after gumbel_64's last K1 bwd row, so that no row
                    # before it sees the buffers this leaves cached
                    print("    " + placement_line(
                        dy_k, w, lambda d, wd: k1.bwd_dx_pass(d, wd, s1_k,
                                                              s2_k)))
                    torch.cuda.empty_cache()


# K2 core's shapes: the critic's flattened input gradient [64, H * W *
# n_tiles] at gumbel_64, at wgan_gp_32 and at the 16x16 presets (not yet on
# a ported path)
K2_CORE_SHAPES = (("gumbel_64", 64 * 64 * 8), ("wgan_gp_32", 32 * 32 * 8),
                  ("16x16", 16 * 16 * 8), ("racetrack_32", 32 * 2))


def k2_core_pair(rows, config, b, f, gen, floor):
    """K2 core fwd and bwd at [b, f] f32 (``k2_core_rows``' rows of one
    shape); returns the (g2, ct) they ran on."""
    import torch
    from levelgan_torch.kernels import gp_penalty as k2
    device = gen.device
    g2 = torch.randn((b, f), generator=gen, device=device) * 0.01
    ct = torch.randn((b,), generator=gen, device=device)
    pen_k, norm_k = k2.norm_penalty_fwd(g2)
    pen_2, norm_2 = k2.norm_penalty_fwd(g2)
    if not (torch.equal(pen_k, pen_2) and torch.equal(norm_k, norm_2)):
        fail(f"K2 core fwd at [{b}, {f}]: two calls differ")
    errs = errs_of(("pen", "norm"), (pen_k, norm_k),
                   k2.norm_penalty_fwd_plain(g2), K2_TOL)
    record(rows, config, "K2 core fwd", "gp", [b, f], errs,
           lambda: k2.norm_penalty_fwd(g2),
           lambda: k2.norm_penalty_fwd_plain(g2),
           lambda: torch.linalg.vector_norm(g2, dim=1), 2.0 * b * f,
           4.0 * b * f + 2 * 4 * b, PEAK_F32_FLOPS)
    plan = str(k2.fwd_plan(b, f))
    rows[-1].update(floor_ms=floor, plan=plan,
                    cold_ms=cold_ms(k2.norm_penalty_fwd, (g2,)))
    print(f"    floor {floor:.5f} ms, L2-cold {rows[-1]['cold_ms']:.5f} "
          f"ms; two calls bit-identical; plan {plan}")
    scale = (ct * 2.0 * (norm_k - 1.0) / norm_k)[:, None]
    errs = errs_of(("dg",), (k2.norm_penalty_bwd(g2, norm_k, ct),),
                   (k2.norm_penalty_bwd_plain(g2, norm_k, ct),), K2_TOL)
    record(rows, config, "K2 core bwd", "gp", [b, f], errs,
           lambda: k2.norm_penalty_bwd(g2, norm_k, ct),
           lambda: k2.norm_penalty_bwd_plain(g2, norm_k, ct),
           lambda: torch.mul(g2, scale), 1.0 * b * f,
           8.0 * b * f + 3 * 4 * b, PEAK_F32_FLOPS)
    plan = str(k2.bwd_plan(b, f))
    rows[-1].update(floor_ms=floor, plan=plan, cold_ms=cold_ms(
        k2.norm_penalty_bwd, (g2, norm_k, ct)))
    print(f"    floor {floor:.5f} ms, L2-cold {rows[-1]['cold_ms']:.5f} "
          f"ms; plan {plan}")
    ct0 = ct[:1].expand(b)
    if not torch.equal(k2.norm_penalty_bwd(g2, norm_k, ct0),
                       k2.norm_penalty_bwd(g2, norm_k, ct0.contiguous())):
        fail(f"K2 core bwd at [{b}, {f}]: a stride-0 cotangent gives "
             "another dg than a contiguous one")
    return g2, ct


def k2_core_rows(device, rows):
    """K2 core fwd / bwd at ``K2_CORE_SHAPES`` (B = 64, f32), each against
    its plain version by K2_TOL, two forward calls bit for bit, a stride-0
    cotangent against a contiguous one, the times (``record``) with the
    launch floor, the L2-cold time (``cold_ms``) and the plan beside them;
    then one ``NormPenalty.backward`` as autograd calls it after the GP's
    ``.mean()``: its ATen operations and device kernels, which must be the
    output's allocation and the K2 core bwd kernel alone."""
    import torch
    from levelgan_torch.kernels import gp_penalty as k2
    b = B_TRAIN
    floor = launch_floor_ms()
    print(f"  launch floor of queued_ms (torch.cuda._sleep(1) back to back): "
          f"{floor:.5f} ms")
    gen = torch.Generator(device).manual_seed(400)
    for config, f in K2_CORE_SHAPES:
        g2, ct = k2_core_pair(rows, config, b, f, gen, floor)
    # a row that the forward reads in several chunks: gumbel_64 at
    # model.level_size=128
    g2l = torch.randn((b, 128 * 128 * 8), generator=gen, device=device) * 0.01
    pen_l, norm_l = k2.norm_penalty_fwd(g2l)
    errs = errs_of(("pen", "norm"), (pen_l, norm_l),
                   k2.norm_penalty_fwd_plain(g2l), K2_TOL)
    errs.update(errs_of(("dg",), (k2.norm_penalty_bwd(g2l, norm_l, ct),),
                        (k2.norm_penalty_bwd_plain(g2l, norm_l, ct),),
                        K2_TOL))
    print(f"  K2 core at [{b}, {g2l.shape[1]}] (plan {k2.fwd_plan(*g2l.shape)}"
          "): " + " ".join(f"{k} rel {v[1]:.3g} (tol {v[2]:.3g})"
                           for k, v in errs.items()))
    if any(v[1] > v[2] for v in errs.values()):
        fail(f"K2 core at [{b}, {g2l.shape[1]}] disagrees with its plain "
             "version")
    del g2l
    # one NormPenalty.backward with the cotangent autograd hands it from
    # the GP's .mean() (the last shape's g2)
    x = g2.clone().requires_grad_()
    pen = k2.NormPenalty.apply(x)
    (ct,) = torch.autograd.grad(pen.mean(), pen)
    ctx = types.SimpleNamespace(saved_tensors=(g2, k2.norm_penalty_fwd(g2)[1]))

    def backward():
        return k2.NormPenalty.backward(ctx, ct)

    ops = aten_ops(backward)
    names = kernel_names(backward)
    print(f"  NormPenalty.backward after .mean(): cotangent of stride "
          f"{ct.stride()}; ATen operations {dict(ops)}; device kernels "
          + ("not recorded by the profiler" if names is None else
             "; ".join(f"x{n} {k[:60]}" for k, n in names.items())))
    if (ops != collections.Counter({"aten.empty_like.default": 1})
            or (names is not None and sum(names.values()) != 1)):
        fail("NormPenalty.backward ran more than the K2 core bwd kernel and "
             "its output's allocation")


def placement_line(t, w, fn, offsets_mib=(0, 1, 2, 3),
                   pads_mib=(0, 8, 32, 128)) -> str:
    """``fn(t, w)`` timed (``queued_ms``) with copies of its input ``t`` at
    several offsets into one buffer; with copies of the weight ``w`` (so
    also of the packed weight the wrapper makes from it) made while a pad
    of several sizes is held; and with copies of both behind the pads
    (which moves the buffers the launch allocates too): how far a row's
    time depends on where the allocator puts them."""
    import torch
    step = (1 << 20) // t.element_size()
    buf = torch.empty(t.numel() + step * max(offsets_mib), dtype=t.dtype,
                      device=t.device)
    out = {"input at an offset": [], "weight behind a pad": [],
           "both behind a pad": []}
    for o in offsets_mib:
        view = buf[o * step:o * step + t.numel()].view(t.shape)
        view.copy_(t)
        out["input at an offset"].append(queued_ms(lambda: fn(view, w)))
    del buf, view
    for p in pads_mib:
        pad = torch.empty(p << 20, dtype=torch.uint8, device=t.device)
        w2 = w.clone()
        out["weight behind a pad"].append(queued_ms(lambda: fn(t, w2)))
        t2 = t.clone()
        out["both behind a pad"].append(queued_ms(lambda: fn(t2, w2)))
        del pad, w2, t2
    return ("the same launch with (ms) " + "; ".join(
        f"{k} of " + " / ".join(str(v) for v in (
            offsets_mib if k.startswith("input") else pads_mib))
        + " MiB: " + " / ".join(f"{x:.5f}" for x in ts)
        for k, ts in out.items()))


def library_stage_bwd(x, w_t, gamma, beta, g, gs, slope):
    """The yardstick of a stage backward (K1 bwd, K1L bwd): one
    ``torch.autograd.grad`` of the library chain of ``library_stage`` for
    (x, gamma, beta) at the output cotangent g (bf16, NCHW), with the
    weight ``w_t`` as ``F.conv_transpose2d`` takes it (bf16); it is not a
    target, so cuDNN computes no dw (dw is outside the kernel, as in
    JAX)."""
    import torch
    import torch.nn.functional as F
    xl = x.permute(0, 3, 1, 2).contiguous().requires_grad_()
    gl = gamma.to(w_t.dtype).requires_grad_()
    bl = beta.to(w_t.dtype).requires_grad_()
    yl = F.leaky_relu(F.group_norm(
        F.conv_transpose2d(xl, w_t, stride=2, padding=1), w_t.shape[1] // gs,
        gl, bl, 1e-5), slope)
    gl_ct = g.permute(0, 3, 1, 2).contiguous()

    def library():
        return torch.autograd.grad(yl, (xl, gl, bl), gl_ct, retain_graph=True)
    return library


def kernel_names(fn, tries: int = 3) -> dict | None:
    """Device kernels of one call of ``fn`` by name -> count (torch.profiler,
    after a warm-up call), or None where the profiler recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if rows:
            return {e.key: e.count for e in rows}
    return None


def aten_ops(fn) -> collections.Counter:
    """The ATen operations one call of ``fn`` dispatches, each with its
    count (after a warm-up call), recorded on the host: unlike the
    profiler's device records, none go missing.  A kernel launched through
    ctypes is not one."""
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = collections.Counter()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen[str(func)] += 1
            return func(*args, **(kwargs or {}))

    fn()
    with Record():
        fn()
    return seen


# what the staged K1L bwd wrapper dispatches itself on a contiguous g: dx,
# dyf and the clusters' partials allocated, the partials added over the
# clusters, dgamma and dbeta selected from that sum
WRAPPER_OPS = collections.Counter({
    "aten.empty.memory_format": 2, "aten.empty_like.default": 1,
    "aten.sum.dim_IntList": 1, "aten.select.int": 2})


def k1l_bwd_parts(x, args, slope, gs):
    """The K1L backward beside the pieces of the two-launch backward it
    replaced: the eager GroupNorm / LeakyReLU pass (``gn_act_bwd_folded``,
    plain PyTorch, on the card here only to be timed), dw
    (``weight_grad_folded``) and the whole ``UpsampleRowsFn.backward`` as
    autograd runs it; the
    kernel's cluster, grid and ring; and the device kernels of one backward
    call (``UpsampleRowsFn.backward`` on this thread).  Fails unless that
    call dispatches exactly dw's ATen operations and the wrapper's
    (``WRAPPER_OPS``), each as often, beside the kernel."""
    import torch
    from levelgan_torch.kernels import upsample_rows as k1l
    g, yf, mu, rstd, gamma, beta, w = args
    b, h, _, ci = x.shape
    co = w.shape[-1]
    dyf = k1l.upsample_rows_bwd(*args, slope=slope, group_size=gs)[1]
    t_gn = queued_ms(lambda: k1l.gn_act_bwd_folded(
        g, yf, mu, rstd, gamma, beta, slope=slope, group_size=gs))
    t_dw = queued_ms(lambda: k1l.weight_grad_folded(x, dyf))
    leaves = [t.clone().requires_grad_() for t in (x, w, gamma, beta)]
    y = k1l.UpsampleRowsFn.apply(*leaves, slope, gs)

    def whole():
        return torch.autograd.grad(y, leaves, g, retain_graph=True)

    t_whole = queued_ms(whole)
    general, rt, slots = k1l.bwd_plan(h, h, ci, co, gs)
    if general:
        fail(f"K1L bwd at {tuple(x.shape)} -> {co} runs the general kernel, "
             "not the staged one")
    maxc = k1l.max_bwd_clusters(x.device, h, h, rt, ci, co, slots)
    print(f"    of that: gn_act_bwd_folded alone (the eager pass it replaced) "
          f"{t_gn:.5f} ms; weight_grad_folded (dw) {t_dw:.5f} ms; "
          f"UpsampleRowsFn.backward whole (the kernel, then dw; "
          f"autograd.grad) {t_whole:.5f} ms")
    print(f"    clusters of {h // rt} blocks ({rt} folded rows each), "
          f"{min(b, maxc)} persistent clusters (the card holds {maxc} at "
          f"once), {32 * k1l.bwd_warps(h, rt, ci)} threads and "
          f"{k1l.bwd_smem(h, rt, ci, co, slots)} bytes of shared memory a "
          "block, weight "
          + ("resident" if slots == co // 8 else f"ring of {slots}"))
    probe = torch.zeros(len(k1l.BWD_PHASES), dtype=torch.int64,
                        device=x.device)
    k1l.upsample_rows_bwd(*args, slope=slope, group_size=gs, probe=probe)
    torch.cuda.synchronize()
    print("    first block by phase (us, summed over its samples): "
          + ", ".join(f"{n} {t / 1e3:.2f}" for n, t in zip(
              k1l.BWD_PHASES, probe.tolist()))
          + f"; block total {sum(probe.tolist()) / 1e3:.2f}")
    # the backward as autograd calls it, on this thread
    ctx = types.SimpleNamespace(saved_tensors=(x, w, gamma, beta, yf, mu,
                                               rstd), slope=slope,
                                group_size=gs)

    def backward():
        return k1l.UpsampleRowsFn.backward(ctx, g)

    bwd_ops = aten_ops(backward)
    dw_ops = aten_ops(lambda: k1l.weight_grad_folded(x, dyf))
    wrapper_ops = aten_ops(lambda: k1l.upsample_rows_bwd(
        *args, slope=slope, group_size=gs))
    want = dw_ops + WRAPPER_OPS
    diff = {k: bwd_ops[k] - want[k] for k in bwd_ops.keys() | want.keys()
            if bwd_ops[k] != want[k]}
    print(f"    ATen operations of one backward call: "
          f"{sum(bwd_ops.values())} of {len(bwd_ops)} kinds; dw's "
          f"{sum(dw_ops.values())}, the wrapper's {dict(wrapper_ops)}; "
          f"beyond dw's and WRAPPER_OPS: {diff or 'none'}")
    if diff or wrapper_ops != WRAPPER_OPS:
        fail(f"the K1L backward dispatched other ATen operations than dw's "
             f"and WRAPPER_OPS: {diff}; the wrapper alone: "
             f"{dict(wrapper_ops)}")
    names = kernel_names(backward)
    dw_names = kernel_names(lambda: k1l.weight_grad_folded(x, dyf))
    if names is None or dw_names is None:
        print("    note: the profiler recorded no device kernels of the "
              "backward call: its kernel list is not measured")
        return
    print(f"    device kernels of one backward call: {sum(names.values())} "
          f"launches, {len(names)} kinds, of which dw's "
          f"{sum(dw_names.values())} (the profiler drops records now and "
          "then; the ATen operations above are the check): "
          + "; ".join(f"x{n} {k[:60]}" for k, n in names.items()))


# shapes the staged K1L backward does not take and the general kernel does:
# gumbel_64's up3 with model.base_channels=128 (Ci = 128 needs 16 warp
# tiles) and Co = 96 (a multiple of 32, not a power of two); then gumbel_64's
# own up3, where the wrapper runs the staged kernel, to compare the two
K1L_BWD_GENERAL = [(32, 128, 64), (32, 64, 96), (32, 64, 32)]


def k1l_bwd_general(cfg, device):
    """The general K1L backward kernel at ``K1L_BWD_GENERAL`` (B = 64,
    inputs from the stage kernel with residuals; at a shape the staged
    kernel takes, the plan is set to the general one for this check): dx,
    dyf, dgamma and dbeta against the plain chain by SUM_TOL, two calls bit
    for bit, and its time beside the plain chain's, the library chain's
    (``library_stage_bwd``) and its bound (``queued_ms``)."""
    import torch
    from levelgan_torch.kernels import upsample_rows as k1l
    gs, slope, b = cfg.model.group_size, cfg.model.leaky_slope, B_TRAIN
    gen = torch.Generator(device).manual_seed(500)
    chosen = k1l.bwd_plan
    for i, (h, ci, co) in enumerate(K1L_BWD_GENERAL):
        staged = not chosen(h, h, ci, co, gs)[0]
        rt, slots = k1l.bwd_general_tile(h, h, ci, co, gs)
        x, w, gamma, beta = stage_inputs(h, ci, co, device, seed=510 + i,
                                         batch=b)
        _, yf, mu, rstd = k1l.upsample_block_rows(
            x, w, gamma, beta, slope=slope, group_size=gs, residuals=True)
        g = torch.randn((b, 2 * h, 2 * h, co), generator=gen,
                        device=device).to(torch.bfloat16)
        args = (g, yf, mu, rstd, gamma, beta, w)

        def run():
            return k1l.upsample_rows_bwd(*args, slope=slope, group_size=gs)

        def plain():
            return k1l.upsample_rows_bwd_plain(*args, slope=slope,
                                               group_size=gs)

        t_staged = queued_ms(run) if staged else None
        k1l.bwd_plan = lambda *a: (True, rt, slots)
        try:
            got = run()
            same = all(torch.equal(a, c) for a, c in zip(got, run()))
            t_k = queued_ms(run)
        finally:
            k1l.bwd_plan = chosen
        errs = errs_of(("dx", "dyf", "dgamma", "dbeta"), got, plain(),
                       SUM_TOL)
        torch.cuda.synchronize()
        bad = {k: v for k, v in errs.items() if v[1] > v[2]}
        t_p = queued_ms(plain)
        t_l = queued_ms(library_stage_bwd(
            x, w.permute(2, 3, 0, 1).flip(2, 3).to(torch.bfloat16)
            .contiguous(), gamma, beta, g, gs, slope))
        b_ms, b_by = bound_ms(32.0 * b * h * h * ci * co,
                              3 * yf.numel() * 2 + b * h * h * ci * 2
                              + 16 * ci * co * 2 + 2 * b * co * 4 + 4 * co * 4)
        print(f"  K1L bwd, general kernel, [{b}, {h}, {h}, {ci}, {co}]: "
              f"clusters of {h // rt} blocks, weight "
              + ("resident" if slots == co // 8 else f"ring of {slots}")
              + f", {k1l.bwd_general_smem(h, ci, slots)} bytes of shared "
              "memory a block; "
              + " ".join(f"{k} abs {v[0]:.4g} rel {v[1]:.3g} (tol {v[2]:.3g})"
                         for k, v in errs.items())
              + f"; two calls bit-identical: {same}; ms={t_k:.5f} "
              f"plain_ms={t_p:.5f} library_ms={t_l:.5f} bound_ms={b_ms:.5f} "
              f"({b_by})"
              + (f"; the staged kernel the wrapper runs here {t_staged:.5f}"
                 if staged else ""))
        if bad or not same:
            fail(f"the general K1L bwd kernel at {(h, ci, co)}: "
                 + (f"disagrees with its plain chain {bad}" if bad
                    else "two calls differ"))


def k1l_training_row(rows, config, stage, x, w, gamma, beta, slope, gs,
                     flops):
    """The K1L stage with residuals at a training shape against its plain
    version, timed by ``queued_ms`` beside the library chain: y by the
    bf16 rule, yf too, mu / rstd within 1e-4 of max |ref|."""
    from levelgan_torch.kernels import upsample_rows as k1l

    b, h, _, ci = x.shape
    co = w.shape[-1]
    library = library_stage(x, w, gamma, beta, gs, slope)

    def run():
        return k1l.upsample_block_rows(x, w, gamma, beta, slope=slope,
                                       group_size=gs, residuals=True)

    def plain():
        return k1l.upsample_block_rows_plain(x, w, gamma, beta, slope=slope,
                                             group_size=gs, residuals=True)

    got, want = run(), plain()
    for name, a, r in zip(("y", "yf"), got, want):
        err, ok = close(a, r)
        if not ok:
            fail(f"K1L at {config} {stage}: {name} disagrees with its plain "
                 f"version (max abs err {err:.4g}, tol {ATOL}+{RTOL}*|ref|)")
    errs = {**errs_of(("y", "yf"), got[:2], want[:2], SUM_TOL),
            **errs_of(("mu", "rstd"), got[2:], want[2:], 1e-4)}
    print("    " + k1l_tile_line(b, h, ci, co, gs, x.device))
    record(rows, config, "K1L", stage, [b, h, h, ci, co], errs, run, plain,
           library, flops, x.numel() * 2 + 16 * ci * co * 2 + 2 * co * 4
           + 2 * b * 4 * h * h * co * 2 + 2 * b * co * 4)


def trunk_inputs(m0, chans, has_gn, device, seed, batch=B_TRAIN):
    """Seeded a0 [B, m0, m0, c0] bf16 (a LeakyReLU output), one (w, b,
    gamma, beta) per trunk layer with weights symmetric in no axis, and
    head_w [4, 4, cl]."""
    import torch
    g = torch.Generator(device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    pre = randn(batch, m0, m0, chans[0])
    a0 = torch.where(pre >= 0, pre, 0.2 * pre).to(torch.bfloat16)
    layers = [(0.05 * randn(4, 4, ci, co), 0.1 * randn(co),
               1.0 + 0.1 * randn(co) if has_gn else None,
               0.1 * randn(co) if has_gn else None)
              for ci, co in zip(chans[:-1], chans[1:])]
    return a0, layers, 0.05 * randn(4, 4, chans[-1])


def sample_errs(name, got, want):
    """``errs_of``-style entries of the per-sample rule (see FLIP_TOL)."""
    import torch
    diff = (got.float() - want.float()).abs()
    per = diff.amax(dim=tuple(range(1, diff.ndim))) / want.float().abs().max()
    q3 = float(torch.quantile(per, 0.75, interpolation="higher"))
    return {f"{name}, 3 samples in 4": (float(diff.max()), q3, SUM_TOL),
            f"{name}, every sample": (float(diff.max()), float(per.max()),
                                      FLIP_TOL)}


def fused_kernel_parity(device, rows, b=B_TRAIN, only=None):
    """Phase 6, K2 fused: the kernel against ``critic_trunk_grad_plain`` on
    the card at the 32x32 critic (the wgan_gp_32 shape) and the 16x16
    critic, with GroupNorm off at the first and group size 8 at the
    second; timed at the two preset shapes.  The library call is the same
    function through cuDNN and autograd in bf16: the trunk's forward from
    layer 0's pre-activation and one ``torch.autograd.grad`` back to it.
    ``only`` picks cases by name; at another ``b`` than B = 64 the rows are
    recorded under ``<case>_b<b>``."""
    import torch
    import torch.nn.functional as F
    from levelgan_torch.kernels import critic_grad as k2f

    slope = 0.2
    cases = (("wgan_gp_32", 16, (64, 128, 256), True, 16, True),
             ("curriculum_16", 8, (64, 128), True, 16, True),
             ("32x32, norm none", 16, (64, 128, 256), False, 16, False),
             ("16x16, group size 8", 8, (64, 128), True, 8, False))
    for i, (name, m0, chans, has_gn, gs, timed) in enumerate(cases):
        if only is not None and name not in only:
            continue
        a0, layers, head_w = trunk_inputs(m0, chans, has_gn, device, 500 + i,
                                          batch=b)
        if b != B_TRAIN:
            name = f"{name}_b{b}"

        def run():
            return k2f.critic_trunk_grad(a0, layers, head_w, slope=slope,
                                         group_size=gs)

        def plain():
            return k2f.critic_trunk_grad_plain(a0, layers, head_w,
                                               slope=slope, group_size=gs)

        got, want = run(), plain()
        errs = sample_errs("dy0", got, want)
        # the same chain without intermediate roundings (f32 activations,
        # the weights and biases as the kernel rounds them): how far bf16
        # itself moves the result, beside how far the two sides differ
        bf16 = torch.bfloat16
        exact = k2f.critic_trunk_grad_plain(
            a0.float(), [(w.to(bf16).float(), bias.to(bf16).float(), ga, be)
                         for w, bias, ga, be in layers], head_w, slope=slope,
            group_size=gs)
        diff = (got.float() - want.float()).abs().amax(dim=(1, 2, 3))
        beyond = int((diff / want.float().abs().max() > SUM_TOL).sum())
        print(f"  K2 fused {name}: {beyond} of {b} samples beyond "
              f"{SUM_TOL:.3g} of the plain version; against the chain "
              f"without intermediate roundings, kernel "
              f"{rel_err(got, exact):.4g}, plain {rel_err(want, exact):.4g}")
        if not timed:
            torch.cuda.synchronize()
            print(f"  K2 fused {name} {[b, m0, m0, *chans]}: "
                  + " ".join(f"{k} abs {v[0]:.4g} rel {v[1]:.3g} (tol "
                             f"{v[2]:.3g})" for k, v in errs.items()))
            if any(v[1] > v[2] for v in errs.values()):
                fail(f"K2 fused at {name} disagrees with its plain version")
            continue

        pre = a0.permute(0, 3, 1, 2).contiguous().requires_grad_()
        lib = [(w.permute(3, 2, 0, 1).to(bf16).contiguous(), bias.to(bf16),
                gamma.to(bf16), beta.to(bf16))
               for w, bias, gamma, beta in layers]
        head_nchw = head_w.permute(2, 0, 1).contiguous()

        def library():
            x = F.leaky_relu(pre, slope)
            for w, bias, gamma, beta in lib:
                x = F.conv2d(x, w, bias, stride=2, padding=1)
                x = F.leaky_relu(F.group_norm(x, x.shape[1] // gs, gamma,
                                              beta, 1e-5), slope)
            return torch.autograd.grad((x.float() * head_nchw).sum(), pre)

        m, flops, wbytes = m0, 0.0, 0
        for ci, co in zip(chans[:-1], chans[1:]):
            m //= 2
            flops += 2 * 2.0 * 16 * m * m * b * ci * co     # forward and dx
            wbytes += 16 * ci * co * 2 + 3 * co * 4
        nbytes = 2 * a0.numel() * 2 + wbytes + head_w.numel() * 4
        record(rows, name, "K2 fused", "gp", [b, m0, m0, *chans], errs, run,
               plain, library, flops, nbytes)

        # where the kernel's time goes: the weight pack (one launch, timed
        # with the kernel above as training calls it), one sample alone on
        # the card, and the first block's phases
        ws = [w for w, *_ in layers]
        packed = k2f.pack_weights(ws)
        if not torch.equal(packed.cpu(), k2f.pack_weights_plain(
                [w.cpu() for w in ws])):
            fail(f"K2 fused at {name}: the pack kernel disagrees with "
                 "pack_weights_plain")
        depth = k2f.ring_depth(m0, chans)
        print(f"    clusters of {k2f.CS} blocks (one per sample, split by "
              f"output channels), grid {b * k2f.CS} blocks of "
              f"{(k2f.NCW + 1) * 32} threads, "
              f"{k2f.smem_layout(m0, chans, depth)['total']} bytes of shared "
              f"memory a block, a ring of {depth} chunks of "
              f"{k2f.CHUNK_BYTES} bytes; the pack kernel matches "
              "pack_weights_plain bit for bit")

        def packing():
            return k2f.pack_weights(ws)

        def one_sample():
            return k2f.critic_trunk_grad(a0[:1], layers, head_w, slope=slope,
                                         group_size=gs)

        # how fast the card's L2 streams the bf16 weights of both directions
        # to every sample: one torch.sum over them broadcast (stride 0) to
        # the batch, so each row re-reads the same 2 x the weight bytes
        wflat = torch.cat([w.to(bf16).reshape(-1) for w in ws] * 2)
        wide = wflat.expand(b, -1)

        def l2_stream():
            return wide.sum(dim=1, dtype=torch.float32)

        l2_ms = queued_ms(l2_stream)
        print(f"    L2 weight stream: {b} x {wflat.numel() * 2 / 2**20:.3f} "
              f"MiB read by torch.sum in {l2_ms:.5f} ms = "
              f"{b * wflat.numel() * 2 / l2_ms / 1e9:.3f} TB/s")
        probe = torch.zeros(2 + 4 * len(layers), dtype=torch.int64,
                            device=device)
        k2f.critic_trunk_grad(a0, layers, head_w, slope=slope, group_size=gs,
                              probe=probe)
        torch.cuda.synchronize()
        stamps = probe.tolist()
        print(f"    of that, the weight pack kernel "
              f"{queued_ms(packing):.5f} ms; the whole call at B = 1 "
              f"{queued_ms(one_sample):.5f} ms; first block by phase (us): "
              + ", ".join(f"{ph} {(t1 - t0) / 1e3:.2f}" for ph, t0, t1 in zip(
                  k2f.phase_names(len(layers)), stamps, stamps[1:]))
              + f"; block total {(stamps[-1] - stamps[0]) / 1e3:.2f}")


def time_gradient_penalties(cfg, device):
    """The GP implementations whole (value + backward to the critic's
    parameters) on ``cfg``'s critic at B = 64, CUDA-event medians: plain,
    K2 core, the fused GP where the kernel serves the critic, and plain
    again (the order of measurement shows in the host-bound wall time)."""
    import torch
    from levelgan_torch.kernels.critic_grad import (fused_supported,
                                                    gradient_penalty_fused)
    from levelgan_torch.kernels.gp_penalty import gradient_penalty_core
    from levelgan_torch.models import Critic
    from levelgan_torch.ops.grad_penalty import gradient_penalty

    m = cfg.model
    critic = Critic(m).init_params(torch.Generator().manual_seed(1)).to(device)
    g = torch.Generator(device).manual_seed(5)
    shape = (B_TRAIN, m.level_size, m.level_size, m.n_tiles)
    real = torch.nn.functional.one_hot(
        torch.randint(0, m.n_tiles, shape[:3], generator=g, device=device),
        m.n_tiles).float()
    fake = torch.softmax(torch.randn(shape, generator=g, device=device), -1)
    eps = torch.rand((B_TRAIN, 1, 1, 1), generator=g, device=device)
    params = list(critic.parameters())
    impls = [("plain", gradient_penalty), ("core", gradient_penalty_core)]
    if fused_supported(m):
        impls.append(("fused", gradient_penalty_fused))
    impls.append(("plain again", gradient_penalty))
    out = {}
    for name, fn in impls:
        def run(fn=fn):
            val = fn(critic, real, fake, None, eps)
            return val, torch.autograd.grad(val, params, allow_unused=True)
        out[name] = (float(run()[0].detach()), median_ms(run),
                     profiled_ms(run, n=5))
    ref = out["plain"][0]
    diffs = {k: abs(v[0] - ref) / max(abs(ref), 1e-6) for k, v in out.items()}
    print(f"  GP value + backward, {cfg.preset} critic, B={B_TRAIN} (wall ms "
          "by CUDA events / device ms by profiler): "
          + ", ".join(f"{k} {v[1]:.4f} / "
                      + ("not measured" if v[2] is None else f"{v[2]:.4f}")
                      for k, v in out.items())
          + "; values " + ", ".join(f"{k} {v[0]:.6g} (rel diff "
                                    f"{diffs[k]:.3g})" for k, v in out.items()))
    if diffs["core"] > 1e-3 or diffs.get("fused", 0.0) > GP_TOL:
        fail(f"the GP implementations disagree (core tol 1e-3, fused tol "
             f"{GP_TOL})")


def train_path(name, overrides, steps, workdir):
    """Phase 7: train preset ``name`` through the CLI with counted launches,
    check the metrics (the BCE step's ``d_real`` / ``d_fake``, the
    conditional step's ``cond_match``) and the checkpoint, then export from
    that checkpoint (a conditional one at the corpus-mean cond)."""
    import numpy as np
    import torch
    from levelgan_torch.cli import export as cli_export
    from levelgan_torch.cli import train as cli_train
    from levelgan_torch.config import preset
    from levelgan_torch.kernels import upsample_rows as k1l

    m = preset(name).model
    track = m.family == "track"
    out = os.path.join(workdir, f"train_{name}")
    # the K1L backward's plain pass may run on CPU tensors only
    eager_gn, on_card = k1l.gn_act_bwd_folded, []

    def spy(g, *a, **kw):
        on_card.append(g.device.type == "cuda")
        return eager_gn(g, *a, **kw)

    reset_counts()
    k1l.gn_act_bwd_folded = spy
    t0 = time.perf_counter()
    try:
        # toy_dcgan_16 is the CLI's default preset: run it without --preset
        # the track corpus (4096 NumPy tracks, 1 MiB) is not cut
        cut = () if track else ("--set", f"data.corpus_size={CORPUS_CUT}")
        rc = cli_train.main([*(("--preset", name) if name != "toy_dcgan_16"
                               else ()), *overrides, "--set",
                             f"train.steps={steps}", "--set",
                             "io.log_every=10", *cut, "--out", out])
        torch.cuda.synchronize()
    finally:
        k1l.gn_act_bwd_folded = eager_gn
    wall = time.perf_counter() - t0
    counts = read_counts()
    if rc != 0:
        fail(f"train CLI returned {rc}")
    if any(on_card):
        fail(f"gn_act_bwd_folded ran on CUDA tensors {sum(on_card)} times")
    expect = {k: steps * v for k, v in PER_STEP[name].items()}
    probes = steps // QUALITY_EVERY if set(QUALITY) <= set(overrides) else 0
    renders = steps // RENDER_EVERY if RENDER[1] in overrides else 0
    if probes or renders:
        # a probe and a render are each a forward of the EMA generator: one
        # launch a stage
        from levelgan_torch.kernels import upsample_block as k1
        fits = [k1.fits(h, h) for _, h, _, _ in stage_shapes(preset(name))]
        expect["K1"] += (probes + renders) * sum(fits)
        expect["K1L"] += (probes + renders) * (len(fits) - sum(fits))
        m = preset(name).model
        if m.head == "gumbel" and m.structural_head == "none":
            expect["head"] += probes + renders
    print(f"  trained {steps} steps through the CLI in {wall:.3f} s "
          f"(wall, incl. corpus carving and checkpoint); launches {counts}; "
          f"gn_act_bwd_folded on CUDA tensors: {sum(on_card)} times")
    if counts != expect:
        fail(f"training launches {counts} != expected {expect}")
    if renders:
        print(f"  io.render_every={RENDER_EVERY}: "
              f"{check_renders(out, steps)}")
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        recs = [json.loads(s) for s in fh.read().splitlines()]
    lines = [r for r in recs if "d_loss" in r]
    if [r["step"] for r in lines] != list(range(10, steps + 1, 10)):
        fail(f"metrics.jsonl steps {[r['step'] for r in lines]}")
    t = preset(name).train
    keys = ["d_loss", "g_loss", *(("d_real", "d_fake") if t.loss == "gan"
                                  else ("gp", "wdist")), "kl", "step_ms"]
    cur = preset(name).curriculum
    if t.loss == "curriculum":
        keys += TRACK_CURRICULUM_KEYS if track else CURRICULUM_KEYS
        if not track and (cur.w_solvable or cur.gap_on_solvable):
            keys.append("solvable_frac")
    if t.w_presence:
        keys.append("presence")
    if t.w_cond_match:
        keys.append("cond_match")
    for r in lines:
        for k in keys:
            if not math.isfinite(r.get(k, float("nan"))):
                fail(f"metrics line {r}: {k} not finite")
        print(f"  metrics step {r['step']}: "
              + " ".join(f"{k}={r[k]:.5g}" for k in keys))
    if probes:
        q = [r for r in recs if "solvable_frac" in r]
        qkeys = ("solvable_frac", "has_start_frac", "has_goal_frac")
        if [r["step"] for r in q] != list(range(QUALITY_EVERY, steps + 1,
                                                 QUALITY_EVERY)) or not all(
                0.0 <= r[k] <= 1.0 for r in q for k in qkeys):
            fail(f"quality probe lines {q}")
        best = os.listdir(os.path.join(out, "ckpt_best"))
        if len(best) != 1:
            fail(f"ckpt_best holds {best}")
        print("  quality probe: " + "; ".join(
            f"step {r['step']} " + " ".join(f"{k}={r[k]:.4g}" for k in qkeys)
            for r in q) + f"; ckpt_best/{best[0]}")
    ckpt = os.path.join(out, "ckpt", f"step_{steps:08d}")
    arrays = load_arrays(ckpt)
    prefixes = ["generator/", "g_ema/", "discriminator/"]
    if t.loss == "curriculum":
        prefixes += ["agent_strong/", "agent_weak/", "opt_as/0/mu/",
                     "opt_aw/0/nu/"]
        if (int(arrays["opt_as/0/count"]) != steps
                or not float(arrays["g_baseline"])):
            fail(f"checkpoint {ckpt}: agent Adam count "
                 f"{int(arrays['opt_as/0/count'])}, g_baseline "
                 f"{float(arrays['g_baseline'])}")
        print(f"  checkpoint: agents, their Adams (count "
              f"{int(arrays['opt_as/0/count'])}) and g_baseline "
              f"{float(arrays['g_baseline']):.5g}")
    for prefix in prefixes:
        if not any(k.startswith(prefix) for k in arrays):
            fail(f"checkpoint {ckpt} holds no {prefix} arrays")
    levels_path = os.path.join(workdir, f"trained_levels_{name}.npz")
    if cli_export.main(["--ckpt", ckpt, "--n", "1024", "--batch", "1024",
                        "--out", levels_path, "--seed", "0"]) != 0:
        fail("export from the trained checkpoint failed")
    if track:
        check_tracks(np.load(levels_path)["tracks"], 1024, m.n_segments,
                     f"the {name} checkpoint's export")
        return counts
    levels = np.load(levels_path)["levels"]
    if (levels.shape != (1024, m.level_size, m.level_size)
            or levels.dtype != np.uint8 or int(levels.max()) >= m.n_tiles):
        fail(f"levels from the trained checkpoint: {levels.dtype} "
             f"{levels.shape} max {int(levels.max())}")
    hist = np.bincount(levels.reshape(-1), minlength=m.n_tiles) / levels.size
    print(f"  exported 1024 levels from {os.path.basename(ckpt)}: tile "
          f"histogram {np.round(hist, 4).tolist()}")
    return counts


def load_arrays(path: str) -> dict:
    import numpy as np
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def differing(a: dict, b: dict) -> list:
    import numpy as np
    return sorted(set(a) ^ set(b)) + [
        k for k in a if k in b and not np.array_equal(a[k], b[k])]


def reproducibility(device, workdir, steps=REPRO_STEPS):
    """A fresh process runs ``steps`` seeded gumbel_64 steps through
    ``api.train`` three times: its first run must equal its later ones in
    every array (``first_run_check``; fatal).  Then two such runs here, by
    default and under ``torch.use_deterministic_algorithms`` (warn only):
    whether the final checkpoints are bit-identical, which arrays differ,
    and the steps' ``step_ms``; where the default runs differ, one step run
    twice from one state names the first module output or parameter
    gradient that differs (``first_divergence``).  Then ``resumed_runs``
    holds a resumed and a SIGTERM-stopped run to the first default run.
    The phase runs with torch's own TF32 settings, as the train CLI does
    (main() turns TF32 off for the plain references)."""
    import numpy as np
    import torch
    from levelgan_torch import api
    from levelgan_torch.config import preset

    cfg = preset("gumbel_64").override(**{
        "train.steps": steps, "data.corpus_size": REPRO_CORPUS,
        "io.log_every": 1})
    fresh = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(min(1, chip_smoke.first_run_check()))"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    for line in fresh.stdout.strip().splitlines():
        print("  " + line)
    if fresh.returncode != 0:
        fail("the first training run of a fresh process differs from its "
             f"later runs: {fresh.stdout[-800:]}{fresh.stderr[-2000:]}")
    differs, whole = {}, None
    # torch's own TF32 settings, as the CLI subprocess below runs: cuDNN's
    # f32 convolutions (the stages' dw) take TF32 by default
    backends = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = [b.allow_tf32 for b in backends]
    for b, on in zip(backends, TORCH_TF32 or saved):
        b.allow_tf32 = on
    try:
        for det in (False, True):
            torch.use_deterministic_algorithms(det, warn_only=True)
            arrays, step_ms = [], []
            for run in (0, 1):
                out = os.path.join(workdir, f"repro_{int(det)}_{run}")
                res = api.train(cfg.override(**{"io.out_dir": out}),
                                device=device, echo=False)
                arrays.append(load_arrays(res["checkpoint"]))
                with open(os.path.join(out, "metrics.jsonl")) as fh:
                    step_ms += [json.loads(ln)["step_ms"]
                                for ln in fh.read().splitlines()][1:]
            diff = [k for k in arrays[0]
                    if not np.array_equal(arrays[0][k], arrays[1][k])]
            params = [k for k in arrays[0]
                      if k.startswith(("generator/", "discriminator/"))]
            differs[det] = diff
            print(f"  use_deterministic_algorithms({det}): two {steps}-step "
                  f"runs {'bit-identical' if not diff else 'differ'}: "
                  f"{len(diff)} of {len(arrays[0])} arrays differ, "
                  f"{sum(k in diff for k in params)} of {len(params)} "
                  f"generator and critic parameters"
                  + (f" (first: {diff[:4]})" if diff else "")
                  + "; step_ms after the first step "
                  + ", ".join(f"{v:.2f}" for v in step_ms))
            whole = whole or arrays[0]
        torch.use_deterministic_algorithms(False)
        if differs[False]:
            print("  " + first_divergence(cfg, device))
        resumed_runs(cfg, device, workdir, whole)
    finally:
        torch.use_deterministic_algorithms(False)
        for b, on in zip(backends, saved):
            b.allow_tf32 = on


def resumed_runs(cfg, device, workdir, whole: dict):
    """Resume and stop against uninterrupted runs, array by array, all
    fatal: a run of ``cfg`` stopped after 2 steps and resumed through
    ``io.resume=auto`` here must equal ``whole``, an uninterrupted run made
    here; through the train CLI, each in a fresh process, an uninterrupted
    run must equal ``whole`` too, and a run sent SIGTERM after its first
    logged step (it must exit 0 with a checkpoint before the last step)
    that ``--resume auto`` then finishes here must equal the uninterrupted
    CLI run."""
    import signal
    from levelgan_torch import api
    from levelgan_torch.cli import train as cli_train
    from levelgan_torch.lio.checkpoint import all_checkpoints

    steps = cfg.train.steps
    here = os.path.dirname(os.path.abspath(__file__))

    def check(what, arrays, ref, ref_name):
        diff = differing(arrays, ref)
        print(f"  {what}: {'bit-identical to' if not diff else 'differs from'}"
              f" {ref_name} in {len(ref)} arrays"
              + (f" ({len(diff)} differ, first: {diff[:4]})" if diff else ""))
        if diff:
            fail(f"{what} differs from {ref_name}: {diff[:8]}")

    out = os.path.join(workdir, "repro_resumed")
    api.train(cfg.override(**{"io.out_dir": out, "train.steps": 2}),
              device=device, echo=False)
    res = api.train(cfg.override(**{"io.out_dir": out, "io.resume": "auto"}),
                    device=device, echo=False)
    check("2 steps, then 1 resumed through io.resume=auto",
          load_arrays(res["checkpoint"]), whole,
          f"the uninterrupted {steps}-step run")

    cfg_path = os.path.join(workdir, "repro_config.json")
    with open(cfg_path, "w") as fh:
        fh.write(cfg.to_json())

    def cli(out, stop):
        argv = ["--config", cfg_path, "--out", out, "--device", str(device)]
        metrics = os.path.join(out, "metrics.jsonl")
        proc = subprocess.Popen(
            [sys.executable, "-m", "levelgan_torch.cli.train", *argv],
            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        try:
            t0 = time.perf_counter()
            while stop and not (os.path.exists(metrics)
                                and os.path.getsize(metrics)):
                if proc.poll() is not None or time.perf_counter() - t0 > 300:
                    fail("the train CLI logged no step: "
                         + proc.communicate(timeout=60)[0][-2000:])
                time.sleep(0.002)
            if stop:
                proc.send_signal(signal.SIGTERM)
            text = proc.communicate(timeout=300)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        ckpts = all_checkpoints(os.path.join(out, "ckpt"))
        step = int(load_arrays(ckpts[-1])["step"]) if ckpts else None
        return argv, proc.returncode, step, text

    _, rc, step, text = cli(os.path.join(workdir, "repro_cli"), False)
    if rc != 0 or step != steps:
        fail(f"the train CLI: exit {rc}, checkpoint step {step}: "
             f"{text[-2000:]}")
    fresh = load_arrays(all_checkpoints(os.path.join(
        workdir, "repro_cli", "ckpt"))[-1])
    check(f"the CLI's uninterrupted {steps}-step run (a fresh process)",
          fresh, whole, f"the uninterrupted {steps}-step run in this process")

    out = os.path.join(workdir, "repro_sigterm")
    argv, rc, stopped, text = cli(out, True)
    print(f"  the CLI sent SIGTERM after its first step: exit {rc}"
          f", checkpoint at step {stopped}; its last line: "
          f"{text.strip().splitlines()[-1] if text.strip() else ''}")
    if rc != 0 or stopped is None or not stopped < steps:
        fail(f"SIGTERM: exit {rc}, checkpoint step {stopped} "
             f"(want exit 0 and a step < {steps}): {text[-2000:]}")
    if cli_train.main([*argv, "--resume", "auto"]) != 0:
        fail("--resume auto after SIGTERM failed")
    check(f"stopped by SIGTERM at step {stopped}, finished with --resume auto",
          load_arrays(all_checkpoints(os.path.join(out, "ckpt"))[-1]), fresh,
          "the CLI's uninterrupted run")


def step_trace(cfg, device, steps: int = 1) -> list:
    """``steps`` train steps from a state made from one seed, on a seeded
    random corpus on the device, with the batches and randomness
    ``api.train`` draws: (name, checksum) of every leaf module output and
    parameter gradient in the order they were computed, of the gradient
    each use of a critic GroupNorm scale or bias receives, and of the
    parameters and the Adam moments after each step; each step under
    ``api.step_mode``, as api.train runs it."""
    import torch
    from levelgan_torch.api import sample_batch, step_generator, step_mode
    from levelgan_torch.models import critic as critic_mod
    from levelgan_torch.train.state import create_state
    from levelgan_torch.train.wgan_gp import make_wgan_gp_step

    m = cfg.model
    corpus = torch.randint(0, m.n_tiles, (CORPUS_CUT, m.level_size,
                                          m.level_size), dtype=torch.uint8,
                           device=device,
                           generator=torch.Generator(device).manual_seed(22))
    step_fn = make_wgan_gp_step(cfg)
    state = create_state(cfg, device, seed=21)
    rec, handles, at = [], [], [0]

    def note(name, t):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            t = t.detach().double()
            rec.append((f"step {at[0]} {name}",
                        torch.stack([t.sum(), t.square().sum()])))

    names = {id(p): n for n, p in state.critic.named_parameters()}
    plain_gn = critic_mod.group_norm

    def gn_uses(x, gamma, beta, *a):
        # each use gets an alias of its own, so its gradient shows alone
        if torch.is_grad_enabled():
            gamma, beta = gamma.view_as(gamma), beta.view_as(beta)
            for t, p in ((gamma, "scale"), (beta, "bias")):
                t.register_hook(lambda g, n=names.get(id(t._base), p):
                                note(f"D {n} use gradient", g))
        return plain_gn(x, gamma, beta, *a)
    critic_mod.group_norm = gn_uses

    for prefix, model in (("G", state.generator), ("D", state.critic)):
        for name, mod in model.named_modules():
            if not list(mod.children()):
                handles.append(mod.register_forward_hook(
                    lambda mod_, args, out, n=f"{prefix} {name or 'root'}":
                    note(f"{n} output", out if isinstance(out, torch.Tensor)
                         else out[0])))
        for name, p in model.named_parameters():
            handles.append(p.register_hook(
                lambda g, n=f"{prefix} {name}": note(f"{n} gradient", g)))
    for i in range(steps):
        at[0] = i
        rng = step_generator(cfg, i, device)
        with step_mode():
            step_fn(state, sample_batch(corpus, cfg, rng), generator=rng)
        for prefix, model, opt in (("G", state.generator, state.opt_g),
                                   ("D", state.critic, state.opt_d)):
            for name, p in model.named_parameters():
                note(f"{prefix} {name} after the update", p)
                for k in ("exp_avg", "exp_avg_sq"):
                    note(f"{prefix} {name} {k}", opt.state[p].get(k))
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    critic_mod.group_norm = plain_gn
    return rec


def first_difference(a: list, b: list, what: str) -> str:
    """The first record where two ``step_trace``s differ, by name."""
    import torch
    for i, ((n0, c0), (n1, c1)) in enumerate(zip(a, b)):
        if n0 != n1:
            return f"{what}: different ops at record {i}: {n0} / {n1}"
        if not torch.equal(c0, c1):
            return f"{what}: first difference at record {i} of {len(a)}: {n0}"
    return (f"{what}: all {len(a)} module outputs, gradients, parameters "
            "and moments identical")


def first_divergence(cfg, device) -> str:
    """One train step run twice from two states made from one seed, with
    the same batch and randomness: the first module output or parameter
    gradient, in the order they were computed, whose checksum differs."""
    return first_difference(step_trace(cfg, device), step_trace(cfg, device),
                            "one step twice from one seed")


def first_run_check(name: str = "gumbel_64", keep: str = "") -> int:
    """Run in a fresh process: three ``REPRO_STEPS``-step runs of preset
    ``name`` through ``api.train`` (a tile corpus cut to REPRO_CORPUS);
    prints whether the process's first run equals its second and its second
    its third, array by array, and returns how many arrays of the first
    differ from the second.  ``keep``: an .npz path for the first run's
    arrays."""
    import numpy as np
    from levelgan_torch import api
    from levelgan_torch.config import preset

    cfg = preset(name).override(**{"train.steps": REPRO_STEPS,
                                   "io.log_every": 1})
    if cfg.model.family == "tile":
        cfg = cfg.override(**{"data.corpus_size": REPRO_CORPUS})
    arrays = []
    with tempfile.TemporaryDirectory() as work:
        for run in (0, 1, 2):
            res = api.train(cfg.override(**{"io.out_dir": os.path.join(
                work, str(run))}), device="cuda", echo=False)
            arrays.append(load_arrays(res["checkpoint"]))
    if keep:
        np.savez(keep, **arrays[0])
    first = []
    for a, b in ((0, 1), (1, 2)):
        diff = differing(arrays[a], arrays[b])
        first += diff if a == 0 else []
        print(f"first-run check {name}: the process's run {a + 1} against "
              f"its run {b + 1} ({REPRO_STEPS} steps each): {len(diff)} of "
              f"{len(arrays[0])} arrays differ"
              + (f" ({diff[:4]})" if diff else ""), flush=True)
    return len(first)


def fresh_vs_warm(steps: int = 3) -> None:
    """Run in a fresh process (the repro phase starts it): ``steps`` traced
    steps of the repro configuration, then the same again in this process,
    now warm; prints where the first differs from the second."""
    import torch
    from levelgan_torch.config import preset
    device = torch.device("cuda", 0)
    cfg = preset("gumbel_64").override(**{"data.corpus_size": REPRO_CORPUS})
    fresh = step_trace(cfg, device, steps)
    print(first_difference(fresh, step_trace(cfg, device, steps),
                           f"{steps} steps in a fresh process against the "
                           "same in that process warm"))


def make_step(cfg):
    """The train step of ``cfg``'s family and loss, as api.train makes it."""
    from levelgan_torch.api import make_step_fn
    return make_step_fn(cfg)


def rollout_site(cfg):
    """(module, name) of the rollout function a curriculum step calls."""
    if cfg.model.family == "track":
        from levelgan_torch.track import train as track_train
        return track_train, "race_rollout"
    from levelgan_torch.train import curriculum
    return curriculum, "rollout"


class RolloutClock:
    """Wraps the curriculum step's rollout (the tile ``rollout``, the
    track's ``race_rollout``): CUDA events and the host clock around each
    call (no synchronisation), summed per step."""

    def __init__(self, cfg):
        self.mod, self.name = rollout_site(cfg)
        self.orig, self.calls = getattr(self.mod, self.name), []

    def __enter__(self):
        import torch

        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = self.orig(*a, **kw)
            end.record()
            self.calls.append((start, end, time.perf_counter() - t0))
            return out
        setattr(self.mod, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)

    def take(self):
        """(device ms, host ms) of the calls since the last take, after a
        device synchronisation."""
        import torch
        torch.cuda.synchronize()
        dev = sum(a.elapsed_time(b) for a, b, _ in self.calls)
        host = 1e3 * sum(h for _, _, h in self.calls)
        self.calls = []
        return dev, host


def warm_steps(cfg, device):
    """The warm step time: a device-synchronised loop of the same step
    (create_state + the loss's step, per-step batches and noise as
    api.train draws them, under ``api.step_mode`` as api.train runs it)
    over a random uint8 corpus already on the device; the median over steps
    10-30.
    For the curriculum also the two rollouts' share of it: their span
    between CUDA events and their host time."""
    import torch
    from levelgan_torch.api import sample_batch, step_generator, step_mode
    from levelgan_torch.train.state import create_state

    m = cfg.model
    state = create_state(cfg, device)
    step_fn = make_step(cfg)
    if m.family == "track":
        from levelgan_torch.api import make_dataset
        corpus = torch.from_numpy(make_dataset(cfg).tracks).to(device)
    else:
        corpus = torch.randint(
            0, m.n_tiles, (CORPUS_CUT, m.level_size, m.level_size),
            dtype=torch.uint8, device=device,
            generator=torch.Generator(device).manual_seed(9))
    torch.cuda.reset_peak_memory_stats()
    times, roll = [], []
    with RolloutClock(cfg) as clock, step_mode():
        for i in range(WARM_STEPS):
            rng = step_generator(cfg, i, device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step_fn(state, sample_batch(corpus, cfg, rng),
                               generator=rng)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            roll.append(clock.take())
    warm = statistics.median(times[10:])
    print(f"  warm step: median {warm:.3f} ms over steps 10-{WARM_STEPS} "
          f"(min {min(times[10:]):.3f}, max {max(times[10:]):.3f}; first "
          f"step {times[0]:.1f} ms); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    if cfg.train.loss == "curriculum":
        dev = statistics.median(d for d, _ in roll[10:])
        host = statistics.median(h for _, h in roll[10:])
        print(f"  the two rollouts ({cfg.curriculum.rollout_steps} env steps "
              f"each, B = {cfg.train.batch_size}): median {host:.3f} ms of "
              f"host time and {dev:.3f} ms between their CUDA events a step, "
              f"{host / warm:.3f} of the warm step's wall time")
    return state, step_fn, corpus


def train_vs_plain(cfg, device):
    """Phase 8: one critic iteration and one generator update through the
    kernels, then through the plain path (``plain=True``, the plain GP), on
    one state, batch and noise.  The kernel side's GP is the one
    ``cfg.model.pallas_gp`` picks (K2 core, or K2 fused with the core).

    The critic's gradients differ only in the GP (both sides run the same
    bf16 critic on the same fake), so they, the loss and the GP value are
    held to GRAD_TOL / LOSS_TOL of each other.  The generator's pass
    through bf16 stages whose rounding points differ (the kernel normalises the f32 conv tile, the
    plain path rounds the conv to bf16 first), so each side is held to an
    f32 copy of the generator (plain path, f32 activations): the kernels'
    gradient may be at most BF16_RATIO times as far from it as the plain
    bf16 path's, plus BF16_SLACK.
    """
    import dataclasses

    import torch
    from levelgan_torch.kernels import upsample_block as k1
    from levelgan_torch.models import Generator, sample_head
    from levelgan_torch.ops.grad_penalty import (gradient_penalty,
                                                 make_gradient_penalty)
    from levelgan_torch.train.gan import current_tau, prepare_real
    from levelgan_torch.train.state import create_state
    from levelgan_torch.train.wgan_gp import draw_step_noise

    m, t = cfg.model, cfg.train
    state = create_state(cfg, device, seed=11)
    gen, critic = state.generator, state.critic
    gen32 = Generator(dataclasses.replace(m, dtype="float32"))
    gen32.load_state_dict(gen.state_dict())
    gen32 = gen32.to(device)
    g = torch.Generator(device).manual_seed(12)
    ids = torch.randint(0, m.n_tiles, (B_TRAIN, m.level_size, m.level_size),
                        dtype=torch.uint8, device=device, generator=g)
    noise = draw_step_noise(cfg, 1, B_TRAIN, device, g)
    nz, ng = noise["critic"][0], noise["g"]
    tau = current_tau(cfg, 0)
    real, _ = prepare_real(cfg, ids, nz["elements"])
    with torch.no_grad():
        # one fake for both sides, so the critic check isolates the GP core
        fake = sample_head(gen(nz["z"]), m.head, tau, m.structural_head,
                           noise=nz["noise"])
    d_params = list(critic.parameters())
    res = {}
    for side, gp_fn, model, plain in (
            ("kernels", make_gradient_penalty(m), gen, False),
            ("plain", gradient_penalty, gen, True),
            ("f32", None, gen32, True)):
        before = read_counts()
        d_loss, gp, d_grads = float("nan"), float("nan"), None
        if gp_fn is not None:
            wdist = critic(real, None).mean() - critic(fake, None).mean()
            gp = gp_fn(critic, real, fake, None, nz["eps"])
            d_loss = -wdist + t.gp_lambda * gp
            d_grads = torch.autograd.grad(d_loss, d_params)
            d_loss, gp = float(d_loss.detach()), float(gp.detach())
        fake_g = sample_head(model(ng["z"], plain=plain), m.head, tau,
                             m.structural_head, noise=ng["noise"])
        g_loss = -critic(fake_g, None).mean()
        g_grads = torch.autograd.grad(g_loss, list(model.parameters()),
                                      allow_unused=True)
        torch.cuda.synchronize()
        after = read_counts()
        res[side] = (d_loss, float(g_loss.detach()), d_grads, g_grads,
                     {k: after[k] - before[k] for k in after}, gp)
    k, p, ref = res["kernels"], res["plain"], res["f32"]
    launches = k[4]
    d_err = sorted(((rel_err(a, r), n) for (n, _), a, r in zip(
        critic.named_parameters(), k[2], p[2])), reverse=True)
    g_err = sorted(((rel_err(a, r32), rel_err(b, r32), n)
                    for (n, _), a, b, r32 in zip(gen.named_parameters(), k[3],
                                                 p[3], ref[3])),
                   key=lambda e: e[0] - BF16_RATIO * e[1], reverse=True)
    loss_err = max(abs(k[i] - p[i]) / max(abs(p[i]), 0.1) for i in (0, 1, 5))
    print(f"  d_loss kernels {k[0]:.6g} plain {p[0]:.6g}; gp kernels "
          f"{k[5]:.6g} plain {p[5]:.6g}; g_loss kernels "
          f"{k[1]:.6g} plain {p[1]:.6g} f32 {ref[1]:.6g}; loss err "
          f"{loss_err:.3g} (tol {LOSS_TOL}); launches {launches}")
    print("  critic gradients, kernels vs plain (max |diff| / max |ref|, tol "
          f"{GRAD_TOL}), largest: "
          + ", ".join(f"{n} {e:.3g}" for e, n in d_err[:4]))
    print("  generator gradients vs the f32 generator (kernels / plain bf16; "
          f"allowed kernels <= {BF16_RATIO} * plain + {BF16_SLACK}), "
          "closest to the limit: "
          + ", ".join(f"{n} {a:.3g}/{b:.3g}" for a, b, n in g_err[:6]))
    n_k1 = sum(k1.fits(h, h) for _, h, _, _ in stage_shapes(cfg))
    n_k1l = len(stage_shapes(cfg)) - n_k1
    want = {"K1": n_k1, "K1L": n_k1l, "K1 bwd": n_k1, "K1L bwd": n_k1l,
            "K2 core fwd": 1, "K2 core bwd": 1,
            "K2 fused": int(m.pallas_gp == "fused"), "head": 0}
    if launches != want or any(p[4].values()) or any(ref[4].values()):
        fail(f"kernel side launched {launches} (want {want}), plain sides "
             f"{p[4]} {ref[4]}")
    for (name, _), gk in zip(gen.named_parameters(), k[3]):
        if gk is None or not bool(gk.abs().max() > 0):
            fail(f"generator parameter {name} got no gradient through the "
                 "kernels")
    if loss_err > LOSS_TOL or d_err[0][0] > GRAD_TOL or any(
            a > BF16_RATIO * b + BF16_SLACK for a, b, _ in g_err):
        fail("training through the kernels disagrees with the plain path")
    print(f"  every one of the {len(k[3])} generator parameters got a "
          "non-zero gradient through the kernels")


def profile_train(state, step_fn, corpus, cfg, steps=3):
    """Phase 9: where a training step's time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from levelgan_torch.api import sample_batch, step_generator, step_mode

    rngs = [step_generator(cfg, 100 + i, corpus.device) for i in range(steps)]
    torch.cuda.synchronize()
    with step_mode(), profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for rng in rngs:
            state, _ = step_fn(state, sample_batch(corpus, cfg, rng),
                               generator=rng)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    if cfg.train.loss == "curriculum":
        rollout_ops(state, cfg, corpus)
    rows = device_rows(prof)
    if not rows:
        print("  profiler recorded no device kernels: breakdown not measured")
        return
    # K2 core bwd runs only on the autograd engine's thread: if the
    # profiler lost that thread's kernels, the breakdown is partial
    seen = sum(e.count for e in rows if "norm_penalty_bwd" in e.key)
    want = PER_STEP[cfg.preset]["K2 core bwd"] * steps
    if seen != want:
        print(f"  note: the profile holds {seen} K2 core bwd launches of "
              f"{want}: kernels of the autograd thread are missing, so "
              "device busy below is a lower bound")
    busy_ms = sum(dev_us(e) for e in rows) / 1e3 / steps
    ours_ms = sum(dev_us(e) for e in rows
                  if any(o in e.key for o in OURS)) / 1e3 / steps
    k2_ms = sum(dev_us(e) for e in rows
                if "norm_penalty_" in e.key) / 1e3 / steps
    print(f"  per step (profiled, {steps} steps): wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; the port's kernels "
          f"{ours_ms:.3f} ms of device time, of which K2 core {k2_ms:.4f}; "
          f"{sum(e.count for e in rows) // steps} device ops per step")
    for e in rows[:15]:
        print(f"    {dev_us(e) / 1e3 / steps:8.3f} ms  x{e.count // steps:<4d}"
              f" {e.key[:90]}")
    from torch.autograd import DeviceType
    host = sorted((e for e in prof.key_averages()
                   if e.device_type != DeviceType.CUDA),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    print("  host: top ops by self CPU time per step")
    for e in host[:10]:
        print(f"    {e.self_cpu_time_total / 1e3 / steps:8.3f} ms  "
              f"x{e.count // steps:<5d} {e.key[:80]}")


def rollout_ops(state, cfg, corpus):
    """The device operations and device time of one rollout at the step's
    shape (the strong agent on B corpus levels), by torch.profiler; the
    first rollout runs under ``set_sync_debug_mode('error')``, so a rollout
    that synchronises the host with the device fails the phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(corpus.device).manual_seed(5)
    data = corpus[:cfg.train.batch_size]
    if cfg.model.family == "track":
        from levelgan_torch.track.race import race_rollout
        from levelgan_torch.track.train import race_params

        def run():
            race_rollout(state.agent_strong, data, race_params(cfg),
                         generator=g)
    else:
        from levelgan_torch.data.codec import encode
        from levelgan_torch.env.sim import rollout
        from levelgan_torch.train.curriculum import env_params
        onehot = encode(data, cfg.model.n_tiles)

        def run():
            rollout(state.agent_strong, data, onehot, env_params(cfg),
                    generator=g)
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = device_rows(prof)
    busy = sum(dev_us(e) for e in rows) / 1e3
    print(f"  one rollout (profiled): {sum(e.count for e in rows)} device "
          f"ops, {busy:.3f} ms of device time in {wall:.3f} ms of wall; its "
          "largest: " + "; ".join(f"x{e.count} {e.key[:50]}"
                                  for e in rows[:4]))


def curriculum_vs_plain(cfg, device):
    """Phase 8 for the curriculum: one whole step through the kernels, one
    through the plain path (every generator stage's plain version, the
    plain GP) and one through an f32 copy of the plain generator, each from
    the same seeded state (agents included), batch and draws (the agents'
    action noise included).  The levels the agents play are each side's own
    hard Gumbel samples, so where a bf16 rounding moves a tile's argmax the
    rollouts differ, and so do the critic's fakes: the share of identical
    tiles must reach TILE_AGREE, the losses agree within LOSS_TOL, the
    generator's gradients (the REINFORCE term included) by the f32 rule of
    ``train_vs_plain``, and each agent's parameter update points the way of
    the plain side's (cosine at least AGENT_COS).  The critic's gradients
    on one shared fake are ``train_vs_plain``'s check."""
    import copy
    import dataclasses

    import torch
    from levelgan_torch.api import step_mode
    from levelgan_torch.models import Generator
    from levelgan_torch.train import curriculum
    from levelgan_torch.train.curriculum import (draw_curriculum_noise,
                                                 make_curriculum_step)
    from levelgan_torch.train.state import create_state

    m = cfg.model
    plain_cfg = cfg.override(**{"model.pallas_gp": "xla"})
    base = create_state(cfg, device, seed=11)
    g = torch.Generator(device).manual_seed(12)
    ids = torch.randint(0, m.n_tiles, (cfg.train.n_critic, B_TRAIN,
                                       m.level_size, m.level_size),
                        dtype=torch.uint8, device=device, generator=g)
    noise = draw_curriculum_noise(cfg, cfg.train.n_critic, B_TRAIN, device, g)
    res = {}
    for side, step_cfg, dtype, plain in (
            ("kernels", cfg, m.dtype, False), ("plain", plain_cfg, m.dtype,
                                               True),
            ("f32", plain_cfg, "float32", True)):
        gen = Generator(dataclasses.replace(m, dtype=dtype))
        gen.load_state_dict(base.generator.state_dict())
        gen = gen.to(device)
        if plain:
            gen.forward = (lambda z, cond=None, _g=gen:
                           Generator.forward(_g, z, cond, plain=True))
        state = create_state(cfg, device, generator=gen,
                             critic=copy.deepcopy(base.critic),
                             agents=(copy.deepcopy(base.agent_strong),
                                     copy.deepcopy(base.agent_weak)))
        grads, levels = {"G": [], "D": []}, []
        for key, opt in (("G", state.opt_g), ("D", state.opt_d)):
            def caught(closure=None, _opt=opt, _key=key, _step=opt.step):
                grads[_key].append([p.grad.detach().clone()
                                    for grp in _opt.param_groups
                                    for p in grp["params"]])
                return _step(closure)
            opt.step = caught
        orig = curriculum.rollout

        def seen(policy, level_ids, *a, **kw):
            levels.append(level_ids)
            return orig(policy, level_ids, *a, **kw)
        curriculum.rollout = seen
        before = read_counts()
        try:
            with step_mode():
                _, met = make_curriculum_step(step_cfg)(state, ids,
                                                        noise=noise)
            torch.cuda.synchronize()
        finally:
            curriculum.rollout = orig
        after = read_counts()
        res[side] = {"met": {k: float(v) for k, v in met.items()
                             if k != "gen_hist"},
                     "grads": grads, "levels": levels[0],
                     "launches": {k: after[k] - before[k] for k in after},
                     "agents": [torch.cat([(p - q).detach().flatten()
                                           for p, q in zip(
                         getattr(state, a).parameters(),
                         getattr(base, a).parameters())])
                         for a in ("agent_strong", "agent_weak")]}
    k, p, ref = res["kernels"], res["plain"], res["f32"]
    agree = float((k["levels"] == p["levels"]).float().mean())
    loss_err = max(abs(k["met"][n] - p["met"][n]) / max(abs(p["met"][n]), 0.1)
                   for n in ("d_loss", "gp", "g_gan"))
    names = [n for n, _ in base.generator.named_parameters()]
    g_err = sorted(((rel_err(a, r), rel_err(b, r), n) for n, a, b, r in zip(
        names, k["grads"]["G"][0], p["grads"]["G"][0], ref["grads"]["G"][0])),
        key=lambda e: e[0] - BF16_RATIO * e[1], reverse=True)
    cos = [float(torch.nn.functional.cosine_similarity(a, b, dim=0))
           for a, b in zip(k["agents"], p["agents"])]
    # the critic's first update, before the two sides' critics part (each
    # side's fakes are its own generator's: checked with one shared fake
    # by ``train_vs_plain``); reported
    d_err = max(rel_err(a, b) for a, b in zip(k["grads"]["D"][0],
                                             p["grads"]["D"][0]))
    print(f"  levels: {agree:.5f} of the tiles identical, kernels vs plain "
          f"(tol {TILE_AGREE}); launches {k['launches']}")
    print("  metrics kernels / plain / f32: " + "; ".join(
        f"{n} {k['met'][n]:.5g} / {p['met'][n]:.5g} / {ref['met'][n]:.5g}"
        for n in ("d_loss", "gp", "g_gan", "g_rl", "g_loss", "playability",
                  "skill_gap", "agent_entropy")))
    print(f"  loss err {loss_err:.3g} (tol {LOSS_TOL}); the critic's first "
          f"update's gradients, kernels vs plain, max rel err {d_err:.3g} "
          f"(reported: the fakes differ); the agents' updates, cosine "
          f"kernels vs plain: strong {cos[0]:.4f}, weak {cos[1]:.4f} (tol "
          f"{AGENT_COS})")
    print("  generator gradients vs the f32 generator (kernels / plain bf16; "
          f"allowed kernels <= {BF16_RATIO} * plain + {BF16_SLACK}), closest "
          "to the limit: " + ", ".join(f"{n} {a:.3g}/{b:.3g}"
                                       for a, b, n in g_err[:6]))
    if k["launches"] != PER_STEP[cfg.preset] or any(
            v for s in (p, ref) for v in s["launches"].values()):
        fail(f"kernel side launched {k['launches']} (want "
             f"{PER_STEP[cfg.preset]}), plain sides {p['launches']} "
             f"{ref['launches']}")
    if (agree < TILE_AGREE or loss_err > LOSS_TOL or min(cos) < AGENT_COS
            or any(a > BF16_RATIO * b + BF16_SLACK for a, b, _ in g_err)):
        fail("the curriculum step through the kernels disagrees with the "
             "plain path")


def check_tracks(tracks, n: int, segments: int, what: str) -> None:
    """Fail unless ``tracks`` are ``n`` finite f32 [segments, 2] tracks
    whose heading closes (| |sum kappa| - 2 pi | <= CLOSURE_TOL, as the
    export's closure repair makes it) and whose |kappa| stays within
    KAPPA_MAX (compared in f32, as the clip leaves it)."""
    import numpy as np
    from levelgan_torch.track.data import KAPPA_MAX, WIDTH_MAX, WIDTH_MIN
    if (tracks.shape != (n, segments, 2) or tracks.dtype != np.float32
            or not np.isfinite(tracks).all()):
        fail(f"{what}: {tracks.dtype} {tracks.shape}, finite "
             f"{bool(np.isfinite(tracks).all())}")
    kappa = tracks[..., 0]
    closure = np.abs(np.abs(kappa.astype(np.float64).sum(-1)) - 2 * np.pi)
    width = tracks[..., 1]
    print(f"  {what}: {n} tracks, closure error max {closure.max():.3g} rad "
          f"(tol {CLOSURE_TOL}), |kappa| max {np.abs(kappa).max():.6g} "
          f"(bound {KAPPA_MAX}), width in [{width.min():.4g}, "
          f"{width.max():.4g}]")
    if (closure.max() > CLOSURE_TOL
            or np.abs(kappa).max() > np.float32(KAPPA_MAX)
            or width.min() < np.float32(WIDTH_MIN)
            or width.max() > np.float32(WIDTH_MAX)):
        fail(f"{what}: a track is not closed or leaves the physical ranges")


def track_export(device, workdir, n=N_TRACKS, batch=B):
    """The racetrack_32 export: a generator with seeded random weights
    written as a FORMAT.md checkpoint and exported through the port's CLI
    (``n`` tracks at ``batch``, repair on by the config's 'auto': the
    closure projection on the card); every track must close and stay in
    range, no kernel of the port may launch (the GRU is plain PyTorch), a
    card batch in f32 must equal the CPU's within TRACK_TOL; then the warm
    export's tracks/s, one batch's device time (``queued_ms``: its ~450
    launches queued behind a spin), its span between CUDA events (the
    host's launches included) and its D2H into pinned memory."""
    import dataclasses

    import numpy as np
    import torch
    from levelgan_torch.cli import export as cli_export
    from levelgan_torch.config import preset
    from levelgan_torch.export import (generate, generate_tracks_batch,
                                       make_generator)
    from levelgan_torch.lio.checkpoint import save_checkpoint
    from levelgan_torch.track.models import TrackGenerator

    cfg = preset("racetrack_32")
    m = cfg.model
    gen = TrackGenerator(m).init_params(torch.Generator().manual_seed(5))
    ckpt = save_checkpoint(os.path.join(workdir, "track_ckpt"), gen, cfg)
    out = os.path.join(workdir, "tracks.npz")
    reset_counts()
    t0 = time.perf_counter()
    rc = cli_export.main(["--ckpt", ckpt, "--n", str(n), "--batch",
                          str(batch), "--out", out, "--seed", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if rc != 0:
        fail(f"track export CLI returned {rc}")
    if any(counts.values()):
        fail(f"the track export launched kernels of the port: {counts}")
    tracks = np.load(out)["tracks"]
    print(f"  exported {n} tracks through the CLI in {wall:.3f} s (wall, "
          f"incl. checkpoint load, first call and the compressed .npz)")
    check_tracks(tracks, n, m.n_segments, "racetrack_32 export")
    # the card against the CPU, f32 on both sides, same weights and z
    m32 = dataclasses.replace(m, dtype="float32")
    cfg32 = dataclasses.replace(cfg, model=m32)
    z = torch.randn((batch, m.latent_dim),
                    generator=torch.Generator().manual_seed(6))
    card = generate_tracks_batch(make_generator(cfg32, gen.state_dict(),
                                                device), z.to(device),
                                 repair=True).cpu()
    host = generate_tracks_batch(make_generator(cfg32, gen.state_dict(),
                                                "cpu"), z, repair=True)
    err = float((card - host).abs().max())
    print(f"  f32 batch of {batch}, card vs CPU: max |diff| {err:.3g} (tol "
          f"{TRACK_TOL})")
    if err > TRACK_TOL:
        fail("the card's track batch disagrees with the CPU's")
    g = make_generator(cfg, gen.state_dict(), device)
    zd = torch.randn((batch, m.latent_dim), device=device)
    def one_batch():
        return generate_tracks_batch(g, zd, repair=True)
    dev_ms = queued_ms(one_batch, n=5)
    span_ms = median_ms(one_batch)
    one = one_batch()
    pinned = torch.empty(one.shape, dtype=one.dtype, pin_memory=True)
    d2h_ms = median_ms(lambda: pinned.copy_(one, non_blocking=True))
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(cfg, g, n, batch_size=batch, device=device)
        walls.append(time.perf_counter() - t0)
    print(f"  warm export of {n} tracks (generate, batch {batch}): "
          f"{n / min(walls):,.0f} tracks/s (best of {len(walls)}: "
          f"{', '.join(f'{w:.4f}' for w in walls)} s); one batch "
          f"{dev_ms:.4f} ms of device time (queued_ms) and {span_ms:.4f} ms "
          f"between CUDA events (the GRU's 32 steps and the closure, the "
          f"host's launches included), D2H of its "
          f"{one.numel() * 4 / 2 ** 10:.0f} KiB {d2h_ms:.4f} ms")


def track_vs_plain(cfg, device):
    """Phase 8 for the track family: one whole step of ``cfg`` (racetrack_32
    or race_curriculum_32) through the K2 core ('auto') and through the
    plain GP ('xla'), from one seeded state (drivers included), batch and
    set of draws.  Both sides run the same plain critic and GRU, so they
    differ only in the GP's norm core: the losses are held within
    LOSS_TOL, every critic iteration's gradients and the generator's
    within GRAD_TOL (max |diff| / max |ref|), the drivers' updates by
    cosine (AGENT_COS: the raced tracks agree to the last bits, and an
    action whose argmax sits at a near-tie may flip); the kernel side must
    launch PER_STEP's K2 core counts, the plain side none."""
    import copy

    import torch
    from levelgan_torch.api import make_dataset, make_step_fn, step_mode
    from levelgan_torch.track.train import draw_track_noise
    from levelgan_torch.train.state import create_state

    t = cfg.train
    curriculum = t.loss == "curriculum"
    plain_cfg = cfg.override(**{"model.pallas_gp": "xla"})
    base = create_state(cfg, device, seed=11)
    corpus = torch.from_numpy(make_dataset(cfg).tracks).to(device)
    g = torch.Generator(device).manual_seed(12)
    batch = corpus[torch.randint(0, corpus.shape[0], (t.n_critic, B_TRAIN),
                                 device=device, generator=g)]
    noise = draw_track_noise(cfg, t.n_critic, B_TRAIN, device, g)
    drivers = ("agent_strong", "agent_weak") if curriculum else ()
    res = {}
    for side, step_cfg in (("kernels", cfg), ("plain", plain_cfg)):
        state = create_state(
            cfg, device, generator=copy.deepcopy(base.generator),
            critic=copy.deepcopy(base.critic),
            agents=tuple(copy.deepcopy(getattr(base, a)) for a in drivers)
            or None)
        grads = {"G": [], "D": []}
        for key, opt in (("G", state.opt_g), ("D", state.opt_d)):
            def caught(closure=None, _opt=opt, _key=key, _step=opt.step):
                grads[_key].append([p.grad.detach().clone()
                                    for grp in _opt.param_groups
                                    for p in grp["params"]])
                return _step(closure)
            opt.step = caught
        before = read_counts()
        with step_mode():
            _, met = make_step_fn(step_cfg)(state, batch, noise=noise)
        torch.cuda.synchronize()
        after = read_counts()
        res[side] = {
            "met": {k: float(v) for k, v in met.items() if k != "gen_hist"},
            "grads": grads,
            "launches": {k: after[k] - before[k] for k in after},
            "drivers": [torch.cat([(p - q).detach().flatten() for p, q in zip(
                getattr(state, a).parameters(),
                getattr(base, a).parameters())]) for a in drivers]}
    k, p = res["kernels"], res["plain"]
    names = ["d_loss", "gp", "g_loss"] + (["g_gan", "g_rl"] if curriculum
                                          else [])
    loss_err = max(abs(k["met"][n] - p["met"][n]) / max(abs(p["met"][n]),
                                                        0.1) for n in names)
    d_err = max(rel_err(a, b) for ka, pa in zip(k["grads"]["D"],
                                                p["grads"]["D"])
                for a, b in zip(ka, pa))
    g_err = max(rel_err(a, b) for a, b in zip(k["grads"]["G"][0],
                                              p["grads"]["G"][0]))
    cos = [float(torch.nn.functional.cosine_similarity(a, b, dim=0))
           for a, b in zip(k["drivers"], p["drivers"])]
    print("  metrics kernels / plain: " + "; ".join(
        f"{n} {k['met'][n]:.6g} / {p['met'][n]:.6g}"
        for n in names + (["drivability", "skill_gap", "agent_entropy"]
                          if curriculum else [])))
    print(f"  loss err {loss_err:.3g} (tol {LOSS_TOL}); the critic's "
          f"{len(k['grads']['D'])} updates' gradients max rel err "
          f"{d_err:.3g}, the generator's {g_err:.3g} (tol {GRAD_TOL})"
          + (f"; the drivers' updates, cosine kernels vs plain: strong "
             f"{cos[0]:.5f}, weak {cos[1]:.5f} (tol {AGENT_COS})"
             if curriculum else "") + f"; launches {k['launches']}")
    if k["launches"] != PER_STEP[cfg.preset] or any(
            p["launches"].values()):
        fail(f"kernel side launched {k['launches']} (want "
             f"{PER_STEP[cfg.preset]}), plain side {p['launches']}")
    if (loss_err > LOSS_TOL or d_err > GRAD_TOL or g_err > GRAD_TOL
            or (cos and min(cos) < AGENT_COS)):
        fail(f"the {cfg.preset} step through the K2 core disagrees with the "
             "plain GP")


def track_repro(device, workdir, steps=REPRO_STEPS):
    """racetrack_32, ``steps`` seeded steps through ``api.train``: a fresh
    process runs them three times (``first_run_check``: its first run must
    equal its later ones) and keeps its first run's arrays; two more runs
    here, under torch's own TF32 settings as the CLI; every run must equal
    every other in every array (fatal).  Catches a GRU or conv backward
    whose summation order depends on its thread or its process."""
    import torch
    from levelgan_torch import api
    from levelgan_torch.config import preset

    kept = os.path.join(workdir, "track_first_run.npz")
    fresh = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit(min(1, "
         f"chip_smoke.first_run_check('racetrack_32', {kept!r})))"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    for line in fresh.stdout.strip().splitlines():
        print("  " + line)
    if fresh.returncode != 0:
        fail("racetrack_32: the first training run of a fresh process "
             f"differs from its later runs: {fresh.stdout[-800:]}"
             f"{fresh.stderr[-2000:]}")
    import numpy as np
    with np.load(kept) as z:
        runs = [{k: z[k] for k in z.files}]
    cfg = preset("racetrack_32").override(**{"train.steps": steps,
                                             "io.log_every": 1})
    backends = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = [b.allow_tf32 for b in backends]
    for b, on in zip(backends, TORCH_TF32 or saved):
        b.allow_tf32 = on
    try:
        for run in (0, 1):
            res = api.train(cfg.override(**{"io.out_dir": os.path.join(
                workdir, f"track_repro_{run}")}), device=device, echo=False)
            runs.append(load_arrays(res["checkpoint"]))
    finally:
        for b, on in zip(backends, saved):
            b.allow_tf32 = on
    for a, b in ((0, 1), (1, 2), (0, 2)):
        diff = differing(runs[a], runs[b])
        print(f"  racetrack_32 {steps}-step runs {a} / {b} (0 = the fresh "
              f"process's first): {len(diff)} of {len(runs[a])} arrays "
              "differ" + (f" ({diff[:4]})" if diff else ""))
        if diff:
            fail("racetrack_32 training is not bit-reproducible")


# ---- the gates phase: the io hooks, the skill gap, causality, the carver ---

GATES_STEPS = 10             # steps of the gates phase's two CLI runs
SKILL_N = 1024               # levels a set of the skill gap
# the skill gap on the card against the CPU path with the same injected
# noise: the agents' f32 convs sum in another order on the two sides (TF32
# off), so now and then an action at a near tie flips and that level's
# rollout goes its own way.  At most SKILL_FLIPS levels of a set may then
# differ in each agent's return (beyond SKILL_RTOL relative) or in
# reaching GOAL; each mean may move by what SKILL_FLIPS levels can move it:
# SKILL_FLIPS / SKILL_N for playability, SKILL_FLIPS times the set's span
# of returns / SKILL_N for a return
SKILL_FLIPS = 2
SKILL_RTOL = 1e-5
CARVE_N, CARVE_SIZE = 4096, 64   # the native carver's corpus
CARVE_NUMPY_N = 256          # the NumPy carver's levels, scaled to CARVE_N


def check_renders(out: str, steps: int, kind: str = "levels") -> list:
    """The renders ``io.render_every`` must have written (PNG, or the
    ``.npz`` beside the name without PIL)."""
    want = [f"{kind}_{s:08d}.png"
            for s in range(RENDER_EVERY, steps + 1, RENDER_EVERY)]
    have = set(os.listdir(out))
    got = [w if w in have else w + ".npz" for w in want
           if w in have or w + ".npz" in have]
    if len(got) != len(want):
        fail(f"renders in {out}: "
             f"{sorted(f for f in have if f.startswith(kind))}, want {want}")
    return got


TRACE_CAT = re.compile(r'"cat": "([^"]*)"')
TRACE_NAME = re.compile(r'"name": ("(?:[^"\\]|\\.)*")')


def trace_kernel_names(path: str) -> collections.Counter:
    """Device kernels of a Chrome trace by name, read a line at a time
    (with CPU activities a trace of ten steps runs to hundreds of MB): an
    event's ``cat`` comes before its ``name``, on its line or an earlier
    one."""
    names, cat = collections.Counter(), None
    with open(path) as fh:
        for line in fh:
            m = TRACE_CAT.search(line)
            if m:
                cat = m.group(1)
            m = TRACE_NAME.search(line)
            if m and cat is not None:
                if cat == "kernel":
                    names[json.loads(m.group(1))] += 1
                cat = None
    return names


def gates_cli_run(workdir: str) -> tuple[str, dict]:
    """curriculum_16 through the CLI for GATES_STEPS with io.render_every,
    io.profile and io.tensorboard: the renders, a trace naming the port's
    K1 fwd and K1 bwd kernels, the TensorBoard event files (or the
    notice), checkpoints at every render for the GIF."""
    import contextlib
    import glob
    import io as _io
    import torch
    from levelgan_torch.cli import train as cli_train

    out = os.path.join(workdir, "gates_curriculum_16")
    buf = _io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_train.main([
            "--preset", "curriculum_16", *RENDER, "--set", "io.profile=true",
            "--set", "io.tensorboard=true", "--set",
            f"io.ckpt_every={RENDER_EVERY}", "--set",
            f"train.steps={GATES_STEPS}", "--set", "io.log_every=10",
            "--set", f"data.corpus_size={CORPUS_CUT}", "--out", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    text = buf.getvalue()
    if rc != 0:
        fail(f"curriculum_16 with the io hooks returned {rc}:\n{text}")
    renders = GATES_STEPS // RENDER_EVERY
    expect = {k: GATES_STEPS * v for k, v in PER_STEP["curriculum_16"].items()}
    expect["K1"] += renders * 2          # a render: the EMA's two stages
    expect["head"] += renders            # and its one batch's head
    if counts != expect:
        fail(f"curriculum_16 with the io hooks: launches {counts} != "
             f"{expect}")
    got = check_renders(out, GATES_STEPS)
    trace = os.path.join(out, "profile", "trace.json")
    if not os.path.exists(trace):
        fail(f"io.profile wrote no {trace}")
    names = trace_kernel_names(trace)
    trace_bytes = os.path.getsize(trace)
    os.remove(trace)
    ours = {k: sum(n for name, n in names.items() if k in name)
            for k in ("upsample_block_fwd_kernel", "k1_bwd_")}
    if not all(ours.values()):
        fail(f"the trace names none of {[k for k, v in ours.items() if not v]}"
             f" among its {sum(names.values())} device kernels")
    events = glob.glob(os.path.join(out, "tb", "events.out.tfevents.*"))
    notice = "tensorboard requested but not installed" in text
    if not events and not notice:
        fail("io.tensorboard wrote no event file and printed no notice")
    print(f"  curriculum_16 {GATES_STEPS} steps with io.render_every="
          f"{RENDER_EVERY}, io.profile, io.tensorboard: {wall:.3f} s wall; "
          f"launches {counts}; renders {got}; trace "
          f"{trace_bytes} bytes, {sum(names.values())} device "
          f"kernels, of them {ours}; "
          + (f"TensorBoard event files {len(events)}" if events else
             "tensorboard not installed: the JSONL notice was printed"))
    return out, counts


def gates_skill_gap(out: str, device) -> dict:
    """The skill gap of the curriculum checkpoint's agents on SKILL_N
    repaired levels of its EMA and as many corpus levels, on the card and
    through the CPU path with the same injected noise: level by level
    (``play_levels``) and the report's means; one rollout under
    ``set_sync_debug_mode('error')``; the card's wall time."""
    import torch
    from levelgan_torch.api import make_dataset
    from levelgan_torch.config import Config
    from levelgan_torch.export import generate
    from levelgan_torch.lio.checkpoint import load_checkpoint, load_manifest
    from levelgan_torch.lio.skillgap import (draw_rollout_noise, play_levels,
                                             score_levels, skill_gap_report)
    from levelgan_torch.train.state import create_state

    ckpt = os.path.join(out, "ckpt", f"step_{GATES_STEPS:08d}")
    cfg = Config.from_dict(load_manifest(ckpt)["config"])
    on = {"card": device, "cpu": torch.device("cpu")}
    states = {k: load_checkpoint(ckpt, create_state(cfg, d))[0]
              for k, d in on.items()}
    reset_counts()
    levels = generate(cfg, states["card"].g_ema, SKILL_N, seed=0,
                      repair=True, device=device)
    counts = read_counts()
    if not counts["K1"]:
        fail(f"the skill gap's levels launched no K1 fwd: {counts}")
    corpus = make_dataset(cfg.override(**{
        "data.corpus_size": SKILL_N})).levels[:SKILL_N]
    noise = draw_rollout_noise(cfg, SKILL_N, "cpu", seed=0)
    sets = {"generated": levels, "corpus": corpus}
    per = {k: {part: {q: v.double().cpu() for q, v in play_levels(
        cfg, states[k], torch.from_numpy(x).to(d),
        {a: v.to(d) for a, v in noise.items()}).items()}
        for part, x in sets.items()} for k, d in on.items()}
    got = {k: skill_gap_report(cfg, states[k], levels, corpus, device=d,
                               noise=noise)
           for k, d in on.items()}
    flips, worst = {}, {}
    for part in sets:
        for q in ("return_strong", "return_weak", "playable_strong",
                  "playable_weak"):
            a, b = per["card"][part][q], per["cpu"][part][q]
            off = int(((a - b).abs() > SKILL_RTOL * (1 + b.abs())).sum())
            flips[f"{part} {q}"] = off
            if off > SKILL_FLIPS:
                fail(f"skill gap {part} {q}: {off} of {SKILL_N} levels "
                     f"differ between card and CPU (> {SKILL_FLIPS})")
            span = 1.0 if q.startswith("playable") else float(b.max() - b.min())
            tol = SKILL_FLIPS * span / SKILL_N + SKILL_RTOL * (
                1 + abs(got["cpu"][part][q]))
            err = abs(got["card"][part][q] - got["cpu"][part][q])
            worst[f"{part} {q}"] = f"{err:.3g} (tol {tol:.3g})"
            if err > tol:
                fail(f"skill gap {part} {q}: card {got['card'][part][q]} "
                     f"cpu {got['cpu'][part][q]} (|diff| > {tol:.4g})")
    data = torch.from_numpy(corpus).to(device)
    on_card = {k: v.to(device) for k, v in noise.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        score_levels(cfg, states["card"], data, on_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    walls = []
    for seed in (1, 2):
        t0 = time.perf_counter()
        skill_gap_report(cfg, states["card"], levels, corpus, seed=seed,
                         device=device)
        walls.append(time.perf_counter() - t0)
    sg = got["card"]
    print(f"  skill gap, {SKILL_N} repaired levels of the step-"
          f"{GATES_STEPS} EMA against {SKILL_N} corpus levels: separation "
          f"{sg['separation']:.5g}, playable_separation "
          f"{sg['playable_separation']:.5g}; generated "
          + " ".join(f"{k}={v:.5g}" for k, v in sg["generated"].items())
          + "; corpus " + " ".join(f"{k}={v:.5g}" for k, v in
                                   sg["corpus"].items())
          + f"; card vs CPU (same noise): levels that differ {flips} (at "
          f"most {SKILL_FLIPS} a set and agent), |diff| of the means {worst};"
          f" one rollout under sync debug mode 'error': "
          f"no sync; skill_gap_report wall (drawn noise, warm) "
          f"{walls[-1] * 1e3:.1f} ms (first {walls[0] * 1e3:.1f} ms); the "
          f"levels' launches {counts}")
    return counts


def gates_progress_gif(out: str) -> dict:
    """``cli/progress_gif`` over the curriculum run's checkpoints: one
    frame a checkpoint, sampled on the card."""
    from levelgan_torch.cli import progress_gif
    from levelgan_torch.lio.checkpoint import all_checkpoints

    ckpts = all_checkpoints(os.path.join(out, "ckpt"))
    gif = os.path.join(out, "progress.gif")
    reset_counts()
    t0 = time.perf_counter()
    if progress_gif.main([out, "--out", gif]) != 0:
        fail("progress_gif returned non-zero")
    wall = time.perf_counter() - t0
    counts = read_counts()
    if not counts["K1"]:
        fail(f"progress_gif launched no K1 fwd: {counts}")
    try:
        from PIL import Image
        frames = Image.open(gif).n_frames
    except ImportError:
        import numpy as np
        frames = len(np.load(gif + ".npz")["frames"])
    if frames != len(ckpts):
        fail(f"progress GIF has {frames} frames for {len(ckpts)} checkpoints")
    print(f"  progress GIF: {frames} frames for {len(ckpts)} checkpoints in "
          f"{wall:.3f} s wall; launches {counts}")
    return counts


def gates_causality(workdir: str) -> dict:
    """conditional_32 trained GATES_STEPS through the CLI, then
    ``cli/validate --fit-calibration``: the causality gates with a fitted
    calibration (random-ish weights: the verdicts are printed, not
    required); the sweep's export must run K1 fwd at all three stages."""
    import contextlib
    import io
    import torch
    from levelgan_torch.cli import train as cli_train
    from levelgan_torch.cli import validate

    out = os.path.join(workdir, "gates_conditional_32")
    if cli_train.main(["--preset", "conditional_32", "--set",
                       f"train.steps={GATES_STEPS}", "--set",
                       "io.log_every=10", "--set",
                       f"data.corpus_size={CORPUS_CUT}", "--out", out]) != 0:
        fail("conditional_32 training for the causality gates failed")
    path = os.path.join(out, "validate.json")
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):   # the report: in path
        rc = validate.main(["--ckpt", out, "--fit-calibration", "--out",
                            path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    with open(path) as fh:
        report = json.load(fh)
    gates, cau = report["gates"], report.get("causality", {})
    missing = [g for g in ("causality", "causality_calibrated")
               if g not in gates]
    if missing or not cau.get("calibration_written"):
        fail(f"validate --fit-calibration: gates {sorted(gates)}, "
             f"calibration {cau.get('calibration_written')}")
    if not counts["K1"] or counts["K1"] % 3 or counts["K1L"]:
        fail(f"the causality sweeps' launches {counts}: K1 fwd at the three "
             "conditional_32 stages only")
    print(f"  validate --fit-calibration on conditional_32 (step "
          f"{GATES_STEPS}): rc {rc}, {wall:.3f} s wall; causality "
          f"{gates['causality']['passed']} (min r "
          f"{gates['causality']['min_pearson_r']}), causality_calibrated "
          f"{gates['causality_calibrated']['passed']} (slopes "
          f"{gates['causality_calibrated']['slopes']}); the sweeps "
          f"{cau['wall_s']:.3f} s wall, the export inside them "
          f"{cau['export_levels_per_s']:.1f} levels/s at "
          f"{cau['n_per_point']} a point; launches {counts}")
    return counts, cau["n_per_point"]


def gates_carver() -> None:
    """The native carver (CARVE_N levels at CARVE_SIZE) against the NumPy
    carver on this host (CARVE_NUMPY_N levels, scaled)."""
    import numpy as np
    from levelgan_torch.config import GOAL, START
    from levelgan_torch.data.dataset import synthetic_corpus
    from levelgan_torch.native.build import synthetic_corpus_native

    synthetic_corpus_native(4, CARVE_SIZE)          # the build
    t0 = time.perf_counter()
    levels = synthetic_corpus_native(CARVE_N, CARVE_SIZE, seed=1234)
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    synthetic_corpus(CARVE_NUMPY_N, CARVE_SIZE, seed=1234)
    t_np = time.perf_counter() - t0
    one = [(levels == t).sum(axis=(1, 2)) for t in (START, GOAL)]
    if levels.shape != (CARVE_N, CARVE_SIZE, CARVE_SIZE) or not all(
            (c == 1).all() for c in one):
        fail(f"native corpus {levels.shape}: not one START and one GOAL "
             "a level")
    print(f"  carver at {CARVE_SIZE}x{CARVE_SIZE}: native {CARVE_N} levels "
          f"{t_c:.3f} s; NumPy {CARVE_NUMPY_N} levels {t_np:.3f} s "
          f"({t_np * CARVE_N / CARVE_NUMPY_N:.1f} s scaled to {CARVE_N}); "
          f"native / NumPy per level {t_c / CARVE_N:.3e} / "
          f"{t_np / CARVE_NUMPY_N:.3e} s")


def gates_phase(device, workdir, rows) -> dict:
    """The gates phase: each path's launches by name.  The forward kernels
    are held against their plain versions at the batches these paths give
    them that no other phase runs (into ``rows``): curriculum_16 at the
    skill gap's SKILL_N levels, conditional_32 at the sweep's levels a
    point."""
    from levelgan_torch.config import preset

    out, counts = gates_cli_run(workdir)
    runs = {"curriculum_16 io hooks": counts}
    runs["skill gap levels"] = gates_skill_gap(out, device)
    runs["progress GIF"] = gates_progress_gif(out)
    runs["causality sweeps"], n_point = gates_causality(workdir)
    for name, b in (("curriculum_16", min(SKILL_N, B)),
                    ("conditional_32", min(n_point, B))):
        print(f"forward kernel parity and timing ({name}, B={b}, the gates "
              "path's batch):")
        train_kernel_parity(preset(name), device, rows, b=b, fwd_only=True)
    gates_carver()
    return runs


# ---- the dp phase: data parallelism through mesh.launch -------------------

# the dp phase's arms: name -> (preset, overrides, full): a full arm also
# runs the launcher at world size 1 on one card and the timed steps at
# dp=N; the others only dp=N against dp=1 and two dp=N runs
DP_ARMS = {
    "curriculum_16": ("curriculum_16", {}, True),
    "gumbel_64": ("gumbel_64", {}, True),
    # BASELINE.md's "mbstd pair": the critic's per-position stddev over the
    # batch, a statistic of the global batch under data parallelism
    "mbstd_pair": ("wgan_gp_32", {"train.w_presence": 10.0,
                                  "model.critic_mbstd": "input"}, True),
    "mbstd_trunk": ("wgan_gp_32", {"model.critic_mbstd": "trunk"}, False),
}
DP_STEPS = 3                 # steps of each world-size-1 launcher run
DP_COMPARE_STEPS = 10        # steps of the dp=N against dp=1 runs
B_RANK = B_TRAIN // 4        # a rank's batch at dp=4, the kernels' B there
DP_COS = 0.95                # cosine of a model's 10-step update, dp=N vs 1
DP_LOSS = 0.05               # |d_loss dp=N - dp=1| / max(1, |d_loss dp=1|)


class tf32_as_torch:
    """torch's own TF32 settings (main() turns TF32 off for the plain
    references), as the train CLI and a launched rank run."""

    def __enter__(self):
        import torch
        self.backends = torch.backends.cudnn, torch.backends.cuda.matmul
        self.saved = [b.allow_tf32 for b in self.backends]
        for b, on in zip(self.backends, TORCH_TF32 or self.saved):
            b.allow_tf32 = on

    def __exit__(self, *exc):
        for b, on in zip(self.backends, self.saved):
            b.allow_tf32 = on


def dp_train(cfg_dict, device_type="cuda"):
    """On each rank of ``mesh.launch``: ``api.train`` with counted
    launches; the rank's result and its counts."""
    import torch
    from levelgan_torch import api
    from levelgan_torch.config import Config
    reset_counts()
    res = api.train(Config.from_dict(cfg_dict), device=device_type,
                    echo=False)
    if device_type == "cuda":
        torch.cuda.synchronize()
    return {"result": res, "counts": read_counts()}


def dp_steps(cfg_dict, warm, timed, profiled, device_type="cuda"):
    """On each rank: the data-parallel step loop on a seeded random corpus
    on the card (``api.step_inputs``, as api.train draws and shards), a
    device sync and a host barrier around each timed step; then
    ``profiled`` steps under torch.profiler: the rank's device busy time,
    its NCCL kernels' time and its idle share a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from levelgan_torch import api
    from levelgan_torch.config import Config
    from levelgan_torch.dist import mesh
    from levelgan_torch.train.state import create_state

    cfg = Config.from_dict(cfg_dict)
    m = cfg.model
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    sync = torch.cuda.synchronize if device_type == "cuda" else (
        lambda: None)
    state, step_fn = create_state(cfg, dev), api.make_step_fn(cfg)
    corpus = torch.randint(0, m.n_tiles, (CORPUS_CUT, m.level_size,
                                          m.level_size), dtype=torch.uint8,
                           device=dev,
                           generator=torch.Generator(dev).manual_seed(9))
    times = []
    with api.step_mode():
        for i in range(warm + timed):
            if i == warm:
                mesh.collectives.clear()
            batch, noise = api.step_inputs(cfg, corpus, i, dev)
            sync()
            mesh.barrier()
            t0 = time.perf_counter()
            state, _ = step_fn(state, batch, noise=noise)
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        coll = {k: v / timed for k, v in sorted(mesh.collectives.items())}
        mesh.barrier()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(profiled):
                batch, noise = api.step_inputs(cfg, corpus, 1000 + i, dev)
                state, _ = step_fn(state, batch, noise=noise)
            sync()
            wall = 1e3 * (time.perf_counter() - t0) / profiled
    rows = device_rows(prof)
    busy = sum(dev_us(e) for e in rows) / 1e3 / profiled
    nccl = sum(dev_us(e) for e in rows if "nccl" in e.key.lower()
               ) / 1e3 / profiled
    return {"rank": mesh.rank(), "step_ms": statistics.median(times[warm:]),
            "min_ms": min(times[warm:]), "max_ms": max(times[warm:]),
            "collectives": coll, "wall_ms": wall, "busy_ms": busy, "nccl_ms": nccl,
            "nccl_calls": sum(e.count for e in rows
                              if "nccl" in e.key.lower()) // profiled,
            "idle": max(0.0, 1 - busy / wall) if rows else None}


def dp_allreduce(names, reps=20):
    """On each rank: one update's all-reduce alone (``all_reduce_grads``
    over gradients of the shapes of each arm's generator and critic),
    the ranks lined up first (host barrier, device sync), CUDA events
    around the call; the median ms by arm and model."""
    import torch
    from levelgan_torch.dist import mesh
    from levelgan_torch.train.state import create_state

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"rank": mesh.rank()}
    for name in names:
        state = create_state(dp_arm(name), dev)
        for model in ("generator", "critic"):
            grads = [torch.randn_like(p) for p in
                     getattr(state, model).parameters()]
            ms = []
            for i in range(reps + 3):
                torch.cuda.synchronize()
                mesh.barrier()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                mesh.all_reduce_grads(grads)
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            out[f"{name} {model}"] = (
                statistics.median(ms[3:]),
                4 * sum(g.numel() for g in grads) / 2 ** 20)
    return out


def print_allreduce(plan, arms=tuple(DP_ARMS)) -> None:
    print(f"  one update's all-reduce alone at dp={plan.world}, the ranks "
          "lined up:")
    from levelgan_torch.dist import mesh
    for r in mesh.launch(dp_allreduce, (list(arms),), {}, plan):
        print(f"  rank {r.pop('rank')}: " + "; ".join(
            f"{k} {ms:.4f} ms for {mib:.2f} MiB" for k, (ms, mib)
            in r.items()))


def dp_allreduce_main() -> int:
    """``python3 -c "import sys, chip_smoke; sys.exit(chip_smoke.
    dp_allreduce_main())"``: ``dp_allreduce`` over every card."""
    import torch
    from levelgan_torch.dist import mesh
    n = torch.cuda.device_count()
    print(f"card: {card_line()}; {n} cards")
    print_allreduce(mesh.Plan(world=n, local=n, first_rank=0,
                              device_type="cuda"))
    return 0


def dp_arm(name):
    """The configuration of the dp phase's arm ``name`` (``DP_ARMS``)."""
    from levelgan_torch.config import preset
    base, kw, _ = DP_ARMS[name]
    return preset(base).override(**kw)


def dp_config(name, workdir, tag, steps, **kw):
    """Arm ``name`` for ``steps`` steps, one rank unless ``kw`` says
    otherwise (``dist.dp=0`` would take every card), corpus cut to
    REPRO_CORPUS."""
    return dp_arm(name).override(**{
        "data.corpus_size": REPRO_CORPUS, "train.steps": steps,
        "dist.dp": 1,
        "io.log_every": 1, "io.out_dir": os.path.join(workdir,
                                                      f"dp_{name}_{tag}"),
        **kw})


def dp_launcher_runs(device, workdir, train_counts, arms):
    """One card: each full arm of ``arms`` trained DP_STEPS steps in this
    process and through ``mesh.launch`` at world size 1 (NCCL, the gloo host
    group), whose checkpoint must equal this process's bit for bit; the
    launched rank's kernel launches (counted in that process) must be
    DP_STEPS times the per-step counts."""
    from levelgan_torch import api
    from levelgan_torch.dist import mesh

    plan = mesh.Plan(world=1, local=1, first_rank=0, device_type="cuda")
    for name in (a for a in arms if DP_ARMS[a][2]):
        alone = dp_config(name, workdir, "alone", DP_STEPS)
        with tf32_as_torch():
            res = api.train(alone, device=device, echo=False)
        t0 = time.perf_counter()
        [rank] = mesh.launch(dp_train, (dp_config(
            name, workdir, "launched", DP_STEPS).to_dict(),), {}, plan)
        wall = time.perf_counter() - t0
        want = load_arrays(res["checkpoint"])
        diff = differing(load_arrays(rank["result"]["checkpoint"]), want)
        expect = {k: DP_STEPS * v for k, v in PER_STEP[name].items()}
        print(f"  {name}: {DP_STEPS} steps through mesh.launch at world size "
              f"1 (NCCL) in {wall:.1f} s wall (a fresh process: start, "
              f"carving, the steps); checkpoint "
              + ("bit-identical to" if not diff else "differs from")
              + f" this process's run in {len(want)} arrays; the rank's "
              f"launches {rank['counts']}")
        if diff:
            fail(f"{name} through the launcher differs from the run without "
                 f"it: {diff[:8]}")
        if rank["counts"] != expect:
            fail(f"{name} through the launcher: launches {rank['counts']} "
                 f"!= expected {expect}")
        train_counts[f"dp {name}"] = rank["counts"]


def dp_update_agreement(ref, got, start):
    """The cosine of each model's update from ``start``, ``ref``'s against
    ``got``'s."""
    import numpy as np
    out = {}
    for field in ("generator", "discriminator"):
        keys = [k for k in ref if k.startswith(field + "/")]
        a = np.concatenate([(ref[k] - start[k]).ravel() for k in keys]
                           ).astype(np.float64)
        b = np.concatenate([(got[k] - start[k]).ravel() for k in keys]
                           ).astype(np.float64)
        out[field] = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    return out


def dp_many_cards(device, workdir, n, arms):
    """Two or more cards: each of ``arms`` at dp=n against dp=1 on the
    same global batch (DP_COMPARE_STEPS steps: every step's d_loss by
    DP_LOSS, each model's update by DP_COS; bf16, so not the f32 CPU
    tests' tolerance), two dp=n runs bit for bit (the runs' own replica
    check held every rank bit-equal at the checkpoints), a SIGTERM to a
    dp=n CLI run (every rank stops after one step, one checkpoint, exit 0),
    and, for the full arms, the warm step, the collectives a step, the
    NCCL kernels' device time and each rank's idle share at dp=n against
    dp=1 (``dp_steps``)."""
    import signal
    import numpy as np
    from levelgan_torch import api
    from levelgan_torch.dist import mesh
    from levelgan_torch.lio.checkpoint import all_checkpoints

    dt = device.type
    many = mesh.Plan(world=n, local=n, first_rank=0, device_type=dt)
    one = mesh.Plan(world=1, local=1, first_rank=0, device_type=dt)
    for name in arms:
        full = DP_ARMS[name][2]
        init = dp_config(name, workdir, "init", 0)
        with tf32_as_torch():
            start = load_arrays(api.train(init, device=device,
                                          echo=False)["checkpoint"])
        runs = {}
        for tag, plan in (("dp1", one), (f"dp{n}", many), (f"dp{n}b", many)):
            cfg = dp_config(name, workdir, tag, DP_COMPARE_STEPS,
                            **{"dist.dp": plan.world})
            t0 = time.perf_counter()
            ranks = mesh.launch(dp_train, (cfg.to_dict(), dt), {}, plan)
            runs[tag] = (load_arrays(ranks[0]["result"]["checkpoint"]),
                         [r["d_loss"] for r in map(json.loads, open(
                             os.path.join(cfg.io.out_dir, "metrics.jsonl")))
                          if "d_loss" in r],
                         time.perf_counter() - t0)
            print(f"  {name} {tag}: {DP_COMPARE_STEPS} steps in "
                  f"{runs[tag][2]:.1f} s wall; rank 0's launches "
                  f"{ranks[0]['counts']}")
        (ref, l1, _), (got, ln, _), (again, _, _) = (
            runs["dp1"], runs[f"dp{n}"], runs[f"dp{n}b"])
        diff = differing(got, again)
        print(f"  {name}: two dp={n} runs "
              + ("bit-identical" if not diff else "differ")
              + f" in {len(got)} arrays")
        if diff:
            fail(f"{name}: two dp={n} runs differ: {diff[:8]}")
        cos = dp_update_agreement(ref, got, start)
        lr = dp_arm(name).train.lr_g
        worst = max(float(np.abs(got[k] - ref[k]).max()) for k in ref
                    if k.startswith(("generator/", "discriminator/")))
        loss = [abs(a - b) / max(1.0, abs(a)) for a, b in zip(l1, ln)]
        print(f"  {name} dp={n} against dp=1: update cosine "
              f"{ {k: round(v, 5) for k, v in cos.items()} }; max |param "
              f"diff| {worst:.3g} ({worst / lr:.3g} lr); d_loss per step "
              f"dp=1 {[round(x, 5) for x in l1]} dp={n} "
              f"{[round(x, 5) for x in ln]}, max rel diff {max(loss):.4g}")
        if min(cos.values()) < DP_COS or max(loss) > DP_LOSS:
            fail(f"{name}: dp={n} does not follow dp=1 (cosine {cos}, "
                 f"d_loss {max(loss):.4g})")
        for tag, plan in (("dp1", one), (f"dp{n}", many)) if full else ():
            cfg = dp_config(name, workdir, "steps", 0,
                            **{"dist.dp": plan.world})
            res = mesh.launch(dp_steps, (cfg.to_dict(), 5, 15, 3, dt), {},
                              plan)
            for r in res:
                print(f"  {name} {tag} rank {r['rank']}: warm step median "
                      f"{r['step_ms']:.3f} ms ({r['min_ms']:.3f}-"
                      f"{r['max_ms']:.3f}); collectives a step "
                      f"{r['collectives']}; profiled {r['wall_ms']:.3f} ms "
                      f"a step, device busy {r['busy_ms']:.3f} ms, NCCL "
                      f"{r['nccl_ms']:.4f} ms in {r['nccl_calls']} kernels, "
                      f"idle share {r['idle']}")
    print_allreduce(many, arms)
    # SIGTERM to the launching CLI process
    cfg = dp_config("curriculum_16", workdir, "sigterm", 500,
                    **{"dist.dp": n})
    cfg_path = os.path.join(workdir, "dp_sigterm.json")
    with open(cfg_path, "w") as fh:
        fh.write(cfg.to_json())
    out = cfg.io.out_dir
    proc = subprocess.Popen(
        [sys.executable, "-m", "levelgan_torch.cli.train", "--config",
         cfg_path, "--device", dt], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    metrics = os.path.join(out, "metrics.jsonl")
    try:
        t0 = time.perf_counter()
        while not (os.path.exists(metrics) and os.path.getsize(metrics)):
            if proc.poll() is not None or time.perf_counter() - t0 > 300:
                fail("the dp CLI logged no step: "
                     + proc.communicate(timeout=60)[0][-2000:])
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        text = proc.communicate(timeout=300)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    ckpts = all_checkpoints(os.path.join(out, "ckpt"))
    step = int(load_arrays(ckpts[-1])["step"]) if ckpts else None
    print(f"  SIGTERM to a dp={n} CLI run after its first logged step: exit "
          f"{proc.returncode}, {len(ckpts)} checkpoint(s), at step {step}")
    if (proc.returncode != 0 or len(ckpts) != 1 or step is None
            or not step < cfg.train.steps or "preempted" not in text):
        fail(f"SIGTERM at dp={n}: exit {proc.returncode}, checkpoints "
             f"{ckpts}: {text[-2000:]}")


def dp_phase(device, workdir, rows, train_counts, arms):
    """The dp phase: the path's kernels at a dp=4 rank's batch (B = 16)
    against their plain versions, the launcher at world size 1, and with
    two or more cards the data-parallel runs (``dp_many_cards``)."""
    import torch
    from levelgan_torch.config import preset
    print(f"  the path's kernels at a dp=4 rank's batch, B = {B_RANK}:")
    for name in ("curriculum_16", "gumbel_64", "wgan_gp_32"):
        train_kernel_parity(preset(name), device, rows, b=B_RANK)
    fused_kernel_parity(device, rows, b=B_RANK, only=("curriculum_16",))
    gen = torch.Generator(device).manual_seed(410)
    floor = launch_floor_ms()
    for config, f in (("16x16", 16 * 16 * 8), ("gumbel_64", 64 * 64 * 8),
                      ("wgan_gp_32", 32 * 32 * 8)):
        k2_core_pair(rows, f"{config}_b{B_RANK}", B_RANK, f, gen, floor)
    dp_launcher_runs(device, workdir, train_counts, arms)
    n = torch.cuda.device_count()
    if n > 1:
        dp_many_cards(device, workdir, n, arms)
    else:
        print("  one card: the dp=N runs need two or more (python3 "
              "chip_smoke.py --phases build,dp on a machine with four)")



# the pair_drift phase: BASELINE.md's mbstd pair (wgan_gp_32 with
# train.w_presence=10 and model.critic_mbstd=input, the softmax head, bf16)
# and its control (neither knob) trained PAIR_DRIFT_STEPS injected steps
# from one seeded state on the card (K1, K1 bwd, K2 core) and on this
# machine's CPU (the plain versions).  Per step, a loss's deviation is
# |card - cpu| / max(|cpu|, 1); at the end the update's deviation is
# |p_card - p_cpu| / |p_cpu - p_0| over every parameter of G and D.  The
# pair's mean loss deviation and its update deviation may each be at most
# PAIR_DRIFT_FACTOR times the control's: a fault on the pair's path (the
# mbstd channel, the presence prior) shows as drift the control does not
# have.  On an H100 the pair reads 0.43x / 1.5x the control's, and faults
# planted on the card side of a copy read: the mbstd map zeroed 151x /
# 21x (caught), the map 1% high 0.75x / 2.0x, its variance or the presence
# prior's counts rounded to bf16 at most 1.2x / 2.0x (not caught: faults
# of a rounding's size are the CPU parity tests').  The CPU side is cut to
# PAIR_DRIFT_CUT_B levels a batch when the CPU would take over
# PAIR_DRIFT_CPU_S for both arms at B = 64.
PAIR_DRIFT_ARMS = {"pair": {"train.w_presence": 10.0,
                            "model.critic_mbstd": "input"},
                   "control": {}}
PAIR_DRIFT_STEPS = 8
PAIR_DRIFT_FACTOR = 4.0
PAIR_DRIFT_CPU_S = 60.0
PAIR_DRIFT_CUT_B = 16
PAIR_DRIFT_LOSSES = ("d_loss", "gp", "wdist", "g_loss", "presence")


def tree_to(tree, device):
    """``tree`` (tensors in dicts, lists and tuples; None where a head
    draws nothing) on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return None if tree is None else tree.to(device)


def pair_drift_arm(name, device, batch, train_counts):
    """One arm of the pair_drift phase: (per-step loss deviations, the
    update's deviation, CPU seconds); the card side's launches go into
    ``train_counts`` under the arm's path name."""
    import torch
    from levelgan_torch.api import step_mode
    from levelgan_torch.config import preset
    from levelgan_torch.train.state import create_state
    from levelgan_torch.train.wgan_gp import draw_step_noise, \
        make_wgan_gp_step

    cfg = preset("wgan_gp_32").override(**{
        **PAIR_DRIFT_ARMS[name], "train.batch_size": batch})
    m, t = cfg.model, cfg.train
    g = torch.Generator().manual_seed(31)
    inputs = [(torch.randint(0, m.n_tiles, (t.n_critic, batch, m.level_size,
                                            m.level_size), dtype=torch.uint8,
                             generator=g),
               draw_step_noise(cfg, t.n_critic, batch, "cpu", g))
              for _ in range(PAIR_DRIFT_STEPS)]
    sides, cpu_s = {}, 0.0
    for side in ("card", "cpu"):
        dev = device if side == "card" else torch.device("cpu")
        state = create_state(cfg, dev, seed=33)
        p0 = [p.detach().float().cpu().clone() for p in
              (*state.generator.parameters(), *state.critic.parameters())]
        step = make_wgan_gp_step(cfg)
        losses = []
        if side == "card":
            torch.cuda.synchronize()
            reset_counts()
        t0 = time.perf_counter()
        with step_mode():
            for ids, noise in inputs:
                state, met = step(state, ids.to(dev), noise=tree_to(
                    noise, dev))
                losses.append({k: float(met[k]) for k in PAIR_DRIFT_LOSSES
                               if k in met})
        if side == "card":
            torch.cuda.synchronize()
            train_counts[f"wgan_gp_32 pair_drift {name}"] = read_counts()
        else:
            cpu_s = time.perf_counter() - t0
        sides[side] = (losses, [p.detach().float().cpu() for p in (
            *state.generator.parameters(), *state.critic.parameters())])
    (card_l, card_p), (cpu_l, cpu_p) = sides["card"], sides["cpu"]
    devs = [{k: abs(a[k] - b[k]) / max(abs(b[k]), 1.0) for k in b}
            for a, b in zip(card_l, cpu_l)]
    num = math.sqrt(sum(float((a - b).double().square().sum())
                        for a, b in zip(card_p, cpu_p)))
    den = math.sqrt(sum(float((b - z).double().square().sum())
                        for b, z in zip(cpu_p, p0)))
    return devs, num / den, cpu_s


def pair_drift(device, train_counts):
    """The pair_drift phase (see PAIR_DRIFT_ARMS): prints every step's loss
    deviations and the update's; fails when the pair drifts past its
    control, or when a kernel of the path did not launch on the card."""
    import torch
    from levelgan_torch.config import preset
    from levelgan_torch.train.state import create_state
    from levelgan_torch.train.wgan_gp import make_wgan_gp_step

    batch = B_TRAIN
    # the CPU's time for one step of the pair at B = 64, scaled to both arms
    cfg = preset("wgan_gp_32").override(**PAIR_DRIFT_ARMS["pair"])
    state = create_state(cfg, "cpu", seed=33)
    m, t = cfg.model, cfg.train
    ids = torch.zeros((t.n_critic, batch, m.level_size, m.level_size),
                      dtype=torch.uint8)
    t0 = time.perf_counter()
    make_wgan_gp_step(cfg)(state, ids, generator=torch.Generator())
    est = (time.perf_counter() - t0) * PAIR_DRIFT_STEPS * len(PAIR_DRIFT_ARMS)
    if est > PAIR_DRIFT_CPU_S:
        batch = PAIR_DRIFT_CUT_B
        print(f"  cut: the CPU side would take ~{est:.0f} s at B = "
              f"{B_TRAIN} (over {PAIR_DRIFT_CPU_S:.0f} s), so both sides "
              f"and both arms run B = {batch}")
    res = {}
    for name in PAIR_DRIFT_ARMS:
        devs, upd, cpu_s = pair_drift_arm(name, device, batch, train_counts)
        res[name] = (statistics.mean(max(d.values()) for d in devs), upd)
        print(f"  {name} (B = {batch}, {PAIR_DRIFT_STEPS} steps, CPU side "
              f"{cpu_s:.1f} s): loss deviation a step "
              + " ".join("{" + ", ".join(f"{k} {v:.3g}" for k, v in d.items())
                         + "}" for d in devs)
              + f"; update deviation at the end {upd:.4g}; launches "
              f"{train_counts[f'wgan_gp_32 pair_drift {name}']}")
    (p_loss, p_upd), (c_loss, c_upd) = res["pair"], res["control"]
    print(f"  pair / control: mean loss deviation {p_loss:.4g} / "
          f"{c_loss:.4g}, update deviation {p_upd:.4g} / {c_upd:.4g} "
          f"(allowed {PAIR_DRIFT_FACTOR} x control)")
    for name in PAIR_DRIFT_ARMS:
        c = train_counts[f"wgan_gp_32 pair_drift {name}"]
        idle = [k for k in ("K1", "K1 bwd", "K2 core fwd", "K2 core bwd")
                if not c[k]]
        if idle:
            fail(f"pair_drift {name}: {idle} never launched on the card")
    if (p_loss > PAIR_DRIFT_FACTOR * c_loss
            or p_upd > PAIR_DRIFT_FACTOR * c_upd):
        fail("the mbstd pair drifts from the CPU more than its control")


# the race_drift phase: race_curriculum_32 at full width in bf16 (its
# dtype) and its f32 control, RACE_DRIFT_STEPS injected steps from one
# seeded state on the card (the K2 core) and on this machine's CPU (its
# plain version), read as pair_drift reads its arms.  In f32 the card
# follows the CPU to a few ulps (update deviation 4.5e-5 on an H100); in
# bf16 the two sides round differently from the first step on and part by
# 0.019 (mean loss deviation) and 0.042 (update deviation), 1e4x / 950x
# the control, so the bf16 arm is held to RACE_DRIFT_LIMITS, set between
# its reading and those of faults planted on the card side alone
# (RACE_DRIFT_PLANTS, each against the CPU reference of its arm): a G-loss
# term dropped (the closure prior, in an arm that trains with it: 1.0 /
# 0.57) and the GRU gates' sigmoid rounded once, torch's, where XLA rounds
# each op (0.079 / 0.36), must read above a limit; the REINFORCE advantage
# 1% high (0.020 / 0.043) reads as the honest arm does and is printed, not
# held.  RACE_DRIFT_VARIANTS are card-side settings read the same way.
RACE_DRIFT_ARMS = {"bf16": {}, "f32 control": {"model.dtype": "float32"}}
RACE_DRIFT_STEPS = 8
# (mean loss deviation, update deviation): the bf16 arm's ceiling, and the
# f32 control's
RACE_DRIFT_LIMITS = {"bf16": (0.04, 0.15), "f32 control": (1e-3, 1e-3)}
RACE_DRIFT_CLOSURE = {"train.w_closure": 0.5}


def _plant_closure_dropped():
    import levelgan_torch.track.train as tt
    old = tt.closure_penalty
    tt.closure_penalty = lambda tracks: 0.0 * old(tracks)
    return lambda: setattr(tt, "closure_penalty", old)


def _plant_sigmoid_once():
    import torch
    import levelgan_torch.track.models as tm
    old = tm.sigmoid
    tm.sigmoid = torch.sigmoid
    return lambda: setattr(tm, "sigmoid", old)


def _plant_advantage_high():
    import levelgan_torch.track.train as tt
    old = tt.reinforce_term
    tt.reinforce_term = lambda adv, *a: old(1.01 * adv, *a)
    return lambda: setattr(tt, "reinforce_term", old)


def _no_reduced_precision_reduction():
    import torch
    mm = torch.backends.cuda.matmul
    old = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    return lambda: setattr(mm, "allow_bf16_reduced_precision_reduction", old)


# settings of the card side read against the bf16 arm's CPU reference, as
# the plants are (name -> the setting: applies it, returns its undo)
RACE_DRIFT_VARIANTS = {
    "cuBLAS bf16 reductions in f32": _no_reduced_precision_reduction}
# plant -> (the arm's overrides, the plant: applies it, returns its undo;
# whether the bf16 limits must see it)
RACE_DRIFT_PLANTS = {
    "closure prior dropped (w_closure 0.5)": (RACE_DRIFT_CLOSURE,
                                              _plant_closure_dropped, True),
    "GRU sigmoid rounded once": ({}, _plant_sigmoid_once, True),
    "REINFORCE advantage 1% high": ({}, _plant_advantage_high, False)}


def race_drift_side(cfg, dev, inputs, plant=None):
    """``inputs`` [(batch, noise)] as steps of ``cfg`` on ``dev`` from the
    state of seed 33: (per-step metrics, final parameters of G, D and both
    drivers, the initial ones); ``plant`` is applied around the steps."""
    import torch
    from levelgan_torch.api import step_mode
    from levelgan_torch.track.train import make_track_curriculum_step
    from levelgan_torch.train.state import create_state

    def params(st):
        return [p.detach().float().cpu().clone() for mod in (
            st.generator, st.critic, st.agent_strong, st.agent_weak)
            for p in mod.parameters()]
    state = create_state(cfg, dev, seed=33)
    p0 = params(state)
    step = make_track_curriculum_step(cfg)
    undo = plant() if plant else None
    mets = []
    try:
        with step_mode():
            for batch, noise in inputs:
                state, met = step(state, batch.to(dev),
                                  noise=tree_to(noise, dev))
                mets.append({k: float(v) for k, v in met.items()
                             if k != "gen_hist"})
    finally:
        if undo:
            undo()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return mets, params(state), p0


def race_drift_reading(card, cpu) -> tuple:
    """(per-step loss deviations, mean of each step's largest, the update's
    deviation at the end) of a card run against its CPU reference."""
    (card_m, card_p, _), (cpu_m, cpu_p, p0) = card, cpu
    devs = [{k: abs(a[k] - b[k]) / max(abs(b[k]), 1.0) for k in b}
            for a, b in zip(card_m, cpu_m)]
    num = math.sqrt(sum(float((a - b).double().square().sum())
                        for a, b in zip(card_p, cpu_p)))
    den = math.sqrt(sum(float((b - z).double().square().sum())
                        for b, z in zip(cpu_p, p0)))
    return devs, statistics.mean(max(d.values()) for d in devs), num / den


def race_drift(device, train_counts):
    """The race_drift phase (see RACE_DRIFT_ARMS): prints every step's loss
    deviations and the update's for the bf16 arm and its f32 control, and
    each planted fault's and variant's reading on a line of its own; fails
    when an arm drifts past its RACE_DRIFT_LIMITS, when a plant the limits
    must see reads within them, or when the K2 core did not launch on the
    card."""
    import torch
    from levelgan_torch.config import preset
    from levelgan_torch.track.data import synthetic_tracks
    from levelgan_torch.track.train import draw_track_noise

    base = preset("race_curriculum_32").override(
        **{"train.batch_size": B_TRAIN})
    m, t = base.model, base.train
    g = torch.Generator().manual_seed(37)
    corpus = torch.from_numpy(synthetic_tracks(512, m.n_segments, seed=41))
    inputs = [(corpus[torch.randint(0, len(corpus), (t.n_critic, B_TRAIN),
                                    generator=g)],
               draw_track_noise(base, t.n_critic, B_TRAIN, "cpu", g))
              for _ in range(RACE_DRIFT_STEPS)]
    cpu = torch.device("cpu")
    refs, res = {}, {}
    for name, over in (*RACE_DRIFT_ARMS.items(),
                       ("closure", RACE_DRIFT_CLOSURE)):
        cfg = base.override(**over)
        t0 = time.perf_counter()
        refs[name] = race_drift_side(cfg, cpu, inputs)
        cpu_s = time.perf_counter() - t0
        if name == "closure":
            continue
        reset_counts()
        card = race_drift_side(cfg, device, inputs)
        train_counts[f"race_curriculum_32 race_drift {name}"] = read_counts()
        devs, loss, upd = race_drift_reading(card, refs[name])
        res[name] = (loss, upd)
        print(f"  {name} (B = {B_TRAIN}, {RACE_DRIFT_STEPS} steps, CPU side "
              f"{cpu_s:.1f} s): loss deviation a step "
              + " ".join("{" + ", ".join(f"{k} {v:.3g}" for k, v in d.items())
                         + "}" for d in devs)
              + f"; mean {loss:.4g}; update deviation at the end {upd:.4g};"
              f" launches "
              f"{train_counts[f'race_curriculum_32 race_drift {name}']}")
    (b_loss, b_upd), (c_loss, c_upd) = res["bf16"], res["f32 control"]
    print(f"  bf16 / f32 control: mean loss deviation {b_loss:.4g} / "
          f"{c_loss:.4g}, update deviation {b_upd:.4g} / {c_upd:.4g} "
          f"(limits {RACE_DRIFT_LIMITS})")
    blind = []
    for plant, (over, apply, seen) in RACE_DRIFT_PLANTS.items():
        cfg = base.override(**over)
        ref = refs["closure" if over else "bf16"]
        _, loss, upd = race_drift_reading(
            race_drift_side(cfg, device, inputs, apply), ref)
        caught = (loss > RACE_DRIFT_LIMITS["bf16"][0]
                  or upd > RACE_DRIFT_LIMITS["bf16"][1])
        print(f"  planted: {plant}: mean loss deviation {loss:.4g}, update "
              f"deviation {upd:.4g} ({'above' if caught else 'within'} the "
              f"bf16 limits)")
        if seen and not caught:
            blind.append(plant)
    for name, apply in RACE_DRIFT_VARIANTS.items():
        _, loss, upd = race_drift_reading(
            race_drift_side(base, device, inputs, apply), refs["bf16"])
        print(f"  variant: bf16 with {name}: mean loss deviation {loss:.4g}"
              f", update deviation {upd:.4g}")
    for name in RACE_DRIFT_ARMS:
        c = train_counts[f"race_curriculum_32 race_drift {name}"]
        idle = [k for k in ("K2 core fwd", "K2 core bwd") if not c[k]]
        if idle:
            fail(f"race_drift {name}: {idle} never launched on the card")
    for name, (loss, upd) in res.items():
        if loss > RACE_DRIFT_LIMITS[name][0] or upd > RACE_DRIFT_LIMITS[name][1]:
            fail(f"race_curriculum_32 {name} drifts from the CPU past "
                 f"{RACE_DRIFT_LIMITS[name]}")
    if blind:
        fail(f"race_drift's limits do not see the planted {blind}")


def kernels_line(records, counts, train_records, train_counts,
                 gate_counts=None):
    """One entry per kernel.  The forward kernels' times are summed over
    the stages they serve on the export path (per 1024-level batch), with
    that path's launches.  The training kernels' times are summed over the
    stages they serve in one training step (one launch per stage, B = 64)
    of the configuration that runs them (gumbel_64; wgan_gp_32 for K2
    fused), with the launches of all training runs; where the kernel was
    also held at another configuration's shapes, ``at_<configuration>``
    holds the same sums there (for K1 forward ``at_gumbel_64_training``
    too: its B = 64 shapes beside the export entry).  Errors are the max
    over those stages.  The gates phase's paths (``gate_counts``) add
    their launches, each under its own name."""
    meta = {
        "K1": ("upsample_block_fwd", "levelgan_torch/csrc/upsample_block.cu",
               "levelgan/kernels/upsample_block.py:304"),
        "K1L": ("upsample_rows_stage", "levelgan_torch/csrc/upsample_rows.cu",
                "levelgan/kernels/upsample_rows.py:253"),
        "K1 bwd": ("upsample_block_bwd",
                   "levelgan_torch/csrc/upsample_block.cu",
                   "levelgan/kernels/upsample_block.py:462"),
        "K1L bwd": ("upsample_rows_bwd",
                    "levelgan_torch/csrc/upsample_rows.cu",
                    "levelgan/kernels/upsample_rows.py:323 (with the XLA "
                    "pass before it, levelgan/kernels/upsample_rows.py:"
                    "453-479)"),
        "K2 core fwd": ("norm_penalty_fwd", "levelgan_torch/csrc/gp_penalty.cu",
                        "levelgan/kernels/gp_penalty.py:81"),
        "K2 core bwd": ("norm_penalty_bwd", "levelgan_torch/csrc/gp_penalty.cu",
                        "levelgan/kernels/gp_penalty.py:99"),
        "K2 fused": ("critic_trunk_grad", "levelgan_torch/csrc/critic_grad.cu",
                     "levelgan/kernels/critic_grad.py:290"),
    }
    from levelgan_torch.kernels import upsample_block as k1

    def on_path(r):
        if r["stage"] == "gp":
            return True
        fits = k1.fits(r["shape"][1], r["shape"][1])
        return r["kernel"] in (("K1", "K1 bwd") if fits else ("K1L", "K1L bwd"))

    def sums(rs):
        return {
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": max(rs, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": sum(r["library_ms"] for r in rs),
            "stages": [r["stage"] for r in rs]}

    out = []
    for kern, (name, src, repl) in meta.items():
        train = kern not in ("K1", "K1L")
        home = "wgan_gp_32" if kern == "K2 fused" else "gumbel_64"
        pool = [r for r in (train_records if train else records)
                if r["kernel"] == kern and on_path(r)]
        if train:
            by_run = {run: c[kern] for run, c in train_counts.items()}
            launches = sum(by_run.values())
        else:
            by_run, launches = {"gumbel_64 export": counts[kern]}, counts[kern]
            # the B = 64 records of gumbel_64 get an entry of their own,
            # beside the export entry of the same configuration
            pool += [{**r, "config": r["config"] + "_training"}
                     if r["config"] == home else r
                     for r in train_records if r["kernel"] == kern]
        for run, c in (gate_counts or {}).items():
            if c[kern]:
                by_run[run] = c[kern]
                launches += c[kern]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": repl, "launches": launches,
                 **sums([r for r in pool if r.get("config", home) == home]),
                 "per": (f"one launch per stage of a {home} training step "
                         "(B = 64), device time" if train else
                         "one 1024-level export batch (sum over stages)"),
                 "path": "training" if train else "export",
                 "launches_by_run": by_run}
        for other in sorted({r.get("config", home) for r in pool} - {home}):
            rs = [r for r in pool if r.get("config") == other]
            entry[f"at_{other}"] = {
                **sums(rs), "per": f"one launch per stage at {other}'s "
                                   f"shapes (B = {rs[0]['shape'][0]}), "
                                   "device time"}
        out.append(entry)
    return {"kernels": out}


PHASES = ("build", "parity", "head", "export", "export_repair", "export_cond",
          "export_profile", "train_parity", "k2_core", "train", "train_check",
          "train_profile", "pair_drift", "race_drift", "repro", "gates",
          "dp")


def main(argv=()) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--dp-arms", default=",".join(DP_ARMS),
                    help="the dp phase's arms, a comma-separated subset of "
                         + ",".join(DP_ARMS))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    if set(args.dp_arms.split(",")) - set(DP_ARMS):
        ap.error(f"unknown dp arms {args.dp_arms}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from levelgan_torch.config import preset
        from levelgan_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: levelgan_torch not importable: {e}",
              file=sys.stderr)
        return 2

    # the plain versions are references: keep cuDNN/cuBLAS out of TF32
    # (the repro phase runs with torch's own settings, as the CLI does)
    TORCH_TF32.extend((torch.backends.cudnn.allow_tf32,
                       torch.backends.cuda.matmul.allow_tf32))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t_start = time.perf_counter()

    def phase(name):
        run = name in phases
        if run:
            print(f"[{time.perf_counter() - t_start:7.1f} s] phase {name}",
                  flush=True)
        return run

    if phase("build"):
        t0 = time.perf_counter()
        secs = build.build_all()
        print(f"build: {time.perf_counter() - t0:.2f} s wall "
              + " ".join(f"{k}={v:.2f}s" for k, v in secs.items()))
        for stem, log in build.build_logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {stem}: {line.strip()}")

    cfg = preset("gumbel_64")
    # the second configuration: the fused GP's path
    cfg32 = preset("wgan_gp_32").override(**{"model.pallas_gp": "fused"})
    # the third: the curriculum's path through the 16x16 critic
    cfg16 = preset("curriculum_16")
    records = counts = None
    train_records, train_counts, gate_counts = [], {}, {}
    if phase("parity"):
        print("forward kernel parity and timing (gumbel_64 stages, B=1024, "
              "bf16):")
        records = kernel_parity(cfg, device)
        for b, (_, _, names) in k1l_stage_timing(cfg, device).items():
            if [n for n in names if "upsample_rows_stage_kernel" not in n]:
                fail(f"the K1L stage at B={b} ran other device kernels than "
                     f"its own: {names}")
    if phase("head"):
        print(f"fused sampling head parity and timing (gumbel_64, B={B}, "
              "f32 logits):")
        head_kernel(cfg, device)
    workdir = tempfile.mkdtemp(prefix="levelgan_torch_smoke_")
    try:
        if phase("export"):
            print("export path: gumbel_64 export through the port's CLI")
            counts = main_path(cfg, device, workdir)
            print(f"track export: racetrack_32 through the port's CLI, "
                  f"{N_TRACKS} tracks, closure repair on")
            track_export(device, workdir)
        if phase("export_repair"):
            print("repaired export: gumbel_64 through the CLI with --repair "
                  "--exactly-one under both placements")
            export_repair(cfg, device, workdir)
        if phase("export_cond"):
            print("conditioned export: conditional_32 through the CLI with "
                  "--cond, --calibrated and the corpus-mean default")
            export_cond(device, workdir)
        if phase("export_profile"):
            print("profile: one export batch")
            profile_export(cfg, device)
        if phase("train_parity"):
            # toy_dcgan_16: K1 fwd and bwd at its two stages (the BCE step)
            for c in (cfg, cfg32, preset("toy_dcgan_16")):
                print(f"training kernel parity and timing ({c.preset}, "
                      f"B={B_TRAIN}):")
                train_kernel_parity(c, device, train_records)
            print("K1L bwd's general kernel at shapes the staged one does "
                  "not take, and at gumbel_64 up3:")
            k1l_bwd_general(cfg, device)
            print(f"K2 fused parity and timing (B={B_TRAIN}):")
            fused_kernel_parity(device, train_records)
            for c in (cfg, cfg32):
                time_gradient_penalties(c, device)
        if phase("k2_core"):
            print(f"K2 core parity and timing (B={B_TRAIN}, f32):")
            k2_core_rows(device, train_records)
        if phase("train"):
            for name, overrides, steps in TRAIN_RUNS:
                print(f"training path: levelgan_torch.cli.train "
                      f"{'--preset ' + name if name != 'toy_dcgan_16' else ''}"
                      f" {' '.join(overrides)}, {steps} steps "
                      + ("(the whole 4096-track corpus)"
                         if name in TRACK_PRESETS else
                         f"(data.corpus_size cut to {CORPUS_CUT}: the "
                         "preset's 4096 levels take minutes of host NumPy "
                         "carving)"))
                train_counts[name] = train_path(name, overrides, steps,
                                                workdir)
        if phase("train_check"):
            for c in (cfg, cfg32):
                print(f"training through the kernels vs the plain path "
                      f"({c.preset}, pallas_gp={c.model.pallas_gp}):")
                train_vs_plain(c, device)
            print("a curriculum step through the kernels vs the plain path "
                  "(curriculum_16, K2 core):")
            curriculum_vs_plain(cfg16, device)
            for name in TRACK_PRESETS:
                print(f"a {name} step through the K2 core vs the plain GP:")
                track_vs_plain(preset(name), device)
        if phase("train_profile"):
            for c in (cfg, cfg32, cfg16, *map(preset, TRACK_PRESETS)):
                print(f"warm steps and profile: {c.preset} training, "
                      f"pallas_gp={c.model.pallas_gp}")
                state, step_fn, corpus = warm_steps(c, device)
                profile_train(state, step_fn, corpus, c)
        if phase("pair_drift"):
            print("pair drift: the mbstd pair and its control, "
                  f"{PAIR_DRIFT_STEPS} injected wgan_gp_32 steps on the card "
                  "and on the CPU; then the pair's warm step")
            pair_drift(device, train_counts)
            warm_steps(preset("wgan_gp_32").override(
                **PAIR_DRIFT_ARMS["pair"]), device)
        if phase("race_drift"):
            print("race drift: race_curriculum_32 in bf16 and its f32 "
                  f"control, {RACE_DRIFT_STEPS} injected steps on the card "
                  "and on the CPU, and faults planted on the card side")
            race_drift(device, train_counts)
        if phase("repro"):
            print("reproducibility: gumbel_64 trained twice from one seed, "
                  "then resumed and stopped by SIGTERM")
            reproducibility(device, workdir)
            print("reproducibility: racetrack_32 trained in a fresh process "
                  "and here from one seed")
            track_repro(device, workdir)
        if phase("gates"):
            print("gates: curriculum_16 with io.render_every / io.profile / "
                  "io.tensorboard, the skill gap, the progress GIF, the "
                  "causality gates (conditional_32) and the native carver")
            gate_counts.update(gates_phase(device, workdir, train_records))
        if phase("dp"):
            print("data parallelism: the path's kernels at a rank's batch, "
                  "the launcher at world size 1, and dp=N with N cards")
            dp_phase(device, workdir, train_records, train_counts,
                     args.dp_arms.split(","))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"[{time.perf_counter() - t_start:7.1f} s] phases done")
    if set(phases) != set(PHASES):
        print(f"ran phases {phases}: contract lines are printed only by the "
              "full run")
        return 0
    print(json.dumps(kernels_line(records, counts, train_records,
                                  train_counts, gate_counts)))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
