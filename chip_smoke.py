#!/usr/bin/env python3
"""GPU smoke run of the levelgan_torch port: ``python3 chip_smoke.py``.

Needs one CUDA card (exits non-zero without one, and without the
``levelgan_torch`` package beside it).  Phases, each fatal on failure:

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ``levelgan_torch/csrc`` (parallel nvcc);
3. kernel parity + timing at each gumbel_64 stage shape, B = 1024, bf16:
   each kernel against its plain PyTorch version (max abs error against a
   stated bf16 tolerance), kernel / plain / library-call median times
   (CUDA events, warm-up excluded) and the roofline bound;
4. the main path: a gumbel_64 generator with seeded random weights is
   written as a FORMAT.md checkpoint and exported through the port's CLI
   (65,536 levels at batch 1024); the levels are checked, the kernels'
   launch counters must show every batch went through them, and one batch
   through the kernels is held against the plain path on the card;
5. a torch.profiler breakdown of one export batch (device time by kernel,
   device idle share) and the host's D2H and unpack times;
6. print the ``kernels`` JSON line, the card line, and the final
   ``{"ok": true, "device": ...}`` line.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
B = 1024                     # export batch
N_LEVELS = 65536
# bf16 tolerance of a stage output: 4 bf16 ulps relative plus 2^-6
# absolute.  The kernel normalises the f32 conv tile and rounds once; the
# plain version rounds the conv output to bf16 before GroupNorm, which
# alone moves a normalised value by ~2^-9 of its size.
ATOL, RTOL = 2.0 ** -6, 2.0 ** -6
# whole-generator check, kernels vs plain on the card, same z and noise
LOGIT_TOL = 0.05             # max |dlogit| / max |logit|
TILE_AGREE = 0.97            # share of identical sampled tiles


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


def stage_inputs(h, ci, co, device, seed):
    import torch
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn((B, h, h, ci), generator=g, device=device).to(
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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_parity(cfg, device):
    """Phase 3: per (kernel, stage) parity + timing records."""
    import torch
    import torch.nn.functional as F
    from levelgan_torch.kernels import upsample_block as k1
    from levelgan_torch.kernels import upsample_rows as k1l
    from levelgan_torch.ops.blocks import upsample_block

    gs = cfg.model.group_size
    slope = cfg.model.leaky_slope
    rows = []
    for i, (name, h, ci, co) in enumerate(stage_shapes(cfg)):
        x, w, gamma, beta = stage_inputs(h, ci, co, device, seed=100 + i)
        flops = 2.0 * (2 * h) * (2 * h) * 4 * ci * co * B
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        w_t = w.permute(2, 3, 0, 1).flip(2, 3).to(torch.bfloat16).contiguous()
        gamma16, beta16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
        kernels = ["K1"] if k1.fits(h, h) else ["K1L"]
        if name == "up2" and "K1L" not in kernels:
            kernels.append("K1L")    # K1L held at a second shape
        for kern in kernels:
            if kern == "K1":
                run = lambda: k1.upsample_block_fwd(   # noqa: E731
                    x, w, gamma, beta, slope=slope, group_size=gs)
                plain = lambda: upsample_block(        # noqa: E731
                    x, w, gamma, beta, slope=slope, group_size=gs,
                    compute_dtype=torch.bfloat16)

                def library():
                    y = F.conv_transpose2d(x_nchw, w_t, stride=2, padding=1)
                    y = F.group_norm(y, co // gs, gamma16, beta16, 1e-5)
                    return F.leaky_relu(y, slope)

                err, ok = close(run(), plain())
                nbytes = (x.numel() * 2 + 16 * ci * co * 2 + 2 * co * 4
                          + B * 4 * h * h * co * 2)
            else:
                run = lambda: k1l.upsample_rows_fwd(x, w)  # noqa: E731
                plain = lambda: k1l.conv_rows_plain(x, w)  # noqa: E731
                library = lambda: F.conv_transpose2d(      # noqa: E731
                    x_nchw, w_t, stride=2, padding=1)
                yf_k, s1_k, s2_k = run()
                yf_p, s1_p, s2_p = plain()
                err, ok = close(yf_k, yf_p)
                # f32 sums, atomics in any order
                rel = max(float((s_k - s_p).abs().max() / s_p.abs().max())
                          for s_k, s_p in ((s1_k, s1_p), (s2_k, s2_p)))
                ok = ok and rel <= 1e-4
                y_k = k1l.finish(yf_k, s1_k, s2_k, gamma, beta, slope=slope,
                                 group_size=gs)
                y_p = upsample_block(x, w, gamma, beta, slope=slope,
                                     group_size=gs,
                                     compute_dtype=torch.bfloat16)
                stage_err, stage_ok = close(y_k, y_p)
                print(f"  {kern} {name} s1/s2 max rel err {rel:.3g} (tol "
                      f"1e-4); whole stage (kernel + finish) vs plain stage:"
                      f" max_abs_err={stage_err:.4g} ok={stage_ok}")
                ok = ok and stage_ok
                nbytes = (x.numel() * 2 + 16 * ci * co * 2
                          + B * h * h * 4 * co * 2 + 2 * B * co * 4)
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
            rows.append(rec)
    return rows


def main_path(cfg, device, workdir, n_levels=N_LEVELS, batch=B):
    """Phase 4: export through the port's CLI with counted kernel launches."""
    import numpy as np
    import torch
    from levelgan_torch.cli import export as cli
    from levelgan_torch.export import generate, generate_batch
    from levelgan_torch.kernels import upsample_block as k1
    from levelgan_torch.kernels import upsample_rows as k1l
    from levelgan_torch.lio.checkpoint import save_checkpoint
    from levelgan_torch.models import Generator

    gen = Generator(cfg.model).init_params(torch.Generator().manual_seed(0))
    ckpt = save_checkpoint(os.path.join(workdir, "ckpt"), gen, cfg, step=0)
    out = os.path.join(workdir, "levels.npz")

    k1.launches = k1l.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["--ckpt", ckpt, "--n", str(n_levels), "--batch",
                   str(batch), "--out", out, "--seed", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"K1": k1.launches, "K1L": k1l.launches}
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
              "K1L": n_batches * (len(fits) - sum(fits))}
    if counts != expect:
        fail(f"kernel launches {counts} != expected {expect}")
    hist = np.bincount(levels.reshape(-1), minlength=m.n_tiles) / levels.size
    print(f"  exported {n_levels} levels through the CLI in {wall:.3f} s "
          f"(wall, incl. checkpoint load and .npz write); launches {counts}; "
          f"tile histogram {np.round(hist, 4).tolist()}")

    # warm throughput of the same call the CLI makes, without file I/O
    gen = gen.to(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(cfg, gen, n_levels, seed=1, batch_size=batch, device=device)
    torch.cuda.synchronize()
    lps = n_levels / (time.perf_counter() - t0)
    print(f"  warm export: {lps:.1f} levels/s ({n_levels} levels, batch "
          f"{batch}, packed D2H + host unpack included)")

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


def profile_export(cfg, device, batches=4):
    """Phase 5: where one export batch's time goes (torch.profiler device
    time by kernel, device busy share, host-side D2H and unpack)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from levelgan_torch.export import generate_batch, unpack_levels
    from levelgan_torch.models import Generator

    m = cfg.model
    gen = Generator(cfg.model).init_params(
        torch.Generator().manual_seed(0)).to(device)
    g = torch.Generator(device).manual_seed(3)
    zs = [torch.randn((B, m.latent_dim), generator=g, device=device)
          for _ in range(batches + 1)]
    generate_batch(gen, cfg, zs[-1], generator=g, pack=True)   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for z in zs[:batches]:
            generate_batch(gen, cfg, z, generator=g, pack=True)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / batches

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side kernel records only: the aten ops above them carry the
    # same device time again
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  key=dev_us, reverse=True)
    if not rows:
        print("  profiler recorded no device kernels: breakdown not measured")
        return
    busy_ms = sum(dev_us(e) for e in rows) / 1e3 / batches
    print(f"  per batch ({B} levels): wall {wall_ms:.3f} ms (profiled), "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in rows[:14]:
        print(f"    {dev_us(e) / 1e3 / batches:8.3f} ms  x{e.count // batches:<3d}"
              f" {e.key[:90]}")

    packed = generate_batch(gen, cfg, zs[0], generator=g, pack=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = packed.cpu().numpy()
    t_d2h = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    unpack_levels(host, m.level_size)
    t_unpack = 1e3 * (time.perf_counter() - t0)
    print(f"  host per batch: D2H of {host.nbytes} packed bytes "
          f"{t_d2h:.3f} ms, NumPy unpack {t_unpack:.3f} ms")


def kernels_line(records, counts):
    """One entry per kernel; times summed over the stages it serves on the
    main path (i.e. per 1024-level batch), error the max over them."""
    meta = {
        "K1": ("upsample_block_fwd", "levelgan_torch/csrc/upsample_block.cu",
               "levelgan/kernels/upsample_block.py:304"),
        "K1L": ("upsample_rows_fwd", "levelgan_torch/csrc/upsample_rows.cu",
                "levelgan/kernels/upsample_rows.py:253"),
    }
    from levelgan_torch.kernels import upsample_block as k1
    on_path = {r["stage"]: ("K1" if k1.fits(r["shape"][1], r["shape"][1])
                            else "K1L") for r in records}
    out = []
    for kern, (name, src, repl) in meta.items():
        rs = [r for r in records
              if r["kernel"] == kern and on_path[r["stage"]] == kern]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": counts[kern],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": max(rs, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": sum(r["library_ms"] for r in rs),
            "stages": [r["stage"] for r in rs],
            "per": "one 1024-level batch (sum over stages)",
        })
    return {"kernels": out}


def main() -> int:

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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s wall "
          + " ".join(f"{k}={v:.2f}s" for k, v in secs.items()))
    for stem, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}: {line.strip()}")

    cfg = preset("gumbel_64")
    print("kernel parity and timing (gumbel_64 stages, bf16):")
    records = kernel_parity(cfg, device)
    print("main path: gumbel_64 export through the port's CLI")
    workdir = tempfile.mkdtemp(prefix="levelgan_torch_smoke_")
    try:
        counts = main_path(cfg, device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("profile: one export batch")
    profile_export(cfg, device)
    print(json.dumps(kernels_line(records, counts)))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
