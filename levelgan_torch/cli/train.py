"""Train CLI: ``python -m levelgan_torch.cli.train``.

Port of ``levelgan/cli/train.py``: a preset or a config file, dotted
``--set key=value`` overrides, ``--out`` for ``io.out_dir``, ``--resume``
for ``io.resume`` ('auto' or a checkpoint path); runs
``levelgan_torch.api.train`` on the GPU (``--device cpu`` for the plain
CPU path).  SIGTERM or SIGINT stops the run after the step in flight with
a checkpoint, and the CLI exits 0 (``--resume auto`` continues it).
Data parallelism is ``--set dist.dp=N`` (one process a card); over hosts,
each host runs the CLI with ``dist.coordinator_address``,
``dist.num_processes`` and its ``dist.process_id``; the host of rank 0
prints the summary.
``--print-config`` prints the resolved config and exits.
"""

from __future__ import annotations

import argparse

from levelgan_torch.api import train
from levelgan_torch.config import PRESET_NAMES, load_config


def parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"--set expects key=value, got '{p}'")
        k, v = p.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="levelgan-torch-train",
        description="Train a level or track GAN (PyTorch port).")
    ap.add_argument("--preset", choices=PRESET_NAMES, default=None,
                    help="named config preset")
    ap.add_argument("--config", default=None, help="YAML/JSON config file")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="dotted config override, e.g. --set train.steps=500")
    ap.add_argument("--out", default=None, help="shortcut for io.out_dir")
    ap.add_argument("--resume", default=None,
                    help="'auto' (newest readable checkpoint in "
                         "<out>/ckpt) or a checkpoint path; shortcut for "
                         "io.resume")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    ap.add_argument("--print-config", action="store_true",
                    help="print the fully-resolved config as JSON and exit")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    overrides = parse_overrides(args.set)
    if args.out is not None:
        overrides["io.out_dir"] = args.out
    if args.resume is not None:
        overrides["io.resume"] = args.resume
    cfg = load_config(args.config, args.preset or
                      (None if args.config else "toy_dcgan_16"), overrides)
    if args.print_config:
        print(cfg.to_json())
        return 0
    result = train(cfg, device=args.device)
    if result["rank"]:      # another host's ranks: rank 0's host prints
        return 0
    print(f"[levelgan_torch] {'preempted' if result['preempted'] else 'done'}"
          f": checkpoint={result['checkpoint']} kl={result['kl']:.5f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
