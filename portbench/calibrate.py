"""Readings that the limits in ``limits/<cell>.json`` are set from.

    python3 portbench/calibrate.py --workload <name> --program-seeds 12 \
        --control-seeds 3 --faults half_batch --fault-seeds 3 \
        --out <readings>.jsonl

runs, in one process on the card, the cell's sound program on a dozen
seeds, the control (the reference computed in fp8 in the program's place)
and each planted fault (``faults.py``) on a few, each as a run with a
short window that completes at least as many requests (steps) as a run
compares, and prints one JSON line a run: its mode, seed and the numbers
compared.  The benchmark's own runs never run it.
"""

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--base-seed", type=int, default=3_000_000_000)
    ap.add_argument("--program-seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from portbench import faults, harness
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    lim = harness.limits_file(args.workload)
    extra = {"min_requests": lim.get("check_batches", 1), "min_steps": 1}
    runs = [("program", None, i) for i in range(args.program_seeds)]
    runs += [("control", None, 100 + i) for i in range(args.control_seeds)]
    runs += [(f"fault:{f}", f, 200 + 10 * k + i)
             for k, f in enumerate(args.faults)
             for i in range(args.fault_seeds)]
    sink = open(args.out, "a") if args.out else None
    for mode, fault, i in runs:
        seed = args.base_seed + i
        t = time.monotonic()
        details = {}
        if fault:
            with faults.FAULTS[fault]():
                line = harness.run_cell(args.workload, seed, args.seconds,
                                        False, traffic_extra=extra,
                                        details_sink=details)
        else:
            line = harness.run_cell(args.workload, seed, args.seconds, False,
                                    traffic_extra=extra,
                                    control=mode == "control",
                                    details_sink=details)
        row = {"workload": args.workload, "mode": mode, "seed": seed,
               "correct": line["correct"], "attempted": line["attempted"],
               "failed": line["failed"],
               "compared": {k: v["value"] for k, v in line["compared"].items()},
               "metrics": {k: v["value"] for k, v in line["metrics"].items()},
               "run_s": time.monotonic() - t, "details": details}
        print(json.dumps(row), flush=True)
        if sink:
            sink.write(json.dumps(row) + "\n")
            sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
