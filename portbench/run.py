"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU.  The last
line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``compared`` last); the numbers compared with their limits are also the
last lines of standard error.  Without a CUDA device, or with a JAX
module loaded once the window has closed, it exits non-zero and prints no
result.
"""

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


PIN_CPUS = 4


def pin() -> None:
    """Keep the process, and the threads it starts, on the last
    ``PIN_CPUS`` cores it may use (all of them where it may use fewer
    than twice as many), so that the scheduler does not move the host's
    side of the timed path between cores from run to run."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= 2 * PIN_CPUS:
        os.sched_setaffinity(0, cores[-PIN_CPUS:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin()

    import torch
    from portbench import harness
    bench = harness.benchmark()
    chips = harness.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), device="cuda",
                            started=STARTED, bench=bench)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules of the JAX package or JAX loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
