"""The port's benchmark: one run of one cell on the card it is started on.

    python3 portbench/run.py --workload sd2_body --seed 7 --seconds 30 \\
        --trace 0

prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device` and `checks` (each number
compared with the plain reference, beside its limit; also the last lines
of standard error). `--trace 1` adds `breakdown` and the device's busy and
window seconds. Without as many CUDA devices as the cell asks for, it
prints no result and exits with 3.

The process keeps to two fixed cores (the third and fourth it may use)
and one OpenMP thread: the host path of both cells is one Python thread
and the CUDA driver's, and a pinned run spreads about half as much from
run to run as one the scheduler moves (PERF.md §2).

`--calibrate SEED,SEED,...` (not a benchmark run) builds the cell once a
seed in one process, runs a window of `--seconds` and prints the compared
numbers of each seed; with `--control` the plain reference in the
precision below the configuration's takes the program's place, and with
`--fault NAME` the program runs with that fault planted (faults.py).
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--calibrate", default="")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default="")
    return p.parse_args(argv)


def pin_host() -> None:
    """Two fixed cores and one OpenMP thread, before torch is imported."""
    os.environ["OMP_NUM_THREADS"] = "1"
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= 4:
        os.sched_setaffinity(0, cores[2:4])


def main(argv=None) -> int:
    args = parse(argv)
    pin_host()
    if args.calibrate:
        from portbench.calibrate import calibrate

        seeds = [int(s) for s in args.calibrate.split(",") if s]
        return calibrate(args.workload, seeds, args.seconds, args.control,
                         fault=args.fault)
    return harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
