"""Readings that limits are set from (not a benchmark run): for each seed,
the numbers a cell compares, from the program (a window of `seconds`, then
the check) or, with `control`, from the plain reference in the precision
below the configuration's put in the program's place, or with `fault`
the program with that fault planted (`faults.py`). One process for all
the seeds; one line a seed:

    python3 portbench/run.py --workload sd2_body --calibrate 1,2,3 \\
        --seconds 0 [--control | --fault half_batch]
"""
from __future__ import annotations

import gc
import json
import os
import sys

from portbench import harness


def calibrate(workload: str, seeds: list, seconds: float,
              control: bool, device: str = "cuda", bench=None, conf=None,
              traffic=None, out=sys.stdout, fault: str = "") -> int:
    import contextlib

    import torch

    from portbench.faults import planted

    bench = bench or harness.load_json(harness.ROOT, "BENCHMARK.json")
    w = {c["name"]: c for c in bench["workloads"]}[workload]
    conf = conf or harness.load_json(harness.HERE, "configs",
                                     f"{w['config']}.json")
    traffic = traffic or harness.load_json(harness.HERE, "workloads",
                                           f"{w['traffic']}.json")
    mod = harness.load_module(
        os.path.join(harness.HERE, "configs", f"{w['config']}.py"),
        f"portbench_config_{w['config']}")
    rows = []
    for seed in seeds:
        with planted(fault) if fault else contextlib.nullcontext():
            cell = mod.build(seed, device, conf, traffic, control=control)
            if not control:
                harness.run_window(cell, seconds)
        checks = cell.check()
        row = {"seed": seed, "control": control, "fault": fault,
               **{c.name: c.value for c in checks},
               **getattr(cell, "details", {})}
        print(json.dumps(row), file=out)
        out.flush()
        rows.append(row)
        del cell
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return 0
