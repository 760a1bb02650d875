"""Where a benchmark cell's step or frame waits for the card, and what the
program's `hg.*` spans cost when a profiler runs.

    python3 scripts/sync_sites.py --workload sd2_body --units 10
    python3 scripts/sync_sites.py --workload anim_1024 --units 20 \\
        --overhead 4

builds the cell as `portbench/run.py` does (from `--seed`, set-up and
warm-up included) and profiles `--units` more units with
`torch.cuda.set_sync_debug_mode("warn")` on. Every synchronizing call the
mode reports leaves a marker span in the same trace, on the calling
thread, and its call site (the innermost frames of the program) is kept.
It prints one JSON line: the reports a unit, the `hg.read.*` spans a unit,
the reports that fell inside no `hg.read.*` span of their thread (with
their sites), the `hg.read.*` spans that hold no report, every site with
its count, and each `hg.*` span's count and host ms a unit.

`--overhead K` then runs K traced windows of `--units` units with the
program's spans on and K with them off (each module's `trace_annotation`
replaced by the no-op), in turns (on, off, off, on, ...), and prints the
wall ms a unit of each window: the cost of the spans while tracing is on.

`--densify` (`sd2_body`) surveys one more step, at the next step that
runs a density-control pass.

`--tiny` runs the cells at the CPU tests' widths (`portbench/tests/tiny.py`)
on the CPU, where no synchronizing call is reported.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import tempfile
import threading
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MARK = "sync_debug.report"
PROGRAM = os.path.join(ROOT, "humangaussian_torch") + os.sep


def build_cell(workload: str, seed: int, device: str, tiny: bool):
    from portbench import harness

    if tiny:
        from portbench.tests import tiny as tiny_cells

        conf, traffic = tiny_cells.TINY[workload]()
        bench = tiny_cells.BENCH
    else:
        bench = harness.load_json(ROOT, "BENCHMARK.json")
        conf = traffic = None
    w = {x["name"]: x for x in bench["workloads"]}[workload]
    conf = conf or harness.load_json(harness.HERE, "configs",
                                     f"{w['config']}.json")
    traffic = traffic or harness.load_json(harness.HERE, "workloads",
                                           f"{w['traffic']}.json")
    mod = harness.load_module(
        os.path.join(harness.HERE, "configs", f"{w['config']}.py"),
        f"portbench_config_{w['config']}")
    return mod.build(seed, device, conf, traffic)


def site(stack) -> str:
    """The innermost three frames of the program in a stack (of any code,
    marked "outside the program:", where none is the program's)."""
    own = [f for f in stack if f.filename.startswith(PROGRAM)]
    frames = " < ".join(f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} "
                        f"{f.name}" for f in reversed((own or stack)[-3:]))
    return frames if own else "outside the program: " + frames


def chrome_events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data.get("traceEvents", data) if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []))


def survey(cell, units: int, cuda: bool) -> dict:
    """Sync reports and `hg.*` spans over `units` profiled units."""
    import torch

    sites = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        with torch.profiler.record_function(MARK):
            pass
        sites.append((threading.current_thread().name,
                      site(traceback.extract_stack()[:-1])))

    cell.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        with profiler(cuda) as prof:
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(units):
                    cell.run_unit()
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode("default")
            cell.synchronize()
    events = chrome_events(prof)
    reads = [e for e in events if e["name"].startswith("hg.read.")]
    marks = [e for e in events if e["name"] == MARK]

    def inside(m, r):
        return (m["tid"] == r["tid"] and r["ts"] <= m["ts"]
                and m["ts"] + m.get("dur", 0) <= r["ts"] + r.get("dur", 0))

    outside = [i for i, m in enumerate(marks)
               if not any(inside(m, r) for r in reads)]
    empty = [r["name"] for r in reads
             if not any(inside(m, r) for m in marks)]
    by_site, spans = {}, {}
    for _, s in sites:
        by_site[s] = by_site.get(s, 0) + 1
    for e in events:
        if e["name"].startswith("hg."):
            n, ms = spans.get(e["name"], (0, 0.0))
            spans[e["name"]] = (n + 1, ms + e.get("dur", 0) / 1e3)
    return {
        "units": units,
        "reports_a_unit": len(marks) / units,
        "hg_read_spans_a_unit": len(reads) / units,
        "reports_outside_reads": [sites[i] for i in outside
                                  if i < len(sites)],
        "reads_without_report": empty,
        "threads": sorted({t for t, _ in sites}),
        "sites": by_site,
        "spans_a_unit": {k: [n / units, ms / units]
                         for k, (n, ms) in sorted(spans.items())},
    }


@contextlib.contextmanager
def spans_off():
    """Every module's `trace_annotation` replaced by the no-op."""
    from humangaussian_torch.utils import profiling

    on, off = profiling.trace_annotation, contextlib.nullcontext()
    patched = [m for name, m in list(sys.modules.items())
               if name.startswith("humangaussian_torch") and m is not None
               and getattr(m, "trace_annotation", None) is on]
    for m in patched:
        m.trace_annotation = lambda name: off
    try:
        yield len(patched)
    finally:
        for m in patched:
            m.trace_annotation = on


def traced_ms(cell, units: int, cuda: bool) -> float:
    """Wall ms a unit of a profiled window (as portbench's traced one)."""
    cell.synchronize()
    with profiler(cuda):
        t0 = time.perf_counter()
        for _ in range(units):
            cell.run_unit()
        cell.synchronize()
        wall = time.perf_counter() - t0
    return wall / units * 1e3


def overhead(cell, units: int, rounds: int, cuda: bool) -> dict:
    on, off = [], []
    for i in range(2 * rounds):
        if (i % 4) in (0, 3):
            on.append(traced_ms(cell, units, cuda))
        else:
            with spans_off():
                off.append(traced_ms(cell, units, cuda))
    return {"ms_a_unit_spans_on": on, "ms_a_unit_spans_off": off,
            "median_on": statistics.median(on),
            "median_off": statistics.median(off)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=2147483659)
    p.add_argument("--units", type=int, default=10)
    p.add_argument("--overhead", type=int, default=0)
    p.add_argument("--densify", action="store_true",
                   help="sd2_body: survey one more step, a density-control "
                   "pass")
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)
    import torch

    cuda = not args.tiny
    if cuda and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = build_cell(args.workload, args.seed,
                      "cuda" if cuda else "cpu", args.tiny)
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name() if cuda else "cpu"}
    out["survey"] = survey(cell, args.units, cuda)
    if args.densify:
        system, state = cell.system, cell.state
        step = -(-(state.step + 1) // system.cfg.densify_prune_interval) \
            * system.cfg.densify_prune_interval
        step = max(step, system.cfg.densify_prune_interval
                   * (system.cfg.densify_prune_start_step
                      // system.cfg.densify_prune_interval + 1))
        cell.state = state._replace(step=step - 1)
        assert system.should_densify(step), step
        out["densify_step"] = survey(cell, 1, cuda)
    if args.overhead:
        out["overhead"] = overhead(cell, args.units, args.overhead, cuda)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
