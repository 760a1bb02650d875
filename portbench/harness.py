"""One run of one cell: set-up, the measured window, the traced window,
the metrics, the comparison with the plain reference, the result line.

Everything that belongs to one configuration, traffic mix, metric or count
is a file found by its name in BENCHMARK.json:

- configuration `<c>`: `configs/<c>.json` (the sizes, as run) and
  `configs/<c>.py`, whose `build(seed, device, conf, traffic)` returns the
  cell object (see `Cell` below);
- traffic mix `<t>`: `workloads/<t>.json`;
- metric `<m>` (end-to-end or per layer): `metrics/<m>.py`, whose
  `read(ctx)` returns the number, or None when it finds nothing to read;
- count `<n>`: `counts/<n>.py`, loaded by a metric through `ctx.counts`.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "humangaussian_tpu")


class Cell:
    """What a configuration's `build` returns (the methods the harness
    calls; the configurations' cells implement them).

    - `unit`: "step" or "frame";
    - `run_unit()`: one unit of the window's work; returns its latency in
      seconds (request to result on the host) or None;
    - `begin_window()` / `end_window()`: around the measured window,
      `begin_traced()` / `end_traced()` around the traced one;
    - `synchronize()`: waits for the device;
    - `spans()`: a context manager that puts the layer spans on the
      program's instance attributes while a traced window runs;
    - `raster_inputs()`: the scenes and cameras the traced window rendered;
    - `check()`: after the window, frees the program and returns the
      comparison with the plain reference, a list of `checks.Check`, and
      sets `failed`, the compared answers that missed a limit;
    - `launch_note()`: a line of the program's own counters.
    """


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def counts(name: str):
    return load_module(os.path.join(HERE, "counts", f"{name}.py"),
                       f"portbench_counts_{name}")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def process_age_s() -> float:
    """Seconds since this process started (Linux `/proc`), else since the
    harness was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_window(cell, seconds: float):
    """Closed loop for `seconds`, each unit started when the last one has
    returned: (units, wall seconds, latencies)."""
    sync = cell.synchronize
    sync()
    lat = []
    units = 0
    cell.begin_window()
    t0 = time.perf_counter()
    while True:
        x = cell.run_unit()
        units += 1
        if x is not None:
            lat.append(x)
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    wall = time.perf_counter() - t0
    cell.end_window()
    return units, wall, lat


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench: dict | None = None,
             conf: dict | None = None, traffic: dict | None = None,
             out=sys.stdout, err=sys.stderr) -> int:
    """One run; prints the result line on `out`. Returns the exit code."""
    import torch

    bench = bench or load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        print(f"unknown workload {workload!r}", file=err)
        return 2
    w = cells[workload]
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < w["chips"]):
        print(f"{workload} needs {w['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=err)
        return 3
    conf = conf or load_json(HERE, "configs", f"{w['config']}.json")
    traffic = traffic or load_json(HERE, "workloads", f"{w['traffic']}.json")
    mod = load_module(os.path.join(HERE, "configs", f"{w['config']}.py"),
                      f"portbench_config_{w['config']}")
    cell = mod.build(seed, device, conf, traffic)
    setup_s = process_age_s()

    on_cuda = device == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    n_units, wall, lat = run_window(cell, seconds)
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    ctx = types.SimpleNamespace(
        conf=conf, traffic=traffic, cell=cell, workload=workload,
        seconds=seconds, units=n_units, wall_s=wall, latencies_s=lat,
        setup_s=setup_s, peak_bytes=peak, unit_s=wall / max(n_units, 1),
        trace=None, traced_units=0, counts=counts)
    if trace:
        from portbench.trace import profiled

        res = {}
        cell.begin_traced()
        with cell.spans(), profiled(res):
            for _ in range(traffic["traced_units"]):
                cell.run_unit()
        cell.end_traced()
        ctx.trace = res["trace"]
        ctx.traced_units = traffic["traced_units"]

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if not applies(m, workload):
            continue
        reader = load_module(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                             f"portbench_metric_{m['name']}")
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}", file=err)
        return 4
    print(cell.launch_note(), file=err)
    print(f"card {power_limit() if on_cuda else device}; setup_s "
          f"{setup_s!r}; {n_units} {cell.unit}s in {wall!r} s", file=err)

    checks = cell.check()
    failed = cell.failed
    del cell, ctx
    gc.collect()
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}", file=err)
        return 4
    from portbench.checks import report

    correct = all(c.ok for c in checks)
    device_info = {
        "platform": "gpu" if on_cuda else "cpu",
        "kind": torch.cuda.get_device_name() if on_cuda else device,
        "count": w["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": n_units,
              "failed": failed, "metrics": metrics,
              "device": device_info}
    if trace:
        tr = res["trace"]
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {c.name: {"value": c.value if math.isfinite(c.value)
                                 else str(c.value), "limit": c.limit}
                        for c in checks}
    report(checks, err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
