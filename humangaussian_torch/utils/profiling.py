"""Tracing, profiling and numerics-debug helpers.

Port of humangaussian_tpu/utils/profiling.py on torch's tools:

- `trace_annotation(name)`: a `torch.profiler.record_function` range (it
  shows in a `torch.profiler` trace, host and device), plus an NVTX range
  when the card is present (Nsight's timeline);
- `capture_trace(log_dir)`: a `torch.profiler.profile` of the CPU and, on
  the card, CUDA activity, written as a TensorBoard trace
  (`tensorboard_trace_handler`) into `log_dir`, where the JAX package
  writes an XPlane trace;
- `enable_nan_checks(enable)`: `torch.autograd.set_detect_anomaly`, the
  reference's --detect_anomaly, for the JAX package's `jax_debug_nans`;
- `StepTimer`: per-phase host wall-clock totals; `time(name, sync=t)`
  waits for the device of tensor `t` (`torch.cuda.synchronize` on the
  card) before it stops the clock, as the JAX timer blocks on its array.
"""
from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace_annotation(name: str):
    """Named region in the profiler timeline (host and device)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Profile everything inside the context; `tensorboard --logdir
    <log_dir>` (with the torch-tb-profiler plugin) renders the timeline.
    Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def enable_nan_checks(enable: bool = True):
    """Fail fast on NaNs produced in a backward (autograd's anomaly
    mode)."""
    torch.autograd.set_detect_anomaly(enable)


def _synchronize(tensor) -> None:
    if isinstance(tensor, torch.Tensor) and tensor.device.type == "cuda":
        torch.cuda.synchronize(tensor.device)


class StepTimer:
    """Rolling wall-clock stats for the host loop (per-phase totals)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, name: str, sync=None):
        """Time the body; `sync` (a tensor, or a list or dict of them) is
        waited for before the clock stops."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            items = (sync.values() if isinstance(sync, dict)
                     else sync if isinstance(sync, (list, tuple))
                     else [sync])
            for t in items:
                _synchronize(t)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "mean_ms": round(
                    1e3 * self.totals[name] / max(self.counts[name], 1), 3
                ),
                "count": self.counts[name],
            }
            for name in self.totals
        }
