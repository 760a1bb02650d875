"""The device trace of a traced window: `torch.profiler` over the window,
its Chrome trace read back into spans, device operations and their
launches.

A span is a `record_function` range the benchmark puts around a call into
one layer of the program. A span's device time is the sum of the device
operations (kernels, copies, fills) whose launch on the host falls inside
the span, whatever thread launched them: autograd's backward launches
from its own thread inside the span of the call that asked for it.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

WINDOW_SPAN = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    """Spans by name and device operations of one profiled window."""

    def __init__(self, events: list):
        launches = {}
        self.spans = {}  # name -> [(start_us, end_us)]
        self.cpu_ops = []  # (start_us, end_us, name)
        dev = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat == "user_annotation":
                self.spans.setdefault(e["name"], []).append((ts, ts + dur))
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = ts
            elif cat in DEVICE_CATS:
                dev.append(e)
            elif cat == "cpu_op":
                self.cpu_ops.append((ts, ts + dur, e["name"]))
        # (start_us, end_us, name, launch_us)
        self.ops = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e["name"], launches.get(e.get("args", {}).get("correlation"),
                                     float(e["ts"])))
            for e in dev)
        win = self.spans.get(WINDOW_SPAN, [])
        self.window = (win[0] if win else
                       (self.ops[0][0], self.ops[-1][1]) if self.ops
                       else (0.0, 0.0))

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran (the
        union of their intervals)."""
        lo, hi = self.window
        busy, end = 0.0, lo
        for s, e, _, _ in self.ops:
            s, e = max(s, end), min(e, hi)
            if e > s:
                busy += e - s
                end = e
        return busy / 1e6

    def span_device_s(self, name: str, match=None) -> float:
        """Device seconds of the operations launched inside span `name`
        (those whose name contains `match`, if given)."""
        ivs = sorted(self.spans.get(name, []))
        starts = [s for s, _ in ivs]
        total = 0.0
        for s, e, op, launch in self.ops:
            if match is not None and match not in op:
                continue
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch <= ivs[i][1]:
                total += e - s
        return total / 1e6

    def op_device_s(self, match: str) -> float:
        """Device seconds of every operation whose name contains `match`."""
        return sum(e - s for s, e, op, _ in self.ops if match in op) / 1e6

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for s, e, op, _ in self.ops:
            by[op] = by.get(op, 0.0) + (e - s) / 1e6
        return sorted(([k[:160], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10, longest: int = 400) -> list:
        """The `longest` idle gaps of the window, their seconds summed by
        what the host was doing when each began: the innermost benchmark
        span and the innermost host operation then running."""
        import numpy as np

        lo, hi = self.window
        gaps, end = [], lo
        for s, e, _, _ in self.ops:
            if s > end:
                gaps.append((min(s, hi) - end, end))
            end = max(end, e)
        if hi > end:
            gaps.append((hi - end, end))
        gaps = sorted((g for g in gaps if g[0] > 0), reverse=True)[:longest]

        def innermost(ivs, t):
            if not ivs:
                return None
            s = np.array([iv[0] for iv in ivs])
            e = np.array([iv[1] for iv in ivs])
            inside = np.flatnonzero((s <= t) & (e > t))
            if inside.size == 0:
                return None
            return ivs[inside[np.argmin((e - s)[inside])]][2]

        spans = [(s, e, name) for name, ivs in self.spans.items()
                 if name != WINDOW_SPAN for s, e in ivs]
        by = {}
        for dur, g0 in gaps:
            label = ((innermost(spans, g0) or "outside spans") + " / "
                     + (innermost(self.cpu_ops, g0) or "python"))
            by[label] = by.get(label, 0.0) + dur / 1e6
        return sorted(([k[:160], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


@contextlib.contextmanager
def profiled(result: dict):
    """Profile the block's host and device activity; on exit puts the
    block's `Trace` in result["trace"]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            yield
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    result["trace"] = Trace(data.get("traceEvents", data)
                            if isinstance(data, dict) else data)


def wrap(obj, attr: str, span: str, on_call=None, on_result=None):
    """Put a `record_function(span)` around the instance attribute
    `obj.attr` (a bound method); `on_call(args, kwargs)` is called before
    it, `on_result(result)` after. Returns a function that takes the
    wrapper off."""
    import torch

    fn = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        if on_call is not None:
            on_call(args, kwargs)
        with torch.profiler.record_function(span):
            out = fn(*args, **kwargs)
        if on_result is not None:
            on_result(out)
        return out

    setattr(obj, attr, wrapped)
    return lambda: delattr(obj, attr) if attr in vars(obj) else None


class CallSpan:
    """A callable object behind a `record_function(span)`, with every other
    attribute passed through: for an object the program calls."""

    def __init__(self, target, span: str):
        self._target = target
        self._span = span

    def __getattr__(self, name):
        return getattr(self._target, name)

    def __call__(self, *args, **kwargs):
        import torch

        with torch.profiler.record_function(self._span):
            return self._target(*args, **kwargs)
