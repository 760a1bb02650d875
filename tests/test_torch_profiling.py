"""The port's utils/profiling.py (torch.profiler, NVTX, anomaly mode)
beside the JAX package's (jax.profiler, debug_nans)."""
import glob
import os

import pytest
import torch

from humangaussian_torch.utils import profiling
from humangaussian_tpu.utils import profiling as jax_profiling


def test_step_timer_summary_has_the_jax_timers_shape():
    got, want = profiling.StepTimer(), jax_profiling.StepTimer()
    x = torch.ones(3)
    for _ in range(3):
        with got.time("render", sync=x):
            x = x * 2
        with want.time("render"):
            pass
    with got.time("adam", sync={"a": x, "b": [x]}):
        pass
    with want.time("adam"):
        pass
    g, w = got.summary(), want.summary()
    assert set(g) == set(w) == {"render", "adam"}
    for name in g:
        assert set(g[name]) == set(w[name]) == {"total_s", "mean_ms", "count"}
        assert g[name]["count"] == w[name]["count"]
        assert g[name]["total_s"] >= 0.0


def test_capture_trace_writes_a_tensorboard_trace_with_the_annotation(
        tmp_path):
    with profiling.capture_trace(str(tmp_path)) as prof:
        with profiling.trace_annotation("hg_render_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert "hg_render_span" in names
    traces = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json*"))
    assert traces, os.listdir(tmp_path)
    with open(traces[0]) as f:
        assert "hg_render_span" in f.read()


def test_enable_nan_checks_raises_on_a_nan_backward():
    try:
        profiling.enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError):
            (torch.sqrt(x) * 0.0 / x).sum().backward()
    finally:
        profiling.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
