"""The port's utils/profiling.py (torch.profiler traces, anomaly mode);
its `hg.*` spans in the step and the frame are in test_torch_tracing.py."""
import glob
import os

import pytest
import torch

from humangaussian_torch.utils import profiling


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
