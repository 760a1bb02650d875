"""Tracing, profiling and numerics-debug helpers.

Port of humangaussian_tpu/utils/profiling.py on torch's tools:

- `trace_annotation(name)`: a `torch.profiler.record_function` range while
  a torch profiler runs, else a shared no-op context (one flag read, well
  under a microsecond). The program's `hg.*` spans are made by it, at each
  layer boundary of the step and of the animated frame:

  - `hg.step`: one pass of `train/loop.py::run_training`'s loop;
    `hg.frame`: `apps/animate.py::render_motion_frame`;
  - under them, spans that never nest in each other on the calling thread:
    `hg.inputs` (`sample_step_inputs`), `hg.render` (every tiled render,
    with `hg.render.project`, `hg.render.bin` and `hg.render.composite`
    inside), `hg.guidance` (with `hg.guidance.encode`, the resizes and the
    VAE encodes, and `hg.guidance.unet`, the UNet passes and the ANPG
    gradient, with `hg.guidance.unet.xformer` around each of the UNet's
    transformer stacks), `hg.backward` (`torch.autograd.grad`, with
    `hg.render.composite_bwd`, K2 + K2b, and the encodes' recompute inside
    it in time, on autograd's thread on the card), `hg.optim`
    (`apply_grads`), `hg.densify` (a density-control pass) and
    `hg.repose` (`AvatarAnimator.frame_scene`);
  - `hg.read.<site>` around each call of those paths that makes the host
    wait for the card's stream: the reads to the host (binning's `nonzero`
    once a camera, `linalg.inv`'s error check, the loop's metrics and
    density-control counts, density control's masks, the frame's copy)
    and the copies of host values to the card from pageable memory (the
    cameras' constants, the pose images' tables, the UNet's time ids,
    LBS's constant row, the frame's camera and pose), which wait the same
    way. A layer's count of such spans is its number of host syncs, their
    duration the host's wait; `scripts/sync_sites.py` holds them to what
    `torch.cuda.set_sync_debug_mode` reports on the card.

  They land in the same trace as the device's operations, on one clock.
- `capture_trace(log_dir)`: a `torch.profiler.profile` of the CPU and, on
  the card, CUDA activity, written as a TensorBoard trace
  (`tensorboard_trace_handler`) into `log_dir`, where the JAX package
  writes an XPlane trace; the `hg.*` spans of the block show in it;
- `enable_nan_checks(enable)`: `torch.autograd.set_detect_anomaly`, the
  reference's --detect_anomaly, for the JAX package's `jax_debug_nans`.
"""
from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler

_OFF = contextlib.nullcontext()


def trace_annotation(name: str):
    """Named range in the profiler timeline (host, and the device
    operations launched inside it) while a torch profiler runs; a shared
    no-op context otherwise."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Profile everything inside the context, the `hg.*` spans included;
    `tensorboard --logdir <log_dir>` (with the torch-tb-profiler plugin)
    renders the timeline. Yields the profiler."""
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
