"""Time-varying scalar schedules: the C() convention of the configs.

Port of humangaussian_tpu/utils/schedules.py. C(value, step): a scalar
passes through; a 4-list [start_step, start_value, end_value, end_step]
interpolates linearly from start_value to end_value as step goes from
start_step to end_step, clamped outside. Used for grad_clip, the min / max
timestep percents and loss weights. The step is a host integer here (the
port runs eagerly), so the result is a Python float.
"""
from __future__ import annotations


def C_schedule(value, step) -> float:
    """Evaluate a C()-style scalar at `step`."""
    if isinstance(value, (int, float)):
        return float(value)
    if len(value) != 4:
        raise ValueError(f"C schedule needs 4 entries, got {value!r}")
    start_step, start_value, end_value, end_step = value
    t = (float(step) - start_step) / max(end_step - start_step, 1e-8)
    t = min(max(t, 0.0), 1.0)
    return start_value + (end_value - start_value) * t
