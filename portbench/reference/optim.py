"""Frozen plain copy of `humangaussian_torch/train/optim.py` for the benchmark's
reference (imports rewritten; kernel calls replaced by plain torch in
`portbench/reference/common.py`). Original docstring:

Per-group Adam for the Gaussian scene, with upstream's LR schedule.

Port of humangaussian_tpu/train/optim.py: six parameter groups with fixed
learning rates (scaled by `spatial_lr_scale` for positions) except the
means, whose rate follows the log-linear decay of `expon_lr`. Adam's eps
is 1e-15 and sits outside the square root of the bias-corrected second
moment.

Written by hand rather than with `torch.optim.Adam`: densification zeroes
the moment slots of reallocated Gaussians (`densify.zero_moments_at`) and
all groups share one global step count, so that a freshly allocated
Gaussian inherits the global bias correction, as upstream's does. The
JAX module is functional; here `adam_step` updates parameters and moments
in place under `torch.no_grad()`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GaussianOptimConfig:
    """Upstream's OptimizationParams defaults."""

    position_lr_init: float = 0.00005
    position_lr_final: float = 0.000025
    position_lr_delay_mult: float = 0.5
    position_lr_delay_steps: int = 0
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0125
    opacity_lr: float = 0.01
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    spatial_lr_scale: float = 4.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-15

    def group_lrs(self, step: int) -> dict:
        """Current per-group learning rates (the means' depends on `step`)."""
        return {
            "means": expon_lr(
                step,
                self.position_lr_init * self.spatial_lr_scale,
                self.position_lr_final * self.spatial_lr_scale,
                self.position_lr_delay_steps,
                self.position_lr_delay_mult,
                self.position_lr_max_steps,
            ),
            "sh_dc": self.feature_lr,
            "sh_rest": self.feature_lr / 20.0,
            "opacity_logits": self.opacity_lr,
            "log_scales": self.scaling_lr,
            "quats": self.rotation_lr,
        }


def expon_lr(step: int, lr_init, lr_final, delay_steps=0, delay_mult=1.0,
             max_steps=1_000_000) -> float:
    """Log-linear LR decay with an optional sine warm-up delay. `step` is
    a host integer; the arithmetic is float32 (CPU tensors), as the JAX
    function's is: in float64 the schedule drifts from it by 1e-6
    relative, in float32 the two agree to the last bit of exp and log."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32)

    step_f = f32(step)
    if delay_steps > 0:
        delay_rate = delay_mult + (1.0 - delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step_f / delay_steps, 0.0, 1.0))
    else:
        delay_rate = 1.0
    t = torch.clamp(step_f / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(torch.log(f32(lr_init)) * (1.0 - t)
                         + torch.log(f32(lr_final)) * t)
    return float(delay_rate * log_lerp * (step >= 0))


class AdamState(NamedTuple):
    mu: dict  # first moments, same keys and shapes as the params
    nu: dict  # second moments
    count: int  # global step count, shared by every group


def adam_init(params: dict) -> AdamState:
    return AdamState(
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        count=0,
    )


@torch.no_grad()
def adam_step(
    params: dict,
    grads: dict,
    state: AdamState,
    lrs: dict,
    cfg: GaussianOptimConfig = GaussianOptimConfig(),
):
    """One Adam update with per-group learning rates, IN PLACE on `params`
    and on the moments of `state`. Returns (params, state) with the count
    advanced."""
    count = state.count + 1
    b1, b2 = cfg.beta1, cfg.beta2
    f32 = np.float32
    c1 = float(f32(1.0) - f32(b1) ** f32(count))
    c2 = float(f32(1.0) - f32(b2) ** f32(count))
    keys = list(params)
    ps = [params[k] for k in keys]
    gs = [grads[k] for k in keys]
    mus = [state.mu[k] for k in keys]
    nus = [state.nu[k] for k in keys]
    torch._foreach_mul_(mus, b1)
    torch._foreach_add_(mus, gs, alpha=1 - b1)
    torch._foreach_mul_(nus, b2)
    torch._foreach_addcmul_(nus, gs, gs, value=1 - b2)
    # p -= lr * (mu / c1) / (sqrt(nu / c2) + eps)
    denom = torch._foreach_div(nus, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    num = torch._foreach_div(mus, c1)
    torch._foreach_mul_(num, [float(lrs[k]) for k in keys])
    torch._foreach_addcdiv_(ps, num, denom, value=-1.0)
    return params, AdamState(mu=state.mu, nu=state.nu, count=count)
