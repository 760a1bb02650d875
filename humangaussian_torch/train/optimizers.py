"""parse_optimizer / parse_scheduler: config-driven optimizer assembly.

Port of humangaussian_tpu/train/optimizers.py (the reference's
systems/utils.py name -> optimizer class, interval "step"):

- `parse_optimizer(name, params, **args)` returns a torch optimizer for
  adam, adamw, sgd or adan with the JAX function's defaults and the
  reference configs' torch-convention args (lr, betas, eps, weight_decay,
  momentum, max_grad_norm). It takes `params` (an iterable of tensors or
  of parameter groups), because a torch optimizer owns its parameters;
  the JAX function returns a GradientTransformation that is handed them
  later.
- `parse_scheduler(name, lr, max_steps, **args)` returns a step -> lr
  callable whose values equal optax's constant, linear, exponential_decay
  (not staircase) and piecewise_constant schedules, which the JAX function
  builds, boundaries included: the arithmetic is optax's, in float32.
- `attach_scheduler(optimizer, schedule)` drives an optimizer's learning
  rate by such a callable through `torch.optim.lr_scheduler.LambdaLR`.

torch's Adam and AdamW place eps as optax does (outside the square root
of the bias-corrected second moment); they differ from optax in rounding
only, and AdamW applies its decoupled decay as a multiplication of the
parameter by 1 - lr wd before the Adam step, where optax adds -lr wd p to
the update.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from humangaussian_torch.train.adan import Adan


def parse_optimizer(name: str, params, **args) -> torch.optim.Optimizer:
    """name in {adam, adamw, sgd, adan}; args follow torch conventions
    (lr, betas, eps, weight_decay, momentum, max_grad_norm), as the
    reference configs do."""
    lr = args.pop("lr", 1e-3)
    betas = args.pop("betas", None)
    name = name.lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=lr,
                                betas=tuple(betas or (0.9, 0.999)),
                                eps=args.pop("eps", 1e-8))
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr,
                                 betas=tuple(betas or (0.9, 0.999)),
                                 eps=args.pop("eps", 1e-8),
                                 weight_decay=args.pop("weight_decay", 1e-2))
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr,
                               momentum=args.pop("momentum", 0.0))
    if name == "adan":
        return Adan(params, lr=lr, betas=tuple(betas or (0.98, 0.92, 0.99)),
                    eps=args.pop("eps", 1e-8),
                    weight_decay=args.pop("weight_decay", 0.0),
                    max_grad_norm=args.pop("max_grad_norm", 0.0))
    raise ValueError(f"unknown optimizer {name!r}")


_F32 = np.float32


def parse_scheduler(name: str, lr: float, max_steps: int, **args):
    """name in {constant, linear, exponential, multistep} -> a callable of
    the step returning the learning rate (a Python float; float32 values
    for every schedule but constant, as optax computes them)."""
    name = name.lower()
    if name == "constant":
        return lambda step: lr
    if name == "linear":
        end = args.get("end_lr", 0.0)

        def linear(step):
            count = _F32(min(max(int(step), 0), max_steps))
            frac = _F32(1) - count / _F32(max_steps)
            return float(_F32(lr - end) * frac + _F32(end))

        return linear
    if name == "exponential":
        log_gamma = math.log(float(_F32(args.get("gamma", 0.1))))

        def exponential(step):
            if int(step) <= 0:
                return float(_F32(lr))
            p = _F32(int(step)) / _F32(max_steps)
            # XLA's float32 power of the CPU rounds exp(p log gamma) taken
            # in double
            return float(_F32(lr) * _F32(math.exp(float(p) * log_gamma)))

        return exponential
    if name == "multistep":
        milestones = sorted(int(m) for m in
                            args.get("milestones", [max_steps // 2]))
        gamma = _F32(args.get("gamma", 0.5))

        def multistep(step):
            v = _F32(lr)
            for m in milestones:
                indicator = _F32(max(0.0, float(np.sign(m - int(step)))))
                v = v * indicator + (_F32(1) - indicator) * gamma * v
            return float(v)

        return multistep
    raise ValueError(f"unknown scheduler {name!r}")


def attach_scheduler(optimizer: torch.optim.Optimizer, schedule):
    """A LambdaLR that sets each group's learning rate to schedule(step)
    (its factor is schedule(step) over the group's initial lr)."""
    base = [g["lr"] for g in optimizer.param_groups]
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, [lambda step, b=b: schedule(step) / b for b in base])
