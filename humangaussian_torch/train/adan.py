"""Adan optimizer (Xie et al. 2022) as a `torch.optim.Optimizer`.

Port of humangaussian_tpu/train/adan.py, itself the reference's vendored
Adan (`_single_tensor_adan`): three EMAs (the gradient m_t, the gradient
difference diff_t and the squared lookahead n_t), bias corrections,
optional global grad-norm clipping and decoupled or proximal weight decay,
with the JAX transformation's arithmetic order. One difference of form:
the JAX transformation returns the delta new - param for optax to add, so
its parameter is param + (new - param); this class writes `new` itself,
which may differ from it in the last float32 bit.

The clipping norm is taken over every parameter of every group, as
optax.global_norm is over the whole tree.
"""
from __future__ import annotations

import torch


class Adan(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3,
                 betas=(0.98, 0.92, 0.99), eps: float = 1e-8,
                 weight_decay: float = 0.0, max_grad_norm: float = 0.0,
                 no_prox: bool = False):
        if lr < 0.0 or eps < 0.0 or weight_decay < 0.0 \
                or max_grad_norm < 0.0:
            raise ValueError("lr, eps, weight_decay and max_grad_norm must "
                             "be non-negative")
        if len(betas) != 3 or not all(0.0 <= b < 1.0 for b in betas):
            raise ValueError(f"betas must be three values in [0, 1): "
                             f"{betas}")
        super().__init__(params, dict(
            lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
            max_grad_norm=max_grad_norm, no_prox=no_prox))

    def _clip_scale(self):
        """min(max_grad_norm / (|g| + eps), 1) over every gradient (the
        first group's max_grad_norm and eps), or None without clipping."""
        g0 = self.param_groups[0]
        if g0["max_grad_norm"] <= 0.0:
            return None
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        if not grads:
            return None
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(x) for x in grads]))
        return torch.clamp(g0["max_grad_norm"] / (norm + g0["eps"]),
                           max=1.0)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        scale = self._clip_scale()
        for group in self.param_groups:
            b1, b2, b3 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad if scale is None else p.grad * scale
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                    state["exp_avg_diff"] = torch.zeros_like(p)
                    state["neg_pre_grad"] = -g  # the first step's diff is 0
                state["step"] += 1
                t = state["step"]
                diff = state["neg_pre_grad"] + g  # g_t - g_{t-1}
                m = state["exp_avg"].mul_(b1).add_((1 - b1) * g)
                d = state["exp_avg_diff"].mul_(b2).add_((1 - b2) * diff)
                look = g + b2 * diff
                n = state["exp_avg_sq"].mul_(b3).add_(
                    (1 - b3) * look * look)
                bc1 = 1.0 - b1 ** t
                bc2 = 1.0 - b2 ** t
                bc3_sqrt = (1.0 - b3 ** t) ** 0.5
                denom = torch.sqrt(n) / bc3_sqrt + eps
                upd = (lr / bc1 * m + lr * b2 / bc2 * d) / denom
                if group["no_prox"]:
                    p.copy_(p * (1 - lr * wd) - upd)
                else:
                    p.copy_((p - upd) / (1 + lr * wd))
                state["neg_pre_grad"] = -g
        return loss
