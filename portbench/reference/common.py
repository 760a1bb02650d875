"""Plain stand-ins for what the copied modules took from the program: the
device check, the skeleton's line table, GroupNorm and self-attention.

Everything computes in float32 (or the dtype it is given), with no kernel
and no cache. `set_precision` turns on the control: every convolution and
linear layer of a module rounds its weight and its input to float8 (e4m3,
one scale a tensor, as a float8 matrix product takes them) before it
multiplies in float32, the precision below the prior's bfloat16.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

OPENPOSE18_LINES = np.array(
    [[0, 1], [1, 2], [2, 3], [3, 4], [1, 5], [5, 6], [6, 7], [1, 8],
     [8, 9], [9, 10], [1, 11], [11, 12], [12, 13], [0, 14], [14, 16],
     [0, 15], [15, 17]],
    dtype=np.int32,
)

FP8_MAX = 448.0  # largest finite float8 e4m3 value


def resolve_device(device) -> torch.device:
    return torch.device(device)


class GroupNormAct(nn.Module):
    """`nn.GroupNorm` (+ SiLU) in float32 on a channels-first activation;
    parameters `weight` and `bias`, as the program's module names them."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 silu: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.silu = silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(),
                         self.bias.float(), self.eps)
        return (F.silu(y) if self.silu else y).to(x.dtype)


def self_attention(q, k, v, sm_scale: float | None = None):
    """softmax(q k^T s) v in float32, one batch entry at a time:
    q [B, S, H, D], k and v [B, M, H, D] -> [B, S, H, D]."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    outs = []
    for qb, kb, vb in zip(q, k, v):
        logits = torch.einsum("nhd,mhd->hnm", qb.float(), kb.float())
        p = torch.softmax(logits * sm_scale, dim=-1)
        outs.append(torch.einsum("hnm,mhd->nhd", p, vb.float()).to(q.dtype))
    return torch.stack(outs)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude maps to 448), returned in x's dtype; the gradient passes
    through the rounding unchanged."""
    xd = x.detach()
    scale = FP8_MAX / xd.abs().amax().float().clamp_min(1e-30)
    q = ((xd.float() * scale).to(torch.float8_e4m3fn).float()
         / scale).to(x.dtype)
    return x + (q - xd)


def _fp8_input(module, args):
    return (fp8_round(args[0]),) + tuple(args[1:])


def set_precision(module: nn.Module, precision: str) -> nn.Module:
    """`float32`: as built. `fp8`: the control; every Conv2d and Linear
    weight is rounded to float8 in place and every input on the way in."""
    if precision == "float32":
        return module
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.copy_(fp8_round(m.weight))
                m.register_forward_pre_hook(_fp8_input)
    return module
