"""Backgrounds: per-ray colors behind the volume.

Port of humangaussian_tpu/nerf/background.py, whole:

- `SolidColorBackground`: a fixed or learned constant color of any
  channel count (more than 3 for the latent-channel renderers);
- `NeuralEnvironmentMapBackground`: frequency-encoded view directions ->
  MLP -> sigmoid color;
- `TexturedBackground`: a learned equirectangular texture sampled by view
  direction (nearest texel).

The modules hold their parameters (`env_color`, the MLP's `mlp.hidden_i` /
`mlp.out`, `texture`) on a device; `reset_parameters(generator)` draws them
as the Flax initializers do.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from humangaussian_torch import resolve_device
from humangaussian_torch.nerf.encoding import FrequencyEncoding
from humangaussian_torch.nerf.geometry import VanillaMLP


def unit_dirs(dirs):
    return dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-8)


class SolidColorBackground(nn.Module):
    """A constant color [C], learned (`env_color`) or fixed."""

    def __init__(self, color=(1.0, 1.0, 1.0), learned: bool = False,
                 device="cuda"):
        super().__init__()
        self.color = tuple(color)
        self.learned = learned
        c = torch.tensor(self.color, dtype=torch.float32,
                         device=resolve_device(device))
        if learned:
            self.env_color = nn.Parameter(c)
        else:
            self.register_buffer("env_color", c, persistent=False)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.env_color.copy_(torch.tensor(self.color))

    def forward(self, dirs):
        return self.env_color.expand(dirs.shape[:-1] + self.env_color.shape)


class NeuralEnvironmentMapBackground(nn.Module):
    """dir -> frequency encoding -> MLP -> sigmoid color (or a clamp)."""

    def __init__(self, color_activation: str = "sigmoid",
                 n_frequencies: int = 10, n_neurons: int = 16,
                 n_hidden_layers: int = 2, device="cuda", generator=None):
        super().__init__()
        self.color_activation = color_activation
        self.encoding = FrequencyEncoding(n_frequencies)
        self.mlp = VanillaMLP(self.encoding.n_output_dims, 3, n_neurons,
                              n_hidden_layers, device, generator)

    def reset_parameters(self, generator=None):
        self.mlp.reset_parameters(generator)

    def forward(self, dirs):
        rgb = self.mlp(self.encoding(unit_dirs(dirs)))
        if self.color_activation == "sigmoid":
            return torch.sigmoid(rgb)
        return torch.clamp(rgb, 0.0, 1.0)


class TexturedBackground(nn.Module):
    """A learned [H, W, 3] `texture` (starting at 0.5) looked up at the
    view direction's longitude / colatitude, sigmoid(4 x - 2)."""

    def __init__(self, height: int = 64, width: int = 128, device="cuda"):
        super().__init__()
        self.height, self.width = height, width
        self.texture = nn.Parameter(torch.full(
            (height, width, 3), 0.5, dtype=torch.float32,
            device=resolve_device(device)))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.texture.fill_(0.5)

    def forward(self, dirs):
        d = unit_dirs(dirs)
        u = torch.atan2(d[..., 1], d[..., 0]) / (2 * math.pi) + 0.5
        v = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0)) / math.pi
        # truncation toward zero, as JAX's astype(int32)
        xi = torch.clamp((u * self.width).to(torch.int64), 0, self.width - 1)
        yi = torch.clamp((v * self.height).to(torch.int64), 0,
                         self.height - 1)
        return torch.sigmoid(self.texture[yi, xi] * 4.0 - 2.0)
