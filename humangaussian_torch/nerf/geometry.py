"""Implicit-volume geometry: a density and feature field.

Port of humangaussian_tpu/nerf/geometry.py (the reference's
`implicit-volume`): encoding -> VanillaMLP density head (+ feature head),
the density-blob bias (blob_magic3d / blob_dreamfusion), the softplus / exp
/ trunc_exp activation, normals by analytic gradient or central finite
differences, with the bbox rescale to [0, 1]^3.

Differences from the JAX module:

- The modules hold their parameters (`nn.Linear`, the hash table) and are
  built on a device; `reset_parameters(generator)` draws them as Flax's
  initializers do: Dense kernels lecun_normal (a normal truncated at two
  standard deviations, variance 1 / fan_in), biases zero.
- Analytic normals: JAX calls `jax.grad` of the density inside the
  forward. Here one pass computes the density with the points requiring
  grad and `torch.autograd.grad` differentiates it, with
  `create_graph=True` when the caller's grad mode is on (the render is
  differentiated, so the normals carry gradients to the parameters);
  under `torch.no_grad()` the forward enters `torch.enable_grad()` for
  that one gradient and returns detached outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from humangaussian_torch import resolve_device
from humangaussian_torch.nerf.encoding import (
    FrequencyEncoding,
    HashGridConfig,
    HashGridEncoding,
    init_generator,
)

# flax's lecun_normal: a standard normal truncated to [-2, 2] has this
# standard deviation, which the initializer divides out
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class ImplicitVolumeConfig:
    radius: float = 1.0
    n_feature_dims: int = 3
    encoding: str = "hashgrid"  # "hashgrid" | "frequency"
    hash_cfg: HashGridConfig = HashGridConfig()
    n_frequencies: int = 6
    n_neurons: int = 64
    n_hidden_layers: int = 1
    density_activation: str = "softplus"
    density_bias: Any = "blob_magic3d"
    density_blob_scale: float = 10.0
    density_blob_std: float = 0.5
    normal_type: str = "analytic"  # "analytic" | "finite_difference"
    finite_difference_eps: float = 0.01


@torch.no_grad()
def reset_dense(layer: nn.Linear, generator: torch.Generator):
    """Flax Dense initialization: lecun_normal kernel, zero bias."""
    std = (1.0 / layer.in_features) ** 0.5 / _TRUNC_STD
    w = torch.empty(layer.weight.shape)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    layer.weight.copy_(w)
    layer.bias.zero_()


def make_encoding(kind: str, hash_cfg: HashGridConfig, n_frequencies: int,
                  device, generator=None):
    if kind == "hashgrid":
        return HashGridEncoding(hash_cfg, device, generator)
    if kind == "frequency":
        return FrequencyEncoding(n_frequencies)
    raise ValueError(f"unknown encoding {kind!r}")


class VanillaMLP(nn.Module):
    """threestudio VanillaMLP: ReLU hidden layers `hidden_i`, then `out`
    with no activation."""

    def __init__(self, in_dims: int, out_dims: int, n_neurons: int,
                 n_hidden_layers: int, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.n_hidden_layers = n_hidden_layers
        width = in_dims
        for i in range(n_hidden_layers):
            self.add_module(f"hidden_{i}",
                            nn.Linear(width, n_neurons, device=dev))
            width = n_neurons
        self.out = nn.Linear(width, out_dims, device=dev)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        gen = init_generator(generator)
        for layer in self.children():
            reset_dense(layer, gen)

    def forward(self, x):
        for i in range(self.n_hidden_layers):
            x = F.relu(getattr(self, f"hidden_{i}")(x))
        return self.out(x)


def normal_offsets(eps: float, device) -> torch.Tensor:
    """The six central-difference offsets (+x, -x, +y, -y, +z, -z)."""
    return torch.tensor(
        [[eps, 0, 0], [-eps, 0, 0], [0, eps, 0], [0, -eps, 0], [0, 0, eps],
         [0, 0, -eps]], dtype=torch.float32, device=device)


def analytic_gradient(fields_fn, points, key: str):
    """(fields_fn(points), d sum(fields[key]) / d points): the gradient
    keeps its graph when grad mode is on (create_graph); under no_grad the
    fields come back detached."""
    outer = torch.is_grad_enabled()
    with torch.enable_grad():
        p = points if points.requires_grad else \
            points.detach().requires_grad_(True)
        out = fields_fn(p)
        (g,) = torch.autograd.grad(out[key].sum(), p, create_graph=outer)
    if not outer:
        out = {k: v.detach() for k, v in out.items()}
    return out, g


class ImplicitVolume(nn.Module):
    def __init__(self, cfg: ImplicitVolumeConfig = ImplicitVolumeConfig(),
                 device="cuda", generator=None):
        super().__init__()
        c = self.cfg = cfg
        dev = resolve_device(device)
        gen = init_generator(generator)
        self.encoding = make_encoding(c.encoding, c.hash_cfg,
                                      c.n_frequencies, dev, gen)
        n_in = self.encoding.n_output_dims
        self.density_network = VanillaMLP(n_in, 1, c.n_neurons,
                                          c.n_hidden_layers, dev, gen)
        if c.n_feature_dims > 0:
            self.feature_network = VanillaMLP(
                n_in, c.n_feature_dims, c.n_neurons, c.n_hidden_layers, dev,
                gen)

    def reset_parameters(self, generator=None):
        """Redraw every parameter in the Flax init's order (encoding,
        density head, feature head) from `generator`."""
        gen = init_generator(generator)
        for child in self.children():
            child.reset_parameters(gen)

    # ---- density ------------------------------------------------------
    def _density_bias(self, points):
        """Pre-activation bias shaping an initial blob; `points` in the
        original scale."""
        c = self.cfg
        if c.density_bias == "blob_dreamfusion":
            return c.density_blob_scale * torch.exp(
                -0.5 * torch.sum(points**2, -1) / c.density_blob_std**2
            )[..., None]
        if c.density_bias == "blob_magic3d":
            return c.density_blob_scale * (
                1.0 - torch.sqrt(torch.sum(points**2, -1))
                / c.density_blob_std)[..., None]
        return float(c.density_bias)

    def _activate(self, raw):
        act = self.cfg.density_activation
        if act == "softplus":
            return F.softplus(raw)
        if act == "exp":
            return torch.exp(raw)
        if act == "trunc_exp":  # exp with a clamped input (stable grad)
            return torch.exp(torch.clamp(raw, -15.0, 15.0))
        raise ValueError(f"unknown density activation {act!r}")

    def _scaled(self, points):
        """World points in [-radius, radius]^3 -> [0, 1]^3."""
        r = self.cfg.radius
        return torch.clamp((points + r) / (2 * r), 0.0, 1.0)

    def density(self, points):
        enc = self.encoding(self._scaled(points))
        return self._activate(self.density_network(enc)
                              + self._density_bias(points))

    def _fields(self, points):
        enc = self.encoding(self._scaled(points))
        raw = self.density_network(enc) + self._density_bias(points)
        out = {"density": self._activate(raw)}
        if self.cfg.n_feature_dims > 0:
            out["features"] = self.feature_network(enc)
        return out

    def forward(self, points, output_normal: bool = False):
        """points [.., 3] world -> {density [.., 1], features [.., F],
        normal [.., 3] with `output_normal`}."""
        c = self.cfg
        if not output_normal:
            return self._fields(points)
        if c.normal_type == "analytic":
            out, g = analytic_gradient(self._fields, points, "density")
        elif c.normal_type == "finite_difference":
            out = self._fields(points)
            eps = c.finite_difference_eps
            d = self.density(points[..., None, :]
                             + normal_offsets(eps, points.device))
            g = (d[..., 0::2, 0] - d[..., 1::2, 0]) / (2 * eps)
        else:
            raise ValueError(f"unknown normal type {c.normal_type!r}")
        out["normal"] = -g / (torch.linalg.norm(g, dim=-1, keepdim=True)
                              + 1e-8)
        return out
