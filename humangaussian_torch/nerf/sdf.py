"""SDF geometries and the NeuS volume renderer.

Port of humangaussian_tpu/nerf/sdf.py:

- `ImplicitSDF` (the reference's implicit-sdf): encoding -> SDF MLP (+
  feature MLP), shifted by an analytic sphere SDF, normals by analytic
  gradient or central finite differences;
- `VolumeGrid` (volume-grid): a dense [G, G, G, 1 + F] voxel `grid` with
  trilinear interpolation over eight clipped corner gathers, softplus
  density;
- `NeusVolumeRenderer` (neus-volume-renderer): NeuS's section alpha from
  the logistic CDF with a learned inverse standard deviation
  exp(10 variance), over the same static stratified samples as the NeRF
  renderer, with the cos-annealed estimator.

Differences from the JAX module: the modules hold their parameters; the
NeuS `variance` is the parameter of a `LearnedVariance` module beside the
geometry, material and background in the renderer's `field`; analytic
normals use `torch.autograd.grad` with the same `create_graph` rule as
nerf/geometry.py; draws are injected or come from a generator, as in
nerf/renderer.py.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from humangaussian_torch import resolve_device
from humangaussian_torch.nerf.encoding import HashGridConfig, init_generator
from humangaussian_torch.nerf.geometry import (
    VanillaMLP,
    analytic_gradient,
    make_encoding,
    normal_offsets,
)
from humangaussian_torch.nerf.renderer import (
    RendererConfig,
    composite_weights,
    flatten_cameras,
    ray_aabb,
    stratified_depths,
    unflatten,
)


@dataclasses.dataclass(frozen=True)
class ImplicitSDFConfig:
    radius: float = 1.0
    n_feature_dims: int = 3
    encoding: str = "hashgrid"
    hash_cfg: HashGridConfig = HashGridConfig()
    n_frequencies: int = 6
    n_neurons: int = 64
    n_hidden_layers: int = 1
    sdf_bias: str = "sphere"  # "sphere" | "none"
    sdf_bias_params: float = 0.5  # sphere radius
    normal_type: str = "analytic"
    finite_difference_eps: float = 0.01


class ImplicitSDF(nn.Module):
    def __init__(self, cfg: ImplicitSDFConfig = ImplicitSDFConfig(),
                 device="cuda", generator=None):
        super().__init__()
        c = self.cfg = cfg
        dev = resolve_device(device)
        gen = init_generator(generator)
        # anything but "hashgrid" is the frequency encoding, as in JAX
        self.encoding = make_encoding(
            "hashgrid" if c.encoding == "hashgrid" else "frequency",
            c.hash_cfg, c.n_frequencies, dev, gen)
        n_in = self.encoding.n_output_dims
        self.sdf_network = VanillaMLP(n_in, 1, c.n_neurons,
                                      c.n_hidden_layers, dev, gen)
        if c.n_feature_dims > 0:
            self.feature_network = VanillaMLP(
                n_in, c.n_feature_dims, c.n_neurons, c.n_hidden_layers, dev,
                gen)

    def reset_parameters(self, generator=None):
        gen = init_generator(generator)
        for child in self.children():
            child.reset_parameters(gen)

    def _scaled(self, points):
        r = self.cfg.radius
        return torch.clamp((points + r) / (2 * r), 0.0, 1.0)

    def _bias(self, points):
        """Shape initialization: the raw output is shifted by the SDF of a
        sphere of radius `sdf_bias_params`."""
        if self.cfg.sdf_bias == "sphere":
            return (torch.linalg.norm(points, dim=-1, keepdim=True)
                    - self.cfg.sdf_bias_params)
        return 0.0

    def sdf(self, points):
        enc = self.encoding(self._scaled(points))
        return self.sdf_network(enc) + self._bias(points)

    def _fields(self, points):
        enc = self.encoding(self._scaled(points))
        out = {"sdf": self.sdf_network(enc) + self._bias(points)}
        if self.cfg.n_feature_dims > 0:
            out["features"] = self.feature_network(enc)
        return out

    def forward(self, points, output_normal: bool = False):
        """points [.., 3] -> {sdf [.., 1], features [.., F], normal [.., 3]
        (the unit SDF gradient) with `output_normal`}."""
        c = self.cfg
        if not output_normal:
            return self._fields(points)
        if c.normal_type == "analytic":
            out, g = analytic_gradient(self._fields, points, "sdf")
        else:
            out = self._fields(points)
            eps = c.finite_difference_eps
            d = self.sdf(points[..., None, :]
                         + normal_offsets(eps, points.device))
            g = (d[..., 0::2, 0] - d[..., 1::2, 0]) / (2 * eps)
        out["normal"] = g / (torch.linalg.norm(g, dim=-1, keepdim=True)
                             + 1e-8)
        return out


@dataclasses.dataclass(frozen=True)
class VolumeGridConfig:
    radius: float = 1.0
    grid_size: int = 32
    n_feature_dims: int = 3
    density_bias: float = -1.0


class VolumeGrid(nn.Module):
    """Dense [G, G, G, 1 + F] voxel values (normal(0.1) at init),
    trilinearly interpolated: density softplus(v[0] + bias), features
    v[1:]."""

    def __init__(self, cfg: VolumeGridConfig = VolumeGridConfig(),
                 device="cuda", generator=None):
        super().__init__()
        self.cfg = cfg
        self.grid = nn.Parameter(torch.empty(
            (cfg.grid_size,) * 3 + (1 + cfg.n_feature_dims,),
            dtype=torch.float32, device=resolve_device(device)))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.grid.copy_(0.1 * torch.randn(
            self.grid.shape, generator=init_generator(generator)))

    def forward(self, points, output_normal: bool = False):
        c = self.cfg
        u = torch.clamp((points + c.radius) / (2 * c.radius), 0.0, 1.0) * (
            c.grid_size - 1)
        u0 = torch.floor(u)
        frac = (u - u0).reshape(-1, 3)
        u0 = u0.to(torch.int64).reshape(-1, 3)
        acc = 0.0
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    idx = torch.clamp(
                        u0 + u0.new_tensor([dx, dy, dz]), 0,
                        c.grid_size - 1)
                    w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                         * (frac[:, 1] if dy else 1 - frac[:, 1])
                         * (frac[:, 2] if dz else 1 - frac[:, 2]))
                    acc = acc + w[:, None] * self.grid[
                        idx[:, 0], idx[:, 1], idx[:, 2]]
        vals = acc.reshape(points.shape[:-1] + (1 + c.n_feature_dims,))
        return {"density": F.softplus(vals[..., :1] + c.density_bias),
                "features": vals[..., 1:]}


class LearnedVariance(nn.Module):
    """NeuS's learned `variance`; the inverse std is exp(10 variance)."""

    def __init__(self, init: float = 0.3, device="cuda"):
        super().__init__()
        self.init = init
        self.variance = nn.Parameter(torch.tensor(
            init, dtype=torch.float32, device=resolve_device(device)))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.variance.fill_(self.init)

    def forward(self):
        return torch.exp(10.0 * self.variance)


class NeusVolumeRenderer:
    """NeuS over static stratified samples: the section's previous / next
    SDF are extrapolated from the ray-directional derivative d(sdf)/dt,
    estimated from consecutive samples, annealed by `cos_anneal_ratio` (0:
    the isotropic 0.5 (1 - cos) weighting; 1: only descending sections),
    then alpha = clip((Phi(s prev) - Phi(s next) + 1e-5) / (Phi(s prev) +
    1e-5), 0, 1) with Phi the logistic CDF and s the learned inverse
    std."""

    def __init__(self, geometry, material, background,
                 cfg: RendererConfig = RendererConfig(),
                 learned_variance_init: float = 0.3, device="cuda"):
        self.geometry = geometry
        self.material = material
        self.background = background
        self.cfg = cfg
        self.variance = LearnedVariance(learned_variance_init, device)
        self.field = nn.ModuleDict({"geometry": geometry,
                                    "material": material,
                                    "background": background,
                                    "variance": self.variance})

    def reset_parameters(self, generator=None):
        for module in self.field.values():
            module.reset_parameters(generator)

    def render_rays(self, origins, dirs, jitter=None, generator=None,
                    cos_anneal_ratio=1.0):
        """origins / dirs [R, 3] -> {comp_rgb, opacity, depth, weights,
        sdf}; `jitter` [R, S] unit uniforms (drawn from `generator` when
        None and randomized)."""
        c = self.cfg
        s_count = c.num_samples_per_ray
        if not c.randomized:
            jitter = None
        elif jitter is None and generator is not None:
            jitter = torch.rand((origins.shape[0], s_count),
                                generator=generator, device=generator.device)
        t_near, t_far = ray_aabb(origins, dirs, c.radius, c.near_plane)
        t = stratified_depths(t_near, t_far, s_count, jitter)
        pts = origins[:, None, :] + dirs[:, None, :] * t[..., None]

        geo = self.geometry(pts)
        sdf = geo["sdf"][..., 0]  # [R,S]
        inv_s = self.variance()
        dt = (t_far - t_near)[:, None] / s_count
        # d(sdf)/dt = dot(grad sdf, dir), from consecutive samples; the
        # last section repeats the one before
        dsdf = torch.diff(sdf, dim=-1)
        true_cos = torch.cat([dsdf, dsdf[:, -1:]], dim=-1) / (dt + 1e-8)
        ratio = torch.as_tensor(cos_anneal_ratio, dtype=torch.float32,
                                device=sdf.device)
        iter_cos = -(F.relu(-true_cos * 0.5 + 0.5) * (1.0 - ratio)
                     + F.relu(-true_cos) * ratio)
        est_prev = sdf - iter_cos * dt * 0.5
        est_next = sdf + iter_cos * dt * 0.5
        prev_cdf = torch.sigmoid(est_prev * inv_s)
        next_cdf = torch.sigmoid(est_next * inv_s)
        alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5),
                            0.0, 1.0)
        weights = composite_weights(alpha)

        rgb = self.material(geo["features"])
        comp_rgb = torch.sum(weights[..., None] * rgb, dim=-2)
        opacity = torch.sum(weights, dim=-1, keepdim=True)
        depth = torch.sum(weights * t, dim=-1, keepdim=True)
        return {
            "comp_rgb": comp_rgb + (1.0 - opacity) * self.background(dirs),
            "opacity": opacity,
            "depth": depth,
            "weights": weights,
            "sdf": sdf,
        }

    def render_image(self, c2w, fovy, height: int, width: int, jitter=None,
                     generator=None, cos_anneal_ratio=1.0):
        """One camera or a batch, as NerfVolumeRenderer.render_image."""
        lead, o, d, jitter = flatten_cameras(c2w, fovy, height, width,
                                             jitter)
        return unflatten(self.render_rays(o, d, jitter, generator,
                                          cos_anneal_ratio), lead)
