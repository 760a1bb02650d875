"""Materials: geometry features -> shaded color.

Port of humangaussian_tpu/nerf/material.py, whole:

- `NoMaterial`: the activated first three features;
- `DiffuseWithPointLightMaterial`: the DreamFusion shading model, albedo
  under `shading="albedo"`, albedo x (ambient + diffuse max(n . l, 0))
  under "diffuse" and the gray light alone under "textureless";
- `NeuralRadianceMaterial`: MLP(features ++ encoded view direction);
- `PBRMaterial`: Cook-Torrance with GGX distribution, Fresnel-Schlick and
  Smith-GGX geometry under a point light, energy-conserving diffuse;
- `SDLatentAdapterMaterial`: a learned 4 x 3 `adapter` from SD latents to
  RGB, starting at the latent preview matrix;
- `HybridRGBLatentMaterial`: activated RGB, latent channels passed
  through.

Each takes features [.., F] and keyword arguments (positions, normal,
light_positions, viewdirs, shading) it may ignore. The parameters live in
the modules (`mlp.*`, `adapter`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from humangaussian_torch import resolve_device
from humangaussian_torch.nerf.background import unit_dirs
from humangaussian_torch.nerf.encoding import FrequencyEncoding
from humangaussian_torch.nerf.geometry import VanillaMLP


class _Stateless(nn.Module):
    def reset_parameters(self, generator=None):
        pass


class NoMaterial(_Stateless):
    """Direct activation of the first three features."""

    def __init__(self, color_activation: str = "sigmoid"):
        super().__init__()
        self.color_activation = color_activation

    def forward(self, features, **_):
        rgb = features[..., :3]
        if self.color_activation == "sigmoid":
            return torch.sigmoid(rgb)
        if self.color_activation == "scale_-11_01":
            return torch.clamp(rgb * 0.5 + 0.5, 0.0, 1.0)
        return torch.clamp(rgb, 0.0, 1.0)


class DiffuseWithPointLightMaterial(_Stateless):
    """albedo = sigmoid(features[:3]); lambertian shading under a point
    light that follows the camera."""

    def __init__(self, ambient_light_color=(0.1, 0.1, 0.1),
                 diffuse_light_color=(0.9, 0.9, 0.9)):
        super().__init__()
        self.ambient_light_color = tuple(ambient_light_color)
        self.diffuse_light_color = tuple(diffuse_light_color)

    def forward(self, features, positions=None, normal=None,
                light_positions=None, shading: str = "albedo", **_):
        albedo = torch.sigmoid(features[..., :3])
        if shading == "albedo" or normal is None or light_positions is None:
            return albedo
        l_dir = unit_dirs(light_positions - positions)
        lambert = torch.clamp_min(
            torch.sum(normal * l_dir, dim=-1, keepdim=True), 0.0)
        amb = features.new_tensor(self.ambient_light_color)
        dif = features.new_tensor(self.diffuse_light_color)
        light = amb + lambert * dif
        if shading == "textureless":
            return torch.clamp(light, 0.0, 1.0)
        return torch.clamp(albedo * light, 0.0, 1.0)


class NeuralRadianceMaterial(nn.Module):
    """MLP(features ++ frequency-encoded view direction) -> sigmoid."""

    def __init__(self, n_input_dims: int = 3, n_frequencies: int = 4,
                 n_neurons: int = 32, n_hidden_layers: int = 2,
                 device="cuda", generator=None):
        super().__init__()
        self.encoding = FrequencyEncoding(n_frequencies)
        self.mlp = VanillaMLP(n_input_dims + self.encoding.n_output_dims, 3,
                              n_neurons, n_hidden_layers, device, generator)

    def reset_parameters(self, generator=None):
        self.mlp.reset_parameters(generator)

    def forward(self, features, viewdirs=None, **_):
        if viewdirs is None:
            viewdirs = features.new_zeros(features.shape[:-1] + (3,))
        enc = self.encoding(unit_dirs(viewdirs))
        h = torch.cat([features, enc.expand(features.shape[:-1]
                                            + enc.shape[-1:])], dim=-1)
        return torch.sigmoid(self.mlp(h))


def ipow(x, n: int):
    """x^n by repeated squaring in XLA's `integer_pow` order (x^5 = x *
    (x^2)^2), where torch's `**` of 4 or 5 calls powf."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


class PBRMaterial(_Stateless):
    """Features (albedo 3, metallic 1, roughness 1) -> Cook-Torrance under
    a point light; albedo without normals, light or positions."""

    def __init__(self, min_metallic: float = 0.0, max_metallic: float = 0.9,
                 min_roughness: float = 0.08, max_roughness: float = 0.9):
        super().__init__()
        self.min_metallic, self.max_metallic = min_metallic, max_metallic
        self.min_roughness, self.max_roughness = min_roughness, max_roughness

    def forward(self, features, positions=None, normal=None,
                light_positions=None, viewdirs=None, **_):
        albedo = torch.sigmoid(features[..., :3])
        metallic = self.min_metallic + (
            self.max_metallic - self.min_metallic
        ) * torch.sigmoid(features[..., 3:4])
        roughness = self.min_roughness + (
            self.max_roughness - self.min_roughness
        ) * torch.sigmoid(features[..., 4:5])
        if normal is None or light_positions is None or positions is None:
            return albedo
        l = unit_dirs(light_positions - positions)  # noqa: E741
        v = -viewdirs if viewdirs is not None else l
        h = unit_dirs(l + v)

        def dot(a, b):
            return torch.clamp_min(torch.sum(a * b, -1, keepdim=True), 0.0)

        ndl, ndv, ndh, vdh = dot(normal, l), dot(normal, v), \
            dot(normal, h), dot(v, h)
        a2 = ipow(roughness, 4)
        dist = a2 / (math.pi * ipow(ipow(ndh, 2) * (a2 - 1.0) + 1.0, 2)
                     + 1e-6)
        f0 = 0.04 * (1 - metallic) + albedo * metallic
        fresnel = f0 + (1.0 - f0) * ipow(1.0 - vdh, 5)

        def g1(ndx):
            return 2.0 * ndx / (ndx + torch.sqrt(a2 + (1.0 - a2)
                                                  * ipow(ndx, 2)) + 1e-8)

        geom = g1(ndl) * g1(ndv)
        spec = dist * fresnel * geom / (4.0 * ndl * ndv + 1e-6) * ndl
        # the Fresnel-reflected fraction does not also scatter diffusely
        kd = (1.0 - fresnel) * (1.0 - metallic)
        return torch.clamp(kd * albedo * ndl + spec, 0.0, 1.0)


# the SD latent -> RGB preview matrix the adapter starts from
LATENT_RGB = ((0.298, 0.207, 0.208), (0.187, 0.286, 0.173),
              (-0.158, 0.189, 0.264), (-0.184, -0.271, -0.473))


class SDLatentAdapterMaterial(nn.Module):
    """A learned 4 -> 3 linear `adapter` from latent features to RGB."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.adapter = nn.Parameter(torch.tensor(
            LATENT_RGB, dtype=torch.float32, device=resolve_device(device)))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.adapter.copy_(torch.tensor(LATENT_RGB))

    def forward(self, features, **_):
        color = features[..., :4] @ self.adapter
        return torch.clamp((color + 1.0) * 0.5, 0.0, 1.0)


class HybridRGBLatentMaterial(_Stateless):
    """The first three features activated as RGB, the rest unchanged."""

    def __init__(self, n_output_dims: int = 3,
                 color_activation: str = "sigmoid"):
        super().__init__()
        self.n_output_dims = n_output_dims
        self.color_activation = color_activation

    def forward(self, features, **_):
        rgb = features[..., :3]
        rgb = (torch.sigmoid(rgb) if self.color_activation == "sigmoid"
               else torch.clamp(rgb, 0.0, 1.0))
        return torch.cat([rgb, features[..., 3:]], dim=-1)
