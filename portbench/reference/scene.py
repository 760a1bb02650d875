"""Frozen plain copy of `humangaussian_torch/core/scene.py` for the benchmark's
reference (imports rewritten; kernel calls replaced by plain torch in
`portbench/reference/common.py`). Original docstring:

GaussianScene: padded Gaussian parameter store with an `alive` mask.

Port of humangaussian_tpu/core/scene.py. The JAX package pads the scene to
a static capacity so one compiled program serves every densify step; the
port keeps the same padded layout and mask so state moves one-to-one
between the packages (`humangaussian_torch.convert.scene_from_numpy`).

Raw parameters and their activations:
  means           [C,3]  world positions
  log_scales      [C,3]  exp -> scales
  quats           [C,4]  (w,x,y,z), normalize -> rotation
  sh_dc           [C,3]  SH degree-0 colour coefficients
  sh_rest         [C,K-1,3] higher SH coefficients
  opacity_logits  [C,1]  sigmoid -> opacity
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.common import resolve_device
from portbench.reference.sh import num_sh_coeffs, rgb_to_sh


def inverse_sigmoid(x):
    """logit."""
    return torch.log(x / (1.0 - x))


def quat_norm(q: torch.Tensor) -> torch.Tensor:
    """|q| over the last axis, keepdim, equal to `torch.linalg.norm` on
    every row but with a gradient of 0 where the norm is 0 (the zero
    quaternions of the PLY loader's padded slots), where that of the plain
    norm is NaN."""
    zero = torch.linalg.norm(q.detach(), dim=-1, keepdim=True) == 0.0
    n = torch.linalg.norm(torch.where(zero, 1.0, q), dim=-1, keepdim=True)
    return torch.where(zero, 0.0, n)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w,x,y,z) [..,4] -> rotation matrix [..,3,3] (normalizes)."""
    q = q / (quat_norm(q) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack(
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                dim=-1,
            ),
            torch.stack(
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                dim=-1,
            ),
            torch.stack(
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                dim=-1,
            ),
        ],
        dim=-2,
    )


def covariance_from_scaling_rotation(
    scales: torch.Tensor, quats: torch.Tensor, scale_modifier: float = 1.0
) -> torch.Tensor:
    """3D covariance Sigma = R S S^T R^T as a full [..,3,3] matrix."""
    r = quat_to_rotmat(quats)
    m = r * (scales * scale_modifier)[..., None, :]  # R @ diag(s)
    return m @ m.transpose(-1, -2)


class GaussianScene(NamedTuple):
    """Padded Gaussian scene; `capacity` == means.shape[0]."""

    means: torch.Tensor  # [C,3] f32
    log_scales: torch.Tensor  # [C,3] f32
    quats: torch.Tensor  # [C,4] f32 (w,x,y,z)
    sh_dc: torch.Tensor  # [C,3] f32
    sh_rest: torch.Tensor  # [C,K-1,3] f32 (K-1 may be 0)
    opacity_logits: torch.Tensor  # [C,1] f32
    alive: torch.Tensor  # [C] bool

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    @property
    def max_sh_degree(self) -> int:
        k = 1 + self.sh_rest.shape[1]
        return int(round(k**0.5)) - 1

    @property
    def scales(self) -> torch.Tensor:
        return torch.exp(self.log_scales)

    @property
    def rotations(self) -> torch.Tensor:
        return self.quats / (quat_norm(self.quats) + 1e-12)

    @property
    def opacities(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity_logits)

    @property
    def features(self) -> torch.Tensor:
        """[C,K,3] full SH coefficient stack (dc first)."""
        return torch.cat([self.sh_dc[:, None, :], self.sh_rest], dim=1)

    @property
    def num_alive(self) -> int:
        return int(self.alive.sum())

    def params(self) -> dict:
        """The optimizable leaves (excludes the alive mask)."""
        return {
            "means": self.means,
            "log_scales": self.log_scales,
            "quats": self.quats,
            "sh_dc": self.sh_dc,
            "sh_rest": self.sh_rest,
            "opacity_logits": self.opacity_logits,
        }

    def replace_params(self, p: dict) -> "GaussianScene":
        return self._replace(**p)


def empty_scene(capacity: int, sh_degree: int = 0,
                device="cuda") -> GaussianScene:
    dev = resolve_device(device)
    k = num_sh_coeffs(sh_degree)
    f32 = dict(dtype=torch.float32, device=dev)
    quats = torch.zeros((capacity, 4), **f32)
    quats[:, 0] = 1.0
    return GaussianScene(
        means=torch.zeros((capacity, 3), **f32),
        log_scales=torch.full((capacity, 3), -10.0, **f32),
        quats=quats,
        sh_dc=torch.zeros((capacity, 3), **f32),
        sh_rest=torch.zeros((capacity, k - 1, 3), **f32),
        opacity_logits=torch.full((capacity, 1), -10.0, **f32),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=dev),
    )


def scene_from_points(
    points: torch.Tensor,
    colors: torch.Tensor,
    capacity: int,
    sh_degree: int = 0,
    mean_sq_dist: torch.Tensor | None = None,
    init_opacity: float = 0.1,
) -> GaussianScene:
    """Initialize from a point cloud (upstream create_from_pcd): dc colour
    = RGB2SH(rgb); isotropic log-scale = log(sqrt(mean squared 3-NN
    distance)) (clamped at 1e-7); identity quats; opacity = 0.1. The scene
    lives on `points`' device.

    `mean_sq_dist` is the [N] mean squared distance to the 3 nearest
    neighbours (humangaussian_torch.ops.knn.mean_3nn_sq_dist_host); a
    constant 1e-4 stands in when it is None.
    """
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    dev = points.device
    scene = empty_scene(capacity, sh_degree, dev)
    if mean_sq_dist is None:
        mean_sq_dist = torch.full((n,), 1e-4, dtype=torch.float32, device=dev)
    mean_sq_dist = mean_sq_dist.to(dev, torch.float32)
    log_scale = torch.log(torch.sqrt(torch.clamp_min(mean_sq_dist, 1e-7)))
    logit = inverse_sigmoid(torch.tensor(init_opacity, dtype=torch.float32))

    def padded(x, base):
        out = base.clone()
        out[:n] = x
        return out

    return scene._replace(
        means=padded(points.to(torch.float32), scene.means),
        log_scales=padded(log_scale[:, None].expand(n, 3), scene.log_scales),
        sh_dc=padded(rgb_to_sh(colors.to(torch.float32)), scene.sh_dc),
        opacity_logits=padded(logit.to(dev), scene.opacity_logits),
        alive=torch.arange(capacity, device=dev) < n,
    )
