"""GaussianScene: padded Gaussian parameter store with an `alive` mask.

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

from humangaussian_torch import resolve_device
from humangaussian_torch.core.sh import num_sh_coeffs


def inverse_sigmoid(x):
    """logit."""
    return torch.log(x / (1.0 - x))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w,x,y,z) [..,4] -> rotation matrix [..,3,3] (normalizes)."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
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
        return self.quats / (
            torch.linalg.norm(self.quats, dim=-1, keepdim=True) + 1e-12
        )

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
