"""Deterministic evaluation cameras (the orbit of validation and test).

Port of the evaluation part of humangaussian_tpu/data/cameras.py:
`eval_camera_batch` (azimuth sweep at fixed elevation, distance and FoV;
4 val views, 120 test views) with the projection / MVP helpers it uses,
and the `RandomCameraConfig` fields it reads. The random training sampler
is not ported yet.

World frame: right-handed, z up; each camera looks at the origin.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from humangaussian_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class RandomCameraConfig:
    """The evaluation fields of the JAX RandomCameraConfig, same defaults."""

    eval_height: int = 1024
    eval_width: int = 1024
    eval_elevation_deg: float = 15.0
    eval_camera_distance: float = 2.0
    eval_fovy_deg: float = 70.0
    n_val_views: int = 4
    n_test_views: int = 120


class CameraBatch(NamedTuple):
    c2w: torch.Tensor  # [B,4,4] OpenGL camera-to-world
    mvp_mtx: torch.Tensor  # [B,4,4] proj @ w2c (pose-image convention)
    camera_positions: torch.Tensor  # [B,3]
    light_positions: torch.Tensor  # [B,3]
    elevation: torch.Tensor  # [B] degrees
    azimuth: torch.Tensor  # [B] degrees
    camera_distances: torch.Tensor  # [B]
    fovy: torch.Tensor  # [B] radians
    is_head: bool
    is_back: bool


def get_projection_matrix(fovy, aspect_wh, near=0.1, far=1000.0):
    """[B,4,4] OpenGL projection with y flipped, z in [-1,1]."""
    t = torch.tan(fovy / 2.0)
    zeros = torch.zeros_like(fovy)
    rows = [
        torch.stack([1.0 / (t * aspect_wh), zeros, zeros, zeros], -1),
        torch.stack([zeros, -1.0 / t, zeros, zeros], -1),
        torch.stack(
            [zeros, zeros,
             torch.full_like(fovy, -(far + near) / (far - near)),
             torch.full_like(fovy, -2.0 * far * near / (far - near))], -1,
        ),
        torch.stack([zeros, zeros, torch.full_like(fovy, -1.0), zeros], -1),
    ]
    return torch.stack(rows, dim=1)


def get_mvp_matrix(c2w, proj_mtx):
    rt = c2w[:, :3, :3].transpose(1, 2)
    t = -rt @ c2w[:, :3, 3:]
    w2c = torch.zeros_like(c2w)
    w2c[:, :3, :3] = rt
    w2c[:, :3, 3:] = t
    w2c[:, 3, 3] = 1.0
    return proj_mtx @ w2c


def _c2w_from_lookat(camera_positions, center, up):
    lookat = center - camera_positions
    lookat = lookat / torch.linalg.norm(lookat, dim=-1, keepdim=True)
    right = torch.linalg.cross(lookat, up)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    up2 = torch.linalg.cross(right, lookat)
    up2 = up2 / torch.linalg.norm(up2, dim=-1, keepdim=True)
    b = camera_positions.shape[0]
    c2w = torch.zeros((b, 4, 4), dtype=torch.float32,
                      device=camera_positions.device)
    c2w[:, :3, 0] = right
    c2w[:, :3, 1] = up2
    c2w[:, :3, 2] = -lookat
    c2w[:, :3, 3] = camera_positions
    c2w[:, 3, 3] = 1.0
    return c2w


def _linspace(start: float, stop: float, num: int, endpoint: bool, f32):
    """jnp.linspace's f32 formula start (1 - s) + stop s, s = i / div, so
    the sweep's angles round as the JAX package's do."""
    div = num - 1 if endpoint else num
    step = torch.arange(div, **f32) / div
    out = start * (1 - step) + stop * step
    if endpoint:
        out = torch.cat([out, torch.full((1,), stop, **f32)])
    return out


def eval_camera_batch(cfg: RandomCameraConfig = RandomCameraConfig(),
                      split: str = "test", device="cuda") -> CameraBatch:
    """Deterministic azimuth sweep: `val` (n_val_views, endpoint excluded)
    or `test` (n_test_views, -180..180 inclusive)."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    n = cfg.n_val_views if split == "val" else cfg.n_test_views
    if split == "val":
        azimuth_deg = _linspace(-180.0, 180.0, n + 1, True, f32)[:n]
    else:
        azimuth_deg = _linspace(-180.0, 180.0, n, True, f32)
    elevation_deg = torch.full((n,), cfg.eval_elevation_deg, **f32)
    camera_distances = torch.full((n,), cfg.eval_camera_distance, **f32)
    elevation = torch.deg2rad(elevation_deg)
    azimuth = torch.deg2rad(azimuth_deg)
    camera_positions = torch.stack(
        [
            camera_distances * torch.cos(elevation) * torch.cos(azimuth),
            camera_distances * torch.cos(elevation) * torch.sin(azimuth),
            camera_distances * torch.sin(elevation),
        ],
        dim=-1,
    )
    center = torch.zeros_like(camera_positions)
    up = torch.tensor([0.0, 0.0, 1.0], **f32).expand(n, 3)
    fovy = torch.deg2rad(torch.full((n,), cfg.eval_fovy_deg, **f32))
    c2w = _c2w_from_lookat(camera_positions, center, up)
    proj = get_projection_matrix(fovy, cfg.eval_width / cfg.eval_height)
    mvp = get_mvp_matrix(c2w, proj)
    return CameraBatch(
        c2w=c2w,
        mvp_mtx=mvp,
        camera_positions=camera_positions,
        light_positions=camera_positions,
        elevation=elevation_deg,
        azimuth=azimuth_deg,
        camera_distances=camera_distances,
        fovy=fovy,
        is_head=False,
        is_back=False,
    )
