"""Single-image-conditioned datamodule (image-to-3D workflows).

Port of humangaussian_tpu/data/image.py: one fixed reference view (an
RGBA image plus optional depth / normal sidecars, nearest-resized on the
host, rgb premultiplied by the mask) placed by (elevation, azimuth,
distance) in the z-up world and looking at the origin, with rays at pixel
centres in the OpenGL convention (`nerf/renderer.py::get_rays`, imported
here as the JAX module imports it), plus random novel-view camera
batches for the guidance term from data/cameras.py.

Differences from the JAX module: the fixed batch holds CPU tensors;
`random_batch` draws from a `torch.Generator` (`camera_draws`), or takes
the draws it is handed, as the camera sampler does; images are read with
PIL where the JAX module uses imageio.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, NamedTuple

import numpy as np
import torch

from humangaussian_torch.data.cameras import (
    CameraBatch,
    RandomCameraConfig,
    camera_batch_from_draws,
    camera_draws,
)
from humangaussian_torch.nerf.renderer import get_rays


@dataclasses.dataclass(frozen=True)
class SingleImageConfig:
    """The JAX SingleImageConfig, same defaults."""

    image_path: str = ""
    height: int = 96
    width: int = 96
    default_elevation_deg: float = 0.0
    default_azimuth_deg: float = -180.0
    default_camera_distance: float = 1.2
    default_fovy_deg: float = 60.0
    use_random_camera: bool = True
    requires_depth: bool = False
    requires_normal: bool = False
    random_camera: RandomCameraConfig = RandomCameraConfig(
        batch_size=1, height=96, width=96
    )


class SingleImageBatch(NamedTuple):
    rgb: torch.Tensor  # [1,H,W,3]
    mask: torch.Tensor  # [1,H,W,1]
    rays_o: torch.Tensor  # [1,H,W,3]
    rays_d: torch.Tensor  # [1,H,W,3]
    c2w: torch.Tensor  # [1,4,4]
    elevation: torch.Tensor  # [1]
    azimuth: torch.Tensor  # [1]
    camera_distances: torch.Tensor  # [1]
    fovy: torch.Tensor  # [1] radians
    depth: Any = None  # [1,H,W,1] if requires_depth
    normal: Any = None  # [1,H,W,3] if requires_normal


def _camera_from_angles(elev_deg, azim_deg, distance):
    """z-up world, camera at (elevation, azimuth, distance) looking at the
    origin."""
    elev = np.deg2rad(elev_deg)
    azim = np.deg2rad(azim_deg)
    pos = np.array(
        [
            distance * np.cos(elev) * np.cos(azim),
            distance * np.cos(elev) * np.sin(azim),
            distance * np.sin(elev),
        ],
        np.float32,
    )
    up = np.array([0.0, 0.0, 1.0], np.float32)
    lookat = -pos
    lookat /= np.linalg.norm(lookat)
    right = np.cross(lookat, up)
    right /= np.linalg.norm(right)
    up2 = np.cross(right, lookat)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = up2
    c2w[:3, 2] = -lookat
    c2w[:3, 3] = pos
    return c2w


def _load_rgba(path: str, height: int, width: int):
    from PIL import Image

    with Image.open(path) as im:
        img = np.asarray(im).astype(np.float32) / 255.0
    if img.shape[:2] != (height, width):
        ys = (np.arange(height) * img.shape[0] / height).astype(int)
        xs = (np.arange(width) * img.shape[1] / width).astype(int)
        img = img[ys][:, xs]
    if img.shape[-1] == 4:
        rgb, mask = img[..., :3], img[..., 3:4]
        rgb = rgb * mask  # premultiplied, as the reference does
    else:
        rgb, mask = img[..., :3], np.ones_like(img[..., :1])
    return rgb, (mask > 0.5).astype(np.float32)


class SingleImageDataModule:
    """Holds the fixed reference view and hands out random-camera batches:
    `fixed_batch()` -> SingleImageBatch (the supervision view),
    `random_batch(generator, step)` -> CameraBatch for the guidance term."""

    def __init__(self, cfg: SingleImageConfig):
        self.cfg = cfg
        rgb, mask = _load_rgba(cfg.image_path, cfg.height, cfg.width)
        c2w = torch.from_numpy(_camera_from_angles(
            cfg.default_elevation_deg, cfg.default_azimuth_deg,
            cfg.default_camera_distance))
        fovy = float(np.deg2rad(cfg.default_fovy_deg))
        rays_o, rays_d = get_rays(c2w, fovy, cfg.height, cfg.width)
        depth = normal = None
        stem, _ = os.path.splitext(cfg.image_path)
        base = stem[: -len("_rgba")] if stem.endswith("_rgba") else stem
        if cfg.requires_depth:
            d, _ = _load_rgba(base + "_depth.png", cfg.height, cfg.width)
            depth = torch.from_numpy(np.ascontiguousarray(d[..., :1]))[None]
        if cfg.requires_normal:
            nrm, _ = _load_rgba(base + "_normal.png", cfg.height, cfg.width)
            normal = torch.from_numpy(nrm * 2.0 - 1.0)[None]

        def f32(*v):
            return torch.tensor(v, dtype=torch.float32)

        self._batch = SingleImageBatch(
            rgb=torch.from_numpy(np.ascontiguousarray(rgb))[None],
            mask=torch.from_numpy(mask)[None],
            rays_o=rays_o[None],
            rays_d=rays_d[None],
            c2w=c2w[None],
            elevation=f32(cfg.default_elevation_deg),
            azimuth=f32(cfg.default_azimuth_deg),
            camera_distances=f32(cfg.default_camera_distance),
            fovy=f32(fovy),
            depth=depth,
            normal=normal,
        )

    def fixed_batch(self) -> SingleImageBatch:
        return self._batch

    def random_batch(self, generator: torch.Generator | None, step: int,
                     draws: dict | None = None) -> CameraBatch:
        """The guidance term's camera batch at host `step`, drawn from
        `generator` unless `draws` (`camera_draws`' dict) are given."""
        if not self.cfg.use_random_camera:
            raise ValueError("use_random_camera is disabled")
        cam_cfg = self.cfg.random_camera
        if draws is None:
            draws = camera_draws(cam_cfg.batch_size, generator, device="cpu")
        return camera_batch_from_draws(draws, step, cam_cfg)
