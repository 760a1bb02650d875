"""Multiview-frames datamodule (posed-video reconstruction).

Port (a plain numpy / PIL copy) of humangaussian_tpu/data/multiview.py:
reads an instant-ngp style `transforms.json` (OPENCV camera model,
per-frame `transform_matrix` / fl_x / fl_y / cx / cy) from `dataroot`,
recentres the camera cloud per `camera_layout` ("around" subtracts the
mean position, "front" also pushes along the mean -z by
`camera_distance`), downsamples the frames (nearest) and serves one posed
image with its rays per step. Eval views interpolate between two train
poses (a position lerp and a rotation lerp projected back onto SO(3)).

`as_photo_dataset` adapts the frames to the photometric 3DGS trainer
(train/photo.py), which renders each on the card. Frames stay numpy
arrays on the host, as in data/photo.py; PNGs are read with PIL where the
JAX module uses imageio (the same pixels).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MultiviewConfig:
    """The JAX MultiviewConfig, same defaults."""

    dataroot: str = ""
    train_downsample_resolution: int = 4
    eval_downsample_resolution: int = 4
    train_data_interval: int = 1
    eval_data_interval: int = 1
    camera_layout: str = "around"  # "around" | "front"
    camera_distance: float = -1.0
    eval_interpolation: tuple | None = None  # (idx0, idx1, steps)


class MultiviewFrame(NamedTuple):
    rgb: np.ndarray  # [H,W,3]
    c2w: np.ndarray  # [4,4] OPENCV convention
    intrinsic: np.ndarray  # [4,4] (fx, fy, cx, cy at downsampled scale)
    rays_o: np.ndarray  # [H,W,3]
    rays_d: np.ndarray  # [H,W,3]


def _rays_from_intrinsic(c2w, intrinsic, h, w):
    """OPENCV-model rays (x right, y down, z forward) rotated to world."""
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    xs = (np.arange(w, dtype=np.float32) + 0.5 - cx) / fx
    ys = (np.arange(h, dtype=np.float32) + 0.5 - cy) / fy
    xx, yy = np.meshgrid(xs, ys)
    dirs = np.stack([xx, yy, np.ones_like(xx)], axis=-1)
    dirs = dirs @ c2w[:3, :3].T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-9
    origins = np.broadcast_to(c2w[:3, 3], dirs.shape)
    return origins.astype(np.float32), dirs.astype(np.float32)


def _resize_nearest(img, h, w):
    ys = (np.arange(h) * img.shape[0] / h).astype(int)
    xs = (np.arange(w) * img.shape[1] / w).astype(int)
    return img[ys][:, xs]


def interpolate_pose(c2w0, c2w1, ratio):
    """Position lerp plus rotation lerp re-orthonormalized through the SVD."""
    pos = (1 - ratio) * c2w0[:3, 3] + ratio * c2w1[:3, 3]
    r = (1 - ratio) * c2w0[:3, :3] + ratio * c2w1[:3, :3]
    u, _, vt = np.linalg.svd(r)
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = u @ vt
    out[:3, 3] = pos
    return out


class MultiviewDataModule:
    def __init__(self, cfg: MultiviewConfig):
        from PIL import Image

        self.cfg = cfg
        with open(os.path.join(cfg.dataroot, "transforms.json")) as f:
            camera_dict = json.load(f)
        if camera_dict.get("camera_model", "OPENCV") != "OPENCV":
            raise ValueError("only the OPENCV camera model is supported")
        frames = camera_dict["frames"][:: cfg.train_data_interval]
        scale = cfg.train_downsample_resolution
        self.height = int(frames[0]["h"]) // scale
        self.width = int(frames[0]["w"]) // scale

        c2w_list = np.stack(
            [np.asarray(f["transform_matrix"], np.float32) for f in frames])
        c2w_list[:, :3, 3] -= c2w_list[:, :3, 3].mean(0, keepdims=True)
        if cfg.camera_layout == "front":
            if cfg.camera_distance <= 0:
                raise ValueError("front layout needs camera_distance > 0")
            z = np.array([0.0, 0.0, -1.0], np.float32)
            rot_z = (c2w_list[:, :3, :3] @ z).mean(0)
            c2w_list[:, :3, 3] -= rot_z * cfg.camera_distance
        elif cfg.camera_layout != "around":
            raise ValueError(f"unknown camera layout {cfg.camera_layout!r}")

        self.frames: list[MultiviewFrame] = []
        for i, fr in enumerate(frames):
            intr = np.eye(4, dtype=np.float32)
            intr[0, 0] = fr["fl_x"] / scale
            intr[1, 1] = fr["fl_y"] / scale
            intr[0, 2] = fr["cx"] / scale
            intr[1, 2] = fr["cy"] / scale
            with Image.open(os.path.join(cfg.dataroot, fr["file_path"])) as im:
                img = np.asarray(im).astype(np.float32) / 255.0
            img = _resize_nearest(img[..., :3], self.height, self.width)
            o, d = _rays_from_intrinsic(c2w_list[i], intr, self.height,
                                        self.width)
            self.frames.append(MultiviewFrame(rgb=img, c2w=c2w_list[i],
                                              intrinsic=intr, rays_o=o,
                                              rays_d=d))

    def as_photo_dataset(self, test_every: int = 8):
        """The posed frames as train/photo.py's PhotoDataset (OpenGL c2w;
        every `test_every`-th frame, from the first, is a test view)."""
        from humangaussian_torch.data.photo import PhotoDataset, PosedImage

        cv2gl = np.diag(np.array([1.0, -1.0, -1.0, 1.0], np.float32))
        posed = []
        for i, fr in enumerate(self.frames):
            fovy = 2.0 * np.arctan(0.5 * self.height / fr.intrinsic[1, 1])
            fovx = 2.0 * np.arctan(0.5 * self.width / fr.intrinsic[0, 0])
            posed.append(PosedImage(
                image=np.asarray(fr.rgb, np.float32),
                c2w=(fr.c2w @ cv2gl).astype(np.float32),
                fovy=float(fovy), fovx=float(fovx), name=f"frame_{i}",
            ))
        train = [p for i, p in enumerate(posed) if i % test_every != 0]
        test = [p for i, p in enumerate(posed) if i % test_every == 0]
        return PhotoDataset(train=train or posed, test=test)

    def __len__(self):
        return len(self.frames)

    def train_frame(self, step: int) -> MultiviewFrame:
        """Deterministic round-robin (batch size 1)."""
        return self.frames[step % len(self.frames)]

    def eval_poses(self):
        """Interpolated eval trajectory (or the train poses)."""
        cfg = self.cfg
        if cfg.eval_interpolation is None:
            return [f.c2w for f in self.frames]
        i0, i1, steps = cfg.eval_interpolation
        a, b = self.frames[i0].c2w, self.frames[i1].c2w
        return [interpolate_pose(a, b, r)
                for r in np.linspace(0.0, 1.0, int(steps))]
