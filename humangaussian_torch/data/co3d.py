"""CO3D sequence datamodule.

Port (a plain numpy / PIL copy) of humangaussian_tpu/data/co3d.py: loads
one CO3D-v2 sequence (`root_dir = <category>/<sequence>`) from the
dataset's `frame_annotations.jgz`, converts PyTorch3D NDC cameras to
OpenCV pixel intrinsics (the `v2_mode` correction for NDC-isotropic
cameras), builds c2w matrices with the PyTorch3D -> OpenCV axis flip,
filters size / pose outliers, applies the similarity-from-cameras
normalization (up-axis alignment, centre-ray recentring, median-distance
rescale), optionally crops each frame around its foreground-mask box with
context, resizes to the configured resolution (bilinear, PIL) and serves
numpy frames with OpenGL c2w. Depth maps use CO3D's float16-in-uint16
PNG encoding (`load_f16_depth_png`).

`as_photo_dataset` adapts the sequence to the photometric 3DGS trainer
(train/photo.py), which renders each frame on the card. The frames stay
numpy arrays on the host, as in data/photo.py.
"""
from __future__ import annotations

import dataclasses
import gzip
import json
import os
from typing import NamedTuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Co3dConfig:
    """Mirrors Co3dDataModuleConfig (threestudio co3d.py:193-216)."""

    root_dir: str = ""
    height: int = 256
    width: int = 256
    cam_scale_factor: float = 0.95
    max_num_frames: int = 300
    v2_mode: bool = True
    use_mask: bool = True
    box_crop: bool = True
    box_crop_mask_thr: float = 0.4
    box_crop_context: float = 0.3
    scale_radius: float = 1.0
    train_split: str = "train"


class Co3dFrame(NamedTuple):
    rgb: np.ndarray  # [H,W,3] float32
    depth: np.ndarray  # [H,W] float32 (0 where invalid)
    mask: np.ndarray  # [H,W] float32
    c2w: np.ndarray  # [4,4] OpenGL convention
    intrinsic: np.ndarray  # [4,4]
    rays_o: np.ndarray  # [H,W,3]
    rays_d: np.ndarray  # [H,W,3]


def load_f16_depth_png(path: str) -> np.ndarray:
    """CO3D 16-bit depth PNGs hold float16 bits (threestudio co3d.py:33-42)."""
    from PIL import Image

    with Image.open(path) as im:
        d = (
            np.frombuffer(
                np.array(im, dtype=np.uint16).tobytes(), dtype=np.float16
            )
            .astype(np.float32)
            .reshape(im.size[1], im.size[0])
        )
    d = d.copy()
    d[~np.isfinite(d)] = 0.0
    return d


def bbox_from_mask(mask, thr, decrease_quant=0.05):
    """xywh bbox of mask>thr, lowering thr until non-empty
    (threestudio co3d.py:60-73)."""
    sel = np.zeros_like(mask)
    while sel.sum() <= 1.0 and thr > 0.0:
        sel = (mask > thr).astype(np.float32)
        thr -= decrease_quant
    if sel.sum() <= 1.0:
        return 0, 0, mask.shape[1], mask.shape[0]
    xs = np.flatnonzero(sel.sum(axis=0))
    ys = np.flatnonzero(sel.sum(axis=1))
    return xs[0], ys[0], xs[-1] - xs[0], ys[-1] - ys[0]


def clamp_bbox(bbox_xywh, context=0.0):
    """Expand by `context` and convert to xyxy (threestudio co3d.py:75-97)."""
    x, y, w, h = [float(v) for v in bbox_xywh]
    if context > 0.0:
        c = context / 2.0
        x -= w * c
        y -= h * c
        w += w * context
        h += h * context
    return max(x, 0.0), max(y, 0.0), x + w, y + h


def similarity_from_cameras(c2w, radius=1.0):
    """Up-axis alignment + center-ray recenter + scale (threestudio
    co3d.py:132-190), c2w in OpenCV convention."""
    t = c2w[:, :3, 3]
    r = c2w[:, :3, :3]
    ups = np.sum(r * np.array([0, -1.0, 0]), axis=-1)
    world_up = ups.mean(axis=0)
    world_up /= np.linalg.norm(world_up)
    up_cam = np.array([0.0, 0.0, 1.0])
    c = float((up_cam * world_up).sum())
    cross = np.cross(world_up, up_cam)
    skew = np.array(
        [
            [0.0, -cross[2], cross[1]],
            [cross[2], 0.0, -cross[0]],
            [-cross[1], cross[0], 0.0],
        ]
    )
    if c > -1:
        r_align = np.eye(3) + skew + (skew @ skew) / (1 + c)
    else:
        r_align = np.diag([-1.0, 1.0, 1.0])
    r = r_align @ r
    fwds = np.sum(r * np.array([0.0, 0.0, 1.0]), axis=-1)
    t = (r_align @ t[..., None])[..., 0]
    nearest = t + (fwds * -t).sum(-1)[:, None] * fwds
    translate = -np.median(nearest, axis=0)
    transform = np.eye(4)
    transform[:3, 3] = translate
    transform[:3, :3] = r_align
    scale = radius / np.median(np.linalg.norm(t + translate, axis=-1))
    return transform, scale


def _resize_bilinear(img, h, w):
    from PIL import Image

    arr = np.asarray(img, np.float32)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[..., None]
    chans = [
        np.asarray(
            Image.fromarray(arr[..., c]).resize((w, h), Image.BILINEAR)
        )
        for c in range(arr.shape[-1])
    ]
    out = np.stack(chans, axis=-1).astype(np.float32)
    scale = w / img.shape[1]
    return (out[..., 0] if squeeze else out), scale


def _rays(c2w_gl, fx, fy, cx, cy, h, w):
    """OpenGL-convention rays (x right, y up, camera looks down -z)."""
    xs = (np.arange(w, dtype=np.float32) + 0.5 - cx) / fx
    ys = (np.arange(h, dtype=np.float32) + 0.5 - cy) / fy
    xx, yy = np.meshgrid(xs, ys)
    dirs = np.stack([xx, -yy, -np.ones_like(xx)], axis=-1)
    dirs = dirs @ c2w_gl[:3, :3].T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-9
    origins = np.broadcast_to(c2w_gl[:3, 3], dirs.shape).astype(np.float32)
    return origins, dirs.astype(np.float32)


class Co3dDataModule:
    """Precomputes all frames of one CO3D sequence (threestudio
    co3d.py:218-523)."""

    def __init__(self, cfg: Co3dConfig):
        from PIL import Image

        self.cfg = cfg
        seq = cfg.root_dir.rstrip("/").split("/")[-1]
        ann = os.path.join(cfg.root_dir, "..", "frame_annotations.jgz")
        with gzip.open(ann, "r") as fp:
            all_frames = json.load(fp)
        frames = [f for f in all_frames if f["sequence_name"] == seq]

        cam_trans = np.diag(np.array([-1, -1, 1, 1], np.float32))
        imgs, depths, masks, exts, intr, sizes = [], [], [], [], [], []
        for fr in frames:
            if "unseen" in fr.get("meta", {}).get("frame_type", ""):
                continue
            base = os.path.join(cfg.root_dir, "..", "..")
            img = (
                np.asarray(
                    Image.open(os.path.join(base, fr["image"]["path"]))
                    .convert("RGB"),
                    np.float32,
                )
                / 255.0
            )
            h, w = fr["image"]["size"]
            fxy = np.array(fr["viewpoint"]["focal_length"], np.float32)
            cxy = np.array(fr["viewpoint"]["principal_point"], np.float32)
            rot = np.array(fr["viewpoint"]["R"], np.float32)
            tr = np.array(fr["viewpoint"]["T"], np.float32)
            if cfg.v2_mode:
                # NDC-isotropic -> NDC per-axis (threestudio co3d.py:305-312)
                min_hw = min(w, h)
                half = np.array([w * 0.5, h * 0.5], np.float32)
                s = np.array([min_hw * 0.5, min_hw * 0.5], np.float32)
                fxy_px = fxy * s
                prp_px = half - cxy * s
                cxy = (half - prp_px) / half
                fxy = fxy_px / half
            s = np.array([w * 0.5, h * 0.5], np.float32)
            focal = fxy * s
            prp = -1.0 * (cxy - 1.0) * s
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = rot
            pose[:3, 3:] = -rot @ tr[..., None]
            pose = pose @ cam_trans  # PyTorch3D -> OpenCV
            if any(np.all(pose == e) for e in exts):
                continue
            depth = np.zeros((h, w), np.float32)
            if fr.get("depth") and fr["depth"].get("path"):
                p = os.path.join(base, fr["depth"]["path"])
                if os.path.exists(p):
                    depth = load_f16_depth_png(p) * float(
                        fr["depth"].get("scale_adjustment", 1.0)
                    )
            if cfg.use_mask and fr.get("mask") and fr["mask"].get("path"):
                m = (
                    np.asarray(
                        Image.open(os.path.join(base, fr["mask"]["path"])),
                        np.float32,
                    )
                    / 255.0
                )
                if m.ndim == 3:
                    m = m[..., 0]
            else:
                m = np.ones((h, w), np.float32)
            imgs.append(img)
            depths.append(depth)
            masks.append(m)
            exts.append(pose)
            k = np.eye(4, dtype=np.float32)
            k[0, 0], k[1, 1] = focal
            k[0, 2], k[1, 2] = prp
            intr.append(k)
            sizes.append((h, w))

        if not imgs:
            raise ValueError(f"no frames found for sequence {seq!r}")

        sizes = np.array(sizes, np.float32)
        exts = np.stack(exts)
        # inlier filter (threestudio co3d.py:338-359)
        med_hw = np.median(sizes, axis=0)
        inlier = np.all(np.abs(sizes - med_hw) / med_hw < 0.1, axis=1)
        dists = np.linalg.norm(
            exts[:, :3, 3] - np.median(exts[:, :3, 3], axis=0), axis=-1
        )
        inlier &= dists < np.median(dists) * 5.0
        if inlier.sum():
            keep = np.flatnonzero(inlier)
        else:
            keep = np.arange(len(imgs))
        keep = keep[: cfg.max_num_frames]
        imgs = [imgs[i] for i in keep]
        depths = [depths[i] for i in keep]
        masks = [masks[i] for i in keep]
        intr = [intr[i] for i in keep]
        exts = exts[keep]

        t, sscale = similarity_from_cameras(exts, radius=cfg.scale_radius)
        exts = t @ exts
        exts[:, :3, 3] *= sscale * cfg.cam_scale_factor
        depths = [d * sscale * cfg.cam_scale_factor for d in depths]

        self.frames: list[Co3dFrame] = []
        gl_flip = np.diag(np.array([1, -1, -1, 1], np.float32))
        for i in range(len(imgs)):
            img, depth, m, k = imgs[i], depths[i], masks[i], intr[i]
            fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
            if cfg.box_crop:
                bb = clamp_bbox(
                    bbox_from_mask(m, cfg.box_crop_mask_thr),
                    cfg.box_crop_context,
                )
                x0, y0, x1, y1 = [int(round(v)) for v in bb]
                x1 = min(x1, img.shape[1])
                y1 = min(y1, img.shape[0])
                img = img[y0:y1, x0:x1]
                if depth.shape == m.shape:
                    depth = depth[y0:y1, x0:x1]
                m = m[y0:y1, x0:x1]
                cx, cy = cx - x0, cy - y0
            img, scale = _resize_bilinear(img, cfg.height, cfg.width)
            m, _ = _resize_bilinear(m, cfg.height, cfg.width)
            if depth.size:
                depth, _ = _resize_bilinear(depth, cfg.height, cfg.width)
            else:
                depth = np.zeros((cfg.height, cfg.width), np.float32)
            fx, fy, cx, cy = fx * scale, fy * scale, cx * scale, cy * scale
            c2w_gl = (exts[i] @ gl_flip).astype(np.float32)
            rays_o, rays_d = _rays(
                c2w_gl, fx, fy, cx, cy, cfg.height, cfg.width
            )
            k2 = np.eye(4, dtype=np.float32)
            k2[0, 0], k2[1, 1], k2[0, 2], k2[1, 2] = fx, fy, cx, cy
            self.frames.append(
                Co3dFrame(img, depth, m, c2w_gl, k2, rays_o, rays_d)
            )

    def as_photo_dataset(self, test_every: int = 8):
        """Adapt one CO3D sequence to train/photo.py's PhotoDataset (the
        frames already carry OpenGL c2w): photometric 3DGS from CO3D."""
        from humangaussian_torch.data.photo import PhotoDataset, PosedImage

        posed = []
        for i, fr in enumerate(self.frames):
            k = np.asarray(fr.intrinsic)
            h, w = np.asarray(fr.rgb).shape[:2]
            posed.append(PosedImage(
                image=np.asarray(fr.rgb, np.float32),
                c2w=np.asarray(fr.c2w, np.float32),
                fovy=float(2.0 * np.arctan(0.5 * h / k[1, 1])),
                fovx=float(2.0 * np.arctan(0.5 * w / k[0, 0])),
                name=f"frame_{i}",
            ))
        train = [p for i, p in enumerate(posed) if i % test_every != 0]
        test = [p for i, p in enumerate(posed) if i % test_every == 0]
        return PhotoDataset(train=train or posed, test=test)

    def __len__(self):
        return len(self.frames)

    def train_frame(self, step: int) -> Co3dFrame:
        return self.frames[step % len(self.frames)]
