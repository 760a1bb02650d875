"""Photo-supervised dataset loaders: Blender-synthetic and COLMAP.

Port (a plain numpy / PIL copy) of humangaussian_tpu/data/photo.py: loads
posed images for the photometric 3DGS trainer (train/photo.py).

- Blender / NeRF-synthetic: transforms_{split}.json with `camera_angle_x`
  and OpenGL c2w matrices; white or black background compositing for
  RGBA images.
- COLMAP: binary sparse model (cameras.bin / images.bin / points3D.bin)
  with PINHOLE / SIMPLE_PINHOLE cameras.

Images stay numpy arrays on the host; the trainer moves the one it
trains on to its device each step.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct

import numpy as np


@dataclasses.dataclass
class PosedImage:
    image: np.ndarray  # [H,W,3] float32 in [0,1]
    c2w: np.ndarray  # [4,4] OpenGL convention (x right, y up, z back)
    fovy: float  # radians
    fovx: float
    name: str = ""


@dataclasses.dataclass
class PhotoDataset:
    train: list
    test: list
    points: np.ndarray | None = None  # [M,3] sparse init points
    point_colors: np.ndarray | None = None  # [M,3] in [0,1]

    @property
    def extent(self) -> float:
        """Scene radius from the camera centers: 1.1 * max distance to
        the average center (upstream getNerfppNorm)."""
        centers = np.stack([p.c2w[:3, 3] for p in self.train])
        avg = centers.mean(0)
        return float(1.1 * np.linalg.norm(centers - avg, axis=1).max())


def _load_image(path: str, white_background: bool) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(path), np.float32) / 255.0
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        rgb, a = img[..., :3], img[..., 3:4]
        bg = 1.0 if white_background else 0.0
        img = rgb * a + bg * (1.0 - a)
    return img.astype(np.float32)


def load_blender(root: str, white_background: bool = False,
                 max_images: int | None = None) -> PhotoDataset:
    """NeRF-synthetic layout: transforms_train/test.json."""

    def load_split(split):
        path = os.path.join(root, f"transforms_{split}.json")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            meta = json.load(f)
        fovx = float(meta["camera_angle_x"])
        out = []
        frames = meta["frames"][:max_images] if max_images else meta["frames"]
        for frame in frames:
            fp = os.path.join(root, frame["file_path"])
            if not os.path.splitext(fp)[1]:
                fp = fp + ".png"
            img = _load_image(fp, white_background)
            h, w = img.shape[:2]
            focal = 0.5 * w / np.tan(0.5 * fovx)
            fovy = 2.0 * np.arctan(0.5 * h / focal)
            c2w = np.asarray(frame["transform_matrix"], np.float32)
            out.append(
                PosedImage(image=img, c2w=c2w, fovy=float(fovy), fovx=fovx,
                           name=os.path.basename(fp))
            )
        return out

    return PhotoDataset(train=load_split("train"), test=load_split("test"))


# ---- COLMAP binary sparse model ---------------------------------------

def _read_colmap_cameras_bin(path: str) -> dict:
    cams = {}
    model_params = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8}  # SIMPLE_PINHOLE..OPENCV
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model, w, h = struct.unpack("<iiQQ", f.read(24))
            num = model_params.get(model)
            if num is None:
                raise ValueError(f"unsupported COLMAP camera model {model}")
            params = struct.unpack(f"<{num}d", f.read(8 * num))
            cams[cam_id] = dict(model=model, width=w, height=h, params=params)
    return cams


def _read_colmap_images_bin(path: str) -> list:
    out = []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            img_id = struct.unpack("<I", f.read(4))[0]
            qw, qx, qy, qz, tx, ty, tz = struct.unpack("<7d", f.read(56))
            cam_id = struct.unpack("<I", f.read(4))[0]
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00":
                    break
                name += ch
            (n_pts,) = struct.unpack("<Q", f.read(8))
            f.read(24 * n_pts)  # skip 2D points
            out.append(
                dict(id=img_id, q=(qw, qx, qy, qz), t=(tx, ty, tz),
                     camera_id=cam_id, name=name.decode())
            )
    return out


def _read_colmap_points_bin(path: str):
    xyz, rgb = [], []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            f.read(8)  # point id
            x, y, z = struct.unpack("<3d", f.read(24))
            r, g, b = struct.unpack("<3B", f.read(3))
            f.read(8)  # error
            (track_len,) = struct.unpack("<Q", f.read(8))
            f.read(8 * track_len)
            xyz.append((x, y, z))
            rgb.append((r, g, b))
    return (
        np.asarray(xyz, np.float32),
        np.asarray(rgb, np.float32) / 255.0,
    )


def _qvec_to_rotmat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


def load_colmap(
    root: str, images_dir: str = "images", test_every: int = 8,
    max_images: int | None = None,
) -> PhotoDataset:
    """COLMAP layout: sparse/0/{cameras,images,points3D}.bin + images/."""
    sparse = os.path.join(root, "sparse", "0")
    cams = _read_colmap_cameras_bin(os.path.join(sparse, "cameras.bin"))
    images = _read_colmap_images_bin(os.path.join(sparse, "images.bin"))
    pts_path = os.path.join(sparse, "points3D.bin")
    points = colors = None
    if os.path.exists(pts_path):
        points, colors = _read_colmap_points_bin(pts_path)

    posed = []
    for meta in sorted(images, key=lambda m: m["name"]):
        cam = cams[meta["camera_id"]]
        img_path = os.path.join(root, images_dir, meta["name"])
        if not os.path.exists(img_path):
            continue
        img = _load_image(img_path, False)
        h, w = img.shape[:2]
        p = cam["params"]
        if cam["model"] == 0:  # SIMPLE_PINHOLE: f, cx, cy
            fx = fy = p[0]
        else:  # PINHOLE: fx, fy, cx, cy
            fx, fy = p[0], p[1]
        fovx = 2.0 * np.arctan(cam["width"] / (2.0 * fx))
        fovy = 2.0 * np.arctan(cam["height"] / (2.0 * fy))
        # COLMAP gives world->cam (y down, z forward); to OpenGL c2w
        r = _qvec_to_rotmat(meta["q"])
        t = np.asarray(meta["t"], np.float32)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = r
        w2c[:3, 3] = t
        c2w = np.linalg.inv(w2c)
        c2w[:3, 1:3] *= -1.0  # COLMAP -> OpenGL axes
        posed.append(
            PosedImage(image=img, c2w=c2w.astype(np.float32),
                       fovy=float(fovy), fovx=float(fovx), name=meta["name"])
        )
        if max_images and len(posed) >= max_images:
            break

    train = [p for i, p in enumerate(posed) if i % test_every != 0]
    test = [p for i, p in enumerate(posed) if i % test_every == 0]
    return PhotoDataset(train=train, test=test, points=points, point_colors=colors)
