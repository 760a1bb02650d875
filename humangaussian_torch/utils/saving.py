"""Artifact saving: images, captioned image grids, gif/mp4 export, metrics.

Port (a numpy/PIL copy) of humangaussian_tpu/utils/saving.py; images may
also be torch tensors on any device. mp4 goes through imageio when an
ffmpeg backend exists, otherwise the frames are written as a GIF.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def to_uint8(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    arr = np.asarray(img)
    return (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)


def save_image(path: str, img) -> str:
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = to_uint8(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    Image.fromarray(arr).save(path)
    return path


def _draw_banner(img: np.ndarray, text: str) -> np.ndarray:
    """A text banner over the top-left corner (white on a black shadow)."""
    from PIL import Image, ImageDraw

    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    x, y = 4, 2
    for line in str(text).split("\n"):
        draw.text((x + 1, y + 1), line, fill=(0, 0, 0))
        draw.text((x, y), line, fill=(255, 255, 255))
        y += 12
    return np.asarray(pil)


def save_image_grid(path: str, images, cols: int | None = None,
                    texts=None) -> str:
    """List of [H,W,3] (or [H,W]) images -> one grid image; `texts` (one
    per image, optional) draws caption banners."""
    images = [to_uint8(i) for i in images]
    n = len(images)
    cols = cols or n
    rows = -(-n // cols)
    h, w = images[0].shape[:2]
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, img in enumerate(images):
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        if texts is not None and i < len(texts) and texts[i]:
            img = _draw_banner(np.ascontiguousarray(img), texts[i])
        r, c = divmod(i, cols)
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = img
    return save_image(path, grid.astype(np.float32) / 255.0)


def save_gif(path: str, frames, fps: int = 30) -> str:
    """[T,H,W,3] float frames -> gif."""
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    imgs = [Image.fromarray(to_uint8(f)) for f in frames]
    imgs[0].save(
        path, save_all=True, append_images=imgs[1:],
        duration=int(1000 / fps), loop=0,
    )
    return path


def save_video(path: str, frames, fps: int = 30) -> str:
    """[T,H,W,3] float frames -> mp4 (when imageio has an ffmpeg backend)
    else gif next to it. Returns the path written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    frames8 = [to_uint8(f) for f in frames]
    if path.endswith(".mp4"):
        try:
            import imageio

            imageio.mimwrite(path, frames8, fps=fps)
            return path
        except (ImportError, ValueError, RuntimeError, OSError):
            # no imageio or no ffmpeg backend: fall back to GIF
            path = path[:-4] + ".gif"
    return save_gif(path, frames, fps)


def save_metrics_csv(path: str, rows: list[dict]) -> str:
    """Rows of scalars -> one CSV with the union of their keys (sorted)."""
    import csv

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if not rows:
        return path
    keys = sorted({k for r in rows for k in r})
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=keys)
        writer.writeheader()
        writer.writerows(rows)
    return path
