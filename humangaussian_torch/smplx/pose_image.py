"""Skeleton pose images, drawn for a whole camera batch in one pass.

Port of humangaussian_tpu/smplx/pose_image.py. The pose image conditions
the dual-branch prior:

- humansd style (`draw_humansd_pose`): 16 bones drawn in order, each a
  capsule of radius w/2 with w = int(10 H / 512), coloured from the
  16-colour "hls" palette quantized to uint8 levels; a later bone
  overwrites an earlier one. Keypoints project through the MVP with
  x = (ndc_x + 1) / 2 * H and y = (ndc_y + 1) / 2 * W, and are floored
  before drawing, as cv2 truncates them.
- openpose style (`draw_openpose_pose`): 18 keypoint circles of radius 4,
  then 17 bone ellipses (semi-axes len/2 and 4) blended at 0.6 over the
  canvas in draw order.
- Occlusion (back views, |azimuth| > 120 degrees in the system): the
  nose, eyes and ears are hidden by the nose's depth against the ears'.

Where the JAX functions draw one camera under `vmap`, these take the
batch: keypoints [K, 3], mvp [B, 4, 4] and a per-camera occlusion flag
[B], and draw every bone of every camera in one [B, bones, H, W] pass on
the mvp's device (no Python loop over bones or cameras). The last bone
covering a pixel wins: the largest covering bone index. Given the same
floored keypoints the capsule test is the JAX one operation for operation,
with the fused multiply-adds that the reference's CPU compiler forms
(`_fma`), so the humansd images agree bit for bit. The openpose ellipses
also go through the reference's atan2, cos and sin, which are not
correctly rounded: an edge pixel of an ellipse may flip, and the blended
colours differ by float32 ulps (summation order). `draw_humansd_keypoints`
and `draw_openpose_keypoints` take keypoints directly.
"""
from __future__ import annotations

import colorsys

import numpy as np
import torch

from humangaussian_torch.smplx.skeleton import OPENPOSE18_LINES
from humangaussian_torch.utils.profiling import trace_annotation

# (color_index, joint_a, joint_b) in draw order
HUMANSD_SKELETON = (
    (1, 0, 1), (0, 0, 2), (3, 1, 3), (2, 2, 4), (5, 3, 5), (4, 4, 6),
    (7, 5, 7), (6, 6, 8), (9, 7, 9), (8, 8, 10), (11, 5, 11), (10, 6, 12),
    (13, 11, 13), (12, 12, 14), (15, 13, 15), (14, 14, 16),
)

# openpose colours (controlnet_aux's table)
OPENPOSE_COLORS = np.array(
    [
        [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
        [170, 255, 0], [85, 255, 0], [0, 255, 0], [0, 255, 85],
        [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
        [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255],
        [255, 0, 170], [255, 0, 85],
    ],
    np.float32,
) / 255.0


def humansd_colors(n: int = 16) -> np.ndarray:
    """seaborn's color_palette("hls", n) (h = .01, l = .6, s = .65),
    quantized to the uint8 levels cv2 draws with."""
    hues = np.linspace(0, 1, n + 1)[:-1]
    hues = (hues + 0.01) % 1.0
    rgb = np.array(
        [colorsys.hls_to_rgb(h, 0.6, 0.65) for h in hues], np.float32
    )
    return np.floor(255.0 * rgb) / 255.0


_HUMANSD_COLORS = humansd_colors(len(HUMANSD_SKELETON))


def project_keypoints(points3d: torch.Tensor, mvp: torch.Tensor,
                      height: int, width: int):
    """[K,3] world keypoints and [B,4,4] MVPs -> pixel xs, ys and NDC depth,
    each [B, K]. H scales x and W scales y (square images in practice)."""
    k = points3d.shape[0]
    hom = torch.cat([points3d, torch.ones((k, 1), dtype=points3d.dtype,
                                          device=points3d.device)], dim=1)
    p = hom @ mvp.transpose(-1, -2)  # [B, K, 4]
    ndc = p[..., :3] / p[..., 3:4]
    xs = (ndc[..., 0] + 1.0) / 2.0 * height
    ys = (ndc[..., 1] + 1.0) / 2.0 * width
    return xs, ys, ndc[..., 2]


def humansd_occlusion_conf(xs, zs, enable) -> torch.Tensor:
    """[B, K] keypoint confidences after the head-occlusion rules, where
    `enable` [B] is set. Index layout: 0 nose, 1 leye, 2 reye, 3 lear,
    4 rear."""
    left_view = (zs[:, 0] > zs[:, 3]) & (zs[:, 0] < zs[:, 4])
    right_view = (zs[:, 0] < zs[:, 3]) & (zs[:, 0] > zs[:, 4])
    back_view = (zs[:, 0] > zs[:, 3]) & (zs[:, 0] > zs[:, 4])
    hide = torch.zeros(xs.shape, dtype=torch.bool, device=xs.device)
    hide[:, 4] = left_view
    hide[:, 2] = left_view & (xs[:, 2] > xs[:, 1])
    hide[:, 3] = right_view
    hide[:, 1] = right_view & (xs[:, 1] < xs[:, 2])
    hide[:, :3] |= back_view[:, None]
    return torch.where(hide & enable[:, None], 0.0, 1.0)


def _fma(a, b, c):
    """a * b + c with one float32 rounding, as a fused multiply-add gives
    it (the float64 product of two float32 values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _segment_dist2(px, py, ax, ay, bx, by):
    """Squared distance from pixel centres to the segment a-b, rounded as
    the reference computes it on the CPU: its compiler contracts
    `apx - t * abx` and `dx * dx + dy * dy` into fused multiply-adds, and a
    pixel on the capsule's edge takes the side their rounding gives."""
    abx, aby = bx - ax, by - ay
    apx, apy = px - ax, py - ay
    denom = torch.clamp_min(abx * abx + aby * aby, 1e-8)
    t = torch.clamp((apx * abx + apy * aby) / denom, 0.0, 1.0)
    dx = _fma(-t, abx, apx)
    dy = _fma(-t, aby, apy)
    return _fma(dx, dx, dy * dy)


def _grid(height, width, device):
    """Pixel x [1, 1, 1, W] and y [1, 1, H, 1] coordinates, float32."""
    xx = torch.arange(width, dtype=torch.float32, device=device)
    yy = torch.arange(height, dtype=torch.float32, device=device)
    return xx.view(1, 1, 1, width), yy.view(1, 1, height, 1)


def _last_cover(mask):
    """[B, n, H, W] bool -> the largest covering index [B, H, W] (-1 where
    none covers): cv2's in-order drawing, the last one wins."""
    n = mask.shape[1]
    idx = torch.arange(n, dtype=torch.int16, device=mask.device)
    return torch.where(mask, idx.view(1, n, 1, 1), -1).amax(dim=1)


def _paint(winner, colors):
    """[B, H, W] winner indices -> [B, H, W, 3] colours, black where -1."""
    img = colors[winner.clamp_min(0).long()]
    return torch.where((winner >= 0)[..., None], img, 0.0)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array copied to `device` (a blocking copy on the card)."""
    with trace_annotation("hg.read.pose_image"):
        return torch.from_numpy(a).to(device)


def draw_humansd_keypoints(xs, ys, conf, height: int, width: int):
    """humansd-style images [B, H, W, 3] from pixel keypoints xs, ys and
    confidences conf, each [B, 17]."""
    w_line = int(10 * height / 512)
    r = w_line / 2.0
    ixs, iys = torch.floor(xs), torch.floor(ys)
    skel = np.asarray(HUMANSD_SKELETON, np.int64)
    ci, ia, ib = (_to_device(skel[:, i], xs.device) for i in range(3))
    ok = (conf[:, ia] > 0.3) & (conf[:, ib] > 0.3)  # [B, bones]
    xx, yy = _grid(height, width, xs.device)

    def at(v, j):
        return v[:, j][..., None, None]

    d2 = _segment_dist2(xx, yy, at(ixs, ia), at(iys, ia), at(ixs, ib),
                        at(iys, ib))
    mask = ok[..., None, None] & (d2 <= r * r)  # [B, bones, H, W]
    colors = _to_device(_HUMANSD_COLORS, xs.device)[ci]
    return _paint(_last_cover(mask), colors)


def draw_humansd_pose(points3d, mvp, height: int = 512, width: int = 512,
                      enable_occlusion=None):
    """humansd-style pose images of a camera batch.

    points3d [17, 3]; mvp [B, 4, 4]; enable_occlusion [B] bool (None: off).
    Returns (images [B, H, W, 3] in [0, 1], keypoints [B, 17, 3] = (x, y,
    conf))."""
    xs, ys, zs = project_keypoints(points3d, mvp, height, width)
    if enable_occlusion is None:
        enable_occlusion = torch.zeros(xs.shape[0], dtype=torch.bool,
                                       device=xs.device)
    conf = humansd_occlusion_conf(xs, zs, enable_occlusion)
    canvas = draw_humansd_keypoints(xs, ys, conf, height, width)
    return canvas, torch.stack([xs, ys, conf], dim=-1)


def openpose_keypoint_mask(xs, ys, zs, height, width, enable):
    """[B, 18] visibility: inside the image, times the occlusion rules where
    `enable` [B] is set (layout: 0 nose, -4 reye, -3 leye, -2 rear, -1
    lear)."""
    mask_kp = ((xs >= 0) & (xs < height) & (ys >= 0)
               & (ys < width)).to(torch.float32)
    left_view = (zs[:, 0] > zs[:, -1]) & (zs[:, 0] < zs[:, -2])
    right_view = (zs[:, 0] < zs[:, -1]) & (zs[:, 0] > zs[:, -2])
    back_view = (zs[:, 0] > zs[:, -1]) & (zs[:, 0] > zs[:, -2])
    hide = torch.zeros(xs.shape, dtype=torch.bool, device=xs.device)
    hide[:, -2] = left_view
    hide[:, -4] = left_view & (xs[:, -4] > xs[:, -3])
    hide[:, -1] = right_view
    hide[:, -3] = right_view & (xs[:, -3] < xs[:, -4])
    for i in (0, -3, -4):
        hide[:, i] |= back_view
    return mask_kp * torch.where(hide & enable[:, None], 0.0, 1.0)


def draw_openpose_keypoints(xs, ys, mask_kp, height: int, width: int):
    """openpose-style images [B, H, W, 3] from pixel keypoints xs, ys and
    visibilities mask_kp, each [B, 18]."""
    dev = xs.device
    xx, yy = _grid(height, width, dev)
    ixs, iys = torch.floor(xs), torch.floor(ys)
    colors = _to_device(OPENPOSE_COLORS, dev)

    # keypoint circles, radius 4; the highest covering index wins
    d2 = ((xx - ixs[..., None, None]) ** 2
          + (yy - iys[..., None, None]) ** 2)
    maskc = (mask_kp[..., None, None] > 0) & (d2 <= 16.0)
    canvas = _paint(_last_cover(maskc), colors)

    # bone ellipses blended at 0.6 in draw order. The sequential blend
    # canvas <- mask_i ? 0.4 canvas + 0.6 c_i : canvas has the closed form
    # canvas0 prod_i w_i + sum_i 0.6 k_i c_i prod_{j>i} w_j with
    # k_i = mask_i and w_i = 1 - 0.6 k_i, one [B, 17, H, W] pass
    lines = _to_device(np.asarray(OPENPOSE18_LINES, np.int64), dev)
    a, b = lines[:, 0], lines[:, 1]
    ok = (mask_kp[:, a] > 0) & (mask_kp[:, b] > 0)  # [B, 17]
    mx = torch.floor((ixs[:, a] + ixs[:, b]) / 2.0)[..., None, None]
    my = torch.floor((iys[:, a] + iys[:, b]) / 2.0)[..., None, None]
    dxl = ixs[:, a] - ixs[:, b]
    dyl = iys[:, a] - iys[:, b]
    length = torch.sqrt((dxl * dxl + dyl * dyl).double()).float()
    ang = torch.arctan2(dyl, dxl)
    ca = torch.cos(ang)[..., None, None]
    sa = torch.sin(ang)[..., None, None]
    # the reference's contractions into fused multiply-adds (see
    # _segment_dist2) and its correctly rounded sqrt; its atan2 / cos / sin
    # are not correctly rounded and differ from torch's by an ulp on some
    # angles, which can move a pixel on an ellipse's edge
    rx = _fma(xx - mx, ca, (yy - my) * sa)
    ry = _fma(yy - my, ca, -(xx - mx) * sa)
    semi = torch.clamp_min(length / 2.0, 1e-3)[..., None, None]
    q = rx / semi
    r4 = ry / 4.0
    inside = _fma(q, q, r4 * r4) <= 1.0
    k = (ok[..., None, None] & inside).to(torch.float32)  # [B, 17, H, W]
    w = 1.0 - 0.6 * k
    sp = torch.cumprod(w.flip(1), dim=1).flip(1)  # prod_{j>=i} w_j
    suffix = sp / w  # prod_{j>i} w_j (w is 1 or 0.4, never 0)
    return canvas * sp[:, 0, ..., None] + torch.einsum(
        "bkhw,kc->bhwc", 0.6 * k * suffix, colors[: lines.shape[0]])


def draw_openpose_pose(points3d, mvp, height: int = 512, width: int = 512,
                       enable_occlusion=None):
    """openpose-style pose images of a camera batch (see
    `draw_humansd_pose`). Returns (images, keypoints [B, 18, 3])."""
    xs, ys, zs = project_keypoints(points3d, mvp, height, width)
    if enable_occlusion is None:
        enable_occlusion = torch.zeros(xs.shape[0], dtype=torch.bool,
                                       device=xs.device)
    mask_kp = openpose_keypoint_mask(xs, ys, zs, height, width,
                                     enable_occlusion)
    canvas = draw_openpose_keypoints(xs, ys, mask_kp, height, width)
    return canvas, torch.stack([xs, ys, mask_kp], dim=-1)
