"""Skeleton: SMPL-X keypoints, scene-init surface sampling, pose metadata.

Port of humangaussian_tpu/smplx/skeleton.py. The skeleton owns the
canonical keypoint set (humansd-17 or openpose-18), maps SMPL-X joints to
it, applies the normalization chain (centre on the bounding box, scale to
a 0.6 box, swap y and z, then the system's `scale(-10)`, a factor of
1.1^10) and samples surface points for the Gaussian scene's
initialization (area-weighted triangle sampling).

The SMPL-X forward runs once, on the CPU, through the port's
`smplx/lbs.py::lbs_forward`; the skeleton then holds numpy arrays, as the
JAX one does. The keypoint index tables, `APOSE_BODY_POSE` and
`sample_mesh_surface` are the port's own copies, so the same seed gives
bit-equal points on the same vertices. The drawing lives in
smplx/pose_image.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from humangaussian_torch.smplx.model import SMPLXModel

# SMPL-X (55 joints + landmarks) -> openpose-18
OPENPOSE18_FROM_SMPLX = np.array(
    [55, 12, 17, 19, 21, 16, 18, 20, 2, 5, 8, 1, 4, 7, 56, 57, 58, 59],
    dtype=np.int32,
)
OPENPOSE18_NAMES = (
    "nose", "neck", "right_shoulder", "right_elbow", "right_wrist",
    "left_shoulder", "left_elbow", "left_wrist", "right_hip", "right_knee",
    "right_ankle", "left_hip", "left_knee", "left_ankle", "right_eye",
    "left_eye", "right_ear", "left_ear",
)
OPENPOSE18_LINES = np.array(
    [[0, 1], [1, 2], [2, 3], [3, 4], [1, 5], [5, 6], [6, 7], [1, 8],
     [8, 9], [9, 10], [1, 11], [11, 12], [12, 13], [0, 14], [14, 16],
     [0, 15], [15, 17]],
    dtype=np.int32,
)

# SMPL-X -> humansd-17 (COCO order)
HUMANSD17_FROM_SMPLX = np.array(
    [55, 57, 56, 59, 58, 16, 17, 18, 19, 20, 21, 1, 2, 4, 5, 7, 8],
    dtype=np.int32,
)
HUMANSD17_NAMES = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle",
)
HUMANSD17_LINES = np.array(
    [[0, 1], [0, 2], [1, 3], [2, 4], [3, 5], [4, 6], [5, 7], [6, 8],
     [7, 9], [8, 10], [5, 11], [6, 12], [11, 13], [12, 14], [13, 15],
     [14, 16]],
    dtype=np.int32,
)

# A-pose body axis-angles (21 joints)
APOSE_BODY_POSE = np.zeros((21, 3), np.float32)
APOSE_BODY_POSE[0, 1] = 0.2
APOSE_BODY_POSE[0, 2] = 0.1
APOSE_BODY_POSE[1, 1] = -0.2
APOSE_BODY_POSE[1, 2] = -0.1
APOSE_BODY_POSE[15, 2] = -0.7853982
APOSE_BODY_POSE[16, 2] = 0.7853982
APOSE_BODY_POSE[19, 0] = 1.0
APOSE_BODY_POSE[20, 0] = 1.0


def joints_to_openpose18(joints: np.ndarray) -> np.ndarray:
    return np.asarray(joints)[OPENPOSE18_FROM_SMPLX]


def joints_to_humansd17(joints: np.ndarray) -> np.ndarray:
    return np.asarray(joints)[HUMANSD17_FROM_SMPLX]


def sample_mesh_surface(
    vertices: np.ndarray,
    faces: np.ndarray,
    n: int,
    rng: np.random.Generator | int | None = None,
) -> np.ndarray:
    """Area-weighted uniform surface sampling: [n, 3] float32 points."""
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    probs = areas / areas.sum()
    idx = rng.choice(f.shape[0], size=n, p=probs)
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    u = 1.0 - r1
    w = r1 * r2
    vv = r1 - w
    pts = u[:, None] * a[idx] + vv[:, None] * b[idx] + w[:, None] * c[idx]
    return pts.astype(np.float32)


@dataclasses.dataclass
class Skeleton:
    """Host-side skeleton state (numpy arrays)."""

    style: str = "humansd"  # or "openpose"
    apose: bool = True
    points3d: np.ndarray | None = None  # [K,3] normalized keypoints
    vertices: np.ndarray | None = None  # [V,3] normalized SMPL-X verts
    faces: np.ndarray | None = None  # [F,3]
    ori_center: np.ndarray | None = None
    ori_scale: float | None = None

    @property
    def names(self):
        return HUMANSD17_NAMES if self.style == "humansd" else OPENPOSE18_NAMES

    @property
    def lines(self):
        return HUMANSD17_LINES if self.style == "humansd" else OPENPOSE18_LINES

    def load_smplx(self, model: SMPLXModel, betas=None, expression=None,
                   body_pose: np.ndarray | None = None) -> "Skeleton":
        """SMPL-X forward (A-pose by default) on the CPU, then the
        normalization chain. `model` holds numpy arrays (`load_smplx_npz`,
        `toy_model`). Returns self for chaining."""
        from humangaussian_torch.convert import smplx_from_numpy
        from humangaussian_torch.smplx.lbs import SMPLXPose, lbs_forward

        if body_pose is None:
            body_pose = APOSE_BODY_POSE if self.apose else np.zeros((21, 3))
        pose = SMPLXPose.rest(
            body_pose=torch.from_numpy(np.asarray(body_pose, np.float32)))

        def opt(x):
            return None if x is None else torch.from_numpy(
                np.asarray(x, np.float32))

        with torch.no_grad():
            verts, joints = lbs_forward(smplx_from_numpy(model, "cpu"), pose,
                                        opt(betas), opt(expression))
        verts = verts.numpy()
        joints = joints.numpy()

        kp = (joints_to_humansd17(joints) if self.style == "humansd"
              else joints_to_openpose18(joints))

        vmin, vmax = verts.min(0), verts.max(0)
        self.ori_center = (vmax + vmin) / 2
        self.ori_scale = 0.6 / np.max(vmax - vmin)
        verts = (verts - self.ori_center) * self.ori_scale
        kp = (kp - self.ori_center) * self.ori_scale

        # OpenGL -> blender: swap y and z
        verts = verts[:, [0, 2, 1]]
        kp = kp[:, [0, 2, 1]]

        self.vertices = verts.astype(np.float32)
        self.faces = np.asarray(model.faces, np.int32)
        self.points3d = kp.astype(np.float32)
        return self

    def scale(self, delta: float) -> "Skeleton":
        """points and vertices *= 1.1**(-delta); the system calls
        scale(-10)."""
        f = 1.1 ** (-delta)
        self.points3d = self.points3d * f
        if self.vertices is not None:
            self.vertices = self.vertices * f
        return self

    @property
    def hand_centers(self) -> np.ndarray:
        """[2,3] left and right wrist positions (the hand-densify mask)."""
        il = self.names.index("left_wrist")
        ir = self.names.index("right_wrist")
        return self.points3d[[il, ir]]

    def sample_smplx_points(self, n: int = 100_000,
                            seed: int = 0) -> np.ndarray:
        assert self.vertices is not None, "call load_smplx first"
        return sample_mesh_surface(self.vertices, self.faces, n, seed)
