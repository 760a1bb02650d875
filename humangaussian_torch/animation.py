"""Zero-shot SMPL-X animation: bind a trained avatar to the body mesh,
re-pose it per frame, render.

Port of humangaussian_tpu/animation.py. The one-time binding
(`closest_point_on_triangles`, `bind_gaussians_to_mesh`) is the same host
numpy + scipy cKDTree code, copied; the per-frame LBS re-pose and the
render run in torch on the scene's device.

Pipeline:
  1. load the avatar PLY with the animation axis shim
     (io/ply.py animation_convention=True);
  2. SMPL-X forward at the binding pose; normalize the mesh with the
     training chain (0.6 box, x1.1^10), centre and scale frozen at the
     binding pose;
  3. bind: per Gaussian, closest face + barycentric uvw + signed distance
     along the face normal; cull points whose reconstruction error
     exceeds 0.01;
  4. per frame: body pose (AMASS poses[:, 1:22]) -> LBS -> re-posed
     positions x = bary(v0, v1, v2) + dist * face_normal -> tiled render.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from humangaussian_torch.core.camera import Camera
from humangaussian_torch.core.scene import GaussianScene
from humangaussian_torch.render import render as render_scene
from humangaussian_torch.smplx.lbs import SMPLXPose, lbs_forward
from humangaussian_torch.smplx.model import SMPLXModel
from humangaussian_torch.utils.profiling import trace_annotation


def closest_point_on_triangles(points: np.ndarray, v0, v1, v2):
    """Vectorized closest point on each triangle (Ericson, RTCD 5.1.5).

    points [M,3] against per-row triangles v0/v1/v2 [M,3].
    Returns (closest [M,3], bary [M,3]).
    """
    ab = v1 - v0
    ac = v2 - v0
    ap = points - v0

    d1 = np.sum(ab * ap, axis=1)
    d2 = np.sum(ac * ap, axis=1)
    bp = points - v1
    d3 = np.sum(ab * bp, axis=1)
    d4 = np.sum(ac * bp, axis=1)
    cp = points - v2
    d5 = np.sum(ab * cp, axis=1)
    d6 = np.sum(ac * cp, axis=1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom = vb + vc + va
    v = np.zeros_like(d1)
    w = np.zeros_like(d1)

    # interior
    safe = np.abs(denom) > 1e-20
    v_in = np.where(safe, vb / np.where(safe, denom, 1.0), 0.0)
    w_in = np.where(safe, vc / np.where(safe, denom, 1.0), 0.0)
    v, w = v_in, w_in

    # edge AC (d2 region): t = d2/(d2-d6)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    t_ac = d2 / np.where(d2 - d6 == 0, 1.0, d2 - d6)
    v = np.where(on_ac, 0.0, v)
    w = np.where(on_ac, t_ac, w)
    # edge AB (d1 region)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    t_ab = d1 / np.where(d1 - d3 == 0, 1.0, d1 - d3)
    v = np.where(on_ab, t_ab, v)
    w = np.where(on_ab, 0.0, w)
    # edge BC (va region)
    on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    t_bc = (d4 - d3) / np.where(
        (d4 - d3) + (d5 - d6) == 0, 1.0, (d4 - d3) + (d5 - d6)
    )
    v = np.where(on_bc, 1.0 - t_bc, v)
    w = np.where(on_bc, t_bc, w)
    # vertices
    at_a = (d1 <= 0) & (d2 <= 0)
    at_b = (d3 >= 0) & (d4 <= d3)
    at_c = (d6 >= 0) & (d5 <= d6)
    v = np.where(at_a, 0.0, np.where(at_b, 1.0, np.where(at_c, 0.0, v)))
    w = np.where(at_a, 0.0, np.where(at_b, 0.0, np.where(at_c, 1.0, w)))

    v = np.clip(v, 0.0, 1.0)
    w = np.clip(w, 0.0, 1.0 - v)
    u = 1.0 - v - w
    closest = u[:, None] * v0 + v[:, None] * v1 + w[:, None] * v2
    bary = np.stack([u, v, w], axis=1)
    return closest, bary


@dataclasses.dataclass
class MeshBinding:
    """One-time Gaussian->triangle attachment."""

    face_idx: np.ndarray  # [M] int32
    bary: np.ndarray  # [M,3]
    dist: np.ndarray  # [M] signed distance along the face normal
    keep_mask: np.ndarray  # [M0] bool over the ORIGINAL gaussian set


def _face_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    return fn / (np.linalg.norm(fn, axis=1, keepdims=True) + 1e-20)


def bind_gaussians_to_mesh(
    points: np.ndarray,
    verts: np.ndarray,
    faces: np.ndarray,
    max_err: float = 0.01,
    k_candidates: int = 32,
) -> MeshBinding:
    """Closest-face binding with KD-tree candidate pruning: query the
    `k_candidates` nearest face centroids, take the exact closest point
    among those triangles, sign the distance by the face normal. Points
    whose reconstruction error exceeds `max_err` are culled."""
    from scipy.spatial import cKDTree

    points = np.asarray(points, np.float64)
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    centroids = verts[faces].mean(axis=1)
    tree = cKDTree(centroids)
    _, cand = tree.query(points, k=k_candidates)  # [M, k]

    m = points.shape[0]
    best_d2 = np.full((m,), np.inf)
    best_face = np.zeros((m,), np.int64)
    best_bary = np.zeros((m, 3))
    for j in range(k_candidates):
        f = cand[:, j]
        tri = faces[f]
        closest, bary = closest_point_on_triangles(
            points, verts[tri[:, 0]], verts[tri[:, 1]], verts[tri[:, 2]]
        )
        d2 = np.sum((points - closest) ** 2, axis=1)
        better = d2 < best_d2
        best_d2 = np.where(better, d2, best_d2)
        best_face = np.where(better, f, best_face)
        best_bary = np.where(better[:, None], bary, best_bary)

    fnormals = _face_normals(verts, faces)[best_face]
    tri = faces[best_face]
    cpoints = (
        best_bary[:, 0:1] * verts[tri[:, 0]]
        + best_bary[:, 1:2] * verts[tri[:, 1]]
        + best_bary[:, 2:3] * verts[tri[:, 2]]
    )
    signed = np.sum((points - cpoints) * fnormals, axis=1)
    recon = cpoints + signed[:, None] * fnormals
    err = np.linalg.norm(recon - points, axis=1)
    keep = err <= max_err
    return MeshBinding(
        face_idx=best_face[keep].astype(np.int32),
        bary=best_bary[keep].astype(np.float32),
        dist=signed[keep].astype(np.float32),
        keep_mask=keep,
    )


def repose_positions(face_verts_idx: torch.Tensor, bary: torch.Tensor,
                     dist: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """[M,3] re-posed Gaussian positions from the current mesh vertices;
    `face_verts_idx` [M,3] are the vertex ids of each bound face."""
    v0 = verts[face_verts_idx[:, 0]]
    v1 = verts[face_verts_idx[:, 1]]
    v2 = verts[face_verts_idx[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    fn = fn / (torch.linalg.norm(fn, dim=1, keepdim=True) + 1e-20)
    cpoints = bary[:, 0:1] * v0 + bary[:, 1:2] * v1 + bary[:, 2:3] * v2
    return cpoints + dist[:, None] * fn


class AvatarAnimator:
    """Bind once, then re-pose + render per frame. `model` has tensor
    fields (`convert.smplx_from_numpy`) on the scene's device."""

    def __init__(
        self,
        scene: GaussianScene,
        model: SMPLXModel,
        binding_pose: SMPLXPose | None = None,
        scale_delta: float = -10.0,
        max_err: float = 0.01,
    ):
        self.model = model
        self.scale_factor = 1.1 ** (-scale_delta)
        dev = scene.device

        if binding_pose is None:
            binding_pose = SMPLXPose.rest(device=dev)
        verts, _ = lbs_forward(model, binding_pose)
        verts = verts.cpu().numpy()
        vmin, vmax = verts.min(0), verts.max(0)
        self.ori_center = (vmax + vmin) / 2
        self.ori_scale = 0.6 / np.max(vmax - vmin)
        verts_n = self._normalize(verts)

        alive = scene.alive.cpu().numpy()
        points = scene.means.cpu().numpy()[alive]
        faces = model.faces.cpu().numpy()
        self.binding = bind_gaussians_to_mesh(
            points, verts_n, faces, max_err=max_err
        )
        self._face_verts = torch.from_numpy(
            faces[self.binding.face_idx].astype(np.int64)).to(dev)
        self._bary = torch.from_numpy(self.binding.bary).to(dev)
        self._dist = torch.from_numpy(self.binding.dist).to(dev)
        self._center = torch.from_numpy(
            np.asarray(self.ori_center, np.float32)).to(dev)

        # compact the culled avatar into a fresh padded scene
        idx = np.flatnonzero(alive)[self.binding.keep_mask]
        m = idx.shape[0]
        cap = int(np.ceil(m / 256) * 256)
        idx_t = torch.from_numpy(idx).to(dev)

        def take(x, fill=0.0):
            x = x[idx_t]
            pad = torch.full((cap - m,) + tuple(x.shape[1:]), fill,
                             dtype=x.dtype, device=dev)
            return torch.cat([x, pad], dim=0)

        self.scene = GaussianScene(
            means=take(scene.means),
            log_scales=take(scene.log_scales, -10.0),
            quats=take(scene.quats),
            sh_dc=take(scene.sh_dc),
            sh_rest=take(scene.sh_rest),
            opacity_logits=take(scene.opacity_logits, -10.0),
            alive=torch.arange(cap, device=dev) < m,
        )
        self.n_gaussians = m

    def _normalize(self, verts: np.ndarray) -> np.ndarray:
        return (verts - self.ori_center) * self.ori_scale * self.scale_factor

    def frame_scene(self, pose: SMPLXPose) -> GaussianScene:
        """Scene re-posed to `pose` (positions only)."""
        with trace_annotation("hg.repose"):
            verts, _ = lbs_forward(self.model, pose)
            verts_n = ((verts - self._center) * float(self.ori_scale)
                       * self.scale_factor)
            new_pos = repose_positions(self._face_verts, self._bary,
                                       self._dist, verts_n)
            means = self.scene.means.clone()
            means[: self.n_gaussians] = new_pos
            return self.scene._replace(means=means)

    def render_frame(self, pose: SMPLXPose, camera: Camera,
                     background: torch.Tensor) -> dict:
        return render_scene(self.frame_scene(pose), camera, background)


def load_amass_body_poses(path: str) -> np.ndarray:
    """AMASS npz -> [T, 21, 3] body poses (poses[:, 1:22] of the
    52/55-joint axis-angle array)."""
    with np.load(path, allow_pickle=True) as d:
        poses = np.asarray(d["poses"], np.float32)
    if poses.ndim == 2:  # [T, J*3]
        poses = poses.reshape(poses.shape[0], -1, 3)
    return poses[:, 1:22]
