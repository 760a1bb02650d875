"""The body: the SMPL-X model as tensors, the skeleton's A-pose chain, the
surface sample and 3-NN scales of a new avatar, the one-time binding of
an avatar to the mesh and its re-pose.

Frozen plain copies from `humangaussian_torch/smplx/skeleton.py`
(`load_smplx`'s normalization, `sample_mesh_surface`), `ops/knn.py`
(`mean_3nn_sq_dist_host`) and `animation.py` (the binding and
`repose_positions`, and `AvatarAnimator`'s normalization), as functions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.lbs import SMPLXPose, lbs_forward
from portbench.reference.model import SMPLXModel


def model_tensors(model: SMPLXModel, device) -> SMPLXModel:
    """The model's arrays as float32 tensors on `device` (`parents` stays
    numpy, faces and landmark ids int64)."""
    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.array(x)).to(device, dtype)

    return SMPLXModel(
        v_template=t(model.v_template), shapedirs=t(model.shapedirs),
        exprdirs=t(model.exprdirs), posedirs=t(model.posedirs),
        j_regressor=t(model.j_regressor), lbs_weights=t(model.lbs_weights),
        parents=np.asarray(model.parents, np.int32),
        faces=t(model.faces, torch.int64),
        landmark_vertex_ids=t(model.landmark_vertex_ids, torch.int64),
        hands_mean=t(model.hands_mean))


# SMPL-X -> humansd-17 (COCO order)
HUMANSD17_FROM_SMPLX = np.array(
    [55, 57, 56, 59, 58, 16, 17, 18, 19, 20, 21, 1, 2, 4, 5, 7, 8],
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


def skeleton_apose(model: SMPLXModel, scale_delta: float = -10.0):
    """(vertices [V,3], humansd keypoints [17,3]) of the A-posed model,
    normalized to a 0.6 box, y and z swapped, times 1.1^-scale_delta, as
    the training system's skeleton holds them."""
    pose = SMPLXPose.rest(body_pose=torch.from_numpy(APOSE_BODY_POSE))
    with torch.no_grad():
        verts, joints = lbs_forward(model_tensors(model, "cpu"), pose)
    verts = verts.numpy()
    kp = joints.numpy()[HUMANSD17_FROM_SMPLX]
    vmin, vmax = verts.min(0), verts.max(0)
    center = (vmax + vmin) / 2
    scale = 0.6 / np.max(vmax - vmin)
    f = 1.1 ** (-scale_delta)
    verts = ((verts - center) * scale)[:, [0, 2, 1]].astype(np.float32) * f
    kp = ((kp - center) * scale)[:, [0, 2, 1]].astype(np.float32) * f
    return verts, kp


def mean_3nn_sq_dist(points) -> torch.Tensor:
    """[N] float32 mean squared distance to each point's 3 nearest
    neighbours."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float32)
    d, _ = cKDTree(pts).query(pts, k=4)
    return torch.from_numpy((d[:, 1:] ** 2).mean(axis=1).astype(np.float32))


@dataclasses.dataclass
class Binding:
    face_verts: torch.Tensor  # [M, 3] vertex ids of each bound face
    bary: torch.Tensor  # [M, 3]
    dist: torch.Tensor  # [M]
    keep: np.ndarray  # [M0] bool over the avatar's alive Gaussians
    center: torch.Tensor  # [3] rest-pose box centre
    ori_scale: float  # 0.6 over the rest pose's largest extent
    factor: float  # 1.1^-scale_delta


def bind(model: SMPLXModel, points: np.ndarray, device,
         scale_delta: float = -10.0, max_err: float = 0.01) -> Binding:
    """The avatar's alive points [M0, 3] bound to the rest-pose mesh
    normalized by its own box (the animator's frame)."""
    tm = model_tensors(model, device)
    verts, _ = lbs_forward(tm, SMPLXPose.rest(device=device))
    verts = verts.cpu().numpy()
    vmin, vmax = verts.min(0), verts.max(0)
    center = (vmax + vmin) / 2
    ori_scale = 0.6 / np.max(vmax - vmin)
    factor = 1.1 ** (-scale_delta)
    faces = np.asarray(model.faces, np.int64)
    b = bind_gaussians_to_mesh(points, (verts - center) * ori_scale * factor,
                               faces, max_err=max_err)
    return Binding(
        face_verts=torch.from_numpy(faces[b.face_idx]).to(device),
        bary=torch.from_numpy(b.bary).to(device),
        dist=torch.from_numpy(b.dist).to(device),
        keep=b.keep_mask,
        center=torch.from_numpy(np.asarray(center, np.float32)).to(device),
        ori_scale=float(ori_scale), factor=factor)


def reposed_means(tm: SMPLXModel, binding: Binding, body_pose: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """[M, 3] positions of the bound Gaussians at `body_pose` [21, 3]; the
    whole chain in `dtype`."""
    pose = SMPLXPose.rest(body_pose=body_pose)
    if dtype != torch.float32:
        tm = tm._replace(**{k: v.to(dtype) for k, v in tm._asdict().items()
                            if isinstance(v, torch.Tensor)
                            and v.is_floating_point()})
        pose = SMPLXPose(*(x.to(dtype) for x in pose))
    verts, _ = lbs_forward(tm, pose)
    verts_n = ((verts - binding.center.to(dtype)) * binding.ori_scale
               * binding.factor)
    return repose_positions(binding.face_verts, binding.bary.to(dtype),
                            binding.dist.to(dtype), verts_n)
