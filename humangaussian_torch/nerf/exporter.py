"""Mesh exporter with texture baking: model.obj + model.mtl +
texture_kd.png.

Port of humangaussian_tpu/nerf/exporter.py (the reference's mesh-exporter
without xatlas and nvdiffrast):

- the isosurface of the density field by the port's numpy marching
  tetrahedra (`humangaussian_torch.mesh.marching_tetrahedra`);
- a per-face UV atlas: each triangle gets its own right-triangle cell of
  a ceil(sqrt(F))^2 grid;
- the albedo baked by evaluating geometry features and material at the
  world point of every texel of a barycentric lattice.

Differences from the JAX module: `export_implicit_volume` takes the
geometry (and material) modules, which hold their parameters, where JAX
takes a module and its parameter tree; the density grid and the texel
colors are queried on the field's device under `torch.no_grad()` in
chunks of `QUERY_CHUNK` points (JAX jits one call over the whole grid).
"""
from __future__ import annotations

import os

import numpy as np
import torch

# points per field query: at 64^3 the grid is one chunk; a 512^2 texture
# bake of a large mesh is several
QUERY_CHUNK = 1 << 18


def per_face_uv_atlas(n_faces: int, texture_size: int):
    """Each face gets a half-cell of a grid atlas. Returns (uvs [3F, 2] in
    [0, 1], uv_faces [F, 3] indices into uvs)."""
    cells = int(np.ceil(np.sqrt(n_faces)))
    cell = 1.0 / cells
    pad = cell * 0.08
    f = np.arange(n_faces)
    cy, cx = np.divmod(f, cells)
    x0, y0 = cx * cell + pad, cy * cell + pad
    x1, y1 = (cx + 1) * cell - pad, (cy + 1) * cell - pad
    uvs = np.stack([np.stack([x0, y0], -1), np.stack([x1, y0], -1),
                    np.stack([x0, y1], -1)], axis=1).astype(np.float32)
    uv_faces = np.arange(3 * n_faces, dtype=np.int32).reshape(-1, 3)
    return uvs.reshape(-1, 2), uv_faces


def bake_albedo(verts, faces, query_color_fn, texture_size: int = 1024):
    """Per-texel albedo: each face's UV cell is filled from
    `query_color_fn(points [N, 3] numpy) -> [N, 3]` at the matching world
    points. Returns (texture [S, S, 3] float, uv_flat, uv_faces)."""
    n_faces = faces.shape[0]
    uv_flat, uv_faces = per_face_uv_atlas(n_faces, texture_size)
    s = texture_size
    tex = np.full((s, s, 3), 0.5, np.float32)

    # a K x K barycentric lattice per face cell
    k = max(2, int(np.ceil(s / np.ceil(np.sqrt(n_faces)))) + 1)
    bi, bj = np.meshgrid(np.linspace(0, 1, k), np.linspace(0, 1, k))
    mask = bi + bj <= 1.0 + 1e-6
    ba = np.stack([1 - bi[mask] - bj[mask], bi[mask], bj[mask]], -1)  # [M,3]

    tri = verts[faces]  # [F,3,3]
    pts = np.einsum("ms,fsd->fmd", ba, tri).reshape(-1, 3)
    cols = np.asarray(query_color_fn(pts)).reshape(n_faces, -1, 3)

    uv_tri = uv_flat[uv_faces]  # [F,3,2]
    uv_pts = np.einsum("ms,fst->fmt", ba, uv_tri)  # [F,M,2]
    xi = np.clip((uv_pts[..., 0] * s).astype(int), 0, s - 1)
    yi = np.clip((uv_pts[..., 1] * s).astype(int), 0, s - 1)
    tex[yi.reshape(-1), xi.reshape(-1)] = cols.reshape(-1, 3)
    return tex, uv_flat, uv_faces


def save_mesh_obj(save_dir: str, verts: np.ndarray, faces: np.ndarray,
                  query_color_fn=None, texture_size: int = 1024,
                  name: str = "model") -> str:
    """The obj + mtl (+ baked texture_kd.png) artifact set; returns the
    obj's path."""
    os.makedirs(save_dir, exist_ok=True)
    obj_path = os.path.join(save_dir, f"{name}.obj")
    mtl_path = os.path.join(save_dir, f"{name}.mtl")
    lines = [f"mtllib {name}.mtl", "usemtl default"]
    lines += [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in verts]
    tex_line = ""
    if query_color_fn is not None:
        from PIL import Image

        tex, uv_flat, uv_faces = bake_albedo(verts, faces, query_color_fn,
                                             texture_size)
        Image.fromarray((np.clip(tex, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(save_dir, "texture_kd.png"))
        tex_line = "map_Kd texture_kd.png"
        lines += [f"vt {uv[0]:.6f} {1.0 - uv[1]:.6f}" for uv in uv_flat]
        lines += ["f " + " ".join(f"{f[i] + 1}/{uvf[i] + 1}"
                                  for i in range(3))
                  for f, uvf in zip(faces, uv_faces)]
    else:
        lines += [f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}" for f in faces]
    with open(obj_path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(mtl_path, "w") as fh:
        fh.write("newmtl default\nKa 0.0 0.0 0.0\nKd 0.8 0.8 0.8\n"
                 "Ks 0.0 0.0 0.0\n" + tex_line + "\n")
    return obj_path


@torch.no_grad()
def query_field(fn, points: np.ndarray, device, chunk: int = QUERY_CHUNK):
    """fn(points chunk on `device`) -> tensor, over numpy points [N, 3], as
    one float32 numpy array."""
    outs = []
    for i in range(0, points.shape[0], chunk):
        p = torch.from_numpy(np.ascontiguousarray(
            points[i:i + chunk], np.float32)).to(device)
        outs.append(fn(p).float().cpu())
    return torch.cat(outs).numpy()


def export_implicit_volume(save_dir: str, geometry, material=None,
                           resolution: int = 64, threshold: float = 10.0,
                           radius: float = 1.0, texture_size: int = 512):
    """Isosurface the geometry's density at `threshold` on a resolution^3
    grid over [-radius, radius]^3, bake the material's color (sigmoid of
    the first three features without one), write obj / mtl / png. Returns
    the obj's path."""
    from humangaussian_torch.mesh import marching_tetrahedra

    device = next(geometry.parameters()).device
    lin = np.linspace(-radius, radius, resolution, dtype=np.float32)
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    dens = query_field(lambda p: geometry(p)["density"], pts, device)
    verts_idx, faces = marching_tetrahedra(
        dens.reshape(resolution, resolution, resolution), threshold)
    # grid-index space -> world
    verts = verts_idx / (resolution - 1) * 2 * radius - radius

    def color_fn(p):
        feats = geometry(p)["features"]
        if material is not None:
            return material(feats)
        return torch.sigmoid(feats[..., :3])

    return save_mesh_obj(
        save_dir, verts, faces,
        lambda p: query_field(color_fn, p, device),
        texture_size=texture_size)
