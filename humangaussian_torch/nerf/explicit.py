"""Triangle-mesh rasterization with differentiable barycentrics.

Port of `rasterize_mesh` and `face_normals` of
humangaussian_tpu/nerf/explicit.py (the nvdiffrast rasterize + interpolate
analogue that the viewer's "mesh" mode calls). The rest of that module,
the tetrahedral SDF grid, the custom mesh and the rasterizer renderers, is
ROADMAP queue 1 item 21b.

The z-buffer search runs over chunks of faces without gradient; the
winning face's barycentrics are then re-derived differentiably, so
attributes and depth carry gradients to the vertices and attributes. A
chunk holds at most `MESH_CHUNK_ELEMENTS` pixel x face entries (the JAX
module scans fixed chunks of 256 faces padded to a multiple): at 512^2
pixels that is 256 faces, at 64^2 every face of a small mesh at once. A
pixel keeps the first face (lowest index) of least depth in every chunk
layout, so the chunk size does not change the result.
"""
from __future__ import annotations

import torch

# pixel x face entries of one chunk's [pixels, faces] float32 tensors
# (256 MiB each; the search holds about ten of them)
MESH_CHUNK_ELEMENTS = 1 << 26


def _bary(ax, ay, bx, by, cx, cy, qx, qy):
    d = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
    d = torch.where(d.abs() > 1e-12, d, 1e-12)
    l0 = ((by - cy) * (qx - cx) + (cx - bx) * (qy - cy)) / d
    l1 = ((cy - ay) * (qx - cx) + (ax - cx) * (qy - cy)) / d
    return l0, l1, 1.0 - l0 - l1


def rasterize_mesh(tri_verts, tri_mask, mvp, height: int, width: int,
                   attrs=None):
    """Z-buffered triangle rasterization.

    tri_verts [F,3,3] world, tri_mask [F] bool, mvp [4,4] (row-vector
    clip transform, `Camera.full_proj`), attrs [F,3,A] per-corner
    attributes (default: the world positions). Returns dict(attr
    [H,W,A], depth [H,W], mask [H,W] bool, face [H,W] int32, -1 off the
    mesh)."""
    dev = tri_verts.device
    if attrs is None:
        attrs = tri_verts
    ones = torch.ones(tri_verts.shape[:-1] + (1,), dtype=tri_verts.dtype,
                      device=dev)
    clip = torch.cat([tri_verts, ones], dim=-1) @ mvp  # [F,3,4]
    wc = clip[..., 3:4]
    ndc = clip[..., :3] / torch.where(wc.abs() > 1e-8, wc, 1e-8)
    sx = (ndc[..., 0] + 1.0) * 0.5 * width  # [F,3]
    sy = (ndc[..., 1] + 1.0) * 0.5 * height
    sz = ndc[..., 2]
    front = (wc[..., 0] > 1e-6).all(dim=-1) & tri_mask

    f32 = dict(dtype=torch.float32, device=dev)
    px = (torch.arange(width, **f32) + 0.5)[None, :].expand(height, width)
    py = (torch.arange(height, **f32) + 0.5)[:, None].expand(height, width)
    px, py = px.reshape(-1), py.reshape(-1)  # [P]
    n_pix, n_faces = px.shape[0], tri_verts.shape[0]

    zbuf = torch.full((n_pix,), torch.inf, **f32)
    fbuf = torch.full((n_pix,), -1, dtype=torch.int32, device=dev)
    chunk = max(1, MESH_CHUNK_ELEMENTS // n_pix)
    with torch.no_grad():
        for base in range(0, n_faces, chunk):
            cx, cy, cz = (v[base:base + chunk].detach() for v in (sx, sy, sz))
            # degenerate (zero screen area) triangles, e.g. marching-tets
            # slivers, would pass the barycentric test everywhere
            area2 = ((cx[:, 1] - cx[:, 0]) * (cy[:, 2] - cy[:, 0])
                     - (cx[:, 2] - cx[:, 0]) * (cy[:, 1] - cy[:, 0]))
            ok = front[base:base + chunk] & (area2.abs() > 1e-9)
            l0, l1, l2 = _bary(cx[None, :, 0], cy[None, :, 0],
                               cx[None, :, 1], cy[None, :, 1],
                               cx[None, :, 2], cy[None, :, 2],
                               px[:, None], py[:, None])  # [P, C]
            inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & ok[None, :]
            z = l0 * cz[None, :, 0] + l1 * cz[None, :, 1] + l2 * cz[None, :, 2]
            z = torch.where(inside, z, torch.inf)
            zmin, amin = z.min(dim=1)
            better = zmin < zbuf
            zbuf = torch.where(better, zmin, zbuf)
            fbuf = torch.where(better, (amin + base).to(torch.int32), fbuf)

    hit = fbuf >= 0
    fid = fbuf.clamp_min(0).long()
    # differentiable re-interpolation on the winning face
    wx, wy, wz = sx[fid], sy[fid], sz[fid]  # [P,3]
    l0, l1, l2 = _bary(wx[:, 0], wy[:, 0], wx[:, 1], wy[:, 1], wx[:, 2],
                       wy[:, 2], px, py)
    fa = attrs[fid]  # [P,3,A]
    attr = (l0[:, None] * fa[:, 0] + l1[:, None] * fa[:, 1]
            + l2[:, None] * fa[:, 2])
    depth = l0 * wz[:, 0] + l1 * wz[:, 1] + l2 * wz[:, 2]
    hitf = hit.to(torch.float32)
    return {
        "attr": (attr * hitf[:, None]).reshape(height, width, -1),
        "depth": (depth * hitf).reshape(height, width),
        "mask": hit.reshape(height, width),
        "face": torch.where(hit, fbuf, -1).reshape(height, width),
    }


def face_normals(tri_verts: torch.Tensor) -> torch.Tensor:
    """[F,3,3] -> unit normals [F,3]."""
    e1 = tri_verts[:, 1] - tri_verts[:, 0]
    e2 = tri_verts[:, 2] - tri_verts[:, 0]
    n = torch.linalg.cross(e1, e2)
    return n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-9)
