"""Gaussian-scene mesh extraction: density field + marching tetrahedra.

Port of humangaussian_tpu/mesh.py (the reference's mesh export: the
opacity-weighted Gaussian density on a 128^3 grid, evaluated block by
block, then an iso-surface):

- `extract_density_field`: the Gaussians are binned to 16^3 spatial blocks
  on the host by the relaxed-bbox rule (a Gaussian joins every block whose
  bounds, widened by `relax_ratio` blocks, hold its centre); a stable sort
  by block keeps the first `block_capacity` Gaussians of each block and
  drops the rest silently, as the JAX module does (`block_counts` gives
  the counts before the cap). The blocks' [points x Gaussians] sums then
  run on the scene's device, a chunk of blocks at a time sized so that one
  [blocks, points, Gaussians] float32 tensor stays within
  `FIELD_CHUNK_ELEMENTS`; the JAX module maps one jitted program over all
  blocks instead.
- `marching_tetrahedra`: a plain numpy copy (each cell split into 6
  tetrahedra; no case tables, no external dependency).
- `extract_mesh` and `save_obj`: world-space vertices and an OBJ file.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from humangaussian_torch.core.scene import (
    GaussianScene,
    covariance_from_scaling_rotation,
)

# elements of the largest [blocks, points, Gaussians] float32 tensor of one
# chunk of the field evaluation (256 MiB); the chunk's temporaries hold a
# few of them
FIELD_CHUNK_ELEMENTS = 1 << 26


def gaussian_3d_coeff(offsets: torch.Tensor,
                      cov6: torch.Tensor) -> torch.Tensor:
    """exp(-0.5 x^T Sigma^-1 x) for packed upper-triangle covariances
    (a, b, c, d, e, f) = (xx, xy, xz, yy, yz, zz); det is clamped at 1e-24."""
    x, y, z = offsets[..., 0], offsets[..., 1], offsets[..., 2]
    return _coeff(x, y, z, *_inverse6(cov6).unbind(-1))


def _inverse6(cov6: torch.Tensor) -> torch.Tensor:
    """[..., 6] packed covariances -> [..., 6] packed inverses, in the JAX
    module's order of float32 operations."""
    a, b, c, d, e, f = cov6.unbind(-1)
    det = a * d * f + 2 * b * c * e - c * c * d - e * e * a - b * b * f
    det = torch.clamp_min(det, 1e-24)
    return torch.stack([(d * f - e * e) / det, (e * c - b * f) / det,
                        (b * e - c * d) / det, (a * f - c * c) / det,
                        (b * c - e * a) / det, (a * d - b * b) / det], dim=-1)


def _coeff(x, y, z, inv_a, inv_b, inv_c, inv_d, inv_e, inv_f):
    power = (-0.5 * (x * x * inv_a + y * y * inv_d + z * z * inv_f)
             - x * y * inv_b - x * z * inv_c - y * z * inv_e)
    return torch.exp(torch.clamp_max(power, 0.0))


def _pack_cov6(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    cov = covariance_from_scaling_rotation(scales, quats)
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
                       dim=-1)


def _normalized(scene: GaussianScene, min_opacity: float):
    """Host arrays of the Gaussians above `min_opacity`, with their centres
    in the normalized [-0.9, 0.9] cube: (xyz_n, scales_n, quats, opacities,
    center, scale)."""
    alive = scene.alive.cpu().numpy()
    opac = scene.opacities.detach().cpu().numpy()[:, 0]
    keep = alive & (opac > min_opacity)
    xyz = scene.means.detach().cpu().numpy()[keep]
    scales = scene.scales.detach().cpu().numpy()[keep]
    quats = scene.rotations.detach().cpu().numpy()[keep]
    mn, mx = xyz.min(0), xyz.max(0)
    center = (mn + mx) / 2
    scale = 1.8 / float((mx - mn).max())
    return (xyz - center) * scale, scales * scale, quats, opac[keep], \
        center, scale


def _bin_to_blocks(xyz_n: np.ndarray, num_blocks: int, relax_ratio: float):
    """The relaxed-bbox binning on the host: a Gaussian joins block k iff
    k*bs - 1 - relax*bs < c < (k+1)*bs - 1 + relax*bs on every axis. Returns
    (starts [num_blocks^3 + 1], gaussian ids sorted stably by block)."""
    block_size = 2.0 / num_blocks
    u = (xyz_n + 1.0) / block_size  # [M,3]
    lo_k = np.floor(u - relax_ratio).astype(np.int64) + 1
    hi_k = np.floor(u + relax_ratio).astype(np.int64)
    span = int(np.ceil(2 * relax_ratio)) + 1  # offsets per axis
    pair_block, pair_gid = [], []
    gids = np.arange(xyz_n.shape[0], dtype=np.int64)
    for ox in range(span):
        for oy in range(span):
            for oz in range(span):
                k = lo_k + np.array([ox, oy, oz])
                ok = np.all((k >= 0) & (k < num_blocks) & (k <= hi_k), axis=1)
                flat = k[:, 0] * num_blocks**2 + k[:, 1] * num_blocks + k[:, 2]
                pair_block.append(flat[ok])
                pair_gid.append(gids[ok])
    pair_block = np.concatenate(pair_block)
    pair_gid = np.concatenate(pair_gid)
    order = np.argsort(pair_block, kind="stable")
    pair_block, pair_gid = pair_block[order], pair_gid[order]
    starts = np.searchsorted(pair_block, np.arange(num_blocks**3 + 1))
    return starts, pair_gid


def block_counts(scene: GaussianScene, num_blocks: int = 16,
                 relax_ratio: float = 1.5,
                 min_opacity: float = 0.005) -> np.ndarray:
    """[num_blocks^3] Gaussians binned to each block before the
    `block_capacity` cap of `extract_density_field`."""
    xyz_n = _normalized(scene, min_opacity)[0]
    return np.diff(_bin_to_blocks(xyz_n, num_blocks, relax_ratio)[0])


def extract_density_field(
    scene: GaussianScene,
    resolution: int = 128,
    num_blocks: int = 16,
    relax_ratio: float = 1.5,
    min_opacity: float = 0.005,
    block_capacity: int = 8192,
):
    """[R,R,R] opacity-density field in the normalized [-1, 1] cube.

    Returns (field, center, scale): a float32 numpy array and the
    normalization, so that vertices map back to world space."""
    dev = scene.device
    xyz_n, scales_n, quats, opas, center, scale = _normalized(
        scene, min_opacity)
    split = resolution // num_blocks
    n_blocks3 = num_blocks**3
    starts, pair_gid = _bin_to_blocks(xyz_n, num_blocks, relax_ratio)
    counts = np.minimum(starts[1:] - starts[:-1], block_capacity)
    kmax = max(int(counts.max()), 1)
    k_arange = np.arange(kmax)
    flat_idx = starts[:-1, None] + k_arange[None, :]
    valid = k_arange[None, :] < counts[:, None]
    idx = pair_gid[np.minimum(flat_idx, pair_gid.size - 1)]
    idx = np.where(valid, idx, 0)

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    xyz_t = t(xyz_n)
    inv6 = _inverse6(_pack_cov6(t(scales_n), t(quats)))
    opa_t = t(opas)
    idx_t, valid_t = t(idx, torch.int64), t(valid, torch.bool)
    lin = t(np.linspace(-1.0, 1.0, resolution, dtype=np.float32))
    # the points of every block, [B3, S, 3] in the block's own i, j, k order
    ar = torch.arange(split, device=dev)
    cell = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                       dim=-1).reshape(-1, 3)  # [S, 3]
    bid = torch.arange(n_blocks3, device=dev)
    corner = torch.stack([bid // num_blocks**2, (bid // num_blocks)
                          % num_blocks, bid % num_blocks], dim=-1) * split

    vals = torch.empty((n_blocks3, split**3), dtype=torch.float32,
                       device=dev)
    per_chunk = max(1, FIELD_CHUNK_ELEMENTS // (split**3 * kmax))
    with torch.no_grad():
        for b0 in range(0, n_blocks3, per_chunk):
            b1 = min(b0 + per_chunk, n_blocks3)
            k = max(int(counts[b0:b1].max()), 1)
            gidx = idx_t[b0:b1, :k]  # [nb, K]
            pts = lin[corner[b0:b1, None, :] + cell[None]]  # [nb, S, 3]
            g_xyz = xyz_t[gidx]  # [nb, K, 3]
            off = [pts[..., i, None] - g_xyz[:, None, :, i] for i in range(3)]
            g_inv = inv6[gidx][:, None]  # [nb, 1, K, 6]
            w = _coeff(*off, *g_inv.unbind(-1))  # [nb, S, K]
            g_opa = torch.where(valid_t[b0:b1, :k], opa_t[gidx], 0.0)
            vals[b0:b1] = (w * g_opa[:, None, :]).sum(dim=-1)
    field = np.zeros((resolution,) * 3, np.float32)
    full = num_blocks * split
    field[:full, :full, :full] = (
        vals.reshape(num_blocks, num_blocks, num_blocks, split, split, split)
        .permute(0, 3, 1, 4, 2, 5).reshape(full, full, full).cpu().numpy())
    return field, center, scale


# 6-tetrahedra decomposition of a cube (corner ids, binary xyz order)
_TETS = np.array(
    [[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
     [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]],
    np.int64,
)
_CORNER_OFFSET = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
    np.int64,
)


def marching_tetrahedra(field: np.ndarray, threshold: float):
    """Iso-surface of a dense [X,Y,Z] field via marching tets.

    Returns (vertices [V,3] in grid coordinates, triangles [F,3]).
    """
    res = np.asarray(field.shape)
    gx, gy, gz = np.meshgrid(
        np.arange(res[0] - 1), np.arange(res[1] - 1), np.arange(res[2] - 1),
        indexing="ij",
    )
    base = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)  # [C,3]

    corner_pos = base[:, None, :] + _CORNER_OFFSET[None]  # [C,8,3]
    corner_val = field[
        corner_pos[..., 0], corner_pos[..., 1], corner_pos[..., 2]
    ]  # [C,8]

    verts_out = []
    tris_out = []
    n_verts = 0
    for tet in _TETS:
        p = corner_pos[:, tet, :].astype(np.float64)  # [C,4,3]
        v = corner_val[:, tet]  # [C,4]
        inside = v > threshold  # [C,4]
        code = (
            inside[:, 0] * 1 + inside[:, 1] * 2
            + inside[:, 2] * 4 + inside[:, 3] * 8
        )

        def edge_point(sel, i, j):
            vi, vj = v[sel, i], v[sel, j]
            t = (threshold - vi) / np.where(vj - vi == 0, 1.0, vj - vi)
            t = np.clip(t, 0.0, 1.0)[:, None]
            return p[sel, i] * (1 - t) + p[sel, j] * t

        # single-corner cases (1 triangle): corner k inside (or outside)
        for k in range(4):
            others = [i for i in range(4) if i != k]
            for c_val in (1 << k, 15 ^ (1 << k)):
                sel = np.nonzero(code == c_val)[0]
                if sel.size == 0:
                    continue
                tri = np.stack(
                    [edge_point(sel, k, o) for o in others], axis=1
                )  # [S,3,3]
                verts_out.append(tri.reshape(-1, 3))
                tris_out.append(
                    np.arange(sel.size * 3).reshape(-1, 3) + n_verts
                )
                n_verts += sel.size * 3

        # two-corner cases (quad -> 2 triangles)
        for pair in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
            c_val = (1 << pair[0]) | (1 << pair[1])
            sel = np.nonzero(code == c_val)[0]
            if sel.size == 0:
                continue
            a, b = pair
            c, d = [i for i in range(4) if i not in pair]
            # crossing edges: a-c, a-d, b-c, b-d
            pac = edge_point(sel, a, c)
            pad = edge_point(sel, a, d)
            pbc = edge_point(sel, b, c)
            pbd = edge_point(sel, b, d)
            quad = np.stack([pac, pad, pbd, pbc], axis=1)  # [S,4,3]
            verts_out.append(quad.reshape(-1, 3))
            t1 = np.stack(
                [np.arange(sel.size) * 4, np.arange(sel.size) * 4 + 1,
                 np.arange(sel.size) * 4 + 2], axis=1,
            )
            t2 = np.stack(
                [np.arange(sel.size) * 4, np.arange(sel.size) * 4 + 2,
                 np.arange(sel.size) * 4 + 3], axis=1,
            )
            tris_out.append(np.concatenate([t1, t2]) + n_verts)
            n_verts += sel.size * 4

    if not verts_out:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    verts = np.concatenate(verts_out).astype(np.float32)
    tris = np.concatenate(tris_out)

    # weld duplicate vertices
    keys = np.round(verts * 1e4).astype(np.int64)
    _, first, inv = np.unique(
        keys, axis=0, return_index=True, return_inverse=True
    )
    return verts[first], inv.reshape(-1)[tris]


def extract_mesh(
    scene: GaussianScene,
    density_thresh: float = 1.0,
    resolution: int = 128,
):
    """Gaussians -> (vertices [V,3] in world space, triangles [F,3]); the
    reference's mesh export without its mesh decimation."""
    field, center, scale = extract_density_field(scene, resolution)
    verts, tris = marching_tetrahedra(field, density_thresh)
    verts = verts / (resolution - 1.0) * 2.0 - 1.0
    verts = verts / scale + center
    return verts.astype(np.float32), tris.astype(np.int32)


def save_obj(path: str, verts: np.ndarray, tris: np.ndarray) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in tris:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
    return path
