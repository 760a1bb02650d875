"""Explicit geometries and the mesh rasterization renderers.

Port of humangaussian_tpu/nerf/explicit.py, the reference's stock
explicit components:

- `tet_grid` and `marching_tets`: the six-tets-per-cube grid and
  differentiable marching tetrahedra with the JAX module's static-shape
  contract (two triangle slots a tet, unused slots all-zero and masked;
  edge points (s_b v_a - s_a v_b) / (s_b - s_a), so the triangles carry
  gradients to the sdf and the vertices);
- `TetrahedraSDFGrid` (tetrahedra-sdf-grid): the per-vertex sdf and
  deformation are the parameters (the sphere init, the deformation
  bounded by tanh to half a cell), with a hash-grid feature field;
- `CustomMesh` (custom-mesh): a fixed triangle mesh with a learned feature
  field;
- `rasterize_mesh` and `face_normals` (the nvdiffrast rasterize +
  interpolate analogue, no antialiasing);
- `NVDiffRasterizer` (nvdiff-rasterizer): the geometry's isosurface
  rasterized with interpolated world positions, the features queried
  there, shaded by the material and composited over the background;
- `PatchRenderer` (patch-renderer): a downsampled global view and one
  full-resolution patch of any base renderer.

As in the rest of the port's NeRF stack, the renderers are plain classes
over `nn.Module`s that hold their parameters (`field`, a ModuleDict of
geometry, material and background); there is no `init_params`. Random
draws come from a `torch.Generator` or are injected (the patch origin).
The JAX module's docstring names a `DeferredVolumeRenderer` that has no
class behind it; the port has none either.

The z-buffer search of `rasterize_mesh` runs over chunks of faces without
gradient; the winning face's barycentrics are then re-derived
differentiably, so attributes and depth carry gradients to the vertices
and attributes. Before the search the faces that are masked or behind the
camera are dropped, keeping their order (marching tets leaves most of its
slots masked: at resolution 32, 393,216 slots for a few thousand live
triangles); such a face never wins, and the order keeps the lowest-index
tie rule, so the result is the JAX module's. A chunk holds at most
`MESH_CHUNK_ELEMENTS` pixel x face entries (the JAX module scans fixed
chunks of 256 faces padded to a multiple): at 512^2 pixels that is 256
faces, at 64^2 every face of a small mesh at once. A pixel keeps the first
face (lowest index) of least depth in every chunk layout, so neither the
chunk size nor the dropped faces change the result.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from humangaussian_torch import resolve_device
from humangaussian_torch.nerf.encoding import (
    FrequencyEncoding,
    HashGridConfig,
    HashGridEncoding,
    init_generator,
)
from humangaussian_torch.nerf.geometry import VanillaMLP
from humangaussian_torch.nerf.renderer import get_rays

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
    n_pix = px.shape[0]

    zbuf = torch.full((n_pix,), torch.inf, **f32)
    fbuf = torch.full((n_pix,), -1, dtype=torch.int64, device=dev)
    chunk = max(1, MESH_CHUNK_ELEMENTS // n_pix)
    with torch.no_grad():
        keep = torch.nonzero(front).squeeze(1)  # in order
        ksx, ksy, ksz = (v.detach()[keep] for v in (sx, sy, sz))
        for base in range(0, keep.shape[0], chunk):
            cx, cy, cz = (v[base:base + chunk] for v in (ksx, ksy, ksz))
            # degenerate (zero screen area) triangles, e.g. marching-tets
            # slivers, would pass the barycentric test everywhere
            area2 = ((cx[:, 1] - cx[:, 0]) * (cy[:, 2] - cy[:, 0])
                     - (cx[:, 2] - cx[:, 0]) * (cy[:, 1] - cy[:, 0]))
            ok = area2.abs() > 1e-9
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
            fbuf = torch.where(better, keep[base:base + chunk][amin], fbuf)

    hit = fbuf >= 0
    fid = fbuf.clamp_min(0)
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
        "face": torch.where(hit, fbuf, -1).to(torch.int32).reshape(
            height, width),
    }


def face_normals(tri_verts: torch.Tensor) -> torch.Tensor:
    """[F,3,3] -> unit normals [F,3]."""
    e1 = tri_verts[:, 1] - tri_verts[:, 0]
    e2 = tri_verts[:, 2] - tri_verts[:, 0]
    n = torch.linalg.cross(e1, e2)
    return n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-9)


# ---- regular tetrahedral grid (six tets per cube) -------------------------

# cube corner offsets indexed 0..7 as (dx, dy, dz) bit triples; the six tets
# share the 0-7 diagonal
_CUBE_TETS = np.array([[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7],
                       [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]], np.int64)

# the 6 edges of a tet as vertex-index pairs
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]],
                      np.int64)

# marching-tets triangle table: for each of the 16 sign configurations (bit
# i = sdf[v_i] < 0) up to 2 triangles of edge indices, -1 unused; faces are
# double-sided downstream, so the winding is only consistent per config
_MT_TABLE = np.full((16, 2, 3), -1, np.int64)
_MT_TABLE[0b0001, 0] = [0, 1, 2]
_MT_TABLE[0b1110, 0] = [0, 2, 1]
_MT_TABLE[0b0010, 0] = [0, 4, 3]
_MT_TABLE[0b1101, 0] = [0, 3, 4]
_MT_TABLE[0b0100, 0] = [1, 3, 5]
_MT_TABLE[0b1011, 0] = [1, 5, 3]
_MT_TABLE[0b1000, 0] = [2, 5, 4]
_MT_TABLE[0b0111, 0] = [2, 4, 5]
_MT_TABLE[0b0011] = [[1, 2, 4], [1, 4, 3]]
_MT_TABLE[0b1100] = [[1, 4, 2], [1, 3, 4]]
_MT_TABLE[0b0101] = [[0, 3, 5], [0, 5, 2]]
_MT_TABLE[0b1010] = [[0, 5, 3], [0, 2, 5]]
_MT_TABLE[0b0110] = [[0, 1, 5], [0, 5, 4]]
_MT_TABLE[0b1001] = [[0, 5, 1], [0, 4, 5]]


def tet_grid(resolution: int):
    """Vertices [(R+1)^3, 3] float32 in [0, 1]^3 and tets [6 R^3, 4]
    int32, as numpy arrays."""
    r = resolution
    lin = np.arange(r + 1, dtype=np.float32) / r
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    cx, cy, cz = np.meshgrid(np.arange(r), np.arange(r), np.arange(r),
                             indexing="ij")
    corners = np.stack(
        [(((cx + ((c >> 2) & 1)) * (r + 1) + cy + ((c >> 1) & 1)) * (r + 1)
          + cz + (c & 1)).reshape(-1) for c in range(8)], axis=1)
    tets = corners[:, _CUBE_TETS].reshape(-1, 4)
    return verts.astype(np.float32), tets.astype(np.int32)


def marching_tets(verts, sdf, tets):
    """Differentiable marching tetrahedra with static shapes.

    verts [V, 3] (possibly deformed), sdf [V], tets [T, 4] integer ->
    (tri_verts [2T, 3, 3], tri_mask [2T] bool): two triangle slots a tet,
    the unused ones all-zero and masked."""
    dev = verts.device
    tets = tets.long()
    tv = verts[tets]  # [T, 4, 3]
    ts = sdf[tets]  # [T, 4]
    occ = (ts < 0).long()
    config = occ[:, 0] | (occ[:, 1] << 1) | (occ[:, 2] << 2) | (occ[:, 3] << 3)
    edges = torch.from_numpy(_TET_EDGES).to(dev)
    sa, sb = ts[:, edges[:, 0]], ts[:, edges[:, 1]]  # [T, 6]
    va, vb = tv[:, edges[:, 0]], tv[:, edges[:, 1]]  # [T, 6, 3]
    denom = sb - sa
    safe = torch.where(denom.abs() > 1e-10, denom, 1e-10)
    w = torch.clamp(sb / safe, 0.0, 1.0)[..., None]  # the weight on v_a
    epts = w * va + (1.0 - w) * vb  # [T, 6, 3]
    tbl = torch.from_numpy(_MT_TABLE).to(dev)[config]  # [T, 2, 3]
    mask = (tbl >= 0).all(dim=-1)  # [T, 2]
    tris = torch.gather(
        epts[:, None].expand(-1, 2, -1, -1), 2,
        tbl.clamp_min(0)[..., None].expand(-1, -1, -1, 3))  # [T, 2, 3, 3]
    tris = torch.where(mask[..., None, None], tris, 0.0)
    return tris.reshape(-1, 3, 3), mask.reshape(-1)


@dataclasses.dataclass(frozen=True)
class TetSDFGridConfig:
    radius: float = 1.0
    isosurface_resolution: int = 32
    deformable: bool = True  # isosurface_deformable_grid
    n_feature_dims: int = 3
    hash_cfg: HashGridConfig = HashGridConfig()
    n_neurons: int = 64
    n_hidden_layers: int = 1
    geometry_only: bool = False
    sdf_init: str = "sphere"  # the analytic sphere sdf; else N(0, 0.1)
    sdf_init_radius: float = 0.5


def _unit_coords(points, radius: float):
    return torch.clamp((points / radius + 1.0) * 0.5, 0.0, 1.0)


class TetrahedraSDFGrid(nn.Module):
    """tetrahedra-sdf-grid: the sdf and the deformation of the grid's
    vertices are the parameters (not an MLP), with a hash-grid feature
    field for the texture."""

    def __init__(self, cfg: TetSDFGridConfig = TetSDFGridConfig(),
                 device="cuda", generator=None):
        super().__init__()
        c = self.cfg = cfg
        dev = resolve_device(device)
        gv, gt = tet_grid(c.isosurface_resolution)
        self.register_buffer("grid_verts", torch.from_numpy(gv).to(dev),
                             persistent=False)
        self.register_buffer("tets", torch.from_numpy(gt).long().to(dev),
                             persistent=False)
        self.sdf = nn.Parameter(torch.empty(gv.shape[0], device=dev))
        if c.deformable:
            self.deformation = nn.Parameter(
                torch.empty((gv.shape[0], 3), device=dev))
        if not c.geometry_only:
            gen = init_generator(generator)
            self.encoding = HashGridEncoding(c.hash_cfg, dev, gen)
            self.feature_network = VanillaMLP(
                self.encoding.n_output_dims, c.n_feature_dims, c.n_neurons,
                c.n_hidden_layers, dev, gen)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The sphere sdf (or N(0, 0.1) from numpy's seed 0, as the JAX
        module), zero deformation, then the feature field from
        `generator`."""
        c = self.cfg
        world = (self.grid_verts.cpu().numpy() * 2.0 - 1.0) * c.radius
        if c.sdf_init == "sphere":
            vals = np.linalg.norm(world, axis=-1) - c.sdf_init_radius
        else:
            vals = np.random.RandomState(0).normal(0, 0.1, world.shape[0])
        self.sdf.copy_(torch.from_numpy(vals.astype(np.float32)))
        if c.deformable:
            self.deformation.zero_()
        if not c.geometry_only:
            gen = init_generator(generator)
            self.encoding.reset_parameters(gen)
            self.feature_network.reset_parameters(gen)

    def isosurface(self):
        """(tri_verts [2T, 3, 3] in world coordinates, mask [2T])."""
        c = self.cfg
        v = self.grid_verts
        if c.deformable:
            # at most half a cell, so that no tet inverts
            v = v + torch.tanh(self.deformation) * (
                0.5 / c.isosurface_resolution)
        return marching_tets((v * 2.0 - 1.0) * c.radius, self.sdf, self.tets)

    def features(self, points):
        u = _unit_coords(points, self.cfg.radius)
        return self.feature_network(self.encoding(u))

    def forward(self, points, output_normal: bool = False):
        if self.cfg.geometry_only:
            return {}
        return {"features": self.features(points)}


@dataclasses.dataclass(frozen=True)
class CustomMeshConfig:
    n_feature_dims: int = 3
    encoding: str = "hashgrid"  # "hashgrid" | "frequency"
    hash_cfg: HashGridConfig = HashGridConfig()
    n_frequencies: int = 6
    n_neurons: int = 64
    n_hidden_layers: int = 1
    radius: float = 1.0


class CustomMesh(nn.Module):
    """custom-mesh: a fixed triangle mesh (verts [V, 3], faces [F, 3]; the
    caller loads, recentres and reorients it) with a learned surface
    feature field."""

    def __init__(self, verts, faces, cfg: CustomMeshConfig = CustomMeshConfig(),
                 device="cuda", generator=None):
        super().__init__()
        c = self.cfg = cfg
        dev = resolve_device(device)
        self.register_buffer("verts", torch.as_tensor(
            verts, dtype=torch.float32).to(dev), persistent=False)
        self.register_buffer("faces", torch.as_tensor(faces).long().to(dev),
                             persistent=False)
        gen = init_generator(generator)
        if c.encoding == "hashgrid":
            self.encoding = HashGridEncoding(c.hash_cfg, dev, gen)
        else:
            self.encoding = FrequencyEncoding(c.n_frequencies)
        self.feature_network = VanillaMLP(
            self.encoding.n_output_dims, c.n_feature_dims, c.n_neurons,
            c.n_hidden_layers, dev, gen)

    def isosurface(self):
        tris = self.verts[self.faces]  # [F, 3, 3]
        return tris, torch.ones(tris.shape[0], dtype=torch.bool,
                                device=tris.device)

    def forward(self, points, output_normal: bool = False):
        u = _unit_coords(points, self.cfg.radius)
        return {"features": self.feature_network(self.encoding(u))}


# ---- renderers -----------------------------------------------------------


class NVDiffRasterizer:
    """nvdiff-rasterizer: geometry.isosurface() -> mesh, rasterized with
    interpolated world positions, shaded by the material, composited over
    the background (the normal, position and colour outputs)."""

    def __init__(self, geometry, material, background, height: int = 256,
                 width: int = 256):
        self.geometry = geometry
        self.material = material
        self.background = background
        self.height = height
        self.width = width
        self.field = nn.ModuleDict({"geometry": geometry,
                                    "material": material,
                                    "background": background})

    def render(self, mvp, camera_position=None, light_positions=None) -> dict:
        """mvp [4, 4] (row-vector clip transform), camera_position [3],
        light_positions [3] -> {comp_rgb [H, W, 3], comp_normal [H, W, 3],
        opacity [H, W, 1], depth [H, W], mesh (tri_verts, mask)}."""
        h, w = self.height, self.width
        tris, mask = self.geometry.isosurface()
        out = rasterize_mesh(tris, mask, mvp, h, w, attrs=tris)
        pos = out["attr"].reshape(-1, 3)  # world positions
        geo = self.geometry(pos)
        nrm = face_normals(tris)[out["face"].clamp_min(0).reshape(-1).long()]
        mat_kwargs = {}
        if light_positions is not None:
            mat_kwargs = dict(positions=pos, normal=nrm,
                              light_positions=light_positions.expand(
                                  pos.shape))
        rgb = self.material(geo["features"], **mat_kwargs).reshape(h, w, 3)
        if camera_position is not None:
            dirs = pos - camera_position[None, :]
            dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True)
                           + 1e-8)
        else:
            dirs = torch.zeros_like(pos)
        bg = self.background(dirs).reshape(h, w, 3)
        m = out["mask"].to(torch.float32)[..., None]
        return {
            "comp_rgb": rgb * m + bg * (1.0 - m),
            "comp_normal": nrm.reshape(h, w, 3) * m,
            "opacity": m,
            "depth": out["depth"],
            "mesh": (tris, mask),
        }


class PatchRenderer:
    """patch-renderer: a global view at 1 / `global_downsample` of the
    resolution and one full-resolution patch, over a base renderer with
    `render_image(c2w, fovy, h, w, ...)` and `render_rays(origins, dirs,
    ...)` (the NeRF renderers)."""

    def __init__(self, base_renderer, patch_size: int = 32,
                 global_downsample: int = 4, global_detach: bool = False):
        self.base = base_renderer
        self.patch_size = patch_size
        self.global_downsample = global_downsample
        self.global_detach = global_detach

    def render_image(self, c2w, fovy, height: int, width: int,
                     generator=None, patch_origin=None, **kw) -> dict:
        """One camera (c2w [4, 4]). The base renders draw from `generator`
        (global view first); the patch's top-left corner (y0, x0) is drawn
        from it between the two renders, or passed as `patch_origin`, or,
        with neither, the centred patch. Returns {global, patch,
        patch_origin}."""
        ds = self.global_downsample
        glob = self.base.render_image(c2w, fovy, height // ds, width // ds,
                                      generator=generator, **kw)
        if self.global_detach:
            glob = {k: v.detach() for k, v in glob.items()}
        ps = self.patch_size
        if patch_origin is not None:
            y0, x0 = (int(v) for v in patch_origin)
        elif generator is not None:
            dev = generator.device
            y0 = int(torch.randint(0, height - ps + 1, (), generator=generator,
                                   device=dev))
            x0 = int(torch.randint(0, width - ps + 1, (), generator=generator,
                                   device=dev))
        else:
            y0 = x0 = (height - ps) // 2
        origins, dirs = get_rays(c2w, fovy, height, width)
        po = origins[y0:y0 + ps, x0:x0 + ps].reshape(-1, 3)
        pd = dirs[y0:y0 + ps, x0:x0 + ps].reshape(-1, 3)
        patch = self.base.render_rays(po, pd, generator=generator, **kw)
        patch = {k: v.reshape((ps, ps) + v.shape[1:])
                 for k, v in patch.items()}
        return {"global": glob, "patch": patch, "patch_origin": (y0, x0)}
