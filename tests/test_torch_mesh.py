"""PyTorch port vs JAX: mesh extraction (mesh.py) and the mesh rasterizer
(nerf/explicit.py::rasterize_mesh, face_normals).

The same numpy scene (made from a seed) goes through both packages on the
CPU. Tolerances: the density field within 1e-5 of the field's max (float32
sums over a block's Gaussians in another order; XLA contracts products
into fused multiply-adds); marching tetrahedra bit-equal on one field (a
numpy copy); the rasterizer's face ids equal off depth ties and its
attributes and depth within 1e-5 where the faces agree.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch import mesh as tmesh
from humangaussian_torch.convert import scene_from_numpy
from humangaussian_torch.nerf.explicit import face_normals as t_normals
from humangaussian_torch.nerf.explicit import rasterize_mesh as t_raster
from humangaussian_tpu import mesh as jmesh
from humangaussian_tpu.core.scene import GaussianScene as JScene
from humangaussian_tpu.nerf.explicit import face_normals as j_normals
from humangaussian_tpu.nerf.explicit import rasterize_mesh as j_raster
from humangaussian_tpu.smplx.model import toy_model
from port_parity import jax_camera, np_


def _scene(n=400, seed=0, capacity=512):
    """A blob of `n` Gaussians with a dense knot of 120 at one corner (one
    block holds more than a lowered `block_capacity`), seeded scales,
    rotations and opacities, some below the extraction's opacity cut."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(n, 3).astype(np.float32) * 0.08
    pts[:120] = 0.15 + rng.randn(120, 3).astype(np.float32) * 0.004
    pad = capacity - n

    def padded(x, fill=0.0):
        return np.concatenate([x, np.full((pad,) + x.shape[1:], fill,
                                          np.float32)]).astype(np.float32)

    logits = rng.randn(n, 1).astype(np.float32) * 2 + 1
    logits[:5] = -8.0  # below min_opacity: left out
    return dict(
        means=padded(pts),
        log_scales=padded(np.log(0.02) + rng.randn(n, 3).astype(np.float32)
                          * 0.3, -10.0),
        quats=padded(rng.randn(n, 4).astype(np.float32)),
        sh_dc=padded(rng.randn(n, 3).astype(np.float32)),
        sh_rest=padded(np.zeros((n, 0, 3), np.float32)),
        opacity_logits=padded(logits, -10.0),
        alive=np.arange(capacity) < n,
    )


def _pair(d):
    return (JScene(**{k: jnp.asarray(v) for k, v in d.items()}),
            scene_from_numpy(d, device="cpu"))


@pytest.mark.parametrize("capacity", [8192, 64])
def test_density_field_matches_jax(capacity):
    jscene, tscene = _pair(_scene())
    kw = dict(resolution=32, num_blocks=4, block_capacity=capacity)
    want, wc, ws = jmesh.extract_density_field(jscene, **kw)
    got, gc, gs = tmesh.extract_density_field(tscene, **kw)
    counts = tmesh.block_counts(tscene, num_blocks=4)
    if capacity == 64:
        assert counts.max() > capacity  # the cap drops Gaussians
    np.testing.assert_array_equal(gc, np.asarray(wc))
    assert gs == ws
    assert got.dtype == np.float32 and got.shape == (32, 32, 32)
    tol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def test_density_field_in_small_chunks(monkeypatch):
    """The chunk size changes only which blocks run together."""
    _, tscene = _pair(_scene(seed=1))
    whole, _, _ = tmesh.extract_density_field(tscene, resolution=32,
                                              num_blocks=4)
    monkeypatch.setattr(tmesh, "FIELD_CHUNK_ELEMENTS", 1)
    chunked, _, _ = tmesh.extract_density_field(tscene, resolution=32,
                                                num_blocks=4)
    np.testing.assert_allclose(chunked, whole, rtol=0,
                               atol=1e-6 * float(whole.max()))


def test_gaussian_3d_coeff_matches_jax():
    rng = np.random.RandomState(2)
    m = rng.randn(50, 3, 3).astype(np.float32)
    cov = m @ m.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    cov6 = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    offs = rng.randn(50, 3).astype(np.float32)
    want = np.asarray(jmesh.gaussian_3d_coeff(jnp.asarray(offs),
                                              jnp.asarray(cov6)))
    got = tmesh.gaussian_3d_coeff(torch.from_numpy(offs),
                                  torch.from_numpy(cov6)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_marching_tetrahedra_and_mesh_match_jax(tmp_path):
    jscene, tscene = _pair(_scene(seed=3))
    field, _, _ = jmesh.extract_density_field(jscene, resolution=32,
                                              num_blocks=4)
    field = np.asarray(field)
    thr = 0.3 * float(field.max())
    gv, gt = tmesh.marching_tetrahedra(field, thr)
    wv, wt = jmesh.marching_tetrahedra(field, thr)
    assert gv.shape[0] > 50
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gt, wt)
    ev, et = tmesh.marching_tetrahedra(np.zeros((6, 6, 6), np.float32), 0.5)
    assert ev.shape == (0, 3) and et.shape == (0, 3)

    verts, tris = tmesh.extract_mesh(tscene, density_thresh=thr,
                                     resolution=32)
    jv, jt = jmesh.extract_mesh(jscene, density_thresh=thr, resolution=32)
    assert verts.dtype == np.float32 and tris.dtype == np.int32
    # the fields differ by float32 rounding, which can move a vertex that
    # sits at the threshold; the surfaces agree
    assert abs(len(tris) - len(jt)) <= 0.01 * len(jt)
    lo, hi = jv.min(0), jv.max(0)
    assert np.all(verts.min(0) >= lo - 1e-2) and np.all(
        verts.max(0) <= hi + 1e-2)
    path = tmesh.save_obj(str(tmp_path / "m" / "mesh.obj"), verts, tris)
    lines = open(path).read().splitlines()
    assert sum(ln.startswith("v ") for ln in lines) == len(verts)
    assert sum(ln.startswith("f ") for ln in lines) == len(tris)


def test_rasterize_mesh_matches_jax():
    model = toy_model(n_ring=16, n_seg_per_bone=4, radius=0.2)
    v = model.v_template
    verts = ((v - (v.max(0) + v.min(0)) / 2) * 1.5).astype(np.float32)
    tri = verts[model.faces]  # [F,3,3]
    mask = np.ones(tri.shape[0], bool)
    mask[::7] = False
    cam = jax_camera(48, 64, eye=(0.4, 0.3, 2.2))
    mvp = np.array(cam.full_proj, np.float32)

    j_nrm = j_normals(jnp.asarray(tri))
    t_nrm = t_normals(torch.from_numpy(tri))
    np.testing.assert_allclose(np_(t_nrm), np.asarray(j_nrm), atol=1e-6)
    attrs = np.concatenate([tri, np.broadcast_to(
        np.asarray(j_nrm)[:, None], tri.shape)], axis=-1)
    want = j_raster(jnp.asarray(tri), jnp.asarray(mask), jnp.asarray(mvp),
                    48, 64, attrs=jnp.asarray(attrs))
    got = t_raster(torch.from_numpy(tri), torch.from_numpy(mask),
                   torch.from_numpy(mvp), 48, 64,
                   attrs=torch.from_numpy(np.ascontiguousarray(attrs)))
    wf, gf = np.asarray(want["face"]), np_(got["face"])
    assert (wf >= 0).sum() > 300
    np.testing.assert_array_equal(np_(got["mask"]), np.asarray(want["mask"]))
    same = wf == gf
    # where the two pick different faces, both faces cover the pixel at the
    # same depth (a shared edge or a depth tie)
    assert (~same).sum() <= 0.01 * same.size
    np.testing.assert_allclose(np_(got["depth"])[~same],
                               np.asarray(want["depth"])[~same], atol=1e-5)
    np.testing.assert_allclose(np_(got["attr"])[same],
                               np.asarray(want["attr"])[same], atol=1e-5)
    np.testing.assert_allclose(np_(got["depth"])[same],
                               np.asarray(want["depth"])[same], atol=1e-5)


def test_rasterize_mesh_chunks_and_gradient(monkeypatch):
    """Chunks of one face give the same buffers; the attributes carry a
    gradient to the vertices."""
    from humangaussian_torch.nerf import explicit

    model = toy_model(n_ring=12, n_seg_per_bone=3)
    v = model.v_template
    tri = torch.from_numpy(((v - v.mean(0)) * 1.5).astype(np.float32)
                           [model.faces]).requires_grad_(True)
    mask = torch.ones(tri.shape[0], dtype=torch.bool)
    mvp = torch.from_numpy(np.array(jax_camera(32, 32).full_proj,
                                      np.float32))
    whole = t_raster(tri, mask, mvp, 32, 32)
    monkeypatch.setattr(explicit, "MESH_CHUNK_ELEMENTS", 1)
    small = t_raster(tri, mask, mvp, 32, 32)
    assert torch.equal(whole["face"], small["face"])
    whole["attr"].sum().backward()
    assert tri.grad is not None and float(tri.grad.abs().sum()) > 0
