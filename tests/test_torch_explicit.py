"""The port's explicit geometries and mesh renderers (humangaussian_torch/
nerf/explicit.py) against the JAX package's, mirroring tests/
test_explicit.py: the tetrahedral grid, marching tets and its gradient,
TetrahedraSDFGrid, CustomMesh, NVDiffRasterizer and PatchRenderer. The
same seeded numpy inputs and Flax parameters (carried by `convert.py`) go
to both; the JAX functions run under `jax.jit`.

Tolerances: the grid and the triangle masks exact; triangle vertices
within 1e-6; rendered outputs within 1e-5 of each output's max |value|
(float32, reassociation only), depth 1e-4; gradients within 1e-4 of
their max |value|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.convert import (
    custom_mesh_state_dict_from_flax,
    nerf_state_dict_from_flax,
    tet_sdf_state_dict_from_flax,
)
from humangaussian_torch.nerf import background as pbg
from humangaussian_torch.nerf import explicit as pex
from humangaussian_torch.nerf import geometry as pgeo
from humangaussian_torch.nerf import material as pmat
from humangaussian_torch.nerf import renderer as pren
from humangaussian_torch.nerf.encoding import HashGridConfig as PHash
from humangaussian_tpu.nerf import background as jbg
from humangaussian_tpu.nerf import explicit as jex
from humangaussian_tpu.nerf import geometry as jgeo
from humangaussian_tpu.nerf import material as jmat
from humangaussian_tpu.nerf import renderer as jren
from humangaussian_tpu.nerf.encoding import HashGridConfig as JHash
from port_parity import nerf_leaves, np_

torch.set_num_threads(4)
HASH = dict(n_levels=2, log2_hashmap_size=10, base_resolution=4)


def _t(x):
    return torch.tensor(np.asarray(x))


def close(got, want, rel=1e-5, what=""):
    want = np.asarray(want)
    err = np.abs(np_(got) - want).max() if want.size else 0.0
    assert err <= rel * max(np.abs(want).max(), 1e-6), (what, err)


def jtree(leaves):
    return jax.tree.map(jnp.asarray, leaves)


def perspective_mvp(eye_z=3.0, hw=32):
    from humangaussian_tpu.core.camera import camera_from_c2w, look_at_c2w

    c2w = look_at_c2w(jnp.array([0.0, 0.0, eye_z]), jnp.zeros(3),
                      jnp.array([0.0, 1.0, 0.0]))
    return np.asarray(camera_from_c2w(c2w, 0.8, hw, hw).full_proj)


def test_grid_equals_jax():
    for r in (1, 4, 7):
        jv, jt = jex.tet_grid(r)
        pv, pt = pex.tet_grid(r)
        np.testing.assert_array_equal(pv, jv)
        np.testing.assert_array_equal(pt, jt)
        assert pt.dtype == np.int32 and pv.dtype == np.float32


def _sphere(res=12, radius=0.5, seed=0):
    v, t = jex.tet_grid(res)
    world = (v * 2.0 - 1.0).astype(np.float32)
    world = world + np.random.RandomState(seed).uniform(
        -0.02, 0.02, world.shape).astype(np.float32)
    sdf = (np.linalg.norm(world, axis=-1) - radius).astype(np.float32)
    return world, sdf, t


def test_marching_tets_matches_jax_with_its_gradient():
    world, sdf, tets = _sphere()
    cot = np.random.RandomState(1).randn(2 * tets.shape[0], 3, 3).astype(
        np.float32)

    def jloss(w, s):
        tris, mask = jex.marching_tets(w, s, jnp.asarray(tets))
        return jnp.sum(tris * mask[:, None, None] * cot), (tris, mask)

    (_, (jtris, jmask)), (jgw, jgs) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(world, sdf)
    w, s = _t(world).requires_grad_(True), _t(sdf).requires_grad_(True)
    tris, mask = pex.marching_tets(w, s, _t(tets))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert int(mask.sum()) > 100
    close(tris, jtris, 1e-6)
    (tris * mask[:, None, None] * _t(cot)).sum().backward()
    close(s.grad, jgs, 1e-4, "d/dsdf")
    close(w.grad, jgw, 1e-4, "d/dverts")
    assert float(s.grad.abs().max()) > 0
    live = tris[mask].detach().reshape(-1, 3).norm(dim=-1)
    assert abs(float(live.mean()) - 0.5) < 0.05


@functools.lru_cache(maxsize=None)
def tet_pair(res=8, seed=0, deform=0.3):
    jg = jex.TetrahedraSDFGrid(jex.TetSDFGridConfig(
        isosurface_resolution=res, hash_cfg=JHash(**HASH)))
    params = jax.jit(jg.init)(jax.random.PRNGKey(seed), jnp.zeros((4, 3)))
    leaves = nerf_leaves(params, seed)
    rs = np.random.RandomState(seed + 5)
    p = leaves["params"]
    p["deformation"] = (deform * rs.randn(*p["deformation"].shape)).astype(
        np.float32)
    p["sdf"] = (p["sdf"] + 0.02 * rs.randn(*p["sdf"].shape)).astype(
        np.float32)
    pg = pex.TetrahedraSDFGrid(pex.TetSDFGridConfig(
        isosurface_resolution=res, hash_cfg=PHash(**HASH)), "cpu")
    pg.load_state_dict(tet_sdf_state_dict_from_flax(leaves))
    return jg, jtree(leaves), pg


def test_tet_sdf_grid_matches_jax():
    jg, jp, pg = tet_pair()
    jtris, jmask = jax.jit(lambda p: jg.apply(p, method="isosurface"))(jp)
    tris, mask = pg.isosurface()
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    close(tris, jtris, 1e-6)
    pts = np.random.RandomState(2).uniform(-1, 1, (50, 3)).astype(np.float32)
    close(pg(_t(pts))["features"], jax.jit(jg.apply)(jp, pts)["features"])


def test_tet_sdf_grid_sphere_init_and_defaults():
    pg = pex.TetrahedraSDFGrid(pex.TetSDFGridConfig(
        isosurface_resolution=8, hash_cfg=PHash(**HASH)), "cpu")
    tris, mask = pg.isosurface()
    r = tris[mask].detach().reshape(-1, 3).norm(dim=-1)
    assert abs(float(r.mean()) - 0.5) < 0.1
    assert float(pg.deformation.abs().max()) == 0.0
    assert pg(torch.zeros(5, 3))["features"].shape == (5, 3)
    full = pex.TetSDFGridConfig()
    v, t = pex.tet_grid(full.isosurface_resolution)
    assert v.shape == (35937, 3) and 2 * t.shape[0] == 393216


def test_rasterize_mesh_drops_masked_slots_without_changing_the_result():
    jg, jp, pg = tet_pair()
    tris, mask = pg.isosurface()
    mvp = perspective_mvp(3.0, 24)
    want = jax.jit(lambda a, m: jex.rasterize_mesh(a, m, mvp, 24, 24))(
        np_(tris), np_(mask))
    got = pex.rasterize_mesh(tris.detach(), mask, _t(mvp), 24, 24)
    np.testing.assert_array_equal(got["face"].numpy(), np.asarray(want["face"]))
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    close(got["attr"], want["attr"])
    close(got["depth"], want["depth"], 1e-4)


def _nvdiff_pair(material="none"):
    jg, jp, pg = tet_pair()
    mats = {"none": (jmat.NoMaterial(), pmat.NoMaterial()),
            "diffuse": (jmat.DiffuseWithPointLightMaterial(),
                        pmat.DiffuseWithPointLightMaterial())}
    jr = jex.NVDiffRasterizer(
        jg, mats[material][0], jbg.SolidColorBackground(color=(0.1, 0.2, 0.3)),
        height=24, width=24)
    pr = pex.NVDiffRasterizer(
        pg, mats[material][1],
        pbg.SolidColorBackground((0.1, 0.2, 0.3), device="cpu"),
        height=24, width=24)
    params = {"geometry": jp, "material": {}, "background": {}}
    return jr, params, pr


@pytest.mark.parametrize("material", ["none", "diffuse"])
def test_nvdiff_rasterizer_matches_jax_with_gradients(material):
    jr, params, pr = _nvdiff_pair(material)
    mvp = perspective_mvp(3.0, 24)
    cam = np.array([0.0, 0.0, 3.0], np.float32)
    light = np.array([1.0, 2.0, 3.0], np.float32)
    kw = {} if material == "none" else {"light_positions": light}
    cot = np.random.RandomState(3).randn(24, 24, 3).astype(np.float32)

    def jloss(p):
        out = jr.render(p, mvp, camera_position=cam, **kw)
        return jnp.sum(out["comp_rgb"] * cot), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    pkw = {k: _t(v) for k, v in kw.items()}
    out = pr.render(_t(mvp), camera_position=_t(cam), **pkw)
    for k in ("comp_rgb", "comp_normal", "opacity"):
        close(out[k], jout[k], what=k)
    close(out["depth"], jout["depth"], 1e-4, "depth")
    op = out["opacity"][..., 0]
    assert float(op[12, 12]) > 0.5 and float(op[0, 0]) < 0.5
    pr.field.zero_grad(set_to_none=True)  # the cached pair is shared
    (out["comp_rgb"] * _t(cot)).sum().backward()
    g = jgrad["geometry"]["params"]
    close(pr.geometry.sdf.grad, g["sdf"], 1e-4, "d/dsdf")
    close(pr.geometry.deformation.grad, g["deformation"], 1e-4, "d/ddeform")
    close(pr.geometry.encoding.table.grad, g["encoding"]["table"], 1e-4,
          "d/dtable")
    assert float(pr.geometry.sdf.grad.abs().max()) > 0


def test_custom_mesh_matches_jax():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                     np.float32) * 0.8 - 0.2
    faces = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)
    for enc in ("hashgrid", "frequency"):
        jm = jex.CustomMesh(jnp.asarray(verts), jnp.asarray(faces),
                            jex.CustomMeshConfig(encoding=enc,
                                                 hash_cfg=JHash(**HASH)))
        params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((4, 3)))
        leaves = nerf_leaves(params, 1)
        pm = pex.CustomMesh(verts, faces, pex.CustomMeshConfig(
            encoding=enc, hash_cfg=PHash(**HASH)), "cpu")
        pm.load_state_dict(custom_mesh_state_dict_from_flax(leaves))
        tris, mask = pm.isosurface()
        assert tris.shape == (4, 3, 3) and bool(mask.all())
        jtris, _ = jm.apply(jtree(leaves), method="isosurface")
        close(tris, jtris, 0.0)
        pts = np.random.RandomState(4).uniform(-1, 1, (30, 3)).astype(
            np.float32)
        close(pm(_t(pts))["features"],
              jax.jit(jm.apply)(jtree(leaves), pts)["features"], what=enc)


def test_patch_renderer_matches_jax():
    jc = jgeo.ImplicitVolumeConfig(hash_cfg=JHash(**HASH))
    pc = pgeo.ImplicitVolumeConfig(hash_cfg=PHash(**HASH))
    jb = jren.NerfVolumeRenderer(
        jgeo.ImplicitVolume(jc), jmat.NoMaterial(),
        jbg.SolidColorBackground(),
        jren.RendererConfig(num_samples_per_ray=16, randomized=False))
    pb = pren.NerfVolumeRenderer(
        pgeo.ImplicitVolume(pc, "cpu"), pmat.NoMaterial(),
        pbg.SolidColorBackground(device="cpu"),
        pren.RendererConfig(num_samples_per_ray=16, randomized=False))
    leaves = nerf_leaves(jb.init_params(jax.random.PRNGKey(0)), 0)
    pb.field.load_state_dict(nerf_state_dict_from_flax(leaves))
    jpr = jex.PatchRenderer(jb, patch_size=8, global_downsample=4)
    ppr = pex.PatchRenderer(pb, patch_size=8, global_downsample=4)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 3.0
    want = jpr.render_image(jtree(leaves), jnp.asarray(c2w), 0.8, 32, 32,
                            rng=jax.random.PRNGKey(1))
    y0, x0 = (int(v) for v in want["patch_origin"])
    got = ppr.render_image(_t(c2w), 0.8, 32, 32, patch_origin=(y0, x0))
    assert got["patch_origin"] == (y0, x0)
    assert got["global"]["comp_rgb"].shape == (8, 8, 3)
    assert got["patch"]["comp_rgb"].shape == (8, 8, 3)
    for part in ("global", "patch"):
        for k in ("comp_rgb", "opacity", "depth"):
            close(got[part][k], want[part][k], 1e-5, f"{part} {k}")
    gen = torch.Generator().manual_seed(0)
    drawn = ppr.render_image(_t(c2w), 0.8, 32, 32, generator=gen)
    y, x = drawn["patch_origin"]
    assert 0 <= y <= 24 and 0 <= x <= 24
    centred = ppr.render_image(_t(c2w), 0.8, 32, 32)
    assert centred["patch_origin"] == (12, 12)
