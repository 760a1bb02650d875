"""The port's NeRF stack (humangaussian_torch/nerf) against the JAX package
on the CPU: encodings, implicit volume, renderer, materials, backgrounds,
the SDF family, the mesh exporter and `convert.nerf_state_dict_from_flax`.

Both sides share one Flax init, carried over by the converter (biases
jittered, hash tables redrawn in +-0.5 so that the encoding's arithmetic
shows); the JAX side's random draws are handed to the port.

Tolerances: frequency encoding, materials and backgrounds 1e-6 absolute;
the hash grid's values 1e-6 absolute, its table gradient 1e-6 of the max
|grad|; the implicit volume's density, features and analytic normals 1e-5
of each output's max |value|, finite-difference normals 1e-4 (their
difference quotient divides the densities' rounding by 2 eps = 0.02),
parameter gradients 1e-4 of each leaf's max |grad|; renders: colors,
opacity, weights 1e-5 of their max, depth 1e-4 of its max, gradients 1e-4
of each leaf's max |grad|, except NeuS's scalar `variance`, a signed sum
over every sample of every ray, at 2e-3 of its value (in float32 it misses
a float64 evaluation by up to 1e-3 relative, on either package); the
exporter: equal face counts, every face's corners within 1e-5, each
mesh's vertices within 1e-5 of the other's, the texture within 1/255. The
vertex counts may differ by a weld: the exporter welds vertices whose
positions round to the same 1e-4 grid-unit key, and a duplicate pair
whose key sits within rounding of a boundary welds in one package only.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from humangaussian_torch.convert import nerf_state_dict_from_flax
from humangaussian_torch.nerf import background as pbg
from humangaussian_torch.nerf import encoding as penc
from humangaussian_torch.nerf import exporter as pexp
from humangaussian_torch.nerf import geometry as pgeo
from humangaussian_torch.nerf import material as pmat
from humangaussian_torch.nerf import renderer as pren
from humangaussian_torch.nerf import sdf as psdf
from humangaussian_tpu.nerf import background as jbg
from humangaussian_tpu.nerf import encoding as jenc
from humangaussian_tpu.nerf import exporter as jexp
from humangaussian_tpu.nerf import geometry as jgeo
from humangaussian_tpu.nerf import material as jmat
from humangaussian_tpu.nerf import renderer as jren
from humangaussian_tpu.nerf import sdf as jsdf
from port_parity import jax_render_draws, nerf_leaves, np_

torch.set_num_threads(1)

SMALL_HASH = dict(n_levels=4, log2_hashmap_size=12, base_resolution=4)
TINY_GEO = dict(encoding="hashgrid", n_neurons=16, n_hidden_layers=1)


def geo_cfgs(**kw):
    """(JAX, port) ImplicitVolumeConfig pair at the tiny widths."""
    hj = jenc.HashGridConfig(**SMALL_HASH)
    hp = penc.HashGridConfig(**SMALL_HASH)
    args = dict(TINY_GEO)
    args.update(kw)
    return (jgeo.ImplicitVolumeConfig(hash_cfg=hj, **args),
            pgeo.ImplicitVolumeConfig(hash_cfg=hp, **args))


def loaded(module, leaves):
    module.load_state_dict(nerf_state_dict_from_flax(leaves))
    return module


def jtree(leaves):
    return jax.tree.map(jnp.asarray, leaves)


def close(got, want, rel=None, atol=0.0, what=""):
    want = np.asarray(want)
    tol = atol + (rel * float(np.abs(want).max()) if rel else 0.0)
    np.testing.assert_allclose(np_(got), want, rtol=0, atol=tol,
                               err_msg=what)


def grads_close(port_module, jax_grads, rel, what="", rel_of=None):
    """Each parameter's .grad within `rel` of the JAX leaf's max |grad|
    (`rel_of` maps a parameter name to its own tolerance)."""
    want = nerf_state_dict_from_flax(jax.tree.map(np.asarray, jax_grads))
    got = {k: p.grad if p.grad is not None else torch.zeros_like(p)
           for k, p in port_module.named_parameters()}
    assert set(got) == set(want), (set(got), set(want))
    for k in want:
        w = want[k].numpy()
        close(got[k], w, rel=(rel_of or {}).get(k, rel), atol=1e-12,
              what=f"{what} {k}")


def value_and_grad(f):
    """jax.value_and_grad(f, has_aux=True), jitted: one compile of these
    small programs costs a tenth of their op-by-op dispatch."""
    return jax.jit(jax.value_and_grad(f, has_aux=True))


def cotangent(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def points(n, seed, scale=0.45):
    return (np.random.RandomState(seed).randn(n, 3) * scale).astype(
        np.float32)


# ---- encodings --------------------------------------------------------------


class TestEncodings:
    @pytest.mark.parametrize("n", [1, 4, 10])
    def test_frequency(self, n):
        x = points(50, n, 2.0)
        enc = jenc.FrequencyEncoding(n)
        want = enc.apply({}, jnp.asarray(x))
        got = penc.FrequencyEncoding(n)(torch.from_numpy(x))
        assert got.shape == (50, 6 * n) == want.shape
        close(got, want, atol=1e-6)

    def _hash_pair(self, cfg_kw, seed=0):
        jc = jenc.HashGridConfig(**cfg_kw)
        enc = jenc.HashGridEncoding(jc)
        params = enc.init(jax.random.PRNGKey(seed), jnp.zeros((2, 3)))
        leaves = nerf_leaves(params, seed)
        port = loaded(penc.HashGridEncoding(penc.HashGridConfig(**cfg_kw),
                                            device="cpu"), leaves)
        return enc, jtree(leaves), port

    def test_hash_values_and_table_gradient(self):
        enc, params, port = self._hash_pair(SMALL_HASH)
        x = np.random.RandomState(2).rand(400, 3).astype(np.float32)
        ct = cotangent((400, 8), 3)
        want, vjp = jax.vjp(lambda p: enc.apply(p, jnp.asarray(x)), params)
        (gwant,) = vjp(jnp.asarray(ct))
        got = port(torch.from_numpy(x))
        close(got, want, atol=1e-6, what="values")
        (got * torch.from_numpy(ct)).sum().backward()
        gw = np.asarray(gwant["params"]["table"])
        close(port.table.grad, gw, rel=1e-6, what="table grad")
        assert float(np.abs(gw).max()) > 0

    def test_hash_full_default(self):
        """16 levels x 2^19 x 2 with base 16: values at 3000 points and the
        per-level resolutions."""
        enc, params, port = self._hash_pair({}, seed=1)
        c = jenc.HashGridConfig()
        want_res = [int(jnp.floor(c.base_resolution
                                  * c.per_level_scale**li).astype(jnp.int32))
                    for li in range(c.n_levels)]
        assert port.resolutions == want_res
        assert want_res[-1] == 4096  # the double rounds up through float32
        x = np.random.RandomState(4).rand(3000, 3).astype(np.float32)
        want = enc.apply(params, jnp.asarray(x))
        close(port(torch.from_numpy(x)), want, atol=1e-6)

    def test_hash_products_past_2_32(self):
        """Corners near the far end of the finest level: the y and z
        products (primes 2,654,435,761 and 805,459,861) of every corner
        pass 2^32, where the uint32 hash wraps and the int64 one must
        mask the same low bits (the x prime is 1)."""
        enc, params, port = self._hash_pair({}, seed=2)
        x = (0.9 + 0.1 * np.random.RandomState(5).rand(500, 3)).astype(
            np.float32)
        p0 = np.floor(x * np.float32(4095.0)).astype(np.int64)
        assert (p0[:, 1] * 2654435761 > 2**32).all()
        assert (p0[:, 2] * 805459861 > 2**32).all()
        rows = penc.hash_rows(torch.from_numpy(p0)[:, None, :],
                              torch.tensor([4096]), 1 << 19)
        want_rows = []
        for i in (0, 1):
            for j in (0, 1):
                for k in (0, 1):
                    c = np.minimum(p0 + [i, j, k], 4095).astype(np.uint32)
                    want_rows.append(
                        (c[:, 0] * np.uint32(1)
                         ^ c[:, 1] * np.uint32(2654435761)
                         ^ c[:, 2] * np.uint32(805459861))
                        & np.uint32((1 << 19) - 1))
        np.testing.assert_array_equal(rows[:, :, 0].numpy(),
                                      np.stack(want_rows))
        close(port(torch.from_numpy(x)), enc.apply(params, jnp.asarray(x)),
              atol=1e-6)

    def test_hashgrid_interpolates(self):
        """The JAX suite's continuity check, as parity of two near
        points."""
        kw = dict(n_levels=2, log2_hashmap_size=10, base_resolution=4)
        enc, params, port = self._hash_pair(kw)
        x = np.array([[0.2, 0.3, 0.4], [0.2001, 0.3, 0.4]], np.float32)
        close(port(torch.from_numpy(x)), enc.apply(params, jnp.asarray(x)),
              atol=1e-6)


# ---- geometry ---------------------------------------------------------------


def geometry_pair(seed=0, **kw):
    jc, pc = geo_cfgs(**kw)
    geo = jgeo.ImplicitVolume(jc)
    params = geo.init(jax.random.PRNGKey(seed), jnp.zeros((4, 3)))
    leaves = nerf_leaves(params, seed)
    return geo, jtree(leaves), loaded(pgeo.ImplicitVolume(pc, "cpu"), leaves)


class TestGeometry:
    @pytest.mark.parametrize("kw", [
        dict(),
        dict(encoding="frequency"),
        dict(density_bias="blob_dreamfusion", density_activation="exp"),
        dict(density_bias=-0.5, density_activation="trunc_exp"),
        dict(normal_type="finite_difference"),
        dict(encoding="frequency", normal_type="finite_difference",
             n_hidden_layers=2),
    ], ids=["hash-analytic", "freq-analytic", "dreamfusion-exp",
            "const-trunc_exp", "hash-fd", "freq-fd-2layers"])
    def test_fields_normals_and_gradients(self, kw):
        geo, params, port = geometry_pair(**kw)
        x = points(64, 1)
        cts = {k: cotangent(s, i) for i, (k, s) in enumerate(
            (("density", (64, 1)), ("features", (64, 3)),
             ("normal", (64, 3))))}

        def f(p):
            out = geo.apply(p, jnp.asarray(x), output_normal=True)
            return sum(jnp.sum(out[k] * cts[k]) for k in cts), out

        (_, want), gw = value_and_grad(f)(params)
        got = port(torch.from_numpy(x), output_normal=True)
        fd = kw.get("normal_type") == "finite_difference"
        for k in cts:
            close(got[k], want[k], rel=1e-4 if fd and k == "normal" else 1e-5,
                  what=k)
        sum((got[k] * torch.from_numpy(cts[k])).sum() for k in cts).backward()
        grads_close(port, gw, 1e-4)

    def test_blob_bias_creates_central_density(self):
        geo, params, port = geometry_pair(seed=2)
        x = np.array([[0, 0, 0], [0.95, 0.95, 0.95]], np.float32)
        want = geo.apply(params, jnp.asarray(x))["density"]
        got = port(torch.from_numpy(x))["density"]
        close(got, want, rel=1e-5)
        assert float(got[0, 0]) > float(got[1, 0])

    def test_normals_under_no_grad(self):
        """render_eval's path: analytic normals under torch.no_grad()
        come back detached and equal to the differentiable ones."""
        _, _, port = geometry_pair(seed=3)
        x = torch.from_numpy(points(16, 4))
        with torch.no_grad():
            a = port(x, output_normal=True)
        b = port(x, output_normal=True)
        assert not a["normal"].requires_grad and b["normal"].requires_grad
        torch.testing.assert_close(a["normal"], b["normal"].detach(),
                                   rtol=0, atol=0)

    def test_init_distribution(self):
        """reset_parameters draws like Flax: zero biases, kernels in two
        standard deviations of 1/sqrt(fan_in) (lecun_normal), the table in
        +-1e-4."""
        _, pc = geo_cfgs()
        port = pgeo.ImplicitVolume(pc, "cpu",
                                   torch.Generator().manual_seed(0))
        t = port.encoding.table
        assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 4e-5
        w = port.density_network.hidden_0.weight
        std = (1 / w.shape[1]) ** 0.5 / 0.87962566103423978
        assert float(w.abs().max()) <= 2 * std
        assert abs(float(w.std()) / (1 / w.shape[1]) ** 0.5 - 1) < 0.1
        assert float(port.density_network.out.bias.abs().max()) == 0.0


# ---- renderer ---------------------------------------------------------------


def renderer_pair(seed=0, material="none", background="solid",
                  geo_kw=None, **rcfg):
    jc, pc = geo_cfgs(**(geo_kw or {}))
    mats = {"none": (jmat.NoMaterial(), pmat.NoMaterial()),
            "diffuse": (jmat.DiffuseWithPointLightMaterial(),
                        pmat.DiffuseWithPointLightMaterial())}
    bgs = {"solid": (jbg.SolidColorBackground(color=(0.2, 0.4, 0.6),
                                              learned=True),
                     pbg.SolidColorBackground((0.2, 0.4, 0.6), True, "cpu")),
           "env": (jbg.NeuralEnvironmentMapBackground(),
                   pbg.NeuralEnvironmentMapBackground(device="cpu"))}
    jr = jren.NerfVolumeRenderer(jgeo.ImplicitVolume(jc), mats[material][0],
                                 bgs[background][0],
                                 jren.RendererConfig(**rcfg))
    pr = pren.NerfVolumeRenderer(pgeo.ImplicitVolume(pc, "cpu"),
                                 mats[material][1], bgs[background][1],
                                 pren.RendererConfig(**rcfg))
    leaves = nerf_leaves(jr.init_params(jax.random.PRNGKey(seed)), seed)
    loaded(pr.field, leaves)
    return jr, jtree(leaves), pr


def rays(n, seed, spread=0.4):
    """Rays from a sphere of radius 2.5 aimed near the origin; with a
    `spread` of 0.15 or less every ray hits the [-1, 1]^3 box."""
    rs = np.random.RandomState(seed)
    o = rs.randn(n, 3).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + spread * rs.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o.astype(np.float32), d


RENDER_REL = {"comp_rgb": 1e-5, "comp_rgb_fg": 1e-5, "opacity": 1e-5,
              "weights": 1e-5, "depth": 1e-4, "comp_normal": 1e-5}


class TestRenderer:
    def test_ray_aabb(self):
        o, d = rays(200, 0)
        o[:5] = [0.0, 0.0, 3.0]
        d[:5] = [0.0, 0.0, -1.0]
        d[5:10] = [1.0, 0.0, 0.0]  # rays that miss
        want = jren.ray_aabb(jnp.asarray(o), jnp.asarray(d), 1.0)
        got = pren.ray_aabb(torch.from_numpy(o), torch.from_numpy(d), 1.0)
        for g, w in zip(got, want):
            close(g, w, atol=1e-6)
        np.testing.assert_allclose(np_(got[0])[0], 2.0, atol=1e-5)
        np.testing.assert_allclose(np_(got[1])[0], 4.0, atol=1e-5)

    @pytest.mark.parametrize("batched", [False, True])
    def test_get_rays(self, batched):
        rs = np.random.RandomState(1)
        c2ws, fovys = [], rs.uniform(0.5, 1.2, 3).astype(np.float32)
        for i in range(3):
            q, _ = np.linalg.qr(rs.randn(3, 3))
            c = np.eye(4, dtype=np.float32)
            c[:3, :3], c[:3, 3] = q, rs.randn(3)
            c2ws.append(c)
        want = [jren.get_rays(jnp.asarray(c), jnp.asarray(f), 12, 20)
                for c, f in zip(c2ws, fovys)]
        if batched:
            got = pren.get_rays(torch.from_numpy(np.stack(c2ws)),
                                torch.from_numpy(fovys), 12, 20)
            for j in range(2):
                close(got[j], np.stack([w[j] for w in want]), atol=1e-6)
        else:
            for c, f, w in zip(c2ws, fovys, want):
                got = pren.get_rays(torch.from_numpy(c), float(f), 12, 20)
                close(got[0], w[0], atol=1e-6)
                close(got[1], w[1], atol=1e-6)

    @pytest.mark.parametrize("jittered", [False, True])
    def test_sample_pdf(self, jittered):
        rs = np.random.RandomState(2)
        t = np.sort(rs.uniform(1, 4, (40, 24)), -1).astype(np.float32)
        w = (rs.rand(40, 24) ** 4).astype(np.float32)
        key = jax.random.PRNGKey(3)
        want = jren.sample_pdf(jnp.asarray(t), jnp.asarray(w), 16,
                               key if jittered else None)
        u = (torch.from_numpy(np.array(jax.random.uniform(key, (40, 16))))
             if jittered else None)
        got = pren.sample_pdf(torch.from_numpy(t), torch.from_numpy(w), 16,
                              u)
        close(got, want, rel=1e-6)

    @pytest.mark.parametrize("case", ["plain", "importance", "normals",
                                      "centres"])
    def test_render_rays(self, case):
        kw = dict(num_samples_per_ray=24)
        call = {}
        material, background = "none", "solid"
        if case == "importance":
            kw["num_importance_samples"] = 16
        spread = 0.4
        if case == "normals":
            material, background = "diffuse", "env"
            call = dict(shading="diffuse", output_normal=True)
            # every ray hits the box: see test_normals_of_missed_rays
            spread = 0.15
        if case == "centres":
            kw["randomized"] = False
        jr, params, pr = renderer_pair(3, material, background, **kw)
        o, d = rays(96, 4, spread)
        assert case != "normals" or bool(
            (pren.ray_aabb(torch.from_numpy(o), torch.from_numpy(d), 1.0)[0]
             < 2.5).all())
        light = (np.random.RandomState(5).randn(96, 3) * 2).astype(
            np.float32)
        key = jax.random.PRNGKey(6)
        want = jr.render_rays(params, jnp.asarray(o), jnp.asarray(d), key,
                              jnp.asarray(light), **call)
        cts = {k: cotangent(v.shape, i) for i, (k, v) in
               enumerate(want.items())}

        def f(p):
            out = jr.render_rays(p, jnp.asarray(o), jnp.asarray(d), key,
                                 jnp.asarray(light), **call)
            return sum(jnp.sum(out[k] * cts[k]) for k in cts), out

        (_, want), gw = value_and_grad(f)(params)
        jitter, fine = jax_render_draws(key, 96, 24,
                                        kw.get("num_importance_samples", 0))
        got = pr.render_rays(torch.from_numpy(o), torch.from_numpy(d),
                             jitter, fine,
                             light_positions=torch.from_numpy(light), **call)
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k], rel=RENDER_REL[k], what=k)
        sum((got[k] * torch.from_numpy(cts[k])).sum()
            for k in cts).backward()
        grads_close(pr.field, gw, 1e-4, case)

    def test_normals_of_missed_rays(self):
        """A ray that misses the box samples far outside it, where the
        blob bias drives softplus to 0 and the density gradient is
        exactly 0. The JAX package's gradient through its normal
        (g / |g|) is NaN there; the port's is finite (torch's norm has
        gradient 0 at 0) and equal to JAX's on every ray that hits
        (ROADMAP queue 3)."""
        jr, params, pr = renderer_pair(3, "diffuse", "env",
                                       num_samples_per_ray=24,
                                       randomized=False)
        o, d = rays(96, 4)
        hit = np_(pren.ray_aabb(torch.from_numpy(o), torch.from_numpy(d),
                                1.0)[0]) < 2.5
        assert not hit.all()
        call = dict(shading="diffuse", output_normal=True)

        def f(p):
            out = jr.render_rays(p, jnp.asarray(o), jnp.asarray(d), None,
                                 **call)
            return jnp.sum(out["comp_normal"]), out

        _, gw = value_and_grad(f)(params)
        assert np.isnan(np.asarray(
            gw["geometry"]["params"]["density_network"]["out"]["kernel"])
        ).any()
        out = pr.render_rays(torch.from_numpy(o), torch.from_numpy(d), **call)
        out["comp_normal"].sum().backward()
        for p in pr.field.parameters():
            assert p.grad is None or bool(torch.isfinite(p.grad).all())

    def test_render_image_batch_matches_per_camera(self):
        """The port's one-call batch against JAX's per-camera renders of a
        camera at +z (the JAX suite's opaque-centre scene) and a second
        one."""
        jr, params, pr = renderer_pair(7, "none", "solid",
                                       num_samples_per_ray=32)
        c2w = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
        c2w[0, 2, 3] = 3.0
        c2w[1, :3, :3] = [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]
        c2w[1, 0, 3] = 2.5
        fovy = np.array([0.8, 0.7], np.float32)
        keys = jax.random.split(jax.random.PRNGKey(8), 2)
        want = [jr.render_image(params, jnp.asarray(c2w[i]), fovy[i], 16, 16,
                                keys[i]) for i in range(2)]
        jit = torch.stack([jax_render_draws(k, 256, 32)[0] for k in keys])
        got = pr.render_image(torch.from_numpy(c2w), torch.from_numpy(fovy),
                              16, 16, jit)
        for k in want[0]:
            close(got[k], np.stack([w[k] for w in want]),
                  rel=RENDER_REL[k], what=k)
        op = np_(got["opacity"])[0, ..., 0]
        assert op[8, 8] > 0.9 and op[8, 8] > op[0, 0]

# ---- materials and backgrounds ----------------------------------------------


def shading_inputs(n=40, f=8, seed=0):
    rs = np.random.RandomState(seed)
    feats = rs.randn(n, f).astype(np.float32)
    pos = (0.3 * rs.randn(n, 3)).astype(np.float32)
    nrm = rs.randn(n, 3)
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(
        np.float32)
    light = (2 * rs.randn(n, 3)).astype(np.float32)
    view = rs.randn(n, 3)
    view = (view / np.linalg.norm(view, axis=-1, keepdims=True)).astype(
        np.float32)
    return feats, pos, nrm, light, view


def apply_both(jm, pm, feats, seed=0, **kw):
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(feats),
                     **{k: jnp.asarray(v) for k, v in kw.items()
                        if not isinstance(v, str)},
                     **{k: v for k, v in kw.items() if isinstance(v, str)})
    leaves = nerf_leaves(params, seed)
    loaded(pm, leaves)
    jkw = {k: (v if isinstance(v, str) else jnp.asarray(v))
           for k, v in kw.items()}
    pkw = {k: (v if isinstance(v, str) else torch.from_numpy(v))
           for k, v in kw.items()}
    return (pm(torch.from_numpy(feats), **pkw),
            jm.apply(jtree(leaves), jnp.asarray(feats), **jkw))


class TestMaterialsAndBackgrounds:
    @pytest.mark.parametrize("act", ["sigmoid", "scale_-11_01", "clamp"])
    def test_no_material(self, act):
        feats = shading_inputs()[0] * 2
        got, want = apply_both(jmat.NoMaterial(act), pmat.NoMaterial(act),
                               feats)
        close(got, want, atol=1e-6)

    @pytest.mark.parametrize("shading", ["albedo", "diffuse", "textureless"])
    def test_diffuse_with_point_light(self, shading):
        feats, pos, nrm, light, _ = shading_inputs(seed=1)
        got, want = apply_both(
            jmat.DiffuseWithPointLightMaterial(),
            pmat.DiffuseWithPointLightMaterial(), feats, positions=pos,
            normal=nrm, light_positions=light, shading=shading)
        close(got, want, atol=1e-6)

    @pytest.mark.parametrize("with_dirs", [False, True])
    def test_neural_radiance(self, with_dirs):
        feats, _, _, _, view = shading_inputs(seed=2)
        kw = {"viewdirs": view} if with_dirs else {}
        got, want = apply_both(jmat.NeuralRadianceMaterial(),
                               pmat.NeuralRadianceMaterial(8, device="cpu"),
                               feats, **kw)
        close(got, want, atol=1e-6)

    @pytest.mark.parametrize("lit", [False, True])
    def test_pbr(self, lit):
        feats, pos, nrm, light, view = shading_inputs(seed=3)
        # half of the points face their light and viewer
        light[:20] = pos[:20] + 2 * nrm[:20]
        view[:20] = -nrm[:20]
        kw = dict(positions=pos, normal=nrm, light_positions=light,
                  viewdirs=view) if lit else {}
        got, want = apply_both(jmat.PBRMaterial(), pmat.PBRMaterial(),
                               feats, **kw)
        close(got, want, atol=1e-6)
        if lit:
            assert float(np.asarray(want).max()) > 0

    def test_sd_latent_adapter_and_hybrid(self):
        feats = shading_inputs(seed=4)[0]
        got, want = apply_both(jmat.SDLatentAdapterMaterial(),
                               pmat.SDLatentAdapterMaterial("cpu"), feats)
        close(got, want, atol=1e-6)
        got, want = apply_both(jmat.HybridRGBLatentMaterial(),
                               pmat.HybridRGBLatentMaterial(), feats)
        close(got, want, atol=1e-6)

    @pytest.mark.parametrize("color,learned", [((1.0, 0.5, 0.0), False),
                                               ((0.1, 0.2, 0.3, 0.4), True)])
    def test_solid_color(self, color, learned):
        d = shading_inputs(seed=5)[4]
        got, want = apply_both(jbg.SolidColorBackground(color, learned),
                               pbg.SolidColorBackground(color, learned,
                                                        "cpu"), d)
        close(got, want, atol=1e-6)

    @pytest.mark.parametrize("act", ["sigmoid", "clamp"])
    def test_neural_environment_map(self, act):
        d = shading_inputs(seed=6)[4] * 3
        got, want = apply_both(
            jbg.NeuralEnvironmentMapBackground(color_activation=act),
            pbg.NeuralEnvironmentMapBackground(act, device="cpu"), d)
        close(got, want, atol=1e-6)

    def test_textured(self):
        d = shading_inputs(n=200, seed=7)[4]
        jm = jbg.TexturedBackground(height=8, width=16)
        pm = pbg.TexturedBackground(8, 16, "cpu")
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(d))
        leaves = nerf_leaves(params)
        leaves["params"]["texture"] = np.random.RandomState(1).randn(
            8, 16, 3).astype(np.float32)
        loaded(pm, leaves)
        close(pm(torch.from_numpy(d)), jm.apply(jtree(leaves), jnp.asarray(d)),
              atol=1e-6)


# ---- the SDF family ---------------------------------------------------------


def sdf_cfgs(**kw):
    kw = dict(n_neurons=16, **kw)
    return (jsdf.ImplicitSDFConfig(
        hash_cfg=jenc.HashGridConfig(**SMALL_HASH), **kw),
            psdf.ImplicitSDFConfig(
        hash_cfg=penc.HashGridConfig(**SMALL_HASH), **kw))


class TestSDFFamily:
    @pytest.mark.parametrize("kw", [dict(), dict(normal_type="finite_difference"),
                                    dict(encoding="frequency", sdf_bias="none")],
                             ids=["hash-analytic", "hash-fd", "freq-nobias"])
    def test_implicit_sdf(self, kw):
        jc, pc = sdf_cfgs(**kw)
        geo = jsdf.ImplicitSDF(jc)
        leaves = nerf_leaves(geo.init(jax.random.PRNGKey(0),
                                      jnp.zeros((4, 3))), table_scale=0.05)
        port = loaded(psdf.ImplicitSDF(pc, "cpu"), leaves)
        x = points(48, 2)
        cts = {"sdf": cotangent((48, 1), 0),
               "features": cotangent((48, 3), 1),
               "normal": cotangent((48, 3), 2)}

        def f(p):
            out = geo.apply(p, jnp.asarray(x), output_normal=True)
            return sum(jnp.sum(out[k] * cts[k]) for k in cts), out

        (_, want), gw = value_and_grad(f)(jtree(leaves))
        got = port(torch.from_numpy(x), output_normal=True)
        fd = kw.get("normal_type") == "finite_difference"
        for k in cts:
            close(got[k], want[k], rel=1e-4 if fd and k == "normal" else 1e-5,
                  what=k)
        sum((got[k] * torch.from_numpy(cts[k])).sum() for k in cts).backward()
        grads_close(port, gw, 1e-4)
        if kw.get("sdf_bias", "sphere") == "sphere":
            # the sphere bias: negative inside radius 0.5, positive outside
            c = port(torch.tensor([[0.0, 0, 0], [0.9, 0.9, 0.9]]))["sdf"]
            assert float(c[0, 0]) < 0 < float(c[1, 0])

    def test_volume_grid(self):
        jm = jsdf.VolumeGrid(jsdf.VolumeGridConfig(grid_size=8))
        pm = psdf.VolumeGrid(psdf.VolumeGridConfig(grid_size=8), "cpu")
        leaves = nerf_leaves(jm.init(jax.random.PRNGKey(1),
                                     jnp.zeros((4, 3))))
        loaded(pm, leaves)
        x = points(300, 3, 0.6)
        x[:10] *= 4  # outside the box: clipped corners
        ct = {"density": cotangent((300, 1), 0),
              "features": cotangent((300, 3), 1)}

        def f(p):
            out = jm.apply(p, jnp.asarray(x))
            return sum(jnp.sum(out[k] * ct[k]) for k in ct), out

        (_, want), gw = value_and_grad(f)(jtree(leaves))
        got = pm(torch.from_numpy(x))
        for k in ct:
            close(got[k], want[k], atol=1e-6, what=k)
        sum((got[k] * torch.from_numpy(ct[k])).sum() for k in ct).backward()
        grads_close(pm, gw, 1e-5)

    @pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0])
    def test_neus_renderer(self, ratio):
        jc, pc = sdf_cfgs()
        rc = dict(num_samples_per_ray=48)
        jr = jsdf.NeusVolumeRenderer(
            jsdf.ImplicitSDF(jc), jmat.NeuralRadianceMaterial(),
            jbg.SolidColorBackground(color=(0.0, 0.0, 0.0)),
            jren.RendererConfig(**rc))
        pr = psdf.NeusVolumeRenderer(
            psdf.ImplicitSDF(pc, "cpu"),
            pmat.NeuralRadianceMaterial(3, device="cpu"),
            pbg.SolidColorBackground((0.0, 0.0, 0.0), device="cpu"),
            pren.RendererConfig(**rc), device="cpu")
        leaves = nerf_leaves(jr.init_params(jax.random.PRNGKey(2)),
                             table_scale=0.05)
        loaded(pr.field, leaves)
        o, d = rays(64, 3)
        key = jax.random.PRNGKey(4)
        cts = {k: cotangent(s, i) for i, (k, s) in enumerate(
            (("comp_rgb", (64, 3)), ("opacity", (64, 1)),
             ("depth", (64, 1))))}

        def f(p):
            out = jr.render_rays(p, jnp.asarray(o), jnp.asarray(d), key,
                                 cos_anneal_ratio=ratio)
            return sum(jnp.sum(out[k] * cts[k]) for k in cts), out

        (_, want), gw = value_and_grad(f)(jtree(leaves))
        jitter = torch.from_numpy(np.array(jax.random.uniform(key, (64, 48))))
        got = pr.render_rays(torch.from_numpy(o), torch.from_numpy(d), jitter,
                             cos_anneal_ratio=ratio)
        rel = dict(RENDER_REL, sdf=1e-5)
        for k in want:
            close(got[k], want[k], rel=rel[k], what=k)
        sum((got[k] * torch.from_numpy(cts[k])).sum() for k in cts).backward()
        grads_close(pr.field, gw, 1e-4, rel_of={"variance.variance": 2e-3})
        assert float(np.abs(np.asarray(gw["variance"]))) > 0

    def test_neus_sphere_silhouette(self):
        """The JAX suite's silhouette: one camera, stratum centres."""
        jc, pc = sdf_cfgs()
        rc = dict(num_samples_per_ray=48, randomized=False)
        jr = jsdf.NeusVolumeRenderer(
            jsdf.ImplicitSDF(jc), jmat.NoMaterial(),
            jbg.SolidColorBackground(color=(0.0, 0.0, 0.0)),
            jren.RendererConfig(**rc))
        pr = psdf.NeusVolumeRenderer(
            psdf.ImplicitSDF(pc, "cpu"), pmat.NoMaterial(),
            pbg.SolidColorBackground((0.0, 0.0, 0.0), device="cpu"),
            pren.RendererConfig(**rc), device="cpu")
        leaves = nerf_leaves(jr.init_params(jax.random.PRNGKey(3)),
                             table_scale=1e-4)
        loaded(pr.field, leaves)
        c2w = np.eye(4, dtype=np.float32)
        c2w[2, 3] = 3.0
        want = jr.render_image(jtree(leaves), jnp.asarray(c2w), 0.8, 16, 16)
        got = pr.render_image(torch.from_numpy(c2w), 0.8, 16, 16)
        for k in want:
            close(got[k], want[k], rel=dict(RENDER_REL, sdf=1e-5)[k], what=k)
        op = np_(got["opacity"])[..., 0]
        assert op[8, 8] > 0.5 and op[8, 8] > op[0, 0] + 0.3


class TestFidelityPass:
    """The JAX suite's fidelity cases (the importance pass, NeuS's
    cos-annealed estimator, the full Cook-Torrance terms) as parity checks
    that keep their properties."""

    def test_importance_sampling_beats_uniform(self):
        """The JAX suite's thin-shell check, as parity of the importance
        render on an analytic field."""
        import flax.linen as nn

        class JShell(nn.Module):
            @nn.compact
            def __call__(self, pts, output_normal=False):
                rad = jnp.linalg.norm(pts, axis=-1, keepdims=True)
                dens = 400.0 * jnp.exp(-(((rad - 0.6) / 0.01) ** 2))
                return {"density": dens, "features": jnp.broadcast_to(
                    jnp.array([0.8, 0.2, 0.1]), pts.shape[:-1] + (3,))}

        class PShell(torch.nn.Module):
            def forward(self, pts, output_normal=False):
                rad = torch.linalg.norm(pts, dim=-1, keepdim=True)
                dens = 400.0 * torch.exp(-(((rad - 0.6) / 0.01) ** 2))
                return {"density": dens, "features": torch.tensor(
                    [0.8, 0.2, 0.1]).expand(pts.shape[:-1] + (3,))}

            def reset_parameters(self, generator=None):
                pass

        bg = (0.0, 0.0, 0.0)
        params = {"geometry": {}, "material": {}, "background": {}}
        c2w = np.eye(4, dtype=np.float32)
        c2w[2, 3] = 2.0

        def both(**kw):
            cfg = dict(randomized=False, **kw)
            jr = jren.NerfVolumeRenderer(JShell(), jmat.NoMaterial(),
                                         jbg.SolidColorBackground(color=bg),
                                         jren.RendererConfig(**cfg))
            pr = pren.NerfVolumeRenderer(PShell(), pmat.NoMaterial(),
                                         pbg.SolidColorBackground(
                                             bg, device="cpu"),
                                         pren.RendererConfig(**cfg))
            want = jr.render_image(params, jnp.asarray(c2w), 0.8, 12, 12)
            got = pr.render_image(torch.from_numpy(c2w), 0.8, 12, 12)
            close(got["opacity"], want["opacity"], rel=1e-5)
            close(got["comp_rgb"], want["comp_rgb"], rel=1e-5)
            return np_(got["opacity"])

        ref = both(num_samples_per_ray=2048)
        uni = both(num_samples_per_ray=64)
        imp = both(num_samples_per_ray=32, num_importance_samples=32)
        assert np.abs(imp - ref).mean() < np.abs(uni - ref).mean()
        assert imp[6, 6, 0] > 0.8

    def test_neus_cos_anneal_ratio(self):
        """One ray through the sphere at ratio 0 and 1: both packages'
        weights agree, and ratio 1 gives the ascending (exit) sections no
        more weight than ratio 0."""
        jc, pc = sdf_cfgs()
        rc = dict(num_samples_per_ray=48, randomized=False)
        jr = jsdf.NeusVolumeRenderer(
            jsdf.ImplicitSDF(jc), jmat.NoMaterial(),
            jbg.SolidColorBackground(color=(0.0, 0.0, 0.0)),
            jren.RendererConfig(**rc))
        pr = psdf.NeusVolumeRenderer(
            psdf.ImplicitSDF(pc, "cpu"), pmat.NoMaterial(),
            pbg.SolidColorBackground((0.0, 0.0, 0.0), device="cpu"),
            pren.RendererConfig(**rc), device="cpu")
        leaves = jax.tree.map(np.asarray,
                              jr.init_params(jax.random.PRNGKey(3)))
        loaded(pr.field, leaves)
        o = np.array([[0.0, 0.0, 3.0]], np.float32)
        d = np.array([[0.0, 0.0, -1.0]], np.float32)
        w = {}
        for ratio in (0.0, 1.0):
            want = jr.render_rays(jtree(leaves), jnp.asarray(o),
                                  jnp.asarray(d), cos_anneal_ratio=ratio)
            got = pr.render_rays(torch.from_numpy(o), torch.from_numpy(d),
                                 cos_anneal_ratio=ratio)
            for k in want:
                close(got[k], want[k],
                      rel=dict(RENDER_REL, sdf=1e-5)[k], what=k)
            assert float(got["opacity"][0, 0]) > 0.5
            w[ratio] = np_(got["weights"])[0]
        sdf = np_(got["sdf"])[0]
        ascending = np.diff(sdf) > 0
        assert w[1.0][:-1][ascending].sum() <= (
            w[0.0][:-1][ascending].sum() + 1e-6)
        assert not np.allclose(w[0.0], w[1.0])

    def test_pbr_fresnel_and_energy(self):
        """A metallic feature under head-on, grazing and 16 random light /
        view directions: both packages agree and stay in [0, 1]."""
        feats = np.zeros((1, 5), np.float32)
        feats[0, 3] = 4.0
        n = np.array([[0.0, 0.0, 1.0]], np.float32)
        p = np.zeros((1, 3), np.float32)
        rs = np.random.RandomState(0)
        pairs = [([0.0, 0.0, 2.0], [0.0, 0.0, 1.0]),
                 ([0.0, 1.95, 0.45], [0.0, 0.975, 0.22])]
        for _ in range(16):
            ldir = rs.randn(3)
            ldir = np.abs(ldir / np.linalg.norm(ldir))
            pairs.append((2.0 * ldir, ldir))
        for light, view in pairs:
            kw = dict(positions=p, normal=n,
                      light_positions=np.asarray([light], np.float32),
                      viewdirs=-np.asarray([view], np.float32))
            got, want = apply_both(jmat.PBRMaterial(), pmat.PBRMaterial(),
                                   feats, **kw)
            close(got, want, atol=1e-6)
            assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


# ---- the exporter -----------------------------------------------------------


class TestExporter:
    def test_per_face_uv_atlas(self):
        for n in (1, 7, 50):
            want = jexp.per_face_uv_atlas(n, 256)
            got = pexp.per_face_uv_atlas(n, 256)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)

    def test_export_implicit_volume(self, tmp_path):
        jc, pc = geo_cfgs()
        geo = jgeo.ImplicitVolume(jc)
        leaves = nerf_leaves(geo.init(jax.random.PRNGKey(9),
                                      jnp.zeros((4, 3))), table_scale=0.3)
        port = loaded(pgeo.ImplicitVolume(pc, "cpu"), leaves)
        mat = jmat.DiffuseWithPointLightMaterial()
        jdir, pdir = tmp_path / "jax", tmp_path / "port"
        jexp.export_implicit_volume(str(jdir), geo, jtree(leaves),
                                    material=mat, material_params={},
                                    resolution=24, threshold=5.0,
                                    texture_size=128)
        obj = pexp.export_implicit_volume(
            str(pdir), port, pmat.DiffuseWithPointLightMaterial(),
            resolution=24, threshold=5.0, texture_size=128)
        assert obj == str(pdir / "model.obj")

        def read(d):
            lines = open(d / "model.obj").read().splitlines()
            v = np.array([[float(x) for x in ln.split()[1:]]
                          for ln in lines if ln.startswith("v ")])
            f = [ln for ln in lines if ln.startswith("f ")]
            tex = np.asarray(Image.open(d / "texture_kd.png"), np.int32)
            return v, f, tex, open(d / "model.mtl").read()

        jv, jf, jt, jm = read(jdir)
        pv, pf, pt, pm = read(pdir)
        assert len(pf) == len(jf) > 10 and pm == jm
        assert abs(len(pv) - len(jv)) <= 2

        def corners(v, f):
            idx = np.array([[int(c.split("/")[0]) - 1 for c in ln.split()[1:]]
                            for ln in f])
            return v[idx]

        np.testing.assert_allclose(corners(pv, pf), corners(jv, jf),
                                   atol=1e-5)
        for a, b in ((pv, jv), (jv, pv)):
            dist = np.abs(a[:, None, :] - b[None, :, :]).max(-1).min(-1)
            assert dist.max() <= 1e-5
        assert np.abs(pt - jt).max() <= 1


def test_converter_covers_every_module():
    """nerf_state_dict_from_flax maps every leaf of each module's Flax tree
    onto the port module's state dict, and nothing else is left."""
    jc, pc = geo_cfgs()
    sj, sp = sdf_cfgs()
    cases = [
        (jgeo.ImplicitVolume(jc), pgeo.ImplicitVolume(pc, "cpu"),
         jnp.zeros((4, 3))),
        (jsdf.ImplicitSDF(sj), psdf.ImplicitSDF(sp, "cpu"), jnp.zeros((4, 3))),
        (jsdf.VolumeGrid(), psdf.VolumeGrid(device="cpu"), jnp.zeros((4, 3))),
        (jbg.SolidColorBackground(learned=True),
         pbg.SolidColorBackground(learned=True, device="cpu"),
         jnp.zeros((4, 3))),
        (jbg.NeuralEnvironmentMapBackground(),
         pbg.NeuralEnvironmentMapBackground(device="cpu"), jnp.zeros((4, 3))),
        (jbg.TexturedBackground(), pbg.TexturedBackground(device="cpu"),
         jnp.zeros((4, 3))),
        (jmat.NeuralRadianceMaterial(),
         pmat.NeuralRadianceMaterial(5, device="cpu"), jnp.zeros((4, 5))),
        (jmat.SDLatentAdapterMaterial(),
         pmat.SDLatentAdapterMaterial("cpu"), jnp.zeros((4, 5))),
    ]
    for jm, pm, x in cases:
        params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), x))
        sd = nerf_state_dict_from_flax(params)
        own = pm.state_dict()
        assert set(sd) == set(own), (type(pm).__name__, set(sd) ^ set(own))
        for k, v in sd.items():
            assert v.shape == own[k].shape, k
        pm.load_state_dict(sd)
    jr = jsdf.NeusVolumeRenderer(jsdf.ImplicitSDF(sj), jmat.NoMaterial(),
                                 jbg.SolidColorBackground())
    pr = psdf.NeusVolumeRenderer(psdf.ImplicitSDF(sp, "cpu"),
                                 pmat.NoMaterial(),
                                 pbg.SolidColorBackground(device="cpu"),
                                 device="cpu")
    sd = nerf_state_dict_from_flax(jax.tree.map(
        np.asarray, jr.init_params(jax.random.PRNGKey(1))))
    assert "variance.variance" in sd
    pr.field.load_state_dict(sd)
    assert float(pr.variance.variance) == pytest.approx(0.3)


def test_port_imports_no_jax():
    """The new modules import torch, numpy and PIL, never JAX or the JAX
    package."""
    import ast
    import humangaussian_torch.nerf as nerf

    root = os.path.dirname(nerf.__file__)
    for name in sorted(os.listdir(root)):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(root, name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""]
                    if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in (
                    "jax", "flax", "optax", "humangaussian_tpu"), (name, m)
