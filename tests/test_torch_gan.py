"""The port's GAN renderer and networks (humangaussian_torch/nerf/gan.py)
against the JAX package's, mirroring tests/test_gan.py: every network
(with Flax's "SAME" padding at even and odd sizes), the diagonal Gaussian,
the hinge losses, and `GANVolumeRenderer` at each of its three generator
levels and in the mode path, with the JAX call's draws (level, z, level
2's z) injected and the gradients to the generator and the base field.
The same Flax parameters (jittered with numpy) go to both through
`convert.py`; the JAX side runs under `jax.jit`.

Tolerances: network outputs within 1e-5 of their max |value| (float32;
the GroupNorms' statistics and the convolutions reassociate), the
renderer's outputs within 1e-5, KL within 1e-5 relative, gradients
within 1e-4 of their max |value|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.convert import (
    gan_state_dict_from_flax,
    nerf_state_dict_from_flax,
)
from humangaussian_torch.nerf import background as pbg
from humangaussian_torch.nerf import gan as pg
from humangaussian_torch.nerf import geometry as pgeo
from humangaussian_torch.nerf import material as pmat
from humangaussian_torch.nerf import renderer as pren
from humangaussian_torch.nerf.encoding import HashGridConfig as PHash
from humangaussian_torch.registry import find
from humangaussian_tpu.nerf import background as jbg
from humangaussian_tpu.nerf import gan as jg
from humangaussian_tpu.nerf import geometry as jgeo
from humangaussian_tpu.nerf import material as jmat
from humangaussian_tpu.nerf import renderer as jren
from humangaussian_tpu.nerf.encoding import HashGridConfig as JHash
from port_parity import _jitter, flax_leaves, nerf_leaves, np_

torch.set_num_threads(4)
Z = 2
HASH = dict(n_levels=2, log2_hashmap_size=10, base_resolution=4)


def _t(x):
    return torch.tensor(np.asarray(x))


def close(got, want, rel=1e-5, what=""):
    want = np.asarray(want)
    err = np.abs(np_(got) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-6), (what, err)


def test_same_padding_is_flax_s():
    assert pg._same_pad(32, 3, 1) == (1, 1)
    assert pg._same_pad(32, 3, 2) == (0, 1)
    assert pg._same_pad(31, 3, 2) == (1, 1)
    assert pg._same_pad(64, 4, 2) == (1, 1)
    assert pg._same_pad(8, 4, 1) == (1, 2)
    assert pg._same_pad(8, 1, 1) == (0, 0)


def _net_pair(jm, pm, xs, kind, seed=0):
    p = jax.jit(jm.init)(jax.random.PRNGKey(seed), *xs)
    leaves = _jitter(flax_leaves(p), np.random.RandomState(seed + 2))
    pm.load_state_dict(gan_state_dict_from_flax(leaves, kind))
    want = jax.jit(jm.apply)(jax.tree.map(jnp.asarray, leaves), *xs)
    with torch.no_grad():
        got = pm(*[_t(x) for x in xs])
    return got, want


@pytest.mark.parametrize("hw", [(8, 8), (6, 10)])
def test_generator_matches_jax(hw):
    rs = np.random.RandomState(0)
    z = rs.rand(2, *hw, 3 + Z).astype(np.float32)
    code = rs.randn(2, 64).astype(np.float32)
    got, want = _net_pair(jg.Generator(ch=8, z_channels=Z),
                          pg.Generator(ch=8, z_channels=Z), (z, code),
                          "generator")
    assert got.shape == (2, hw[0] * 4, hw[1] * 4, 3)
    close(got, want)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


@pytest.mark.parametrize("hw", [(32, 32), (30, 26)])
def test_local_encoder_matches_jax(hw):
    x = np.random.RandomState(1).rand(2, *hw, 3).astype(np.float32)
    got, want = _net_pair(jg.LocalEncoder(ch=8, z_channels=Z),
                          pg.LocalEncoder(ch=8, z_channels=Z), (x,),
                          "local_encoder")
    assert got.shape == np.asarray(want).shape
    close(got, want)


@pytest.mark.parametrize("hw,n_layers", [((64, 64), 3), ((40, 36), 2)])
def test_discriminator_matches_jax(hw, n_layers):
    x = np.random.RandomState(2).rand(2, *hw, 3).astype(np.float32)
    got, want = _net_pair(jg.NLayerDiscriminator(ndf=8, n_layers=n_layers),
                          pg.NLayerDiscriminator(ndf=8, n_layers=n_layers),
                          (x,), "discriminator")
    assert got.shape == np.asarray(want).shape and got.shape[-1] == 1
    close(got, want)


def test_global_encoder_matches_jax():
    x = np.random.RandomState(3).rand(1, 224, 224, 3).astype(np.float32)
    got, want = _net_pair(jg.GlobalEncoder(64), pg.GlobalEncoder(64), (x,),
                          "global_encoder")
    assert got.shape == (1, 64)
    close(got, want)


def test_diagonal_gaussian_and_hinge_losses_match_jax():
    p = np.random.RandomState(4).randn(2, 4, 4, 2 * Z).astype(np.float32)
    p[0, 0, 0, Z:] = 40.0  # logvar clamped at 20
    close(pg.diag_gaussian_mode(_t(p)), jg.diag_gaussian_mode(p), 0.0)
    close(pg.diag_gaussian_kl(_t(p)), jg.diag_gaussian_kl(p))
    key = jax.random.PRNGKey(1)
    eps = np.asarray(jax.random.normal(key, (2, 4, 4, Z)))
    close(pg.diag_gaussian_sample(_t(p), eps=_t(eps)),
          jg.diag_gaussian_sample(p, key))
    assert float(pg.diag_gaussian_kl(torch.zeros(1, 4, 4, 2 * Z))[0]) == 0.0
    real = np.array([2.0, -0.5, 0.3], np.float32)
    fake = np.array([-2.0, 0.7, 0.1], np.float32)
    close(pg.hinge_d_loss(_t(real), _t(fake)), jg.hinge_d_loss(real, fake))
    assert float(pg.hinge_d_loss(torch.full((4,), 2.0),
                                 torch.full((4,), -2.0))) == 0.0


def test_generator_and_discriminator_losses_match_jax():
    d = jg.NLayerDiscriminator(ndf=8, n_layers=2)
    x = np.random.RandomState(5).rand(1, 32, 32, 3).astype(np.float32)
    y = np.random.RandomState(6).rand(1, 32, 32, 3).astype(np.float32)
    dp = jax.jit(d.init)(jax.random.PRNGKey(1), x)
    leaves = _jitter(flax_leaves(dp), np.random.RandomState(7))
    pd = pg.NLayerDiscriminator(ndf=8, n_layers=2)
    pd.load_state_dict(gan_state_dict_from_flax(leaves, "discriminator"))
    jp = jax.tree.map(jnp.asarray, leaves)
    close(pg.generator_loss(pd, _t(y)).detach(),
          jg.generator_loss(d.apply, jp, y))
    dl = pg.discriminator_loss(pd, _t(x), _t(x))
    close(dl.detach(), jg.discriminator_loss(d.apply, jp, x, x))
    assert float(dl.detach()) >= 1.0 - 1e-5


@functools.lru_cache(maxsize=None)
def renderer_pair():
    jgeom = jgeo.ImplicitVolume(jgeo.ImplicitVolumeConfig(
        hash_cfg=JHash(**HASH), n_neurons=16, n_feature_dims=3 + 2 * Z))
    pgeom = pgeo.ImplicitVolume(pgeo.ImplicitVolumeConfig(
        hash_cfg=PHash(**HASH), n_neurons=16, n_feature_dims=3 + 2 * Z),
        "cpu")
    jbase = jren.NerfVolumeRenderer(
        jgeom, jmat.HybridRGBLatentMaterial(),
        jbg.SolidColorBackground(color=(1.0,) * (3 + 2 * Z)),
        jren.RendererConfig(num_samples_per_ray=8, randomized=False))
    pbase = pren.NerfVolumeRenderer(
        pgeom, pmat.HybridRGBLatentMaterial(),
        pbg.SolidColorBackground((1.0,) * (3 + 2 * Z), device="cpu"),
        pren.RendererConfig(num_samples_per_ray=8, randomized=False))
    jr = jg.GANVolumeRenderer(jbase, jg.GANRendererConfig(z_channels=Z))
    pr = pg.GANVolumeRenderer(pbase, pg.GANRendererConfig(z_channels=Z),
                              device="cpu")
    base = nerf_leaves(jbase.init_params(jax.random.PRNGKey(1)), 1)
    params = jax.jit(lambda k: jr.init_params(k, {}, lr_size=8))(
        jax.random.PRNGKey(0))
    leaves = {k: _jitter(flax_leaves(v), np.random.RandomState(i))
              for i, (k, v) in enumerate(params.items()) if k != "base"}
    pbase.field.load_state_dict(nerf_state_dict_from_flax(base))
    pr.nets.load_state_dict(gan_state_dict_from_flax(leaves))
    leaves["base"] = base
    return jr, jax.tree.map(jnp.asarray, leaves), pr


def _level_seed(level):
    """A key whose level draw in the JAX renderer is `level`."""
    for seed in range(64):
        k_lvl = jax.random.split(jax.random.PRNGKey(seed), 3)[0]
        if int(jax.random.randint(k_lvl, (), 0, 3)) == level:
            return seed
    raise AssertionError(level)


# at 1.5 the field covers most of the 8^2 low-resolution view; at 2.5
# (`test_decode_gradient_against_float64`) half of it is the constant
# background, where the global encoder's GroupNorms see near-constant
# groups and float32 gradients lose digits
C2W = np.eye(4, dtype=np.float32)
C2W[2, 3] = 1.5


@functools.lru_cache(maxsize=None)
def jax_render_grad(multi: bool):
    """The JAX render's (loss, outputs) and gradient, jitted once with the
    key as an argument (the level switch is inside the program)."""
    jr, _, _ = renderer_pair()
    gt = np.random.RandomState(8).rand(32, 32, 3).astype(np.float32)
    cot = np.random.RandomState(9).randn(32, 32, 3).astype(np.float32)

    def jloss(p, rng):
        out = jr.render_image(p, jnp.asarray(C2W), 0.8, 32, 32, rng=rng,
                              gt_rgb=gt, multi_level_guidance=multi)
        return jnp.sum(out["comp_gan_rgb"] * cot), out

    return jax.jit(jax.value_and_grad(jloss, has_aux=True)), gt, cot


@pytest.mark.parametrize("level", [None, 0, 1, 2])
def test_render_matches_jax_at_every_level_with_gradients(level):
    _, jp, pr = renderer_pair()
    multi = level is not None
    fn, gt, cot = jax_render_grad(multi)
    rng = jax.random.PRNGKey(_level_seed(level) if multi else 0)
    (_, jout), jgrad = fn(jp, rng)
    kw = {}
    if multi:
        assert int(jout["generator_level"]) == level
        _, k_z, k_z2 = jax.random.split(rng, 3)
        kw = dict(level=level, z_eps=_t(jax.random.normal(k_z, (1, 8, 8, Z))))
        if level == 2:
            kw["z2_eps"] = _t(jax.random.normal(k_z2, (1, 8, 8, Z)))
    pr.nets.zero_grad(set_to_none=True)
    pr.base.field.zero_grad(set_to_none=True)
    out = pr.render_image(_t(C2W), 0.8, 32, 32, gt_rgb=_t(gt),
                          multi_level_guidance=multi, **kw)
    assert out["generator_level"] == (level or 0)
    assert out["comp_gan_rgb"].shape == (32, 32, 3)
    assert out["comp_lr_rgb"].shape == (8, 8, 3)
    for k in ("comp_gan_rgb", "comp_rgb", "comp_lr_rgb", "opacity"):
        close(out[k].detach(), jout[k], what=k)
    close(out["posterior_kl"].detach(), jout["posterior_kl"], what="kl")
    (out["comp_gan_rgb"] * _t(cot)).sum().backward()
    gp = jgrad["generator"]["params"]
    close(pr.generator.conv_in.weight.grad,
          np.transpose(np.asarray(gp["Conv_0"]["kernel"]), (3, 2, 0, 1)),
          1e-4, "generator conv_in")
    close(pr.base.geometry.encoding.table.grad,
          jgrad["base"]["geometry"]["params"]["encoding"]["table"], 1e-4,
          "base hash table")
    assert float(pr.base.geometry.encoding.table.grad.abs().max()) > 0
    if level == 2:
        lp = jgrad["local_encoder"]["params"]
        close(pr.local_encoder.conv_in.weight.grad,
              np.transpose(np.asarray(lp["Conv_0"]["kernel"]), (3, 2, 0, 1)),
              1e-4, "local encoder")


def test_decode_gradient_against_float64(monkeypatch):
    """With half of the view the constant background (camera at 2.5), the
    gradient of the level-0 decode (the code coded from the
    render) through the port's float32 networks stays within 1e-4 of a
    float64 evaluation of the same networks; the JAX package's float32
    gradient misses it by about 1% (ROADMAP queue 3)."""
    import torch.nn.functional as F

    from humangaussian_torch.ops import groupnorm

    jr, jp, pr = renderer_pair()
    c2w = C2W.copy()
    c2w[2, 3] = 2.5
    with torch.no_grad():
        lr = pr.render_image(_t(c2w), 0.8, 32, 32)["comp_lr_rgb"][None]
    assert float((lr > 1.0 - 1e-3).float().mean()) >= 0.5
    z = np.random.RandomState(0).randn(1, 8, 8, Z).astype(np.float32)
    cot = np.random.RandomState(9).randn(1, 32, 32, 3).astype(np.float32)

    def port_grad(dtype):
        x = lr.to(dtype).clone().requires_grad_(True)
        y = pr._decode(x, _t(z).to(dtype), x)
        (y * _t(cot).to(dtype)).sum().backward()
        return x.grad.double().numpy()

    g32 = port_grad(torch.float32)

    def f64_norm(self, x):
        y = F.group_norm(x, self.num_groups, self.weight.double(),
                         self.bias.double(), self.eps)
        return F.silu(y) if self.silu else y

    monkeypatch.setattr(groupnorm.GroupNormAct, "forward", f64_norm)
    pr.nets.double()
    try:
        g64 = port_grad(torch.float64)
    finally:
        pr.nets.float()
    scale = np.abs(g64).max()
    assert np.abs(g32 - g64).max() <= 1e-4 * scale
    gj = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.sum(jr._decode(jp, x, z, x) * cot)))(lr.numpy()))
    assert np.abs(gj - g64).max() > 1e-3 * scale


def test_render_draws_levels_from_the_generator():
    _, _, pr = renderer_pair()
    gt = torch.rand(32, 32, 3)
    levels = set()
    with torch.no_grad():
        for seed in range(8):
            gen = torch.Generator().manual_seed(seed)
            out = pr.render_image(_t(C2W), 0.8, 32, 32, generator=gen,
                                  gt_rgb=gt, multi_level_guidance=True)
            levels.add(out["generator_level"])
            assert torch.isfinite(out["comp_gan_rgb"]).all()
    assert len(levels) >= 2


def test_registry():
    assert find("gan-volume-renderer") is pg.GANVolumeRenderer
