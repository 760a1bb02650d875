"""The port's ControlNet guidance (humangaussian_torch/guidance/
controlnet.py) against the JAX package's, mirroring tests/
test_controlnet.py: zero-initialized taps, residual injection, the SDS
loss and the render gradient, the 1 x 1-projection UNet (SD 1.5's form)
and the converter. The same seeded weights (Flax init, every leaf
jittered with numpy) go to both packages through `convert.py`; the draws
of the JAX call (its per-sample keys) are injected into the port's.

Tolerances: residuals and UNet outputs within 1e-5 of the output's max
|value| (float32 networks, reassociation only); the SDS loss within 1e-5
relative; the render gradient within 1e-4 of its max |value|. The
conditioning embedding is built with equal widths (8, 8), where the JAX
module's layout and diffusers' (which the port follows) coincide; the
last test shows where they part.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.convert import (
    controlnet_state_dict_from_flax,
    unet_state_dict_from_flax,
    vae_state_dict_from_flax,
)
from humangaussian_torch.guidance import controlnet as pcn
from humangaussian_torch.guidance import unet as punet
from humangaussian_torch.guidance.schedule import sd_eps_schedule
from humangaussian_tpu.guidance import controlnet as jcn
from humangaussian_tpu.guidance.dual_branch import per_sample_normal
from humangaussian_tpu.guidance.schedule import DiffusionSchedule
from port_parity import flax_leaves, np_, tiny_vae_pair

torch.set_num_threads(4)
COND = (8, 8)
TOL = 1e-5


def _jitter_all(tree, rs, amount=0.05):
    """Every leaf moved by seeded noise: the zero-initialized taps and
    conv_out too, so that the residuals are not zero."""
    return {k: _jitter_all(v, rs, amount) if isinstance(v, dict)
            else (v + amount * rs.randn(*v.shape)).astype(np.float32)
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def pair():
    """(JAX UNet2D, its params, ControlNet, its params, port UNet2D, port
    ControlNet) at TINY_SD_CONFIG sharing their weights."""
    x = jnp.zeros((2, 8, 8, 4))
    ctx = jnp.zeros((2, 7, 32))
    t = jnp.array([1.0, 2.0])
    unet = jcn.UNet2D(jcn.TINY_SD_CONFIG)
    up = jax.jit(unet.init)(jax.random.PRNGKey(0), x, t, ctx)
    cn = jcn.ControlNet(jcn.TINY_SD_CONFIG, cond_embed_channels=COND)
    cp = jax.jit(cn.init)(jax.random.PRNGKey(1), x, t, ctx,
                          jnp.zeros((2, 16, 16, 3)))
    ul = _jitter_all(flax_leaves(up), np.random.RandomState(1))
    cl = _jitter_all(flax_leaves(cp), np.random.RandomState(2))
    pu = pcn.UNet2D(pcn.TINY_SD_CONFIG)
    pu.load_state_dict(unet_state_dict_from_flax(ul))
    pc = pcn.ControlNet(pcn.TINY_SD_CONFIG, COND)
    pc.load_state_dict(controlnet_state_dict_from_flax(cl))
    return (unet, jax.tree.map(jnp.asarray, ul), cn,
            jax.tree.map(jnp.asarray, cl), pu.eval(), pc.eval())


def _inputs(seed=0, b=2):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, 8, 8, 4).astype(np.float32),
            np.array([20.0, 700.0][:b], np.float32),
            rs.randn(b, 7, 32).astype(np.float32),
            rs.rand(b, 16, 16, 3).astype(np.float32))


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    err = np.abs(np_(got) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), (err, want.max())


def test_unet_uses_the_1x1_convolution_projection():
    u = pcn.UNet2D(pcn.TINY_SD_CONFIG)
    tr = u.down_blocks[0].attentions[0]
    assert tuple(tr.proj_in.weight.shape) == (32, 32, 1, 1)
    assert tuple(tr.proj_out.weight.shape) == (32, 32, 1, 1)
    sd2 = punet.SingleUNet(punet.TINY_SINGLE_CONFIG)
    assert tuple(sd2.down_blocks[0].attentions[0].proj_in.weight.shape) == \
        (32, 32)


def test_unet2d_matches_jax():
    unet, up, _, _, pu, _ = pair()
    x, t, ctx, _ = _inputs()
    want = jax.jit(unet.apply)(up, x, t, ctx)
    with torch.no_grad():
        got = pu(_t(x), _t(t), _t(ctx))
    _close(got, want)


def test_controlnet_residuals_and_injection_match_jax():
    unet, up, cn, cp, pu, pc = pair()
    x, t, ctx, cond = _inputs(1)
    jd, jm = jax.jit(cn.apply)(cp, x, t, ctx, cond)
    with torch.no_grad():
        pd, pm = pc(_t(x), _t(t), _t(ctx), _t(cond))
    assert len(pd) == len(jd) == 4
    for got, want in zip(pd, jd):
        _close(got, want)
    _close(pm, jm)
    want = jax.jit(lambda p, *a: unet.apply(
        p, *a[:3], down_residuals=a[3], mid_residual=a[4]))(
        up, x, t, ctx, jd, jm)
    with torch.no_grad():
        got = pu(_t(x), _t(t), _t(ctx), down_residuals=pd, mid_residual=pm)
    _close(got, want)


def test_zero_init_taps_are_identity_and_taps_change_the_output():
    torch.manual_seed(0)
    pu = pcn.UNet2D(pcn.TINY_SD_CONFIG).eval()
    pc = pcn.ControlNet(pcn.TINY_SD_CONFIG, (8, 16)).eval()
    x, t, ctx, cond = (_t(a) for a in _inputs(2))
    with torch.no_grad():
        down, mid = pc(x, t, ctx, cond)
        assert len(down) == 4  # conv_in, resnet + downsample, resnet
        assert all(float(r.abs().max()) == 0.0 for r in down)
        assert float(mid.abs().max()) == 0.0
        base = pu(x, t, ctx)
        np.testing.assert_array_equal(
            pu(x, t, ctx, down_residuals=down, mid_residual=mid).numpy(),
            base.numpy())
        bumped = pu(x, t, ctx, down_residuals=[r + 0.1 for r in down],
                    mid_residual=mid + 0.1)
    assert float((bumped - base).abs().max()) > 1e-4


def _guidances():
    unet, up, cn, cp, pu, pc = pair()
    jvae, jvp, pvae = tiny_vae_pair(0)
    jg = jcn.ControlNetGuidance(
        unet=unet, unet_params=up, controlnet=cn, controlnet_params=cp,
        vae=jvae, vae_params=jvp,
        schedule=DiffusionSchedule.create(prediction_type="epsilon",
                                          rescale_betas_zero_snr=False),
        image_size=16)
    pg = pcn.ControlNetGuidance(pu, pc, pvae, sd_eps_schedule(device="cpu"),
                                image_size=16)
    return jg, pg


def test_sds_loss_and_render_gradient_match_jax():
    jg, pg = _guidances()
    rs = np.random.RandomState(3)
    b = 2
    control = rs.rand(b, 32, 32, 3).astype(np.float32)
    rgb = rs.rand(b, 32, 32, 3).astype(np.float32)
    text2 = rs.randn(2 * b, 7, 32).astype(np.float32)
    t = np.array([300, 600], np.int32)
    rng = jax.random.PRNGKey(2)

    def loss(x):
        return jg(control, x, text2, t, rng)["loss_sds"]

    j_loss, j_grad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(rgb))
    k_enc, k_noise = jax.random.split(rng)
    idx = jnp.arange(b, dtype=jnp.int32)
    shape = (b, 8, 8, 4)
    eps = np.array(per_sample_normal(k_enc, idx, shape))
    noise = np.array(per_sample_normal(k_noise, idx, shape))
    x = _t(rgb).requires_grad_(True)
    out = pg(_t(control), x, _t(text2), _t(t).long(), latent_eps=_t(eps),
             noise=_t(noise))
    out["loss_sds"].backward()
    assert float(out["loss_sds"].detach()) == pytest.approx(float(j_loss),
                                                            rel=1e-5)
    _close(x.grad, j_grad, 1e-4)
    assert float(x.grad.abs().max()) > 0


def test_generator_draws_and_injection_agree():
    _, pg = _guidances()
    rs = np.random.RandomState(4)
    control, rgb = (_t(rs.rand(2, 16, 16, 3).astype(np.float32))
                    for _ in range(2))
    text2 = _t(rs.randn(4, 7, 32).astype(np.float32))
    t = torch.tensor([100, 900])
    gen = torch.Generator().manual_seed(5)
    drawn = pg(control, rgb, text2, t, gen)
    gen = torch.Generator().manual_seed(5)
    eps = torch.randn((2, 8, 8, 4), generator=gen)
    noise = torch.randn((2, 8, 8, 4), generator=gen)
    injected = pg(control, rgb, text2, t, latent_eps=eps, noise=noise)
    assert float(drawn["loss_sds"]) == float(injected["loss_sds"])
    assert torch.isfinite(drawn["grad"]).all()


def test_converter_covers_the_port_module():
    _, _, _, cp, _, pc = pair()
    sd = controlnet_state_dict_from_flax(flax_leaves(cp))
    assert set(sd) == set(pc.state_dict())
    for k, v in pc.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


def test_diffusers_embedding_layout_differs_from_the_jax_module():
    """diffusers' (and the port's) block 2i keeps its input width and block
    2i + 1 widens it; the JAX module widens in block 2i. At the default
    (16, 32, 96, 256) a diffusers file loads into the port only."""
    port = pcn.ControlNetConditioningEmbedding(320)
    shapes = [tuple(b.weight.shape) for b in port.blocks]
    assert shapes[:2] == [(16, 16, 3, 3), (32, 16, 3, 3)]
    jax_emb = jcn.ControlNet(dataclasses.replace(
        jcn.TINY_SD_CONFIG, block_out_channels=(32,), attn_heads=(2,),
        down_block_has_attn=(False,)), cond_embed_channels=(16, 32))
    params = jax.eval_shape(
        jax_emb.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
        jnp.zeros((1,)), jnp.zeros((1, 7, 32)), jnp.zeros((1, 16, 16, 3)))
    a = params["params"]["cond_block_0a"]["kernel"].shape
    assert a == (3, 3, 16, 32)  # [kh, kw, in, out]: widens in block 2i


def test_dual_branch_unet_without_size_conditioning():
    cfg = dataclasses.replace(punet.TINY_TEST_CONFIG, num_time_ids=0)
    torch.manual_seed(0)
    u = punet.DualBranchUNet(cfg).eval()
    assert u.add_embedding is None
    x = torch.randn(1, 8, 8, 8)
    with torch.no_grad():
        out = u(x, x, torch.tensor([5.0]), torch.randn(1, 7, 32),
                torch.zeros(1, 0))
    assert out.shape == (1, 8, 8, 8) and torch.isfinite(out).all()


def test_configs_match():
    for name in ("SD15_CONFIG", "TINY_SD_CONFIG"):
        want = dataclasses.asdict(getattr(jcn, name))
        got = dataclasses.asdict(getattr(pcn, name))
        assert got.pop("dtype") == {"bfloat16": torch.bfloat16,
                                    "float32": torch.float32}[
            np.dtype(want.pop("dtype")).name]
        # the port's SDXL fields, at the defaults that build these as before
        assert got.pop("transformer_layers_per_block") == 1
        assert got.pop("pooled_text_dim") == 0
        assert got == want, name
