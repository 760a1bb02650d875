"""guidance/unet.py of the port against the Flax DualBranchUNet at
TINY_TEST_CONFIG, weights shared through `unet_state_dict_from_flax`,
float32, within 1e-4 of the reference's max: once with the matrix-product
attention everywhere, once with `flash_attention` on at a 16x16 latent
(256 tokens at level 0, so the JAX side runs its Pallas attention kernel in
interpret mode and the port `self_attention`). Both sides run their fused
GroupNorm (the JAX side's Pallas statistics in interpret mode). The same
tolerance holds `SingleUNet` (TINY_SINGLE_CONFIG with and without
`encoder_hid_proj`) and `branch_num = 2` with `fusion: learn`; the chunked
matrix-product attention equals its one-pass form."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.guidance import unet as port_unet
from humangaussian_torch.ops import attention as port_attention
from humangaussian_tpu.ops import groupnorm as jax_gn
from port_parity import _jitter, flax_leaves, tiny_single_unet_pair, \
    tiny_unet_pair
from torch_unet_mirror import TorchDualBranchUNet

torch.set_num_threads(1)
REL = 1e-4


def _inputs(latent, seed=0, b=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, latent, latent, 8).astype(np.float32),
            rng.randn(b, latent, latent, 8).astype(np.float32),
            np.array([10.0, 600.0], np.float32)[:b],
            (rng.randn(b, 7, 32) * 0.5).astype(np.float32),
            np.tile(np.array([[1024, 1024, 0, 0, 1024, 1024]], np.float32),
                    (b, 1)))


@pytest.mark.parametrize("flash,latent", [(False, 8), (True, 16)])
def test_forward_matches_flax(monkeypatch, flash, latent):
    monkeypatch.setattr(jax_gn, "FORCE_PALLAS_INTERPRET", True)
    module, params, port = tiny_unet_pair(seed=0, flash=flash, latent=latent)
    args = _inputs(latent)
    want = np.asarray(module.apply(params, *map(jnp.asarray, args)))
    calls = []
    real = port_attention._attention_forward
    monkeypatch.setattr(port_attention, "_attention_forward",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args))
    assert got.shape == (2, latent, latent, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want,
                               atol=REL * np.abs(want).max())
    # level 0 has 3 self-attention sites per stem (1 down, 2 up layers);
    # two stems -> 6 at 256 tokens; nothing passes the gate otherwise
    assert calls == ([torch.Size((2, 256, 2, 16))] * 6 if flash else [])


def test_input_gradient_matches_flax(monkeypatch):
    """The UNet differentiated with respect to its latents (GroupNorm's
    analytic backward on both sides)."""
    import jax

    monkeypatch.setattr(jax_gn, "FORCE_PALLAS_INTERPRET", True)
    module, params, port = tiny_unet_pair(seed=1, flash=False, latent=8)
    args = _inputs(8, seed=1)
    cot = np.random.RandomState(2).randn(2, 8, 8, 8).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(module.apply(
        params, a, b, *map(jnp.asarray, args[2:])) * cot), argnums=(0, 1))(
            jnp.asarray(args[0]), jnp.asarray(args[1]))
    port.requires_grad_(False)
    lat = [torch.tensor(a, requires_grad=True) for a in args[:2]]
    out = port(*lat, *map(torch.from_numpy, args[2:]))
    (out * torch.from_numpy(cot)).sum().backward()
    for t, w in zip(lat, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w,
                                   atol=REL * np.abs(w).max())


def test_state_dict_has_the_diffusers_names():
    """A state dict saved from the port has exactly the key set and shapes
    of the mirror of the reference's modified UNet2DConditionModel."""
    from humangaussian_tpu.guidance.unet import TINY_TEST_CONFIG as jax_tiny

    port = port_unet.DualBranchUNet(port_unet.TINY_TEST_CONFIG)
    mirror = TorchDualBranchUNet(jax_tiny)
    want = {k: tuple(v.shape) for k, v in mirror.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    assert "down_blocks_branch.0.0.resnets.0.norm1.weight" in want
    assert "up_blocks_branch.0.0.attentions.1.transformer_blocks.0.ff.net.0" \
        ".proj.weight" in want


def test_weight_types():
    """Weights in cfg.dtype, GroupNorm parameters float32, output
    float32."""
    cfg = dataclasses.replace(port_unet.TINY_TEST_CONFIG,
                              dtype=torch.bfloat16)
    port = port_unet.DualBranchUNet(cfg).eval()
    assert port.dtype == torch.bfloat16
    assert port.conv_norm_out.weight.dtype == torch.float32
    assert port.mid_block.resnets[0].norm1.bias.dtype == torch.float32
    assert port.mid_block.resnets[0].conv1.weight.dtype == torch.bfloat16
    args = _inputs(8)
    with torch.no_grad():
        out = port(*map(torch.from_numpy, args))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    port_unet.cast_weights(port, torch.float32)
    assert port.dtype == torch.float32


def test_full_width_config_counts():
    """SD2_BASE_CONFIG on the meta device: 899,719,048 parameters with its
    two 8-channel conv_in (the 899,696,008 of the reference's dry run, which
    builds them for 4 input channels, plus 2 x 4 x 320 x 9), 77 GroupNorms
    and 20 self-attention sites that pass the kernel's gate at 64^2."""
    with torch.device("meta"):
        unet = port_unet.DualBranchUNet(port_unet.SD2_BASE_CONFIG)
    n = sum(p.numel() for p in unet.parameters())
    assert n == 899_696_008 + 2 * 4 * 320 * 9
    from humangaussian_torch.ops.groupnorm import GroupNormAct

    norms = [m for m in unet.modules() if isinstance(m, GroupNormAct)]
    assert len(norms) == 77  # each runs once per forward
    flash = [m for m in unet.modules()
             if isinstance(m, port_unet.Attention) and m.use_flash]
    # attn1 sites; the mid block's 8 x 8 = 64 tokens fail the n % 128 gate
    assert len(flash) == 21


@pytest.mark.parametrize("field,value", [("branch_num", 2),
                                         ("fusion", "learn")])
def test_waiting_options_raise(field, value):
    """The two options that waited until item 19 now build and run: a
    forward of the right width (one prediction a branch) with finite
    values; an unknown fusion still raises."""
    cfg = dataclasses.replace(port_unet.TINY_TEST_CONFIG, **{field: value})
    port = port_unet.DualBranchUNet(cfg).eval()
    args = list(map(torch.from_numpy, _inputs(8)))
    if cfg.branch_num > 1:
        args[1] = [args[1]] * cfg.branch_num
        assert len(port.conv_in_branch) == 2
    else:
        assert port.fusion_conv.in_channels == 2 * 32
    with torch.no_grad():
        out = port(*args)
    assert out.shape == (2, 8, 8, 4 * (1 + cfg.branch_num))
    assert bool(torch.isfinite(out).all())
    with pytest.raises(ValueError):
        port_unet.DualBranchUNet(dataclasses.replace(
            port_unet.TINY_TEST_CONFIG, fusion="max"))


@pytest.mark.parametrize("encoder_hid_dim", [None, 48])
def test_single_unet_matches_flax(monkeypatch, encoder_hid_dim):
    monkeypatch.setattr(jax_gn, "FORCE_PALLAS_INTERPRET", True)
    module, params, port = tiny_single_unet_pair(
        seed=0, encoder_hid_dim=encoder_hid_dim)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([10.0, 600.0], np.float32)
    text = (rng.randn(2, 7, encoder_hid_dim or 32) * 0.5).astype(np.float32)
    want = np.asarray(module.apply(params, *map(jnp.asarray, (x, t, text))))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (x, t, text)))
    assert got.shape == (2, 8, 8, 4) and got.dtype == torch.float32
    assert (port.encoder_hid_proj is None) == (encoder_hid_dim is None)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=REL * np.abs(want).max())


def test_two_branches_with_learned_fusion_match_flax(monkeypatch):
    """branch_num = 2, fusion learn: the suffixed branch modules
    (conv_in_branch1, down_block_branch1_0, head_branch1, ...) and
    fusion_conv carried across by the converter, each branch fed its own
    input."""
    import jax

    from humangaussian_torch.convert import unet_state_dict_from_flax
    from humangaussian_tpu.guidance import unet as jax_unet

    monkeypatch.setattr(jax_gn, "FORCE_PALLAS_INTERPRET", True)
    jcfg = dataclasses.replace(jax_unet.TINY_TEST_CONFIG, branch_num=2,
                               fusion="learn")
    module = jax_unet.DualBranchUNet(jcfg)
    z = jnp.zeros((1, 8, 8, 8))
    params = module.init(jax.random.PRNGKey(4), z, [z, z], jnp.zeros((1,)),
                         jnp.zeros((1, 7, 32)), jnp.zeros((1, 6)))
    leaves = _jitter(flax_leaves(params), np.random.RandomState(5))
    sd = unet_state_dict_from_flax(leaves)
    assert "conv_in_branch.1.weight" in sd and "fusion_conv.weight" in sd
    port = port_unet.DualBranchUNet(dataclasses.replace(
        port_unet.TINY_TEST_CONFIG, branch_num=2, fusion="learn")).eval()
    port.load_state_dict(sd)
    x, xb, t, text, ids = _inputs(8, seed=6)
    xb2 = np.random.RandomState(7).randn(*xb.shape).astype(np.float32)
    want = np.asarray(module.apply(
        jax.tree.map(jnp.asarray, leaves), jnp.asarray(x),
        [jnp.asarray(xb), jnp.asarray(xb2)], *map(jnp.asarray,
                                                  (t, text, ids))))
    with torch.no_grad():
        got = port(torch.from_numpy(x), [torch.from_numpy(xb),
                                         torch.from_numpy(xb2)],
                   *map(torch.from_numpy, (t, text, ids)))
    assert got.shape == (2, 8, 8, 12)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=REL * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_attention_equals_one_pass(monkeypatch, dtype):
    """The matrix-product branch over chunks of the (batch x heads) rows
    against the same branch in one pass: every row's arithmetic is the
    same, so the outputs agree to within one ulp of their type."""
    rng = np.random.RandomState(8)
    b, n, m, h, d = 3, 64, 48, 5, 16
    q, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
               .to(dtype) for s in (n, m, m))
    monkeypatch.setattr(port_unet, "ATTN_CHUNK_BYTES", 1 << 40)
    one = port_unet.matmul_attention(q, k, v)
    per_row = n * m * 4
    for chunk in (per_row, 4 * per_row, 7 * per_row - 1):
        monkeypatch.setattr(port_unet, "ATTN_CHUNK_BYTES", chunk)
        got = port_unet.matmul_attention(q, k, v)
        assert got.shape == (b, n, h * d) and got.dtype == dtype
        ulp = torch.finfo(dtype).eps * one.float().abs().clamp_min(
            torch.finfo(dtype).tiny)
        assert bool(((got.float() - one.float()).abs() <= ulp).all())


def test_deep_floyd_config_counts():
    """IF_I_XL_CONFIG as a SingleUNet on the meta device: 6,831,512,518
    parameters, the count of the JAX module's `jax.eval_shape`; 90
    GroupNorms over the channel counts new to the kernels."""
    from humangaussian_torch.guidance.deep_floyd import IF_I_XL_CONFIG
    from humangaussian_torch.ops.groupnorm import GroupNormAct

    with torch.device("meta"):
        unet = port_unet.SingleUNet(IF_I_XL_CONFIG)
    assert sum(p.numel() for p in unet.parameters()) == 6_831_512_518
    norms = [m for m in unet.modules() if isinstance(m, GroupNormAct)]
    assert len(norms) == 90
    assert {m.num_channels for m in norms} == {704, 1408, 2112, 2816, 4224,
                                               5632}
    assert not any(m.use_flash for m in unet.modules()
                   if isinstance(m, port_unet.Attention))
