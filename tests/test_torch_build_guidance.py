"""apps/launch.py::build_guidance of the port: the prior built from
diffusers-layout weight files on the CPU, at the tiny widths, and its
compute type against the reference's way of building the prior (its
converters and its `half_precision_weights` cast)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.apps import launch
from humangaussian_torch.guidance import unet as port_unet
from humangaussian_torch.guidance import vae as port_vae
from port_parity_torch import tiny_port_guidance

torch.set_num_threads(1)
B, HW = 2, 16
T = np.array([120, 700], np.int64)


def _scene(seed=3):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, HW, HW, 3).astype(np.float32),  # pose
            rng.rand(B, HW, HW, 3).astype(np.float32),  # rgb
            rng.rand(B, HW, HW, 3).astype(np.float32),  # depth
            (rng.randn(3 * B, 7, 32) * 0.2).astype(np.float32))


def _write_tiny_weights(root, pg):
    """The tiny prior's weights as diffusers-layout files."""
    (root / "joint" / "unet_ema").mkdir(parents=True)
    (root / "vae").mkdir()
    torch.save(pg.unet.state_dict(),
               root / "joint" / "unet_ema" / "diffusion_pytorch_model.bin")
    torch.save(pg.vae.state_dict(),
               root / "vae" / "diffusion_pytorch_model.bin")
    return {"system": {"guidance": {
        "arch": "tiny", "model_key": str(root / "joint"),
        "vae_key": str(root / "vae"), "guidance_scale": 7.5,
        "remat_encode": False}}}


def _bf16_exact(t):
    return torch.equal(t, t.to(torch.bfloat16).to(t.dtype))


@pytest.mark.parametrize("half", [False, True])
def test_build_guidance_loads_the_tiny_prior(tmp_path, half):
    """The launcher's guidance half: files -> DualBranchGuidance on the
    CPU. Without `half_precision_weights` the step equals the object the
    files were written from; with it the tiny prior still computes in its
    configuration's float32, on weights rounded through bfloat16 (the
    GroupNorm parameters too), and gives finite gradients."""
    pg = tiny_port_guidance(seed=0)
    cfg = _write_tiny_weights(tmp_path, pg)
    cfg["system"]["guidance"]["half_precision_weights"] = half
    built = launch.build_guidance(cfg, "cpu")
    assert built.cfg.latent_size == 8 and built.cfg.image_size == 16
    assert built.cfg.guidance_scale == 7.5
    assert not any(p.requires_grad for p in built.unet.parameters())
    pose, rgb, depth, text = map(torch.from_numpy, _scene())
    t = torch.from_numpy(T)
    rgb.requires_grad_(True)
    out = built(pose, rgb, depth, text, t, torch.Generator().manual_seed(1))
    out["loss_sds"].backward()
    assert bool(torch.isfinite(rgb.grad).all()) and float(
        rgb.grad.abs().max()) > 0
    assert built.unet.dtype == built.vae.dtype == torch.float32
    assert built.unet.conv_norm_out.weight.dtype == torch.float32
    # the VAE's norms are GroupNormAct (float32 parameters) and its
    # convolutions' weights channels_last, as the UNet's
    assert built.vae.encoder.conv_norm_out.weight.dtype == torch.float32
    assert built.vae.encoder.conv_in.weight.is_contiguous(
        memory_format=torch.channels_last)
    if half:
        assert all(_bf16_exact(p) for p in built.unet.parameters())
        assert all(_bf16_exact(p) for p in built.vae.parameters())
    else:
        want = pg(pose, rgb.detach(), depth, text, t,
                  torch.Generator().manual_seed(1))
        np.testing.assert_allclose(out["grad"].numpy(), want["grad"].numpy(),
                                   atol=1e-6)


def _reference_prior(root, unet_cfg, vae_cfg, half):
    """The tiny prior as the reference's launcher builds it from the same
    files: its loader and converters, then, with `half_precision_weights`,
    every float32 leaf cast to bfloat16
    (humangaussian_tpu/apps/launch.py:165-177); the modules compute in
    their configuration's dtype."""
    from humangaussian_tpu.guidance import convert

    unet_params, _ = convert.convert_unet_state_dict(
        convert.load_torch_state_dict(str(
            root / "joint" / "unet_ema" / "diffusion_pytorch_model.bin")),
        num_levels=len(unet_cfg.block_out_channels),
        copy_last_n=unet_cfg.copy_last_n_block)
    vae_params, _ = convert.convert_vae_state_dict(
        convert.load_torch_state_dict(str(
            root / "vae" / "diffusion_pytorch_model.bin")))
    if half:
        def cast(tree):
            return jax.tree.map(
                lambda x: x.astype(jnp.bfloat16)
                if getattr(x, "dtype", None) == jnp.float32 else x, tree)

        unet_params, vae_params = cast(unet_params), cast(vae_params)
    return unet_params, vae_params


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_type_matches_the_reference(tmp_path, monkeypatch, dtype,
                                            half):
    """The prior computes in the configuration's dtype whatever
    `half_precision_weights` says; the flag only rounds the stored weights
    through bfloat16, GroupNorm parameters included. For each case the
    port's UNet and VAE-encode outputs match the reference's prior built
    from the same files, and a bfloat16 configuration gives a bfloat16
    prior with the flag off as with it on. Limits, of the reference's max:
    float32 1e-5; bfloat16 2^-5, because the two frameworks round at other
    places through a whole network: on these weights each side's bfloat16
    output lies 1.3e-2 to 1.8e-2 of max from the float32 answer, and the
    two lie 1.4e-2 to 1.7e-2 apart."""
    from humangaussian_tpu.guidance import unet as jax_unet
    from humangaussian_tpu.guidance import vae as jax_vae

    pg = tiny_port_guidance(seed=2)
    rng = np.random.RandomState(3)
    with torch.no_grad():  # norm parameters whose bf16 rounding shows
        for name, p in (*pg.unet.named_parameters(),
                        *pg.vae.named_parameters()):
            if "norm" in name:
                p.add_(torch.from_numpy(
                    0.1 * rng.randn(*p.shape).astype(np.float32)))
    cfg = _write_tiny_weights(tmp_path, pg)
    cfg["system"]["guidance"]["half_precision_weights"] = half
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    monkeypatch.setattr(port_unet, "TINY_TEST_CONFIG", dataclasses.replace(
        port_unet.TINY_TEST_CONFIG, dtype=tdt))
    tiny_vae = port_vae.tiny_vae_config
    monkeypatch.setattr(port_vae, "tiny_vae_config",
                        lambda: dataclasses.replace(tiny_vae(), dtype=tdt))
    built = launch.build_guidance(cfg, "cpu")
    assert built.unet.dtype == built.vae.dtype == tdt
    norm = built.unet.conv_norm_out.weight
    assert norm.dtype == torch.float32
    assert _bf16_exact(norm) == half

    jucfg = dataclasses.replace(jax_unet.TINY_TEST_CONFIG, dtype=jdt)
    jvcfg = dataclasses.replace(jax_vae.tiny_vae_config(), dtype=jdt)
    unet_params, vae_params = _reference_prior(tmp_path, jucfg, jvcfg, half)
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    xb = rng.randn(2, 8, 8, 8).astype(np.float32)
    t = np.array([10.0, 600.0], np.float32)
    text = (rng.randn(2, 7, 32) * 0.5).astype(np.float32)
    ids = np.tile(np.array([[1024, 1024, 0, 0, 1024, 1024]], np.float32),
                  (2, 1))
    img = (rng.rand(2, 16, 16, 3) * 2 - 1).astype(np.float32)
    args = (x, xb, t, text, ids)
    want_unet = np.asarray(jax_unet.DualBranchUNet(jucfg).apply(
        unet_params, *map(jnp.asarray, args)).astype(jnp.float32))
    jvae = jax_vae.AutoencoderKL(jvcfg)
    want_mean = np.asarray(jvae.apply(vae_params, jnp.asarray(img),
                                      method=jvae.encode)[0]
                           .astype(jnp.float32))
    with torch.no_grad():
        got_unet = built.unet(*map(torch.from_numpy, args)).float().numpy()
        got_mean = built.vae.encode(torch.from_numpy(img))[0].float().numpy()
    rel = 1e-5 if dtype == "float32" else 2.0 ** -5
    for name, got, want in (("unet", got_unet, want_unet),
                            ("vae mean", got_mean, want_mean)):
        np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("edit,error", [
    ({"arch": "huge"}, ValueError),
    ({"type": "deep-floyd"}, ValueError),
    ({"unet": {"branch_num": 2}}, ValueError),
    ({"model_key": "/nonexistent"}, FileNotFoundError),
])
def test_build_guidance_rejects(tmp_path, edit, error):
    pg = tiny_port_guidance(seed=0)
    cfg = _write_tiny_weights(tmp_path, pg)
    cfg["system"]["guidance"].update(edit)
    with pytest.raises(error):
        launch.build_guidance(cfg, "cpu")


def test_build_guidance_reports_missing_tensors(tmp_path):
    pg = tiny_port_guidance(seed=0)
    cfg = _write_tiny_weights(tmp_path, pg)
    path = tmp_path / "joint" / "unet_ema" / "diffusion_pytorch_model.bin"
    sd = torch.load(path, weights_only=True)
    del sd["conv_in.weight"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="conv_in.weight"):
        launch.build_guidance(cfg, "cpu")


def test_avatar_system_still_waits():
    """The avatar system with DeepFloyd guidance no longer waits (ROADMAP
    item 19): its builder is `build_deep_floyd`, which rejects an unknown
    arch; `build_guidance` stays the dual-branch builder."""
    cfg = {"system": {"guidance": {"type": "deep-floyd", "arch": "huge",
                                   "model_key": "/nonexistent"}}}
    with pytest.raises(ValueError, match="deep-floyd arch"):
        launch.build_deep_floyd(cfg, "cpu")
    with pytest.raises(ValueError, match="dual-branch"):
        launch.build_guidance(cfg, "cpu")
