"""apps/launch.py::build_guidance of the port: the prior built from
diffusers-layout weight files on the CPU, at the tiny widths."""
import numpy as np
import pytest
import torch

from humangaussian_torch.apps import launch
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


@pytest.mark.parametrize("half", [False, True])
def test_build_guidance_loads_the_tiny_prior(tmp_path, half):
    """The launcher's guidance half: files -> DualBranchGuidance on the
    CPU. With float32 weights the step equals the object the files were
    written from; with `half_precision_weights` the prior is bfloat16 with
    float32 GroupNorm parameters and still gives finite gradients."""
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
    if half:
        assert built.unet.dtype == torch.bfloat16
        assert built.vae.dtype == torch.bfloat16
        assert built.unet.conv_norm_out.weight.dtype == torch.float32
    else:
        want = pg(pose, rgb.detach(), depth, text, t,
                  torch.Generator().manual_seed(1))
        np.testing.assert_allclose(out["grad"].numpy(), want["grad"].numpy(),
                                   atol=1e-6)


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
    with pytest.raises(NotImplementedError, match="items 11, 12, 14"):
        launch.build_system({"system": {"type": "gaussiandreamer-system"}},
                            "cpu")
