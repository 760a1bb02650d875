"""guidance/vae.py of the port against the Flax AutoencoderKL at the tiny
widths, weights shared through `vae_state_dict_from_flax`: the encode
moments, the decode, and d(sum of latents)/d(image), each within 1e-4 of
the reference's max."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.guidance import vae as port_vae
from port_parity import tiny_vae_pair
from torch_vae_mirror import TorchAutoencoderKL

torch.set_num_threads(1)
REL = 1e-4


@pytest.fixture(scope="module")
def pair():
    return tiny_vae_pair(seed=0)


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=REL * np.abs(want).max(), err_msg=what)


def test_encode_moments_match(pair):
    module, params, port = pair
    img = np.random.RandomState(0).rand(2, 16, 16, 3).astype(np.float32)
    img = img * 2 - 1
    jmean, jlogvar = module.apply(params, jnp.asarray(img),
                                  method=module.encode)
    with torch.no_grad():
        mean, logvar = port.encode(torch.from_numpy(img))
    assert mean.shape == (2, 8, 8, 4) and mean.dtype == torch.float32
    _close(mean, jmean, "mean")
    _close(logvar, jlogvar, "logvar")


def test_decode_matches(pair):
    module, params, port = pair
    z = np.random.RandomState(1).randn(2, 8, 8, 4).astype(np.float32)
    want = module.apply(params, jnp.asarray(z), method=module.decode)
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z))
    assert got.shape == (2, 16, 16, 3)
    _close(got, want, "decode")


def test_encoder_gradient_matches(pair):
    """The encoder sits on the gradient path of the guidance step."""
    module, params, port = pair
    rng = np.random.RandomState(2)
    img = rng.rand(2, 16, 16, 3).astype(np.float32) * 2 - 1
    eps = rng.randn(2, 8, 8, 4).astype(np.float32)

    def jloss(x):
        mean, logvar = module.apply(params, x, method=module.encode)
        return jnp.sum(mean + jnp.exp(0.5 * logvar) * eps)

    want = jax.grad(jloss)(jnp.asarray(img))
    x = torch.tensor(img, requires_grad=True)
    mean, logvar = port.encode(x)
    port_vae.sample_latent(mean, logvar, eps=torch.from_numpy(eps)).sum() \
        .backward()
    _close(x.grad, want, "d latents / d image")


def test_norms_are_group_norm_act_and_convolutions_see_channels_last():
    """No library GroupNorm is left: the encoder's and the decoder's norms
    are GroupNormAct (SiLU fused but in the attention block's), and with
    the weights in `channels_last`, as `build_guidance` puts them, every
    convolution's input is `channels_last` in an encode, its backward and
    a decode."""
    from humangaussian_torch.ops.groupnorm import GroupNormAct

    vae = port_vae.AutoencoderKL(port_vae.tiny_vae_config())
    vae.to(memory_format=torch.channels_last)
    assert not any(type(m) is torch.nn.GroupNorm for m in vae.modules())
    # tiny widths: per resnet 2 norms; encoder 2 down resnets + mid 2
    # resnets + attention + conv_norm_out, decoder 2 x 2 up resnets + mid
    # + conv_norm_out
    norms = [m for m in vae.modules() if isinstance(m, GroupNormAct)]
    assert len(norms) == (2 * 2 + 2 * 2 + 1 + 1) + (4 * 2 + 2 * 2 + 1 + 1)
    assert [m.silu for m in norms].count(False) == 2  # the attention blocks

    seen = []

    def hook(module, inputs, output):
        seen.append(inputs[0].is_contiguous(memory_format=torch.channels_last))

    for m in vae.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    convs = sum(isinstance(m, torch.nn.Conv2d) for m in vae.modules())
    x = torch.rand(2, 16, 16, 3, requires_grad=True)
    mean, logvar = vae.encode(x)
    (mean.sum() + logvar.sum()).backward()
    assert torch.isfinite(x.grad).all()
    with torch.no_grad():
        vae.decode(torch.randn(2, 8, 8, 4))
    assert len(seen) == convs and all(seen)


@pytest.mark.parametrize("bias_grad", [False, True])
def test_convolutions_on_the_cpu_are_nn_conv2d_and_launch_nothing(bias_grad):
    """Every convolution of the VAE is a BiasConv2d, and on CPU tensors it
    is nn.Conv2d.forward bit for bit, its bias gradient too where the bias
    requires one, with no kernel launched."""
    from humangaussian_torch import kernels

    vae = port_vae.AutoencoderKL(port_vae.tiny_vae_config())
    vae.to(memory_format=torch.channels_last)
    convs = [m for m in vae.modules() if isinstance(m, torch.nn.Conv2d)]
    assert all(type(m) is port_vae.BiasConv2d for m in convs)
    assert len(convs) == 13 + 17  # encoder + quant_conv, decoder + post
    vae.requires_grad_(False)
    gen = torch.Generator().manual_seed(5)
    kernels.reset_launch_counts()
    for m in convs:
        m.bias.requires_grad_(bias_grad)
        x = torch.randn((2, m.in_channels, 6, 6), generator=gen).contiguous(
            memory_format=torch.channels_last)
        got = m(x)
        want = torch.nn.Conv2d.forward(m, x)
        assert torch.equal(got, want)
        if bias_grad:
            (g1,) = torch.autograd.grad(got.sum(), m.bias)
            (g2,) = torch.autograd.grad(want.sum(), m.bias)
            assert torch.equal(g1, g2)
    assert set(kernels.launch_counts().values()) == {0}


def test_convolution_off_the_cpu_never_takes_the_library_add():
    """Off the CPU a convolution adds its bias with the kernel or raises: a
    bias that requires grad raises while grad is enabled (the kernel gives
    it no gradient), and the meta device has no kernel."""
    conv = port_vae.BiasConv2d(4, 8, 3, padding=1, device="meta")
    x = torch.empty((1, 4, 6, 6), device="meta")
    with pytest.raises(RuntimeError, match="outside autograd"):
        conv(x)
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="no conv bias kernel"):
        conv(x)
    conv.requires_grad_(False)
    with pytest.raises(ValueError, match="no conv bias kernel"):
        conv(x)


def test_logvar_is_clipped():
    vae = port_vae.AutoencoderKL(port_vae.tiny_vae_config())
    with torch.no_grad():
        vae.quant_conv.bias[4:] = 1e3
        _, hi = vae.encode(torch.zeros(1, 16, 16, 3))
        vae.quant_conv.bias[4:] = -1e3
        _, lo = vae.encode(torch.zeros(1, 16, 16, 3))
    assert float(hi.max()) == 20.0 and float(lo.min()) == -30.0


def test_sample_latent_draws_from_the_generator():
    mean, logvar = torch.zeros(1, 4, 4, 4), torch.zeros(1, 4, 4, 4)
    a = port_vae.sample_latent(mean, logvar, torch.Generator().manual_seed(3))
    b = port_vae.sample_latent(mean, logvar, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and float(a.std()) > 0.5


def test_state_dict_has_the_diffusers_names():
    """Exactly the keys and shapes of the mirror of diffusers'
    AutoencoderKL, and the older attention names load after the
    upgrade."""
    from humangaussian_tpu.guidance.vae import tiny_vae_config as jax_tiny

    port = port_vae.AutoencoderKL(port_vae.tiny_vae_config())
    mirror = TorchAutoencoderKL(jax_tiny())
    want = {k: tuple(v.shape) for k, v in mirror.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    legacy = {}
    for k, v in port.state_dict().items():
        for new, old in (("to_q", "query"), ("to_k", "key"),
                         ("to_v", "value"), ("to_out.0", "proj_attn")):
            if f"attentions.0.{new}." in k:
                k = k.replace(new, old)
                if k.endswith("weight"):
                    v = v[:, :, None, None]
        legacy[k] = v
    assert any("proj_attn" in k for k in legacy)
    upgraded = port_vae.upgrade_vae_state_dict(legacy)
    assert {k: tuple(v.shape) for k, v in upgraded.items()} == want
