"""PyTorch port vs JAX: LPIPS (perceptual.py).

The JAX module's parameters (a Flax init from a seed, or the ones
`load_lpips_params` builds from a torchvision-layout state dict) are
carried into the port (`convert.lpips_state_dict_from_flax`, or the
port's own `load_lpips_params` on the same state dict); the same 64^2
numpy images go through both. Tolerance: 1e-5 relative on the distance
(float32 convolutions summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch import perceptual as tp
from humangaussian_torch.convert import lpips_state_dict_from_flax
from humangaussian_tpu import perceptual as jp

torch.set_num_threads(4)


def _images(seed, b=2, size=64):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, size, size, 3).astype(np.float32)
    y = np.clip(x + rng.randn(b, size, size, 3).astype(np.float32) * 0.1,
                0, 1).astype(np.float32)
    return x, y


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _torchvision_vgg(seed):
    """A seeded state dict in torchvision's `vgg16().features` names, with
    lpips lin weights for taps 0, 2 and 4 only."""
    rng = np.random.RandomState(seed)
    sd, cin = {}, 3
    ids = iter(tp.VGG_CONV_IDS)
    for ch, n in tp.VGG_STAGES:
        for _ in range(n):
            tid = next(ids)
            sd[f"features.{tid}.weight"] = (
                rng.randn(ch, cin, 3, 3) * np.sqrt(2.0 / (9 * cin))
            ).astype(np.float32)
            sd[f"features.{tid}.bias"] = (rng.randn(ch) * 0.01).astype(
                np.float32)
            cin = ch
    lins = {f"lin{i}.model.1.weight": rng.rand(1, ch, 1, 1).astype(
        np.float32) for i, (ch, _) in enumerate(tp.VGG_STAGES) if i % 2 == 0}
    return sd, lins


def _port(state_dict):
    model = tp.LPIPS()
    model.load_state_dict(state_dict)
    return model.eval()


@pytest.mark.parametrize("seed", [0, 1])
def test_lpips_with_jax_parameters(seed):
    params = jp.LPIPS().init(jax.random.PRNGKey(seed),
                             jnp.zeros((1, 32, 32, 3)),
                             jnp.zeros((1, 32, 32, 3)))
    leaves = jax.tree.map(np.asarray, params)
    x, y = _images(seed)
    want = np.asarray(jp.LPIPS().apply(params, jnp.asarray(x),
                                       jnp.asarray(y)))
    with torch.no_grad():
        got = _port(lpips_state_dict_from_flax(leaves))(_nchw(x),
                                                       _nchw(y)).numpy()
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)


def test_load_lpips_params_matches_jax_loader():
    vgg, lins = _torchvision_vgg(3)
    x, y = _images(4)
    want = np.asarray(jp.lpips_fn(jp.load_lpips_params(vgg, lins))(
        jnp.asarray(x), jnp.asarray(y)))
    sd = tp.load_lpips_params({k: torch.from_numpy(v) for k, v in vgg.items()},
                              {k: torch.from_numpy(v)
                               for k, v in lins.items()})
    with torch.no_grad():
        got = _port(sd)(_nchw(x), _nchw(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)
    # the lin layers the lpips weights lack are 1/C, as in the JAX loader
    np.testing.assert_array_equal(sd["lin1.weight"].numpy(),
                                  np.full((1, 128, 1, 1), 1 / 128, np.float32))


def test_load_lpips_params_reads_files_and_is_a_metric(tmp_path):
    vgg, lins = _torchvision_vgg(5)
    torch.save({k: torch.from_numpy(v) for k, v in vgg.items()},
               tmp_path / "vgg16.pth")
    torch.save({k: torch.from_numpy(v) for k, v in lins.items()},
               tmp_path / "lin.pth")
    model = _port(tp.load_lpips_params(str(tmp_path / "vgg16.pth"),
                                       str(tmp_path / "lin.pth")))
    x, y = (_nchw(a) for a in _images(6))
    with torch.no_grad():
        dxx, dxy, dyx = model(x, x), model(x, y), model(y, x)
    assert float(dxx.abs().max()) == 0.0
    assert bool((dxy > 0).all())
    torch.testing.assert_close(dxy, dyx, rtol=1e-6, atol=0.0)
