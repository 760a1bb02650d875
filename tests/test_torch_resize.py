"""The port's antialiased resize (humangaussian_torch/ops/resize.py)
against `jax.image.resize(..., "bilinear")`: the same seeded numpy image
and cotangent through both, the forward within 1e-6 absolute and the
gradient within 1e-6 of max-|grad|, at the shapes the port resizes
(the step's renders, the IF path, ControlNet's and the GAN's sizes)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.guidance import dual_branch
from humangaussian_torch.ops import resize
from humangaussian_torch.ops.resize import resize_bilinear

TOL = 1e-6


def _pair(b, h, w, oh, ow, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, h, w, 3).astype(np.float32)
    g = rng.randn(b, oh, ow, 3).astype(np.float32)
    return x, g


def _jax_resize(x, g, oh, ow):
    """jax.image.resize's output and the gradient of <resize(x), g>."""
    shape = (x.shape[0], oh, ow, x.shape[3])

    def f(a):
        return jnp.sum(jax.image.resize(a, shape, "bilinear") * g)

    want = np.asarray(jax.image.resize(jnp.asarray(x), shape, "bilinear"))
    return want, np.asarray(jax.grad(f)(jnp.asarray(x)))


@pytest.mark.parametrize("b, hw, out", [
    (1, (1024, 1024), (512, 512)),   # the step's rgb and depth renders
    (1, (1024, 1024), (64, 64)),     # the IF path
    (2, (256, 256), (512, 512)),     # a growing resize
    (2, (64, 48), (256, 192)),       # the GAN's upsample
    (2, (100, 60), (37, 23)),        # odd sizes, both axes shrink
    (1, (512, 512), (224, 224)),     # the GAN's global encoder input
])
def test_matches_jax_forward_and_gradient(b, hw, out):
    x, g = _pair(b, *hw, *out)
    want, want_grad = _jax_resize(x, g, *out)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = resize_bilinear(xt, out)
    (y * torch.from_numpy(g)).sum().backward()
    assert y.shape == (b, *out, 3)
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0, atol=TOL)
    err = np.abs(xt.grad.numpy() - want_grad).max()
    assert err <= TOL * np.abs(want_grad).max(), err


def test_one_axis_changes():
    """Only W changes: H is left as it is, as JAX skips it."""
    x, g = _pair(2, 32, 48, 32, 20, seed=1)
    want, want_grad = _jax_resize(x, g, 32, 20)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = resize_bilinear(xt, (32, 20))
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=0,
                               atol=TOL * np.abs(want_grad).max())


def test_identity_size_returns_the_input():
    x = torch.rand(2, 16, 24, 3)
    assert resize_bilinear(x, (16, 24)) is x
    y = torch.rand(1, 8, 8, 3)
    assert resize_bilinear(y, 8) is y


def test_expanded_input():
    """A depth map expanded to three channels (a stride-0 view, as the
    step's depth3): the same values as the contiguous copy and JAX's, and
    the gradient summed back onto the one channel."""
    rng = np.random.RandomState(2)
    d = rng.rand(2, 64, 64, 1).astype(np.float32)
    g = rng.randn(2, 24, 24, 3).astype(np.float32)
    want, want_grad = _jax_resize(np.repeat(d, 3, axis=-1), g, 24, 24)
    dt = torch.from_numpy(d).requires_grad_(True)
    view = dt.expand(-1, -1, -1, 3)
    assert not view.is_contiguous()
    y = resize_bilinear(view, 24)
    assert torch.equal(y, resize_bilinear(view.contiguous(), 24))
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0, atol=TOL)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(dt.grad.numpy(),
                               want_grad.sum(-1, keepdims=True), rtol=0,
                               atol=TOL * np.abs(want_grad).max() * 3)


@pytest.mark.parametrize("n, m", [(1024, 512), (1024, 64), (256, 512),
                                  (48, 192), (100, 37), (60, 23),
                                  (512, 224)])
def test_band_weights_and_transpose(n, m):
    """Each output's taps sum to 1 (every sample lies inside the input at
    these sizes), and the backward's taps are the forward's, transposed:
    both rebuild `weight_matrix` exactly."""
    mat = resize.weight_matrix(n, m)
    b = resize.band(n, m, torch.device("cpu"), torch.float32)
    np.testing.assert_allclose(b.w.sum(0).numpy(), 1.0, rtol=0, atol=1e-6)
    fwd = np.zeros((n, m), np.float32)
    np.add.at(fwd, (b.idx.numpy(), np.arange(m)[None, :]), b.w.numpy())
    bwd = np.zeros((n, m), np.float32)
    np.add.at(bwd, (np.arange(n)[None, :], b.idx_t.numpy()), b.w_t.numpy())
    np.testing.assert_array_equal(fwd, mat)
    np.testing.assert_array_equal(bwd, mat)
    # taps in increasing order, padding with weight 0 at the last index
    assert (np.diff(b.idx.numpy(), axis=0) >= 0).all()
    assert (np.diff(b.idx_t.numpy(), axis=0) >= 0).all()


def test_backward_is_the_ports_function():
    """The graph goes through the port's own Function (the library's
    upsample backward, which scatters with atomics, cannot come back
    unnoticed), and the guidance modules resize through it."""
    x = torch.rand(1, 32, 32, 3, requires_grad=True)
    y = resize_bilinear(x, 16)
    assert y.grad_fn._forward_cls is resize.AxisResize
    assert y.grad_fn.next_functions[0][0]._forward_cls is resize.AxisResize
    assert dual_branch.resize_bilinear is resize_bilinear


def test_gradcheck_float64():
    """Backward and double backward against finite differences (float64,
    weights cast to the input's dtype)."""
    x = torch.rand(1, 9, 7, 2, dtype=torch.float64, requires_grad=True)
    for size in ((4, 5), (13, 3)):
        assert torch.autograd.gradcheck(
            lambda a: resize_bilinear(a, size), (x,))
        assert torch.autograd.gradgradcheck(
            lambda a: resize_bilinear(a, size), (x,))
