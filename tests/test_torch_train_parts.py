"""PyTorch port vs JAX: the parts of a training step around the render.

Same numpy inputs through both packages:
- `scene_from_points`, `covariance_from_scaling_rotation`,
  `mean_3nn_sq_dist_host`: 1e-6 absolute;
- `l1_loss`, `l2_loss`, `psnr`, `ssim`, `photometric_loss`: 1e-6 absolute on
  the value (psnr 1e-4: a log of the same mse), and d loss / d pred to
  1e-5 of max-|grad| (the blur sums in another order);
- `expon_lr` / `group_lrs` at steps 0, 1, 100, 30000: 2e-7 relative
  (both compute in float32; XLA's and torch's exp and log differ in the
  last bit, and one float32 ulp is 1.2e-7);
- `adam_step`, 3 steps from the same state and gradients: 1e-6 relative +
  1e-8 absolute on the parameters and both moments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch import losses as t_losses
from humangaussian_torch.convert import adam_state_from_numpy
from humangaussian_torch.core import scene as t_scene
from humangaussian_torch.ops.knn import mean_3nn_sq_dist_host as t_knn
from humangaussian_torch.train import optim as t_optim
from humangaussian_tpu import losses as j_losses
from humangaussian_tpu.core import scene as j_scene
from humangaussian_tpu.ops.knn import mean_3nn_sq_dist_host as j_knn
from humangaussian_tpu.train import optim as j_optim
from port_parity import adam_leaves, assert_tree_close, np_

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("sh_degree,with_dist", [(0, True), (2, False)])
def test_scene_from_points(sh_degree, with_dist):
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((40, 3)).astype(np.float32)
    cols = rng.random((40, 3)).astype(np.float32)
    dist = j_knn(pts) if with_dist else None
    np.testing.assert_allclose(np_(t_knn(pts)), np.asarray(j_knn(pts)),
                               atol=1e-6)
    want = j_scene.scene_from_points(jnp.asarray(pts), jnp.asarray(cols), 64,
                                     sh_degree, dist)
    got = t_scene.scene_from_points(
        _t(pts), _t(cols), 64, sh_degree,
        None if dist is None else _t(np.asarray(dist)))
    assert_tree_close(got._asdict(), want._asdict(), atol=1e-6)
    assert got.alive.dtype == torch.bool and int(got.alive.sum()) == 40
    assert_tree_close(got.params(), want.params(), atol=1e-6)
    assert set(got.params()) == {"means", "log_scales", "quats", "sh_dc",
                                 "sh_rest", "opacity_logits"}
    swapped = got.replace_params(dict(got.params(), means=got.means + 1.0))
    np.testing.assert_allclose(np_(swapped.means), np_(got.means) + 1.0)
    with pytest.raises(ValueError, match="exceed capacity"):
        t_scene.scene_from_points(_t(pts), _t(cols), 8)


def test_covariance_from_scaling_rotation():
    rng = np.random.default_rng(1)
    scales = np.exp(rng.standard_normal((30, 3))).astype(np.float32)
    quats = rng.standard_normal((30, 4)).astype(np.float32)
    want = j_scene.covariance_from_scaling_rotation(
        jnp.asarray(scales), jnp.asarray(quats), 1.3)
    got = t_scene.covariance_from_scaling_rotation(_t(scales), _t(quats), 1.3)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "psnr", "ssim",
                                  "photometric_loss"])
@pytest.mark.parametrize("shape", [(24, 40, 3), (2, 16, 16, 3)])
def test_losses_and_their_gradients(name, shape):
    rng = np.random.default_rng(2)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    j_fn, t_fn = getattr(j_losses, name), getattr(t_losses, name)
    want, want_grad = jax.value_and_grad(j_fn)(jnp.asarray(a), jnp.asarray(b))
    pred = _t(a).requires_grad_(True)
    got = t_fn(pred, _t(b))
    (got_grad,) = torch.autograd.grad(got, pred)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               atol=1e-4 if name == "psnr" else 1e-6)
    scale = float(np.abs(np.asarray(want_grad)).max())
    np.testing.assert_allclose(np_(got_grad) / scale,
                               np.asarray(want_grad) / scale, atol=1e-5)


def test_ssim_of_identical_images_is_one():
    img = _t(np.random.default_rng(3).random((32, 32, 3)).astype(np.float32))
    assert float(t_losses.ssim(img, img)) == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("step", [0, 1, 100, 30000])
@pytest.mark.parametrize("delay_steps", [0, 200])
def test_expon_lr_and_group_lrs(step, delay_steps):
    kw = dict(position_lr_delay_steps=delay_steps, spatial_lr_scale=2.7)
    want = j_optim.GaussianOptimConfig(**kw).group_lrs(step)
    got = t_optim.GaussianOptimConfig(**kw).group_lrs(step)
    assert set(got) == set(want)
    for k in want:
        assert isinstance(got[k], float)
        np.testing.assert_allclose(got[k], float(want[k]), rtol=2e-7,
                                   err_msg=k)
    assert t_optim.expon_lr(-1, 1e-3, 1e-4) == 0.0


def test_adam_three_steps():
    rng = np.random.default_rng(4)
    shapes = {"means": (50, 3), "log_scales": (50, 3), "quats": (50, 4),
              "sh_dc": (50, 3), "sh_rest": (50, 8, 3),
              "opacity_logits": (50, 1)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = j_optim.adam_init(j_params)
    # start from non-trivial moments and count, as after densify surgery
    j_state = j_state._replace(
        mu={k: jnp.asarray(0.01 * rng.standard_normal(s), jnp.float32)
            for k, s in shapes.items()},
        nu={k: jnp.asarray(1e-4 * rng.random(s), jnp.float32)
            for k, s in shapes.items()},
        count=jnp.asarray(7, jnp.int32))
    t_params = {k: _t(v) for k, v in params.items()}
    t_state = adam_state_from_numpy(adam_leaves(j_state), "cpu")
    j_cfg = j_optim.GaussianOptimConfig()
    t_cfg = t_optim.GaussianOptimConfig()
    for step in range(3):
        grads = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1))
                 .astype(np.float32) for k, s in shapes.items()}
        grads["means"][:5] = 0.0  # dead slots get exactly zero gradients
        j_params, j_state = j_optim.adam_step(
            j_params, {k: jnp.asarray(v) for k, v in grads.items()}, j_state,
            j_cfg.group_lrs(step), j_cfg)
        t_params, t_state = t_optim.adam_step(
            t_params, {k: _t(v) for k, v in grads.items()}, t_state,
            t_cfg.group_lrs(step), t_cfg)
        assert t_state.count == int(j_state.count) == 8 + step
        assert_tree_close(t_params, j_params, rtol=1e-6, atol=1e-8,
                          what=f"params step {step}")
        assert_tree_close(t_state.mu, j_state.mu, rtol=1e-6, atol=1e-8,
                          what=f"mu step {step}")
        assert_tree_close(t_state.nu, j_state.nu, rtol=1e-6, atol=1e-8,
                          what=f"nu step {step}")
    init = t_optim.adam_init(t_params)
    assert init.count == 0 and float(init.mu["sh_rest"].abs().sum()) == 0.0
