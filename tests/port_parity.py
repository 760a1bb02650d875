"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Scenes are made with numpy from a seed and handed to both packages as the
same arrays. A camera is built once by the JAX package and its matrices
are handed to the port as they are, so both rasterizers see bit-identical
cameras (the builders themselves are compared in test_torch_core.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from humangaussian_torch.core.camera import Camera
from humangaussian_tpu.core.camera import camera_from_c2w, look_at_c2w


def make_scene(n=300, n_dead=50, seed=0, sh_degree=0):
    """numpy (means, log_scales, quats, features, opacity_logits, alive),
    the scene of tests/test_rasterize_tiled.py::make_scene."""
    rng = np.random.RandomState(seed)
    k = (sh_degree + 1) ** 2
    means = rng.randn(n, 3).astype(np.float32) * 0.5
    log_scales = (rng.randn(n, 3) * 0.5 - 3.0).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    feats = (rng.randn(n, k, 3) * 0.3).astype(np.float32)
    opa_logits = rng.randn(n).astype(np.float32)
    alive = np.ones(n, bool)
    if n_dead:
        alive[-n_dead:] = False
    return means, log_scales, quats, feats, opa_logits, alive


def activated(scene):
    """(means, scales, quats, features, opacities, alive) in numpy."""
    means, log_scales, quats, feats, opa_logits, alive = scene
    return (means, np.exp(log_scales), quats, feats,
            1.0 / (1.0 + np.exp(-opa_logits.astype(np.float64))).astype(
                np.float32), alive)


def jax_args(scene):
    return tuple(jnp.asarray(x) for x in activated(scene))


def torch_args(scene):
    return tuple(torch.from_numpy(np.ascontiguousarray(x))
                 for x in activated(scene))


def jax_camera(h=64, w=64, eye=(0.3, 0.2, 3.0), fovy=0.8):
    c2w = look_at_c2w(jnp.array(eye, jnp.float32), jnp.zeros(3),
                      jnp.array([0.0, 1.0, 0.0]))
    return camera_from_c2w(c2w, fovy, h, w)


def torch_camera_from_jax(cam) -> Camera:
    """The port's Camera holding the JAX camera's arrays (any batch dims)."""
    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    return Camera(view=t(cam.view), full_proj=t(cam.full_proj),
                  campos=t(cam.campos), tan_fovx=t(cam.tan_fovx),
                  tan_fovy=t(cam.tan_fovy), height=cam.height,
                  width=cam.width)


def stack_jax_cameras(cams):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *cams)


def adam_leaves(adam) -> dict:
    """A JAX AdamState as numpy leaves (convert.adam_state_from_numpy)."""
    return {"mu": {k: np.asarray(v) for k, v in adam.mu.items()},
            "nu": {k: np.asarray(v) for k, v in adam.nu.items()},
            "count": int(adam.count)}


def densify_leaves(ds) -> dict:
    """A JAX DensifyState as numpy leaves."""
    return {k: np.asarray(v) for k, v in ds._asdict().items()}


def scene_leaves(scene) -> dict:
    """A JAX GaussianScene as numpy leaves."""
    return {k: np.asarray(v) for k, v in scene._asdict().items()}


def photo_state_leaves(state) -> dict:
    """A JAX PhotoTrainState as numpy leaves (the PRNG key is left out;
    convert.photo_state_from_numpy seeds a torch.Generator instead)."""
    return {"scene": scene_leaves(state.scene),
            "adam": adam_leaves(state.adam),
            "densify": densify_leaves(state.densify),
            "step": int(state.step),
            "active_sh_degree": int(state.active_sh_degree)}


def assert_tree_close(got: dict, want: dict, rtol=0.0, atol=0.0,
                      scale_rel=None, what=""):
    """Every entry of `got` (torch) against `want` (JAX / numpy). With
    `scale_rel`, the tolerance is that fraction of the entry's max-|want|
    (plus `atol`)."""
    assert set(got) == set(want), (set(got), set(want))
    for k in want:
        w = np.asarray(want[k])
        tol = atol
        if scale_rel is not None:
            tol = atol + scale_rel * float(np.max(np.abs(w))) if w.size else atol
        np.testing.assert_allclose(np_(got[k]), w, rtol=rtol, atol=tol,
                                   err_msg=f"{what} {k}")


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
