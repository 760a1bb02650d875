"""PyTorch port vs JAX: SH evaluation, camera builders, scene activations.

The same numpy inputs go through humangaussian_tpu and humangaussian_torch
(CPU). Tolerance 1e-6 absolute (f32 rounding of the same formulas; the
4x4 inverses run through different LAPACK calls).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.convert import scene_from_numpy
from humangaussian_torch.core import camera as tcam
from humangaussian_torch.core import scene as tscene
from humangaussian_torch.core import sh as tsh
from humangaussian_torch.data import cameras as tcams
from humangaussian_tpu.core import camera as jcam
from humangaussian_tpu.core import scene as jscene
from humangaussian_tpu.core import sh as jsh
from humangaussian_tpu.data import cameras as jcams

torch.set_num_threads(1)
ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh(degree):
    rng = np.random.RandomState(degree)
    k = (degree + 1) ** 2
    sh = rng.randn(64, k, 3).astype(np.float32)
    dirs = rng.randn(64, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    want = np.asarray(jsh.eval_sh(degree, jnp.asarray(sh), jnp.asarray(dirs)))
    got = tsh.eval_sh(degree, _t(sh), _t(dirs)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_rgb_sh_roundtrip():
    rgb = np.random.RandomState(0).rand(16, 3).astype(np.float32)
    np.testing.assert_allclose(
        tsh.rgb_to_sh(_t(rgb)).numpy(), np.asarray(jsh.rgb_to_sh(rgb)),
        atol=ATOL)
    np.testing.assert_allclose(
        tsh.sh_to_rgb(tsh.rgb_to_sh(_t(rgb))).numpy(), rgb, atol=ATOL)
    assert tsh.SH_C0 == jsh.SH_C0


@pytest.mark.parametrize("eye,fovy,hw", [
    ((0.3, 0.2, 3.0), 0.8, (64, 64)),
    ((-1.5, 0.7, -2.0), 1.1, (96, 64)),
])
def test_camera_from_c2w(eye, fovy, hw):
    h, w = hw
    jc2w = jcam.look_at_c2w(jnp.array(eye), jnp.zeros(3),
                            jnp.array([0.0, 1.0, 0.0]))
    tc2w = tcam.look_at_c2w(torch.tensor(eye), torch.zeros(3),
                            torch.tensor([0.0, 1.0, 0.0]))
    np.testing.assert_allclose(tc2w.numpy(), np.asarray(jc2w), atol=ATOL)
    jc = jcam.camera_from_c2w(jc2w, fovy, h, w)
    tc = tcam.camera_from_c2w(tc2w, fovy, h, w)
    for name in ("view", "full_proj", "campos", "tan_fovx", "tan_fovy"):
        np.testing.assert_allclose(
            getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
            atol=ATOL, rtol=1e-6, err_msg=name)
    assert (tc.height, tc.width) == (h, w)
    np.testing.assert_allclose(float(tc.focal_x), float(jc.focal_x),
                               rtol=1e-6)


@pytest.mark.parametrize("route", ["inv", "solve", "lu_solve"])
def test_camera_inverse_routes_differ_from_xla_by_ulps(route):
    """The known difference behind the JAX-built camera of the fixture
    replay (ROADMAP queue 3): on the fixture cameras every torch route to
    the c2w inverse gives the same matrix as `torch.linalg.inv`, which
    differs from `jnp.linalg.inv` by at most 1e-8 (measured 6.6e-9, on the
    near-zero translation entries); no route reproduces XLA's rounding."""
    import glob
    import os

    root = os.path.join(os.path.dirname(__file__), "fixtures", "cuda")
    for path in sorted(glob.glob(os.path.join(root, "*.npz"))):
        c2w = np.load(path)["c2w"].astype(np.float32)
        want = np.asarray(jnp.linalg.inv(jnp.asarray(c2w)))
        t = torch.from_numpy(c2w)
        if route == "inv":
            got = torch.linalg.inv(t)
        elif route == "solve":
            got = torch.linalg.solve(t, torch.eye(4))
        else:
            got = torch.linalg.lu_solve(*torch.linalg.lu_factor(t),
                                        torch.eye(4))
        assert torch.equal(got, torch.linalg.inv(t)), path
        assert np.abs(got.numpy() - want).max() <= 1e-8, path


def test_perspective_and_focal():
    fovx, fovy = 0.7, 0.9
    want = np.asarray(jcam.perspective_projection(0.01, 100.0, fovx, fovy))
    got = tcam.perspective_projection(
        0.01, 100.0, torch.tensor(fovx), torch.tensor(fovy)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(float(tcam.fov_to_focal(torch.tensor(0.9), 512)),
                               float(jcam.fov_to_focal(0.9, 512)), rtol=1e-6)


def test_batched_camera_matches_single():
    cfg = tcams.RandomCameraConfig(n_val_views=4)
    cams = tcams.eval_camera_batch(cfg, "val", device="cpu")
    batch = tcam.camera_from_c2w(cams.c2w, cams.fovy, 64, 64)
    assert len(batch) == 4
    for i in range(4):
        one = tcam.camera_from_c2w(cams.c2w[i], cams.fovy[i], 64, 64)
        np.testing.assert_allclose(batch[i].full_proj.numpy(),
                                   one.full_proj.numpy(), atol=ATOL)


@pytest.mark.parametrize("split", ["val", "test"])
def test_eval_camera_batch(split):
    jb = jcams.eval_camera_batch(jcams.RandomCameraConfig(), split)
    tb = tcams.eval_camera_batch(tcams.RandomCameraConfig(), split,
                                 device="cpu")
    for name in ("c2w", "mvp_mtx", "camera_positions", "elevation",
                 "azimuth", "camera_distances", "fovy"):
        want = np.asarray(getattr(jb, name))
        np.testing.assert_allclose(getattr(tb, name).numpy(), want,
                                   atol=1e-5, rtol=1e-6, err_msg=name)


def test_quat_to_rotmat():
    q = np.random.RandomState(1).randn(32, 4).astype(np.float32)
    np.testing.assert_allclose(
        tscene.quat_to_rotmat(_t(q)).numpy(),
        np.asarray(jscene.quat_to_rotmat(jnp.asarray(q))), atol=ATOL)


def test_scene_activations_and_convert():
    rng = np.random.RandomState(2)
    cap, n = 256, 200
    js = jscene.scene_from_points(
        jnp.asarray(rng.randn(n, 3).astype(np.float32)),
        jnp.asarray(rng.rand(n, 3).astype(np.float32)), cap, sh_degree=2)
    js = js._replace(
        quats=jnp.asarray(rng.randn(cap, 4).astype(np.float32)),
        log_scales=jnp.asarray(rng.randn(cap, 3).astype(np.float32) - 3),
        opacity_logits=jnp.asarray(rng.randn(cap, 1).astype(np.float32)),
        sh_rest=jnp.asarray(rng.randn(cap, 8, 3).astype(np.float32)),
    )
    ts = scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                          device="cpu")
    assert ts.capacity == js.capacity and ts.max_sh_degree == js.max_sh_degree
    assert ts.num_alive == int(js.num_alive)
    for name in ("scales", "rotations", "opacities", "features"):
        np.testing.assert_allclose(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
            atol=ATOL, rtol=1e-6, err_msg=name)
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))


def test_empty_scene():
    je = jscene.empty_scene(8, sh_degree=1)
    te = tscene.empty_scene(8, sh_degree=1, device="cpu")
    for name, v in je._asdict().items():
        np.testing.assert_array_equal(getattr(te, name).numpy(),
                                      np.asarray(v), err_msg=name)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tscene.empty_scene(8)


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
