"""PyTorch port vs JAX: the browser viewer and pose editor (apps/viewer.py)
and `smplx/lbs.py::joint_world_rotations`.

The same toy avatar (numpy, from a seed) and toy SMPL-X body go into both
packages' viewers, posed alike. Tolerances: `joint_world_rotations` 1e-5;
the viewer's camera 1e-6; its float frames at 64^2, on the JAX-built
camera (tests/port_parity.py), "gs" within NUMERICS.md's image tolerance
2e-6, "mesh" equal where the two pick the same face (a face id may flip
on a shared edge) and within 1e-5 there, "skel" equal on all but a few
edge pixels (the joints agree to 1e-5; PIL rounds the line ends). Then a
port-only HTTP round trip on port 0.
"""
import io
import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.animation import AvatarAnimator as TAnimator
from humangaussian_torch.apps import viewer as tviewer
from humangaussian_torch.convert import scene_from_numpy, smplx_from_numpy
from humangaussian_torch.smplx.lbs import SMPLXPose as TPose
from humangaussian_torch.smplx.lbs import joint_world_rotations as t_jwr
from humangaussian_tpu.animation import AvatarAnimator as JAnimator
from humangaussian_tpu.apps import viewer as jviewer
from humangaussian_tpu.core.scene import GaussianScene as JScene
from humangaussian_tpu.smplx.lbs import SMPLXPose as JPose
from humangaussian_tpu.smplx.lbs import joint_world_rotations as j_jwr
from humangaussian_tpu.smplx.model import load_smplx_npz
from port_parity import np_, torch_camera_from_jax
from test_launch import make_smplx_npz
from test_torch_animation import _avatar_scene

torch.set_num_threads(4)
POSE = {"joint": 15, "values": [0.3, -0.5, 0.8],
        "global_orient": [0.2, 0.0, 0.9]}


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = tmp_path_factory.mktemp("smplx") / "SMPLX_NEUTRAL.npz"
    make_smplx_npz(str(path))
    return load_smplx_npz(str(path))


@pytest.mark.parametrize("seed", [0, 1])
def test_joint_world_rotations(model, seed):
    rng = np.random.RandomState(seed)
    bp = (rng.randn(21, 3) * 0.5).astype(np.float32)
    go = (rng.randn(3) * 0.5).astype(np.float32)
    want = np.asarray(j_jwr(model, JPose.rest(body_pose=jnp.asarray(bp))
                            ._replace(global_orient=jnp.asarray(go))))
    got = t_jwr(smplx_from_numpy(model, device="cpu"),
                TPose.rest(body_pose=torch.from_numpy(bp))
                ._replace(global_orient=torch.from_numpy(go)))
    assert got.shape == (55, 3, 3)
    np.testing.assert_allclose(np_(got), want, rtol=0, atol=1e-5)


def _servers(model, animated=True):
    d = _avatar_scene()
    jscene = JScene(**{k: jnp.asarray(v) for k, v in d.items()})
    tscene = scene_from_numpy(d, device="cpu")
    janim = tanim = None
    if animated:
        janim = JAnimator(jscene, model)
        tanim = TAnimator(tscene, smplx_from_numpy(model, device="cpu"))
    return (jviewer.ViewerServer(jscene, port=0, size=64, animator=janim),
            tviewer.ViewerServer(tscene, port=0, size=64, animator=tanim))


@pytest.fixture(scope="module")
def posed_servers(model):
    jsrv, tsrv = _servers(model)
    for s in (jsrv, tsrv):
        s.set_pose(POSE)
    return jsrv, tsrv


def _on_jax_camera(jsrv, tsrv, view):
    """Hand the port's server the camera the JAX server builds for `view`
    (no torch route reproduces jnp.linalg.inv's rounding)."""
    jcam, jc2w = jsrv._camera(*view)
    tcam, tc2w = tviewer.ViewerServer._camera(tsrv, *view)
    np.testing.assert_allclose(np_(tc2w), np.asarray(jc2w), atol=1e-6)
    np.testing.assert_allclose(np_(tcam.full_proj),
                               np.asarray(jcam.full_proj), atol=1e-6)
    tsrv._camera = lambda *a: (torch_camera_from_jax(jcam),
                               torch.from_numpy(np.array(jc2w)))


@pytest.mark.parametrize("view", [(30.0, 15.0, 2.0), (-120.0, 40.0, 1.6)])
def test_gs_frame_matches_jax(posed_servers, view):
    jsrv, tsrv = posed_servers
    _on_jax_camera(jsrv, tsrv, view)
    want = np.asarray(jsrv._render(*view, mode="gs"))
    got = tsrv.render(*view, mode="gs")
    assert got.shape == (64, 64, 3) and got.dtype == np.float32
    assert want.max() > 0.2  # the avatar is in view
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_gs_frame_without_animator_matches_jax(model):
    jsrv, tsrv = _servers(model, animated=False)
    view = (0.0, 15.0, 2.0)
    _on_jax_camera(jsrv, tsrv, view)
    want = np.asarray(jsrv._render(*view, mode="mesh"))  # falls back to gs
    np.testing.assert_allclose(tsrv.render(*view, mode="mesh"), want,
                               rtol=0, atol=2e-6)


def test_mesh_frame_matches_jax(posed_servers):
    jsrv, tsrv = posed_servers
    view = (45.0, 20.0, 2.0)
    _on_jax_camera(jsrv, tsrv, view)
    want = np.asarray(jsrv._render(*view, mode="mesh"))
    got = tsrv.render(*view, mode="mesh")
    covered = want.max(axis=-1) > 0
    assert covered.sum() > 100
    close = np.abs(got - want).max(axis=-1) <= 1e-5
    # a pixel on a shared edge may take either face's normal
    assert np.mean(~close) <= 0.02, np.mean(~close)
    np.testing.assert_array_equal(got.max(axis=-1) > 0, covered)


def test_skel_frame_matches_jax(posed_servers):
    jsrv, tsrv = posed_servers
    view = (10.0, 15.0, 2.0)
    _on_jax_camera(jsrv, tsrv, view)
    want = np.asarray(jsrv._render(*view, mode="skel"))
    got = tsrv.render(*view, mode="skel")
    assert (want.max(axis=-1) > 0).sum() > 50
    differ = np.abs(got - want).max(axis=-1) > 0
    assert differ.sum() <= 8, differ.sum()
    jj = jsrv.joints_2d(*view)
    tj = tsrv.joints_2d(*view)
    assert tj["parents"] == jj["parents"] and tj["names"] == jj["names"]
    np.testing.assert_allclose(tj["xy"], jj["xy"], atol=0.11)


def test_drag_matches_jax(model):
    jsrv, tsrv = _servers(model)
    q = (0.0, 15.0, 2.0)
    _on_jax_camera(jsrv, tsrv, q)
    j0 = jsrv.joints_2d(*q)
    jd = j0["names"].index("left_elbow")
    src = j0["xy"][jd]
    update = {"joint": jd, "from": src, "to": [src[0], src[1] + 10.0],
              "azimuth": q[0], "elevation": q[1], "distance": q[2]}
    want = jsrv.apply_drag(update)
    got = tsrv.apply_drag(update)
    np.testing.assert_allclose(got["body_pose"], want["body_pose"],
                               atol=1e-5)
    np.testing.assert_allclose(got["global_orient"], want["global_orient"],
                               atol=1e-5)
    with pytest.raises(ValueError, match="pelvis"):
        tsrv.apply_drag({**update, "joint": 0})


def _get(url):
    return urllib.request.urlopen(url, timeout=120).read()


def _post(url, body: bytes):
    return urllib.request.urlopen(
        urllib.request.Request(url, data=body, method="POST"),
        timeout=120).read()


def test_http_round_trip(model):
    from PIL import Image

    _, server = _servers(model)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        assert b"viewer" in _get(f"{base}/")
        info = json.loads(_get(f"{base}/info"))
        assert info == {"n_gaussians": 600, "size": 64}
        frames = {}
        for mode in ("gs", "mesh", "skel"):
            png = _get(f"{base}/render?azimuth=30&mode={mode}")
            img = Image.open(io.BytesIO(png))
            assert img.size == (64, 64) and img.mode == "RGB"
            frames[mode] = png
        assert len(set(frames.values())) == 3
        st = json.loads(_post(f"{base}/pose", json.dumps(POSE).encode()))
        assert st["posable"] and st["body_pose"][15] == pytest.approx(
            POSE["values"])
        posed = _get(f"{base}/render?azimuth=30&mode=gs")
        assert posed != frames["gs"]
        _post(f"{base}/pose", b'{"reset": true}')
        assert _get(f"{base}/render?azimuth=30&mode=gs") == frames["gs"]
        joints = json.loads(_get(f"{base}/joints?azimuth=0"))
        assert len(joints["xy"]) == 22
        assert np.isfinite(np.asarray(joints["xy"])).all()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/pose", b'{"joint": 40, "values": [0, 0, 0]}')
        assert e.value.code == 400
    finally:
        server.stop()


def test_pose_post_without_animator_is_400(model):
    _, server = _servers(model, animated=False)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/pose", b'{"joint": 0, "values": [1, 0, 0]}')
        assert e.value.code == 400
        assert json.loads(_get(f"{base}/joints")) == {"posable": False}
    finally:
        server.stop()


def test_cli_builds_on_the_cpu_and_defaults_to_the_card(tmp_path, model):
    from humangaussian_torch.io.ply import save_ply

    ply = str(tmp_path / "avatar.ply")
    save_ply(scene_from_numpy(_avatar_scene(), device="cpu"), ply)
    npz = str(tmp_path / "SMPLX_NEUTRAL.npz")
    make_smplx_npz(npz)
    server = tviewer.build_server(["--ply", ply, "--smplx_path", npz,
                                   "--port", "0", "--size", "32",
                                   "--device", "cpu"])
    assert server.animator is not None and server.size == 32
    assert server.render(0.0, 15.0, 2.0).shape == (32, 32, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            tviewer.main(["--ply", ply])


def test_cli_binds_the_avatar_in_the_animation_frame(tmp_path):
    """A property of the reference: the JAX viewer CLI loads the PLY in
    the training frame and binds it to the SMPL-X mesh as it is, so most
    Gaussians fail the binding; the port's CLI loads the animation frame,
    as apps.animate does, and binds them all."""
    from humangaussian_tpu.io.ply import load_ply as j_load_ply

    import chip_smoke

    npz, ply, _, _ = chip_smoke.write_assets(str(tmp_path), n_avatar=2000)
    jmodel = load_smplx_npz(npz)
    as_jax_cli = JAnimator(j_load_ply(ply), jmodel).n_gaussians
    server = tviewer.build_server(["--ply", ply, "--smplx_path", npz,
                                   "--device", "cpu"])
    assert server.animator.n_gaussians == 2000
    assert as_jax_cli < 0.8 * 2000
