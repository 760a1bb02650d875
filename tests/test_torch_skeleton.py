"""PyTorch port vs JAX: the camera sampler, the skeleton and the pose
images of the avatar trainer.

- `camera_batch_from_draws` on the unit draws the JAX sampler makes from
  the same key (`port_parity.jax_camera_draws`), at steps 0, 1300 and 3700
  (the head / back windows off, on, off), with `batch_uniform_azimuth` on
  and off and every perturbation on: c2w, mvp, fovy, elevation, azimuth,
  distances and lights within 1e-5, the curriculum choice equal; the head,
  back and frontal shares of the port's own generator within 4 sigma of
  their probabilities over 4000 batches.
- `Skeleton` in both styles, A-pose on and off: points3d, vertices and
  hand centres within 1e-5; `sample_smplx_points` bit-equal on the same
  vertices.
- Pose images given the same keypoints, occlusion on and off, at 64^2 and
  512^2: humansd bit for bit; openpose with the same covered pixels and
  within 1e-6 elsewhere except where an ellipse edge pixel flips (the
  reference's atan2 / cos / sin are not correctly rounded: at most 0.2%
  of the covered pixels); the projected keypoints within 1e-3 px and the
  occlusion confidences equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.data import cameras as port_cam
from humangaussian_torch.smplx import pose_image as port_pose
from humangaussian_torch.smplx.model import toy_model as port_toy_model
from humangaussian_torch.smplx.skeleton import Skeleton as PortSkeleton
from humangaussian_torch.smplx.skeleton import sample_mesh_surface
from humangaussian_tpu.data import cameras as jax_cam
from humangaussian_tpu.smplx import pose_image as jax_pose
from humangaussian_tpu.smplx.model import toy_model
from humangaussian_tpu.smplx.skeleton import Skeleton
from humangaussian_tpu.smplx.skeleton import (
    sample_mesh_surface as jax_sample_mesh_surface,
)
from port_parity import jax_camera_draws, np_

torch.set_num_threads(1)
PERTURBED = dict(camera_perturb=0.1, center_perturb=0.05, up_perturb=0.02,
                 frontal_prob=0.3)


@pytest.mark.parametrize("uniform_azimuth", [True, False])
@pytest.mark.parametrize("step", [0, 1300, 3700])
def test_camera_batch_matches(step, uniform_azimuth):
    cfg = dict(batch_size=8, batch_uniform_azimuth=uniform_azimuth,
               **PERTURBED)
    jcfg = jax_cam.RandomCameraConfig(**cfg)
    pcfg = port_cam.RandomCameraConfig(**cfg)
    heads = backs = 0
    for seed in range(12):
        key = jax.random.PRNGKey(seed)
        want = jax_cam.sample_camera_batch(key, step, jcfg)
        got = port_cam.camera_batch_from_draws(jax_camera_draws(key, 8),
                                               step, pcfg)
        for f in ("c2w", "mvp_mtx", "camera_positions", "light_positions",
                  "elevation", "azimuth", "camera_distances", "fovy"):
            np.testing.assert_allclose(np_(getattr(got, f)),
                                       np.asarray(getattr(want, f)),
                                       atol=1e-5, rtol=0, err_msg=f)
        assert bool(got.is_head) == bool(want.is_head)
        assert bool(got.is_back) == bool(want.is_back)
        heads += bool(want.is_head)
        backs += bool(want.is_back)
    if step != 1300:
        assert heads == backs == 0


def test_c2w_from_angles_matches():
    rng = np.random.default_rng(2)
    elev = rng.uniform(-80, 80, 6).astype(np.float32)
    azim = rng.uniform(-180, 180, 6).astype(np.float32)
    dist = rng.uniform(0.5, 3, 6).astype(np.float32)
    np.testing.assert_allclose(
        np_(port_cam.c2w_from_angles(torch.tensor(elev), torch.tensor(azim),
                                     torch.tensor(dist))),
        np.asarray(jax_cam.c2w_from_angles(elev, azim, dist)), atol=1e-6)


def test_curriculum_shares():
    """head_prob inside the window; back_prob of the rest; frontal_prob of
    what remains (azimuth inside the frontal window)."""
    cfg = port_cam.RandomCameraConfig(batch_size=2, frontal_prob=0.3)
    gen = torch.Generator().manual_seed(0)
    n = 4000
    head = back = front = 0
    for _ in range(n):
        cams = port_cam.sample_camera_batch(gen, 1300, cfg, device="cpu")
        head += bool(cams.is_head)
        back += bool(cams.is_back)
        if not cams.is_head and not cams.is_back:
            az = cams.azimuth
            front += bool(((az >= 45.0) & (az <= 135.0)).all())
    p_back = (1 - cfg.head_prob) * cfg.back_prob
    p_front = (1 - cfg.head_prob - p_back) * cfg.frontal_prob
    for count, p in ((head, cfg.head_prob), (back, p_back)):
        sigma = (n * p * (1 - p)) ** 0.5
        assert abs(count - n * p) <= 4 * sigma, (count, n * p)
    # a full-body batch of 2 stratified azimuths has one in [-180, 0), so
    # only a frontal batch lies wholly inside the window
    sigma = (n * p_front * (1 - p_front)) ** 0.5
    assert abs(front - n * p_front) <= 4 * sigma, (front, n * p_front)
    outside = port_cam.sample_camera_batch(gen, 100, cfg, device="cpu")
    assert not bool(outside.is_head) and not bool(outside.is_back)


@pytest.mark.parametrize("apose", [True, False])
@pytest.mark.parametrize("style", ["humansd", "openpose"])
def test_skeleton_matches(style, apose):
    want = Skeleton(style=style, apose=apose).load_smplx(
        toy_model()).scale(-10)
    got = PortSkeleton(style=style, apose=apose).load_smplx(
        port_toy_model()).scale(-10)
    for f in ("points3d", "vertices", "hand_centers"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   atol=1e-5, rtol=0, err_msg=f)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.names == want.names
    np.testing.assert_array_equal(got.lines, want.lines)
    got.vertices = want.vertices
    np.testing.assert_array_equal(got.sample_smplx_points(700, seed=4),
                                  want.sample_smplx_points(700, seed=4))


def test_sample_mesh_surface_bit_equal():
    rng = np.random.default_rng(1)
    verts = rng.standard_normal((40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, (60, 3)).astype(np.int32)
    for seed in (0, 7):
        np.testing.assert_array_equal(
            sample_mesh_surface(verts, faces, 300, seed),
            jax_sample_mesh_surface(verts, faces, 300, seed))


def _jax_images(style, points, mvp, size, occ):
    draw = (jax_pose.draw_humansd_pose if style == "humansd"
            else jax_pose.draw_openpose_pose)
    out = [draw(jnp.asarray(points), jnp.asarray(m), size, size, occ)
           for m in mvp]
    return (np.stack([np.asarray(o[0]) for o in out]),
            np.stack([np.asarray(o[1]) for o in out]))


@pytest.mark.parametrize("size", [64, 512])
@pytest.mark.parametrize("style", ["humansd", "openpose"])
def test_pose_images_match(style, size):
    skel = Skeleton(style=style, apose=True).load_smplx(
        toy_model()).scale(-10)
    cams = jax_cam.sample_camera_batch(jax.random.PRNGKey(size), 0,
                                       jax_cam.RandomCameraConfig())
    mvp = np.asarray(cams.mvp_mtx)
    for occ in (False, True):
        want, want_kp = _jax_images(style, skel.points3d, mvp, size, occ)
        got, got_kp = (port_pose.draw_humansd_pose
                       if style == "humansd" else
                       port_pose.draw_openpose_pose)(
            torch.tensor(skel.points3d), torch.tensor(mvp), size, size,
            torch.full((8,), occ))
        np.testing.assert_allclose(np_(got_kp[..., :2]), want_kp[..., :2],
                                   atol=1e-3, rtol=0)
        np.testing.assert_array_equal(np_(got_kp[..., 2]), want_kp[..., 2])
        kp = [torch.from_numpy(np.ascontiguousarray(want_kp[..., i]))
              for i in range(3)]
        if style == "humansd":
            drawn = port_pose.draw_humansd_keypoints(*kp, size, size)
            np.testing.assert_array_equal(np_(drawn), want)
            # the port's own projection floors to the same pixels here
            np.testing.assert_array_equal(np.floor(np_(got_kp[..., :2])),
                                          np.floor(want_kp[..., :2]))
            np.testing.assert_array_equal(np_(got), want)
        else:
            drawn = np_(port_pose.draw_openpose_keypoints(*kp, size, size))
            covered = want.max(-1) > 0
            np.testing.assert_array_equal(drawn.max(-1) > 0, covered)
            err = np.abs(drawn - want).max(-1)
            assert int((err > 1e-6).sum()) <= 0.002 * covered.sum()
        assert want.max() > 0 and covered_share(want) < 0.5


def covered_share(images):
    return float((images.max(-1) > 0).mean())


def test_back_view_occlusion_hides_the_face():
    """A camera behind the body: occlusion on hides nose and eyes."""
    skel = PortSkeleton(style="humansd", apose=True).load_smplx(
        port_toy_model()).scale(-10)
    cfg = port_cam.RandomCameraConfig(eval_elevation_deg=0.0)
    cams = port_cam.eval_camera_batch(cfg, "test", device="cpu")
    back = cams.azimuth.abs() > 120.0
    _img, kp = port_pose.draw_humansd_pose(
        torch.from_numpy(skel.points3d), cams.mvp_mtx, 64, 64, back)
    _img, kp_off = port_pose.draw_humansd_pose(
        torch.from_numpy(skel.points3d), cams.mvp_mtx, 64, 64)
    assert bool((kp_off[..., 2] == 1).all())
    assert bool((kp[~back][..., 2] == 1).all())
    assert bool((kp[back][..., :3, 2] == 0).any())
