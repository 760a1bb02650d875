"""PyTorch port vs JAX: the capture datamodules (data/multiview.py,
data/co3d.py, data/image.py) and the launcher's multiview / co3d branches.

The same synthetic captures, written from a seed, are loaded by both
packages. Tolerances: frames, c2w and intrinsics within 1e-6 (the same
numpy arithmetic; the port reads PNGs with PIL, the JAX multiview module
with imageio: the same pixels); `as_photo_dataset` fields of view equal;
the image datamodule's fixed batch within 1e-6 (rays through torch instead
of jnp) and its random batch equal to the JAX one with the JAX draws
injected, to the camera sampler's 1e-5.
"""
import gzip
import json
import os

import jax
import numpy as np
import pytest
import torch

from humangaussian_torch.apps import launch as t_launch
from humangaussian_torch.data import co3d as tco3d
from humangaussian_torch.data import image as timage
from humangaussian_torch.data import multiview as tmv
from humangaussian_torch.data.cameras import RandomCameraConfig as TCamCfg
from humangaussian_tpu.data import co3d as jco3d
from humangaussian_tpu.data import image as jimage
from humangaussian_tpu.data import multiview as jmv
from humangaussian_tpu.data.cameras import RandomCameraConfig as JCamCfg
from port_parity import jax_camera_draws, np_


def _write_png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)


def write_multiview(root, n=6, h=32, w=64, seed=0):
    """An instant-ngp capture: n frames on a circle looking at the origin,
    seeded noise images, OPENCV intrinsics with an off-centre principal
    point."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    frames = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        pos = np.array([3 * np.cos(ang), 3 * np.sin(ang), 0.5 + 0.1 * i])
        fwd = -pos / np.linalg.norm(pos)  # OPENCV: +z looks forward
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, pos
        name = f"frame_{i:03d}.png"
        _write_png(os.path.join(root, name),
                   (rng.rand(h, w, 3) * 255).astype(np.uint8))
        frames.append({
            "file_path": name, "transform_matrix": c2w.tolist(),
            "w": w, "h": h, "fl_x": 40.0 + i, "fl_y": 41.0 + i,
            "cx": w / 2 + 1.5, "cy": h / 2 - 2.25,
        })
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump({"camera_model": "OPENCV", "frames": frames}, f)
    return root


def write_co3d(root, n=6, h=40, w=48, seed=0):
    """A CO3D-v2 sequence `<root>/<category>/<sequence>`: NDC-isotropic
    PyTorch3D cameras on a circle in `frame_annotations.jgz`, seeded JPEG
    images, box masks and float16-in-uint16 depth PNGs; one frame is
    marked unseen and one repeats a pose (both dropped)."""
    from PIL import Image

    cat, name = "apple", "110_13051_23361"
    seq = os.path.join(root, cat, name)
    for sub in ("images", "masks", "depths"):
        os.makedirs(os.path.join(seq, sub), exist_ok=True)
    rng = np.random.RandomState(seed)
    frames = []
    for i in range(n):
        ang = 2 * np.pi * min(i, n - 2) / (n - 1)
        cam_pos = np.array([2.0 * np.cos(ang), 0.4, 2.0 * np.sin(ang)])
        fwd = -cam_pos / np.linalg.norm(cam_pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        r_stored = np.stack([right, up2, fwd], axis=0).T
        t_stored = -(r_stored.T @ cam_pos)
        stem = f"frame{i:06d}"
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            os.path.join(seq, "images", stem + ".jpg"))
        mask = np.zeros((h, w), np.uint8)
        y0, x0 = 5 + i, 7 + 2 * i
        mask[y0:y0 + h // 2, x0:x0 + w // 3] = 255
        Image.fromarray(mask).save(os.path.join(seq, "masks", stem + ".png"))
        depth = (1.5 + rng.rand(h, w)).astype(np.float16).view(np.uint16)
        Image.fromarray(depth).save(
            os.path.join(seq, "depths", stem + ".png"))
        frames.append({
            "sequence_name": name,
            "meta": {"frame_type": "unseen" if i == 1 else "train"},
            "image": {"path": f"{cat}/{name}/images/{stem}.jpg",
                      "size": [h, w]},
            "mask": {"path": f"{cat}/{name}/masks/{stem}.png"},
            "depth": {"path": f"{cat}/{name}/depths/{stem}.png",
                      "scale_adjustment": 1.25},
            "viewpoint": {"focal_length": [2.0 + 0.05 * i, 2.1],
                          "principal_point": [0.03 * i, -0.02],
                          "R": r_stored.tolist(), "T": t_stored.tolist()},
        })
    with gzip.open(os.path.join(root, cat, "frame_annotations.jgz"),
                   "wt") as fp:
        json.dump(frames, fp)
    return seq


def _assert_frames_close(got, want, fields):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in fields:
            np.testing.assert_allclose(np_(getattr(g, f)), np.asarray(
                getattr(w, f)), rtol=0, atol=1e-6, err_msg=f)


def _assert_photo_dataset_equal(got, want):
    for split in ("train", "test"):
        g, w = getattr(got, split), getattr(want, split)
        assert [p.name for p in g] == [p.name for p in w]
        for a, b in zip(g, w):
            assert a.fovy == b.fovy and a.fovx == b.fovx
            np.testing.assert_array_equal(a.image, b.image)
            np.testing.assert_allclose(a.c2w, b.c2w, rtol=0, atol=1e-6)
    assert got.extent == pytest.approx(want.extent, rel=1e-6)


@pytest.mark.parametrize("layout,interp", [("around", None),
                                           ("front", (0, 3, 5))])
def test_multiview_matches_jax(tmp_path, layout, interp):
    root = write_multiview(str(tmp_path / "mv"))
    kw = dict(dataroot=root, train_downsample_resolution=1,
              camera_layout=layout, camera_distance=2.5,
              eval_interpolation=interp)
    got = tmv.MultiviewDataModule(tmv.MultiviewConfig(**kw))
    want = jmv.MultiviewDataModule(jmv.MultiviewConfig(**kw))
    assert (got.height, got.width) == (want.height, want.width) == (32, 64)
    _assert_frames_close(got.frames, want.frames,
                         ("rgb", "c2w", "intrinsic", "rays_o", "rays_d"))
    assert got.train_frame(7) is got.frames[1]
    for a, b in zip(got.eval_poses(), want.eval_poses()):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    _assert_photo_dataset_equal(got.as_photo_dataset(test_every=3),
                                want.as_photo_dataset(test_every=3))


def test_multiview_downsamples_and_refuses_other_models(tmp_path):
    root = write_multiview(str(tmp_path / "mv"))
    kw = dict(dataroot=root, train_downsample_resolution=2,
              train_data_interval=2)
    got = tmv.MultiviewDataModule(tmv.MultiviewConfig(**kw))
    want = jmv.MultiviewDataModule(jmv.MultiviewConfig(**kw))
    assert len(got) == 3 and got.frames[0].rgb.shape == (16, 32, 3)
    _assert_frames_close(got.frames, want.frames, ("rgb", "intrinsic"))
    with open(os.path.join(root, "transforms.json")) as f:
        meta = json.load(f)
    meta["camera_model"] = "PINHOLE"
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="OPENCV"):
        tmv.MultiviewDataModule(tmv.MultiviewConfig(dataroot=root))


@pytest.mark.parametrize("box_crop", [True, False])
def test_co3d_matches_jax(tmp_path, box_crop):
    seq = write_co3d(str(tmp_path / "co3d"))
    kw = dict(root_dir=seq, height=32, width=32, box_crop=box_crop)
    got = tco3d.Co3dDataModule(tco3d.Co3dConfig(**kw))
    want = jco3d.Co3dDataModule(jco3d.Co3dConfig(**kw))
    assert len(got) == len(want) == 4  # one unseen, one repeated pose
    _assert_frames_close(got.frames, want.frames,
                         ("rgb", "depth", "mask", "c2w", "intrinsic",
                          "rays_o", "rays_d"))
    _assert_photo_dataset_equal(got.as_photo_dataset(test_every=2),
                                want.as_photo_dataset(test_every=2))


def test_co3d_helpers_match_jax(tmp_path):
    from PIL import Image

    p = str(tmp_path / "d.png")
    d16 = np.array([[1.5, np.inf], [0.25, 3.0]], np.float16).view(np.uint16)
    Image.fromarray(d16).save(p)
    np.testing.assert_array_equal(tco3d.load_f16_depth_png(p),
                                  jco3d.load_f16_depth_png(p))
    mask = np.zeros((20, 30), np.float32)
    mask[4:9, 6:20] = 0.3
    for thr in (0.4, 0.2):
        assert (tco3d.bbox_from_mask(mask, thr)
                == jco3d.bbox_from_mask(mask, thr))
    assert (tco3d.clamp_bbox((2, 3, 10, 4), 0.3)
            == jco3d.clamp_bbox((2, 3, 10, 4), 0.3))
    rng = np.random.RandomState(0)
    c2w = np.tile(np.eye(4), (5, 1, 1))
    c2w[:, :3, 3] = rng.randn(5, 3)
    t_got, s_got = tco3d.similarity_from_cameras(c2w, radius=1.5)
    t_want, s_want = jco3d.similarity_from_cameras(c2w, radius=1.5)
    np.testing.assert_array_equal(t_got, t_want)
    assert s_got == s_want


def _write_rgba(path, size=24):
    rgba = np.zeros((size, size, 4), np.uint8)
    rgba[6:18, 5:20] = (200, 50, 30, 255)
    _write_png(path, rgba)


def test_single_image_batches_match_jax(tmp_path):
    path = str(tmp_path / "ref_rgba.png")
    _write_rgba(path)
    for side in ("depth", "normal"):
        _write_png(str(tmp_path / f"ref_{side}.png"),
                   np.full((24, 24, 3), 128, np.uint8))
    kw = dict(image_path=path, height=16, width=16, requires_depth=True,
              requires_normal=True, default_elevation_deg=10.0,
              default_azimuth_deg=30.0)
    cam = dict(batch_size=2, height=16, width=16)
    got = timage.SingleImageDataModule(timage.SingleImageConfig(
        **kw, random_camera=TCamCfg(**cam)))
    want = jimage.SingleImageDataModule(jimage.SingleImageConfig(
        **kw, random_camera=JCamCfg(**cam)))
    g, w = got.fixed_batch(), want.fixed_batch()
    for f in g._fields:
        np.testing.assert_allclose(np_(getattr(g, f)),
                                   np.asarray(getattr(w, f)), rtol=0,
                                   atol=1e-6, err_msg=f)

    key = jax.random.PRNGKey(3)
    for step in (0, 500):
        gb = got.random_batch(None, step, draws=jax_camera_draws(key, 2))
        wb = want.random_batch(key, step)
        for f in ("c2w", "mvp_mtx", "elevation", "azimuth",
                  "camera_distances", "fovy"):
            np.testing.assert_allclose(np_(getattr(gb, f)),
                                       np.asarray(getattr(wb, f)), rtol=1e-5,
                                       atol=1e-5, err_msg=f)
    # drawn from a generator: the configured batch, reproducible by seed
    a = got.random_batch(torch.Generator().manual_seed(1), 0)
    b = got.random_batch(torch.Generator().manual_seed(1), 0)
    assert a.c2w.shape == (2, 4, 4) and torch.equal(a.c2w, b.c2w)


def test_get_rays_matches_jax():
    from humangaussian_tpu.nerf.renderer import get_rays as j_get_rays

    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(np.random.RandomState(0).randn(3, 3))[0]
    c2w[:3, 3] = (0.5, -1.0, 2.0)
    o_got, d_got = timage.get_rays(torch.from_numpy(c2w), 0.9, 12, 20)
    o_want, d_want = j_get_rays(c2w, 0.9, 12, 20)
    np.testing.assert_allclose(np_(o_got), np.asarray(o_want), atol=1e-6)
    np.testing.assert_allclose(np_(d_got), np.asarray(d_want), atol=1e-6)


@pytest.mark.parametrize("kind", ["multiview", "co3d"])
def test_launcher_trains_on_a_capture(tmp_path, kind):
    """Two photo-3DGS steps through the CLI on a 64x32 multiview capture
    or a 32^2 CO3D sequence; the trained scene reads back."""
    from humangaussian_torch.io.ply import load_ply

    if kind == "multiview":
        root = write_multiview(str(tmp_path / "data"))
        extra = ["data.train_downsample_resolution=1"]
    else:
        root = write_co3d(str(tmp_path / "data"))
        extra = ["data.height=32", "data.width=32"]
    config = tmp_path / "photo.yaml"
    config.write_text(
        f"exp_root_dir: {tmp_path / 'outputs'}\n"
        "data:\n  type: blender\n  dataroot: nowhere\n"
        "system:\n  type: photo-3dgs-system\n")
    trial = t_launch.main([
        "--config", str(config), "--train", "--device", "cpu",
        f"data.type={kind}", f"data.dataroot={root}", *extra,
        "system.capacity=512", "system.init_points=100",
        "system.sh_degree=1", "system.tile_capacity=256",
        "trainer.max_steps=2", "trainer.log_every=1"])
    scene = load_ply(os.path.join(trial, "save", "last.ply"), device="cpu")
    assert scene.num_alive == 100
    assert all(bool(torch.isfinite(v[scene.alive]).all())
               for v in scene.params().values())
