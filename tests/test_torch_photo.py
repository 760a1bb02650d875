"""PyTorch port vs JAX: the photo-3DGS training slice as a whole.

- One `train_step` from the same `PhotoTrainState` (carried over with
  `convert.photo_state_from_numpy`) on the same posed image: loss 1e-5
  relative; every parameter 1e-6 absolute; Adam moments and densify
  statistics 1e-5 of the tensor's max-|value| (they are gradients, held
  like gradients). The state starts mid-training (non-zero moments, Adam
  count 10): from zero moments Adam's first update is lr * sign(g), and a
  gradient at rounding level would flip a whole step.
- `densify_step` with the JAX split draw passed in, and `reset_opacity`
  (also tests/test_photo.py's own check): as tests/test_torch_densify.py.
- 30 steps on a fixed view with the port alone: last loss < 0.7 x first
  (tests/test_photo.py::TestPhotoOverfit).
- `load_blender` on a 3-image RGBA dataset: equal arrays.
- The launcher end to end on the CPU (2 steps, 32x32 Blender dataset):
  the JAX `load_ply` reads its `last.ply` with arrays equal to the port's.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.apps import launch as t_launch
from humangaussian_torch.convert import photo_state_from_numpy
from humangaussian_torch.data import photo as t_data
from humangaussian_torch.io.ply import load_ply as t_load_ply
from humangaussian_torch.ops.projection import RasterizeConfig as TCfg
from humangaussian_torch.train import photo as t_photo
from humangaussian_tpu.core.camera import camera_from_c2w, look_at_c2w
from humangaussian_tpu.data import photo as j_data
from humangaussian_tpu.densify import DensifyState as JDensifyState
from humangaussian_tpu.io.ply import load_ply as j_load_ply
from humangaussian_tpu.ops.projection import RasterizeConfig as JCfg
from humangaussian_tpu.train import photo as j_photo
from port_parity import assert_tree_close, np_, photo_state_leaves

torch.set_num_threads(1)
N, CAPACITY = 200, 256


def _trainers(sh_degree=1, **kw):
    cfg = dict(capacity=CAPACITY, sh_degree=sh_degree, tile_capacity=256,
               densify_from_iter=10_000, **kw)
    jt = j_photo.PhotoTrainer(
        j_photo.PhotoTrainConfig(**cfg), extent=2.0,
        raster_cfg=JCfg(tile=32, max_tiles_per_gaussian=16))
    tt = t_photo.PhotoTrainer(
        t_photo.PhotoTrainConfig(**cfg), extent=2.0,
        raster_cfg=TCfg(tile=32, max_tiles_per_gaussian=16), device="cpu")
    return jt, tt


def _points(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, 3).astype(np.float32) * 0.3,
            rng.rand(N, 3).astype(np.float32))


def _mid_training_state(jt, seed=0):
    """A JAX state as after some steps: opaque-ish scene, non-zero SH
    bands, populated Adam moments, count 10, step 10."""
    rng = np.random.default_rng(seed)
    state = jt.init_state(jax.random.PRNGKey(0), *_points(seed))
    scene = state.scene
    alive = scene.alive[:, None]
    scene = scene._replace(
        opacity_logits=jnp.where(alive, jnp.asarray(
            rng.uniform(-2, 2, (CAPACITY, 1)), jnp.float32), -10.0),
        sh_rest=jnp.asarray(0.1 * rng.standard_normal(scene.sh_rest.shape),
                            jnp.float32),
        quats=jnp.asarray(rng.standard_normal((CAPACITY, 4)), jnp.float32),
    )
    mu = {k: jnp.asarray(1e-3 * rng.standard_normal(v.shape), jnp.float32)
          for k, v in scene.params().items()}
    nu = {k: jnp.asarray(1e-6 * (1 + rng.random(v.shape)), jnp.float32)
          for k, v in scene.params().items()}
    return state._replace(
        scene=scene,
        adam=state.adam._replace(mu=mu, nu=nu,
                                 count=jnp.asarray(10, jnp.int32)),
        step=jnp.asarray(10, jnp.int32))


def _posed_target(jt, state):
    """The fixed view of tests/test_photo.py: a render of the scene with
    brighter colours and opaque Gaussians."""
    target = state.scene._replace(
        sh_dc=state.scene.sh_dc + 0.5,
        opacity_logits=jnp.where(state.scene.alive[:, None], 2.0, -10.0))
    c2w = look_at_c2w(jnp.array([0.0, 0.0, 2.5]), jnp.zeros(3),
                      jnp.array([0.0, 1.0, 0.0]))
    gt = np.array(jt.render(target, camera_from_c2w(c2w, 0.9, 64, 64))
                  ["image"])
    return j_data.PosedImage(image=gt, c2w=np.array(c2w), fovy=0.9,
                             fovx=0.9)


def _assert_states_close(got, want, what):
    np.testing.assert_array_equal(np_(got.scene.alive),
                                  np.asarray(want.scene.alive))
    assert_tree_close(got.scene.params(), want.scene.params(), atol=1e-6,
                      what=f"{what} param")
    for name in ("mu", "nu"):
        assert_tree_close(getattr(got.adam, name), getattr(want.adam, name),
                          scale_rel=1e-5, what=f"{what} {name}")
    assert_tree_close(got.densify._asdict(), want.densify._asdict(),
                      scale_rel=1e-5, what=f"{what} densify")
    assert got.adam.count == int(want.adam.count)
    assert got.step == int(want.step)
    assert got.active_sh_degree == int(want.active_sh_degree)


def test_train_step_densify_and_reset_match_jax():
    jt, tt = _trainers()
    j_state = _mid_training_state(jt)
    posed = _posed_target(jt, j_state)
    t_state = photo_state_from_numpy(photo_state_leaves(j_state), "cpu")
    assert t_state.step == 10 and t_state.adam.count == 10

    j_state, j_metrics = jt.train_step(j_state, posed)
    t_state, t_metrics = tt.train_step(t_state, posed)
    np.testing.assert_allclose(float(t_metrics["loss"]),
                               float(j_metrics["loss"]), rtol=1e-5)
    assert int(t_metrics["n_alive"]) == int(j_metrics["n_alive"]) == N
    _assert_states_close(t_state, j_state, "train_step")
    assert float(t_state.densify.grad_accum.max()) > 0
    assert float(t_state.adam.mu["sh_rest"].abs().max()) > 0

    # density control from statistics well clear of the threshold
    rng = np.random.default_rng(5)
    hit = rng.random(CAPACITY) < 0.3
    stats = JDensifyState(
        grad_accum=jnp.asarray(np.where(hit, 3e-3, 1e-5), jnp.float32),
        denom=jnp.ones((CAPACITY,), jnp.float32),
        max_radii2d=j_state.densify.max_radii2d)
    j_state = j_state._replace(densify=stats)
    t_state = t_state._replace(densify=type(t_state.densify)(
        *(torch.from_numpy(np.array(v)) for v in stats)))
    k_split = jax.random.split(j_state.key)[1]
    noise = np.array(jax.random.normal(k_split, (2 * CAPACITY, 3)))
    j_state, j_info = jt.densify_step(j_state, True)
    t_state, t_info = tt.densify_step(t_state, True,
                                      noise=torch.from_numpy(noise))
    for k, v in j_info._asdict().items():
        assert int(getattr(t_info, k)) == int(v), k
    assert int(t_info.n_cloned) + int(t_info.n_split) > 0
    _assert_states_close(t_state, j_state, "densify_step")

    j_state = jt.reset_opacity(j_state)
    t_state = tt.reset_opacity(t_state)
    _assert_states_close(t_state, j_state, "reset_opacity")
    op = torch.sigmoid(t_state.scene.opacity_logits)[t_state.scene.alive]
    assert float(op.max()) <= 0.01 + 1e-5
    assert float(t_state.adam.mu["opacity_logits"].abs().sum()) == 0.0
    assert float(t_state.adam.nu["opacity_logits"].abs().sum()) == 0.0


def test_loss_decreases_on_fixed_view():
    jt, tt = _trainers(sh_degree=0)
    j_state = jt.init_state(jax.random.PRNGKey(0), *_points())
    posed = _posed_target(jt, j_state)
    state = tt.init_state(0, *_points())
    assert_tree_close(state.scene.params(), j_state.scene.params(),
                      atol=1e-6, what="init")
    losses = []
    for _ in range(30):
        state, metrics = tt.train_step(state, posed)
        losses.append(float(metrics["loss"]))
    assert state.step == 30 and state.adam.count == 30
    assert losses[-1] < losses[0] * 0.7, losses[:3] + losses[-3:]


def test_density_control_schedule():
    _, tt = _trainers(sh_degree=0)
    tt.cfg = t_photo.PhotoTrainConfig(
        capacity=CAPACITY, sh_degree=2, tile_capacity=256,
        densify_from_iter=2, densification_interval=2,
        opacity_reset_interval=3, oneup_sh_interval=4, densify_until_iter=7)
    state = tt.init_state(0, *_points())
    state = state._replace(scene=state.scene._replace(
        sh_rest=torch.zeros((CAPACITY, 8, 3))))
    ran, reset = [], []
    for step in range(1, 10):
        state = state._replace(step=step)
        before = float(torch.sigmoid(state.scene.opacity_logits).max())
        state, info = tt.maybe_density_control(state)
        if info is not None:
            ran.append(step)
        if float(torch.sigmoid(state.scene.opacity_logits).max()) < before:
            reset.append(step)
    assert ran == [4, 6]  # > from_iter, every 2nd, < until_iter
    assert reset == [3]  # 6 resets too, but opacities are already <= 0.01
    assert state.active_sh_degree == 2  # raised at 4 and 8, capped


def _write_blender(root, n_train, n_test, size, seed=0):
    from PIL import Image

    rng = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        frames = []
        for i in range(n):
            img = (rng.rand(size, size, 4) * 255).astype(np.uint8)
            name = f"{split}_{i}"
            Image.fromarray(img).save(os.path.join(root, name + ".png"))
            c2w = np.eye(4)
            c2w[:3, 3] = [0.3 * i, 0.1, 2 + 0.5 * i]
            frames.append({"file_path": f"./{name}",
                           "transform_matrix": c2w.tolist()})
        if n:
            with open(os.path.join(root, f"transforms_{split}.json"),
                      "w") as f:
                json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    return root


@pytest.mark.parametrize("white", [True, False])
def test_load_blender_matches_jax(tmp_path, white):
    root = _write_blender(str(tmp_path), 3, 1, 32)
    want = j_data.load_blender(root, white_background=white)
    got = t_data.load_blender(root, white_background=white)
    assert len(got.train) == 3 and len(got.test) == 1
    assert got.points is None
    assert got.extent == want.extent > 0
    for g, w in zip(got.train + got.test, want.train + want.test):
        np.testing.assert_array_equal(g.image, w.image)
        np.testing.assert_array_equal(g.c2w, w.c2w)
        assert (g.fovy, g.fovx, g.name) == (w.fovy, w.fovx, w.name)
    assert len(t_data.load_blender(root, max_images=2).train) == 2


def test_launcher_end_to_end_on_the_cpu(tmp_path, capsys):
    os.makedirs(tmp_path / "scene")
    root = _write_blender(str(tmp_path / "scene"), 3, 1, 32)
    config = tmp_path / "photo.yaml"
    config.write_text(
        "name: photo3dgs\ntag: tiny\nseed: 0\n"
        f"exp_root_dir: {tmp_path / 'outputs'}\n"
        f"data:\n  type: blender\n  dataroot: {root}\n"
        "system:\n  type: photo-3dgs-system\n  capacity: 256\n"
        "  sh_degree: 1\n  init_points: 100\n  tile_capacity: 256\n"
        "trainer:\n  max_steps: 7000\n")
    trial = t_launch.main(["--config", str(config), "--train", "--device",
                           "cpu", "trainer.max_steps=2",
                           "trainer.log_every=1"])
    printed = capsys.readouterr().out
    assert "photo step 2: loss=" in printed and "alive=100" in printed
    assert "photo eval: psnr=" in printed
    assert os.path.exists(os.path.join(trial, "configs", "raw.yaml"))
    ply = os.path.join(trial, "save", "last.ply")
    want = j_load_ply(ply)
    got = t_load_ply(ply, device="cpu")
    assert int(got.alive.sum()) == 100 and got.max_sh_degree == 1
    assert_tree_close(got._asdict(), want._asdict(), what="last.ply")
    assert bool(torch.isfinite(got.means).all())


@pytest.mark.parametrize("override,error,match", [
    # the avatar system is ported: it asks for its SMPL-X file
    ("system.type=gaussiandreamer-system", KeyError, "smplx_path"),
    ("system.type=dreamfusion-system", NotImplementedError, "item 21"),
    ("system.type=bogus", ValueError, "unknown system.type"),
    # co3d is ported: `data.dataroot` is the sequence, whose category
    # holds the annotations
    ("data.type=co3d", FileNotFoundError, "frame_annotations"),
    ("data.type=bogus", ValueError, "unknown data.type"),
])
def test_launcher_refuses_what_is_not_ported(tmp_path, override, error, match):
    config = tmp_path / "photo.yaml"
    config.write_text(
        f"exp_root_dir: {tmp_path / 'outputs'}\n"
        "data:\n  type: blender\n  dataroot: nowhere\n"
        "system:\n  type: photo-3dgs-system\n")
    with pytest.raises(error, match=match):
        t_launch.main(["--config", str(config), "--device", "cpu", override])


def test_launcher_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    config = tmp_path / "photo.yaml"
    config.write_text("system:\n  type: photo-3dgs-system\n")
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_launch.main(["--config", str(config)])


def _write_colmap(root, n_images=5, size=(24, 16), seed=0):
    """A COLMAP binary sparse model (one PINHOLE camera, `n_images` posed
    images, 7 points) and its image files."""
    import struct

    from PIL import Image

    rng = np.random.RandomState(seed)
    w, h = size
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, w, h))  # PINHOLE
        f.write(struct.pack("<4d", 30.0, 28.0, w / 2, h / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_images))
        for i in range(n_images):
            q = rng.randn(4)
            q /= np.linalg.norm(q)
            f.write(struct.pack("<I", i + 1))
            f.write(struct.pack("<7d", *q, *rng.randn(3)))
            f.write(struct.pack("<I", 1))
            f.write(f"img_{i}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(b"\x00" * 48)  # two 2D points
            Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
                os.path.join(root, "images", f"img_{i}.png"))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 7))
        for i in range(7):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<3d", *rng.randn(3)))
            f.write(struct.pack("<3B", *rng.randint(0, 256, 3)))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", 1))
            f.write(b"\x00" * 8)
    return root


def test_load_colmap_matches_jax(tmp_path):
    root = _write_colmap(str(tmp_path))
    want = j_data.load_colmap(root, test_every=3)
    got = t_data.load_colmap(root, test_every=3)
    assert len(got.train) == 3 and len(got.test) == 2
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.point_colors, want.point_colors)
    assert got.points.shape == (7, 3) and got.extent == want.extent
    for g, w in zip(got.train + got.test, want.train + want.test):
        np.testing.assert_array_equal(g.image, w.image)
        np.testing.assert_array_equal(g.c2w, w.c2w)
        assert (g.fovy, g.fovx, g.name) == (w.fovy, w.fovx, w.name)
