"""PyTorch port vs JAX: SMPL-X LBS, mesh binding, re-posed render, CLI.

Tolerances: LBS vertices and joints 1e-5 absolute (f32 einsum sums over
55 joints in another order); binding faces equal and barycentrics /
distances 1e-6 (the same numpy code on vertices that agree to ~1e-7);
the re-posed 64x64 render to the rasterizer's 2e-6 image / alpha and
2e-5 depth, on the JAX-built camera.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.animation import AvatarAnimator as TAnimator
from humangaussian_torch.animation import load_amass_body_poses
from humangaussian_torch.apps import animate as t_animate
from humangaussian_torch.convert import scene_from_numpy, smplx_from_numpy
from humangaussian_torch.io.ply import load_ply, save_ply
from humangaussian_torch.smplx import model as tmodel
from humangaussian_torch.smplx.lbs import SMPLXPose as TPose
from humangaussian_torch.smplx.lbs import lbs_forward as t_lbs
from humangaussian_tpu.animation import AvatarAnimator as JAnimator
from humangaussian_tpu.core.scene import GaussianScene as JScene
from humangaussian_tpu.io.ply import load_ply as j_load_ply
from humangaussian_tpu.smplx.lbs import SMPLXPose as JPose
from humangaussian_tpu.smplx.lbs import lbs_forward as j_lbs
from humangaussian_tpu.smplx.model import toy_model
from humangaussian_tpu.smplx.skeleton import sample_mesh_surface
from port_parity import jax_camera, np_, torch_camera_from_jax

torch.set_num_threads(1)
MODEL = toy_model()
BG = np.array([1.0, 1.0, 1.0], np.float32)


def _pose(seed, scale=0.4):
    return (np.random.RandomState(seed).randn(21, 3) * scale).astype(np.float32)


def _avatar_scene(n=600, seed=0, capacity=1024):
    """A degree-1 avatar on the toy body's normalized rest surface (the
    animator's own frame), with small normal offsets."""
    v = MODEL.v_template
    center = (v.max(0) + v.min(0)) / 2
    scale = 0.6 / np.max(v.max(0) - v.min(0)) * 1.1 ** 10
    verts_n = (v - center) * scale
    rng = np.random.RandomState(seed)
    pts = sample_mesh_surface(verts_n, MODEL.faces, n, seed)
    pts = pts + rng.randn(n, 3).astype(np.float32) * 1e-3
    pad = capacity - n

    def padded(x, fill=0.0):
        return np.concatenate(
            [x, np.full((pad,) + x.shape[1:], fill, np.float32)]
        ).astype(np.float32)

    return dict(
        means=padded(pts),
        log_scales=padded(np.full((n, 3), np.log(0.01), np.float32)
                          + rng.randn(n, 3).astype(np.float32) * 0.2, -10.0),
        quats=padded(rng.randn(n, 4).astype(np.float32)),
        sh_dc=padded(rng.randn(n, 3).astype(np.float32) * 0.5),
        sh_rest=padded(rng.randn(n, 3, 3).astype(np.float32) * 0.1),
        opacity_logits=padded(rng.randn(n, 1).astype(np.float32) + 1.0,
                              -10.0),
        alive=np.arange(capacity) < n,
    )


def test_toy_model_is_a_copy():
    t = tmodel.toy_model(n_ring=12, n_seg_per_bone=3)
    j = toy_model(n_ring=12, n_seg_per_bone=3)
    for name, v in j._asdict().items():
        np.testing.assert_array_equal(getattr(t, name), v, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_lbs_forward(seed):
    bp = _pose(seed)
    jv, jj = j_lbs(MODEL, JPose.rest(body_pose=jnp.asarray(bp)))
    tmod = smplx_from_numpy(MODEL, device="cpu")
    tv, tj = t_lbs(tmod, TPose.rest(body_pose=torch.from_numpy(bp)))
    np.testing.assert_allclose(np_(tv), np_(jv), atol=1e-5)
    np.testing.assert_allclose(np_(tj), np_(jj), atol=1e-5)


def _animators():
    d = _avatar_scene()
    janim = JAnimator(JScene(**{k: jnp.asarray(v) for k, v in d.items()}),
                      MODEL)
    tanim = TAnimator(scene_from_numpy(d, device="cpu"),
                      smplx_from_numpy(MODEL, device="cpu"))
    return janim, tanim


def test_binding_and_render_frame():
    janim, tanim = _animators()
    jb, tb = janim.binding, tanim.binding
    np.testing.assert_array_equal(tb.keep_mask, jb.keep_mask)
    np.testing.assert_array_equal(tb.face_idx, jb.face_idx)
    np.testing.assert_allclose(tb.bary, jb.bary, atol=1e-6)
    np.testing.assert_allclose(tb.dist, jb.dist, atol=1e-6)
    assert tanim.n_gaussians == janim.n_gaussians > 500

    bp = _pose(3)
    jcam = jax_camera(64, 64, eye=(0.4, 0.3, 2.0), fovy=0.9)
    jscene = janim.frame_scene(JPose.rest(body_pose=jnp.asarray(bp)))
    tscene = tanim.frame_scene(TPose.rest(body_pose=torch.from_numpy(bp)))
    np.testing.assert_allclose(np_(tscene.means), np_(jscene.means),
                               atol=1e-5)
    want = janim.render_frame(JPose.rest(body_pose=jnp.asarray(bp)), jcam,
                              jnp.asarray(BG))
    got = tanim.render_frame(TPose.rest(body_pose=torch.from_numpy(bp)),
                             torch_camera_from_jax(jcam),
                             torch.from_numpy(BG))
    assert np_(got["alpha"]).max() > 0.9
    for key, atol in (("image", 2e-6), ("alpha", 2e-6), ("depth", 2e-5)):
        np.testing.assert_allclose(np_(got[key]), np_(want[key]), atol=atol,
                                   err_msg=key)
    np.testing.assert_array_equal(np_(got["radii"]), np_(want["radii"]))


def _write_smplx_npz(path, m):
    """The toy body in the SMPL-X release npz schema."""
    v = m.v_template.shape[0]
    kintree = np.zeros((2, 55), np.int64)
    kintree[0] = m.parents
    np.savez(
        path, v_template=m.v_template,
        shapedirs=np.zeros((v, 3, 400), np.float32), posedirs=m.posedirs,
        J_regressor=m.j_regressor, kintree_table=kintree,
        weights=m.lbs_weights, f=m.faces,
        hands_meanl=np.zeros(45, np.float32),
        hands_meanr=np.zeros(45, np.float32),
    )


def test_ply_roundtrip_matches_jax_loader(tmp_path):
    d = _avatar_scene(n=300, capacity=512)
    path = str(tmp_path / "a.ply")
    assert save_ply(scene_from_numpy(d, device="cpu"), path) == 300
    for conv in (False, True):
        t = load_ply(path, animation_convention=conv, device="cpu")
        j = j_load_ply(path, animation_convention=conv)
        for name, v in j._asdict().items():
            np.testing.assert_array_equal(np_(getattr(t, name)), np_(v),
                                          err_msg=name)


def test_animate_cli_end_to_end(tmp_path):
    d = _avatar_scene(n=400, capacity=512)
    # store in the training frame: the loader's axis shim swaps y/z back
    for key in ("means", "log_scales"):
        d[key] = d[key][:, [0, 2, 1]]
    ply = str(tmp_path / "last.ply")
    save_ply(scene_from_numpy(d, device="cpu"), ply)
    smplx_path = str(tmp_path / "SMPLX_NEUTRAL.npz")
    _write_smplx_npz(smplx_path, tmodel.toy_model())
    motion = str(tmp_path / "motion.npz")
    poses = np.random.RandomState(0).randn(3, 55 * 3).astype(np.float32) * 0.2
    np.savez(motion, poses=poses)
    assert load_amass_body_poses(motion).shape == (3, 21, 3)

    out = str(tmp_path / "anim.mp4")
    written, frames = t_animate.main([
        "--ply", ply, "--motion", motion, "--smplx_path", smplx_path,
        "--out", out, "--device", "cpu", "--size", "64",
        "--max_frames", "2", "--rotate",
    ])
    assert os.path.exists(written) and os.path.getsize(written) > 0
    assert written in (out, out[:-4] + ".gif")
    assert len(frames) == 2 and frames[0].shape == (64, 64, 3)
    assert all(np.isfinite(f).all() for f in frames)
    assert not np.allclose(frames[0], 1.0)  # the avatar is in view


def test_animate_cli_defaults_to_cuda():
    assert t_animate.build_parser().parse_args(
        ["--ply", "a", "--motion", "b", "--smplx_path", "c"]).device == "cuda"
