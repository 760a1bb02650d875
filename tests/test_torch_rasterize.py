"""PyTorch port vs JAX: the whole tiled render (plain compositing path).

The port's `rasterize_tiled` / `rasterize_tiled_batch` on CPU tensors run
projection, binning and `composite_plain`; they are held against the JAX
`rasterize_tiled` / `rasterize_tiled_batch` (Pallas in interpret mode),
against the port's own brute-force oracle, and against the recorded
forward outputs of tests/fixtures/cuda/*.npz.

Tolerances (NUMERICS.md layer 0, tests/test_cuda_fixtures.py:31): image
and alpha 2e-6 absolute, depth 2e-5 absolute; radii and visible exact.
"""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.ops.binning import build_pair_lists
from humangaussian_torch.ops.projection import RasterizeConfig as TCfg
from humangaussian_torch.ops.projection import project_gaussians
from humangaussian_torch.ops.rasterize_ref import rasterize_reference as t_ref
from humangaussian_torch.ops.rasterize_tiled import (
    composite,
    feature_matrix,
    rasterize_tiled as t_tiled,
    rasterize_tiled_batch as t_tiled_batch,
)
from humangaussian_tpu.core.camera import camera_from_c2w as j_camera
from humangaussian_tpu.ops.projection import RasterizeConfig as JCfg
from humangaussian_tpu.ops.rasterize_tiled import (
    rasterize_tiled as j_tiled,
    rasterize_tiled_batch as j_tiled_batch,
)
from port_parity import (jax_args, jax_camera, make_scene, np_,
                         stack_jax_cameras, torch_args, torch_camera_from_jax)

torch.set_num_threads(1)
FWD_ATOL = {"image": 2e-6, "alpha": 2e-6, "depth": 2e-5}
BG = np.array([0.1, 0.2, 0.3], np.float32)
FIXTURES = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "fixtures", "cuda", "*.npz")))


def _assert_close(got, want):
    for key, atol in FWD_ATOL.items():
        np.testing.assert_allclose(np_(got[key]), np_(want[key]), atol=atol,
                                   err_msg=key)
    for key in ("radii", "visible"):
        np.testing.assert_array_equal(np_(got[key]), np_(want[key]),
                                      err_msg=key)


@pytest.mark.parametrize("hw,sh_degree,max_tiles", [
    ((64, 64), 0, 16),
    ((96, 64), 3, 9),
])
def test_tiled_matches_jax(hw, sh_degree, max_tiles):
    scene = make_scene(n=300, n_dead=50, seed=sum(hw) + sh_degree,
                       sh_degree=sh_degree)
    jcam = jax_camera(*hw)
    want = j_tiled(*jax_args(scene), jcam, jnp.asarray(BG), sh_degree,
                   JCfg(max_tiles_per_gaussian=max_tiles), tile_capacity=512)
    got = t_tiled(*torch_args(scene), torch_camera_from_jax(jcam),
                  torch.from_numpy(BG), sh_degree,
                  TCfg(max_tiles_per_gaussian=max_tiles), tile_capacity=512)
    assert int(want["overflow"]) == 0 and int(got["overflow"]) == 0
    assert int(got["overflow_spill"]) == 0
    assert got["image"].shape == (hw[0], hw[1], 3)
    assert np_(got["alpha"]).max() > 0.5
    _assert_close(got, want)
    # the port's own oracle agrees as well
    ref = t_ref(*torch_args(scene), torch_camera_from_jax(jcam),
                torch.from_numpy(BG), sh_degree,
                TCfg(max_tiles_per_gaussian=max_tiles))
    _assert_close(got, ref)


def test_batch_of_three_matches_jax():
    scene = make_scene(n=300, n_dead=20, seed=11, sh_degree=1)
    eyes = [(0.3, 0.2, 3.0), (-2.0, 0.5, 2.0), (1.0, -1.5, 2.5)]
    jcams = stack_jax_cameras([jax_camera(64, 64, eye=e) for e in eyes])
    want = j_tiled_batch(*jax_args(scene), jcams, jnp.asarray(BG), 1,
                         JCfg(), tile_capacity=512)
    got = t_tiled_batch(*torch_args(scene), torch_camera_from_jax(jcams),
                        torch.from_numpy(BG), 1, TCfg(), tile_capacity=512)
    assert got["image"].shape == (3, 64, 64, 3)
    assert got["radii"].shape == (3, 300)
    _assert_close(got, want)


def test_empty_scene_is_background():
    scene = make_scene(n=256, n_dead=256, seed=0)
    jcam = jax_camera()
    got = t_tiled(*torch_args(scene), torch_camera_from_jax(jcam),
                  torch.from_numpy(BG))
    want = j_tiled(*jax_args(scene), jcam, jnp.asarray(BG))
    _assert_close(got, want)
    np.testing.assert_array_equal(np_(got["image"]),
                                  np.broadcast_to(BG, (64, 64, 3)))
    assert float(got["alpha"].abs().max()) == 0.0


def test_composite_outputs_are_consistent():
    """final_t = 1 - alpha, and n_contrib is 0 exactly where nothing was
    composited."""
    scene = make_scene(n=300, n_dead=0, seed=7)
    cfg = TCfg()
    prims = project_gaussians(*torch_args(scene),
                              torch_camera_from_jax(jax_camera()), 0, cfg)
    pairs = build_pair_lists([prims], 2, 2, 4096, cfg)
    out = composite(feature_matrix(prims), pairs.gids, pairs.starts[:-1],
                    pairs.counts, torch.from_numpy(BG), 2, 2, cfg)
    np.testing.assert_allclose(np_(out["final_t"]), 1.0 - np_(out["alpha"]),
                               atol=1e-7)
    assert out["n_contrib"].dtype == torch.int32
    untouched = np_(out["n_contrib"]) == 0
    assert untouched.any() and (~untouched).any()
    np.testing.assert_array_equal(np_(out["alpha"])[untouched], 0.0)
    assert int(out["visits"]) >= int(out["contribs"]) > 0


@pytest.mark.parametrize("path", FIXTURES,
                         ids=[os.path.basename(p) for p in FIXTURES])
def test_fixture_replay_forward(path):
    """The fixtures were recorded through the JAX camera builder, so the
    replay hands the port that camera's matrices (the port's own builder
    differs from XLA's LU inverse in the last bits of near-zero entries;
    see test_torch_core.py and ROADMAP queue 3)."""
    fx = np.load(path, allow_pickle=False)
    n = fx["means"].shape[0]
    h, w = int(fx["height"]), int(fx["width"])
    cam = torch_camera_from_jax(
        j_camera(jnp.asarray(fx["c2w"]), float(fx["fovy"]), h, w))
    out = t_tiled(
        torch.from_numpy(fx["means"]), torch.from_numpy(fx["scales"]),
        torch.from_numpy(fx["quats"]), torch.from_numpy(fx["sh"]),
        torch.from_numpy(fx["opacities"]), torch.ones(n, dtype=torch.bool),
        cam, torch.from_numpy(fx["background"]), int(fx["sh_degree"]),
        TCfg(tile=32, max_tiles_per_gaussian=16),
        scale_modifier=float(fx["scale_modifier"]),
        means2d_offset=torch.zeros((n, 2)),
    )
    for key, atol in FWD_ATOL.items():
        np.testing.assert_allclose(np_(out[key]), fx[key], atol=atol,
                                   err_msg=f"{os.path.basename(path)}: {key}")
    np.testing.assert_array_equal(np_(out["radii"]), fx["radii"])
