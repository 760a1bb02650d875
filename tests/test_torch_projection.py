"""PyTorch port vs JAX: every ProjectedGaussians field.

rect, radii and visible must agree exactly (they decide which pairs
exist); the float fields to 1e-6 relative + 1e-5 absolute (f32 rounding of
the same elementwise formulas; means2d are in pixels).
"""
import numpy as np
import pytest
import torch

from humangaussian_torch.ops.projection import RasterizeConfig as TCfg
from humangaussian_torch.ops.projection import project_gaussians as t_project
from humangaussian_tpu.ops.projection import RasterizeConfig as JCfg
from humangaussian_tpu.ops.projection import project_gaussians as j_project
from port_parity import (jax_args, jax_camera, make_scene, np_,
                         torch_args, torch_camera_from_jax)

torch.set_num_threads(1)


@pytest.mark.parametrize("max_tiles", [4, 9, 16])
@pytest.mark.parametrize("seed,sh_degree,hw", [
    (0, 0, (64, 64)),
    (1, 3, (96, 64)),
])
def test_projection_fields(max_tiles, seed, sh_degree, hw):
    scene = make_scene(n=400, n_dead=40, seed=seed, sh_degree=sh_degree)
    # a few large, near and behind-camera splats exercise the radius cap,
    # the rect clip and the near cull
    scene[0][:20] *= 4.0
    scene[1][:10] += 2.0
    jcam = jax_camera(*hw)
    tcam = torch_camera_from_jax(jcam)
    off = np.random.RandomState(seed).randn(400, 2).astype(np.float32) * 0.1
    want = j_project(*jax_args(scene), jcam, sh_degree,
                     JCfg(max_tiles_per_gaussian=max_tiles),
                     scale_modifier=0.9, means2d_offset=off)
    got = t_project(*torch_args(scene), tcam, sh_degree,
                    TCfg(max_tiles_per_gaussian=max_tiles),
                    scale_modifier=0.9, means2d_offset=torch.from_numpy(off))
    for name in ("rect", "radii", "visible"):
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np_(getattr(want, name)), err_msg=name)
    vis = np_(want.visible)
    assert vis.sum() > 100
    assert (np_(want.radii) == TCfg(max_tiles_per_gaussian=max_tiles)
            .max_radius_px).any() or max_tiles == 16
    for name in ("means2d", "depths", "conics", "rgb", "opacities"):
        np.testing.assert_allclose(
            np_(getattr(got, name))[vis], np_(getattr(want, name))[vis],
            rtol=1e-6, atol=1e-5, err_msg=name)
    assert got.radii.dtype == torch.int32 and got.rect.dtype == torch.int32


def test_offscreen_rects_clip():
    """Means left of / above the image give negative rect bounds, which
    truncate toward zero and clip to the tile grid as the JAX astype +
    clip does."""
    scene = make_scene(n=64, n_dead=0, seed=3)
    scene[0][:] *= 3.0
    jcam = jax_camera(64, 64, eye=(1.2, 0.2, 3.0))
    want = j_project(*jax_args(scene), jcam, 0, JCfg())
    got = t_project(*torch_args(scene), torch_camera_from_jax(jcam), 0,
                    TCfg())
    np.testing.assert_array_equal(np_(got.rect), np_(want.rect))
    assert (np_(got.means2d) < 0).any()
