"""Scene-level render API: GaussianScene + Camera + background -> dict.

Port of humangaussian_tpu/render.py (`render`), plus `render_batch`, the
scene-level batched render that the JAX system's `render_batch` /
`render_eval` run over a CameraBatch (train/system.py).
"""
from __future__ import annotations

import torch

from humangaussian_torch.core.camera import Camera
from humangaussian_torch.core.scene import GaussianScene
from humangaussian_torch.ops.projection import RasterizeConfig
from humangaussian_torch.ops.rasterize import rasterize
from humangaussian_torch.ops.rasterize_tiled import rasterize_tiled_batch


def render(
    scene: GaussianScene,
    camera: Camera,
    background: torch.Tensor,
    sh_degree: int | None = None,
    cfg: RasterizeConfig = RasterizeConfig(),
    scale_modifier: float = 1.0,
    means2d_offset: torch.Tensor | None = None,
    impl: str = "tiled",
    **kwargs,
) -> dict:
    """Render one view. Returns {image, depth, alpha, radii, visible, ...}.
    `sh_degree` is the active degree (defaults to the scene's max)."""
    if sh_degree is None:
        sh_degree = scene.max_sh_degree
    return rasterize(
        scene.means, scene.scales, scene.quats, scene.features,
        scene.opacities, scene.alive, camera, background, sh_degree, cfg,
        scale_modifier=scale_modifier, means2d_offset=means2d_offset,
        impl=impl, **kwargs,
    )


def render_batch(
    scene: GaussianScene,
    cameras: Camera,
    background: torch.Tensor,
    sh_degree: int | None = None,
    cfg: RasterizeConfig = RasterizeConfig(),
    **kwargs,
) -> dict:
    """Render a batch of views (a Camera with a leading batch axis) in one
    compositing launch; outputs carry a leading batch axis."""
    if sh_degree is None:
        sh_degree = scene.max_sh_degree
    return rasterize_tiled_batch(
        scene.means, scene.scales, scene.quats, scene.features,
        scene.opacities, scene.alive, cameras, background, sh_degree, cfg,
        **kwargs,
    )
