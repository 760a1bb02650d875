"""Vanilla photo-supervised 3DGS trainer (L1 + D-SSIM).

Port of humangaussian_tpu/train/photo.py: per step, render one posed
training image through the tiled rasterizer (K1 forward, K2 backward on a
card), minimize (1-lambda)*L1 + lambda*(1-SSIM), update the densify
statistics and take one per-group Adam step; between steps, adaptive
density control (densify from 500 to 15000 every 100, opacity reset every
3000, SH degree raised every 1000), all on the padded scene.

`reset_opacity` sets opacity <- logit(min(opacity, 0.01)) and zeroes the
opacity Adam moments.

Differences from the JAX module, which is functional and jitted: state
tensors live on the trainer's `device`; `train_step` updates the
parameters and Adam moments of the state it is given IN PLACE and returns
a state that shares them; `step`, the Adam count and the active SH degree
are host integers (the density-control schedule reads them, so keeping
them on the device would only add syncs); the split noise comes from the
state's `torch.Generator` instead of a JAX key. Host syncs per step: the
binning `nonzero` and sort sizes; per densify pass: the `nonzero` of the
free slots.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from humangaussian_torch import resolve_device
from humangaussian_torch.core.camera import Camera, camera_from_c2w
from humangaussian_torch.core.scene import (
    GaussianScene,
    inverse_sigmoid,
    scene_from_points,
)
from humangaussian_torch.densify import (
    DensifyState,
    densify_and_prune,
    init_densify_state,
    update_stats,
)
from humangaussian_torch.losses import photometric_loss, psnr, ssim
from humangaussian_torch.ops.knn import mean_3nn_sq_dist_host
from humangaussian_torch.ops.projection import RasterizeConfig
from humangaussian_torch.ops.rasterize_tiled import rasterize_tiled
from humangaussian_torch.train.optim import (
    AdamState,
    GaussianOptimConfig,
    adam_init,
    adam_step,
)


@dataclasses.dataclass(frozen=True)
class PhotoTrainConfig:
    """Upstream's OptimizationParams defaults."""

    capacity: int = 1 << 19
    sh_degree: int = 3
    iterations: int = 30_000
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    size_threshold: float = 20.0
    white_background: bool = False
    tile_capacity: int = 4096
    oneup_sh_interval: int = 1000


class PhotoTrainState(NamedTuple):
    scene: GaussianScene
    adam: AdamState
    densify: DensifyState
    step: int
    generator: torch.Generator  # draws the split noise
    active_sh_degree: int


class PhotoTrainer:
    def __init__(
        self,
        cfg: PhotoTrainConfig,
        extent: float,
        optim_cfg: GaussianOptimConfig | None = None,
        raster_cfg: RasterizeConfig = RasterizeConfig(),
        device="cuda",
    ):
        self.cfg = cfg
        self.extent = float(extent)
        self.optim_cfg = optim_cfg or GaussianOptimConfig(
            spatial_lr_scale=float(extent)
        )
        self.raster_cfg = raster_cfg
        self.device = resolve_device(device)
        self.background = torch.full(
            (3,), 1.0 if cfg.white_background else 0.0,
            dtype=torch.float32, device=self.device)

    def init_state(self, seed: int, points: np.ndarray,
                   colors: np.ndarray) -> PhotoTrainState:
        dev = self.device
        scene = scene_from_points(
            torch.from_numpy(np.asarray(points, np.float32)).to(dev),
            torch.from_numpy(np.asarray(colors, np.float32)).to(dev),
            capacity=self.cfg.capacity,
            sh_degree=self.cfg.sh_degree,
            mean_sq_dist=mean_3nn_sq_dist_host(points),
        )
        return PhotoTrainState(
            scene=scene,
            adam=adam_init(scene.params()),
            densify=init_densify_state(self.cfg.capacity, dev),
            step=0,
            generator=torch.Generator(device=dev).manual_seed(int(seed)),
            active_sh_degree=0,
        )

    def camera_for(self, posed) -> Camera:
        """The camera of a PosedImage, on the trainer's device."""
        c2w = torch.from_numpy(np.asarray(posed.c2w, np.float32))
        return camera_from_c2w(c2w.to(self.device), float(posed.fovy),
                               *posed.image.shape[:2])

    def render(self, scene: GaussianScene, camera: Camera,
               active_sh_degree=None, background=None):
        # The training step renders at the max SH degree with the higher
        # bands still zero-initialized, which is numerically identical to
        # upstream's progressive activation once bands start at 0.
        return rasterize_tiled(
            scene.means, scene.scales, scene.quats, scene.features,
            scene.opacities, scene.alive, camera,
            self.background if background is None else background,
            scene.max_sh_degree if active_sh_degree is None
            else active_sh_degree,
            self.raster_cfg, tile_capacity=self.cfg.tile_capacity,
        )

    def loss_and_grads(self, scene: GaussianScene, camera: Camera, gt):
        """Render with the `means2d_offset` tap and differentiate the
        photometric loss: (loss, radii, parameter grads, means2d grad)."""
        cfg = self.cfg
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in scene.params().items()}
        offset = torch.zeros((cfg.capacity, 2), dtype=torch.float32,
                             device=self.device, requires_grad=True)
        live = scene.replace_params(leaves)
        out = rasterize_tiled(
            live.means, live.scales, live.quats, live.features,
            live.opacities, live.alive, camera, self.background,
            live.max_sh_degree, self.raster_cfg,
            means2d_offset=offset, tile_capacity=cfg.tile_capacity,
        )
        loss = photometric_loss(out["image"], gt, cfg.lambda_dssim)
        grads = torch.autograd.grad(loss, [*leaves.values(), offset])
        return (loss.detach(), out["radii"], dict(zip(leaves, grads[:-1])),
                grads[-1])

    def train_step(self, state: PhotoTrainState, posed) -> tuple:
        gt = torch.from_numpy(np.asarray(posed.image, np.float32))
        loss, radii, param_grads, means2d_grad = self.loss_and_grads(
            state.scene, self.camera_for(posed), gt.to(self.device))
        densify = update_stats(state.densify, means2d_grad, radii, radii > 0)
        lrs = self.optim_cfg.group_lrs(state.step)
        new_params, adam = adam_step(state.scene.params(), param_grads,
                                     state.adam, lrs, self.optim_cfg)
        return (
            state._replace(
                scene=state.scene.replace_params(new_params),
                adam=adam,
                densify=densify,
                step=state.step + 1,
            ),
            {"loss": loss, "n_alive": state.scene.alive.sum()},
        )

    # ---- density control schedule --------------------------------------
    def densify_step(self, state: PhotoTrainState, use_size_threshold: bool,
                     noise: torch.Tensor | None = None):
        cfg = self.cfg
        moments = {"mu": state.adam.mu, "nu": state.adam.nu}
        scene, moments, ds, info = densify_and_prune(
            state.scene, moments, state.densify, state.generator,
            max_grad=cfg.densify_grad_threshold,
            min_opacity=cfg.min_opacity,
            extent=self.extent,
            max_screen_size=cfg.size_threshold if use_size_threshold
            else None,
            noise=noise,
        )
        adam = AdamState(mu=moments["mu"], nu=moments["nu"],
                         count=state.adam.count)
        return state._replace(scene=scene, adam=adam, densify=ds), info

    @torch.no_grad()
    def reset_opacity(self, state: PhotoTrainState) -> PhotoTrainState:
        """opacity <- logit(min(opacity, 0.01)), opacity moments zeroed."""
        scene = state.scene
        new_logits = inverse_sigmoid(
            torch.clamp_max(torch.sigmoid(scene.opacity_logits), 0.01))
        new_logits = torch.where(scene.alive[:, None], new_logits, -10.0)
        mu = dict(state.adam.mu)
        nu = dict(state.adam.nu)
        mu["opacity_logits"] = torch.zeros_like(mu["opacity_logits"])
        nu["opacity_logits"] = torch.zeros_like(nu["opacity_logits"])
        return state._replace(
            scene=scene._replace(opacity_logits=new_logits),
            adam=AdamState(mu=mu, nu=nu, count=state.adam.count),
        )

    def maybe_density_control(self, state: PhotoTrainState):
        step = state.step
        cfg = self.cfg
        info = None
        if step < cfg.densify_until_iter:
            if (
                step > cfg.densify_from_iter
                and step % cfg.densification_interval == 0
            ):
                use_st = step > cfg.opacity_reset_interval
                state, info = self.densify_step(state, use_st)
            if step % cfg.opacity_reset_interval == 0 or (
                cfg.white_background and step == cfg.densify_from_iter
            ):
                state = self.reset_opacity(state)
        if step % cfg.oneup_sh_interval == 0:
            state = state._replace(
                active_sh_degree=min(state.active_sh_degree + 1,
                                     cfg.sh_degree))
        return state, info

    # ---- eval ------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, scene: GaussianScene, posed_images: list) -> dict:
        """PSNR / SSIM over a split."""
        psnrs, ssims = [], []
        for p in posed_images:
            out = self.render(scene, self.camera_for(p))
            gt = torch.from_numpy(np.asarray(p.image, np.float32)).to(
                self.device)
            psnrs.append(float(psnr(out["image"], gt)))
            ssims.append(float(ssim(out["image"], gt)))
        return {
            "psnr": float(np.mean(psnrs)),
            "ssim": float(np.mean(ssims)),
        }


def train_photo(
    trainer: PhotoTrainer,
    state: PhotoTrainState,
    dataset,
    iterations: int | None = None,
    rng: np.random.Generator | None = None,
    log_every: int = 100,
    log_fn=print,
):
    """Host loop: random camera per step + density-control schedule."""
    rng = rng or np.random.default_rng(0)
    iterations = iterations or trainer.cfg.iterations
    for _ in range(state.step, iterations):
        posed = dataset.train[int(rng.integers(len(dataset.train)))]
        state, metrics = trainer.train_step(state, posed)
        state, _ = trainer.maybe_density_control(state)
        if state.step % log_every == 0:
            log_fn(
                f"photo step {state.step}: loss={float(metrics['loss']):.4f} "
                f"alive={int(metrics['n_alive'])}"
            )
    return state
