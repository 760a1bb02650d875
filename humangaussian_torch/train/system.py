"""GaussianDreamer training system: the text-to-avatar SDS step.

Port of humangaussian_tpu/train/system.py. One `train_step`:

  sample 8 cameras, draw their pose images, anneal timesteps, pick text
  -> batched tiled render with the means2d tap (K1; K2 in the backward)
  -> the guidance: dual-branch ANPG (VAE encodes, UNet, reparameterized
     loss), DeepFloyd IF (`system.guidance.type: deep-floyd`), which is
     handed the cameras' elevation, azimuth and distance for Perp-Neg, or
     SDXL (`stable-diffusion-xl`), which is also handed the pooled text
     rows of the step's views (`StepInputs.pooled`)
  -> sparsity (and opaque) losses -> gradients of the Gaussian parameters
     and of the means2d tap in one `torch.autograd.grad`
  -> densify statistics -> per-group Adam.

Gradient accumulation over the camera batch falls out of one means2d
offset tensor shared by the batch's cameras: its gradient is the sum over
the batch. Densify / prune runs between steps on the host step's schedule
(clone + split from 300 to 2100 every 300; prune-only from 2400 to 3300
every 300).

Reference quirks kept: "opacity" is depth over the batch's maximum depth
(a stop-gradient constant, + 1e-5); the guidance's depth is min-max
normalized per image and repeated to 3 channels; the timestep range
anneals to [0.02, 0.55] after `half_scheduler_max_step`; the losses are
the sparsity term sqrt(o^2 + 0.01) and the self-BCE opaque term.

Differences from the JAX module, which is one jitted function of a PRNG
key: `TrainState` holds a host `int` step and a `torch.Generator` on the
device, which draws the cameras, the timesteps, the guidance noise and the
split noise; `train_step` updates the parameters and Adam moments in place
(`train/optim.py`); `train_step(state, inputs)` takes injected cameras,
pose images, text and timesteps (and the guidance's draws), which is how
the parity tests feed the JAX draws. The metrics stay tensors on the
device, so reading them costs the step no host sync; the syncs a step
does make are its `hg.read.*` spans (utils/profiling.py).
`TrainState.tile_cap` is the per-tile pair cap of the training render
(the JAX step's static `tile_cap`): it starts at `cfg.tile_capacity`, the
loop's ladder grows it (train/loop.py) and the checkpoint keeps it, with
the ladder's overflow streak `TrainState.ovf_streak`.
`render_eval` renders the orbit in chunks of the training batch size
(each camera is rendered independently, so the chunks equal one
whole-batch render). There is no counterpart of `remat_render`, nor of the
static-shape arguments `active_cap` and `class_fracs`, which size the JAX
package's static candidate and class buffers: the port's binning is sized
by the live scene; `GaussianDreamerConfig` has no `remat_render` field,
and the launcher's `_take` drops it. `guidance_eval_snapshot` draws from
a generator of its own (seeded from the host step unless one is passed),
so that a snapshot leaves the training stream as it was, as the JAX
method leaves the state's key. `batch_loss`'s shard arguments are
`group` (a torch.distributed process group, for the JAX `axis_name`),
`n_shards` and `global_batch`; the JAX `sample_idx` has no counterpart:
the data-parallel step (dist/parallel.py) draws the whole batch's inputs
and noise and hands each rank its rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from humangaussian_torch import resolve_device
from humangaussian_torch.core.camera import camera_from_c2w
from humangaussian_torch.core.scene import GaussianScene, scene_from_points
from humangaussian_torch.data.cameras import (
    CameraBatch,
    RandomCameraConfig,
    eval_camera_batch,
    sample_camera_batch,
)
from humangaussian_torch.densify import (
    DensifyState,
    densify_and_prune,
    init_densify_state,
    prune_only,
    update_stats,
)
from humangaussian_torch.ops.knn import mean_3nn_sq_dist_host
from humangaussian_torch.ops.projection import RasterizeConfig
from humangaussian_torch.ops.rasterize_tiled import rasterize_tiled_batch
from humangaussian_torch.smplx.pose_image import (
    draw_humansd_pose,
    draw_openpose_pose,
)
from humangaussian_torch.train.optim import (
    AdamState,
    GaussianOptimConfig,
    adam_init,
    adam_step,
)
from humangaussian_torch.utils.profiling import trace_annotation
from humangaussian_torch.utils.schedules import C_schedule


@dataclasses.dataclass(frozen=True)
class GaussianDreamerConfig:
    """The JAX GaussianDreamerConfig without `remat_render`."""

    capacity: int = 1 << 19  # padded Gaussian slot count (init 100k)
    pts_num: int = 100_000
    sh_degree: int = 0
    bg_white: bool = False
    apose: bool = True
    texture_structure_joint: bool = True
    disable_hand_densification: bool = False
    hand_radius: float = 0.05
    cameras_extent: float = 4.0
    # densify / prune schedule
    densify_prune_start_step: int = 300
    densify_prune_end_step: int = 2100
    densify_prune_interval: int = 300
    size_threshold: float = 20.0
    size_threshold_fix_step: int = 1500
    max_grad: float = 0.0002
    prune_only_start_step: int = 2400
    prune_only_end_step: int = 3300
    prune_only_interval: int = 300
    prune_size_threshold: float = 0.008
    min_opacity: float = 0.05
    # timestep annealing and loss weights (C() schedules allowed)
    half_scheduler_max_step: int = 1500
    min_step_percent: float = 0.02
    max_step_percent: float = 0.98
    max_step_percent_annealed: float = 0.55
    lambda_sds: Any = 1.0
    lambda_sparsity: Any = 1.0
    lambda_opaque: Any = 0.0
    grad_clip: Any = (0, 1.5, 2.0, 1000)
    pose_image_size: int = 512
    max_steps: int = 3600
    tile_capacity: int = 4096  # pairs composited per tile at most


class TrainState(NamedTuple):
    scene: GaussianScene
    adam: AdamState
    densify: DensifyState
    step: int  # host step count
    generator: torch.Generator  # on the device: every draw of the step
    tile_cap: int  # pairs composited per tile at most (grown by the loop)
    # logged checks in a row over the loop's overflow threshold, carried
    # across `run_training` calls so that a caller stepping one at a time
    # climbs the tile-capacity ladder as one long call does
    ovf_streak: int = 0


class StepInputs(NamedTuple):
    """What a step samples before it renders. `guidance_draws` (None: the
    guidance draws from the state's generator) holds `latent_eps` (a dict
    rgb / depth / pose), `noise` and `depth_noise`, [B, h, w, 4] each."""

    cameras: CameraBatch
    pose: torch.Tensor  # [B, S, S, 3] pose images
    text: torch.Tensor  # [3B, L, D] [cond | neg | null]
    t: torch.Tensor  # [B] int64 timesteps
    guidance_draws: dict | None = None
    # [3B, P] pooled text rows, [cond | neg | null], for a prior that takes
    # them (SDXL); None for the others
    pooled: torch.Tensor | None = None


class GaussianDreamerSystem:
    """Configuration, skeleton, prior and prompt embeddings; the step,
    density control and evaluation renders."""

    def __init__(
        self,
        cfg: GaussianDreamerConfig,
        skeleton,  # smplx.skeleton.Skeleton, loaded and scaled(-10)
        guidance=None,  # DualBranchGuidance or DeepFloydSystemGuidance
        prompt_embeddings=None,  # guidance.prompt.PromptEmbeddings
        camera_cfg: RandomCameraConfig = RandomCameraConfig(),
        optim_cfg: GaussianOptimConfig = GaussianOptimConfig(),
        raster_cfg: RasterizeConfig = RasterizeConfig(),
        device=None,
    ):
        self.cfg = cfg
        self.skeleton = skeleton
        self.guidance = guidance
        self.prompt_embeddings = prompt_embeddings
        self.camera_cfg = camera_cfg
        self.optim_cfg = optim_cfg
        self.raster_cfg = raster_cfg
        if device is None:
            device = guidance.device if guidance is not None else "cuda"
        self.device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.background = torch.full((3,), 1.0 if cfg.bg_white else 0.0,
                                     **f32)
        self.pose_points = torch.tensor(skeleton.points3d, **f32)
        self.hand_centers = torch.tensor(skeleton.hand_centers, **f32)

    # ---- init ------------------------------------------------------------
    def init_state(self, seed: int = 0) -> TrainState:
        """The SMPL-X surface sample as a padded scene (grey, isotropic
        scales from the 3-NN distances); the generator is seeded with
        `seed`."""
        pts = self.skeleton.sample_smplx_points(self.cfg.pts_num, seed=seed)
        colors = np.full((pts.shape[0], 3), 0.5, np.float32)
        scene = scene_from_points(
            torch.from_numpy(pts).to(self.device),
            torch.from_numpy(colors).to(self.device),
            capacity=self.cfg.capacity,
            sh_degree=self.cfg.sh_degree,
            mean_sq_dist=mean_3nn_sq_dist_host(pts),
        )
        return TrainState(
            scene=scene,
            adam=adam_init(scene.params()),
            densify=init_densify_state(self.cfg.capacity, self.device),
            step=0,
            generator=torch.Generator(device=self.device).manual_seed(
                int(seed)),
            tile_cap=self.cfg.tile_capacity,
        )

    # ---- rendering -------------------------------------------------------
    def render_batch(self, scene: GaussianScene, cameras: CameraBatch,
                     height: int, width: int, background=None,
                     means2d_offset=None, raster_cfg=None,
                     tile_cap=None) -> dict:
        """The camera batch in one render: image [B,H,W,3], depth, alpha,
        radii [B, C], visible, overflow. `tile_cap` (None:
        `cfg.tile_capacity`) caps the pairs composited per tile."""
        cams = camera_from_c2w(cameras.c2w, cameras.fovy, height, width)
        return rasterize_tiled_batch(
            scene.means, scene.scales, scene.quats, scene.features,
            scene.opacities, scene.alive, cams,
            self.background if background is None else background,
            self.cfg.sh_degree,
            self.raster_cfg if raster_cfg is None else raster_cfg,
            means2d_offset=means2d_offset,
            tile_capacity=tile_cap or self.cfg.tile_capacity,
        )

    def pose_images(self, cameras: CameraBatch) -> torch.Tensor:
        """[B, S, S, 3] skeleton images, occluded for back views (|azimuth|
        > 120 degrees)."""
        size = self.cfg.pose_image_size
        draw = (draw_humansd_pose if self.cfg.texture_structure_joint
                else draw_openpose_pose)
        img, _kp = draw(self.pose_points, cameras.mvp_mtx, size, size,
                        cameras.azimuth.abs() > 120.0)
        return img

    # ---- inputs ----------------------------------------------------------
    def timesteps_from_uniform(self, u: torch.Tensor, step: int):
        """[B] int64 t = int(t_lo + u (t_hi + 1 - t_lo)) of unit draws u, the
        range annealed at host `step`; t_hi in float32, as the JAX
        package computes it."""
        cfg = self.cfg
        n_train = self.guidance.schedule.num_train_timesteps
        max_pct = (cfg.max_step_percent_annealed
                   if step > cfg.half_scheduler_max_step
                   else cfg.max_step_percent)
        t_lo = int(n_train * cfg.min_step_percent)
        t_hi = int(np.float32(n_train) * np.float32(max_pct))
        return (t_lo + u * float(t_hi + 1 - t_lo)).to(torch.int64)

    def sample_step_inputs(self, state: TrainState) -> StepInputs:
        """Cameras, pose images, timesteps and text of the step, drawn from
        the state's generator."""
        with trace_annotation("hg.inputs"):
            gen = state.generator
            cameras = sample_camera_batch(gen, state.step, self.camera_cfg,
                                          self.device)
            u = torch.rand(self.camera_cfg.batch_size, generator=gen,
                           device=gen.device, dtype=torch.float32)
            emb = self.prompt_embeddings
            text = emb.get_text_embeddings(
                cameras.elevation, cameras.azimuth, cameras.camera_distances)
            pooled = None if emb.pooled is None else \
                emb.pooled.get_text_embeddings(
                    cameras.elevation, cameras.azimuth,
                    cameras.camera_distances)
            return StepInputs(cameras=cameras,
                              pose=self.pose_images(cameras), text=text,
                              t=self.timesteps_from_uniform(u, state.step),
                              pooled=pooled)

    # ---- loss --------------------------------------------------------------
    def batch_loss(self, params: dict, offset, scene_template, inputs,
                   step: int, generator=None, tile_cap=None, group=None,
                   n_shards: int = 1, global_batch: int | None = None):
        """(loss, aux) of the camera batch, or of one shard of it;
        `params` and `offset` are the differentiated leaves. For a shard
        (dist/parallel.py), `group` makes the depth maximum the whole
        batch's (an all-reduce MAX over the process group), the SDS loss
        is rescaled from the shard's batch to `global_batch`, and the mean
        losses are divided by `n_shards`, so that the sum over the shards
        of the loss and of its gradients is the whole batch's."""
        cfg = self.cfg
        scene = scene_template.replace_params(params)
        out = self.render_batch(scene, inputs.cameras,
                                self.camera_cfg.height, self.camera_cfg.width,
                                means2d_offset=offset, tile_cap=tile_cap)
        images = out["image"]  # [B,H,W,3]
        depths = out["depth"][..., None]  # [B,H,W,1]
        local_b = images.shape[0]
        global_batch = global_batch or local_b

        # "opacity": depth over the batch's maximum (a constant)
        depth_max = depths.max().detach()
        if group is not None:
            torch.distributed.all_reduce(
                depth_max, torch.distributed.ReduceOp.MAX, group=group)
        opacity = depths / (depth_max + 1e-5)
        # the guidance's depth: per-image min-max, 3 channels
        dmin = depths.amin(dim=(1, 2, 3), keepdim=True)
        dmax = depths.amax(dim=(1, 2, 3), keepdim=True)
        depth3 = ((depths - dmin) / (dmax - dmin + 1e-10)).expand(
            -1, -1, -1, 3)

        draws = dict(inputs.guidance_draws or {})
        if inputs.pooled is not None:
            draws["pooled"] = inputs.pooled
        cams = inputs.cameras
        with trace_annotation("hg.guidance"):
            g_out = self.guidance(
                inputs.pose, images, depth3, inputs.text, inputs.t,
                generator, grad_clip_val=C_schedule(cfg.grad_clip, step),
                elevation=cams.elevation, azimuth=cams.azimuth,
                camera_distances=cams.camera_distances, **draws)
        loss_sds = g_out["loss_sds"] * (local_b / global_batch)
        loss = loss_sds * C_schedule(cfg.lambda_sds, step)
        loss_sparsity = torch.sqrt(opacity ** 2 + 0.01).mean() / n_shards
        loss = loss + loss_sparsity * C_schedule(cfg.lambda_sparsity, step)
        oc = opacity.clamp(1e-3, 1.0 - 1e-3)
        loss_opaque = (-(oc * torch.log(oc)
                         + (1 - oc) * torch.log(1 - oc))).mean() / n_shards
        loss = loss + loss_opaque * C_schedule(cfg.lambda_opaque, step)
        aux = {
            "radii": out["radii"].amax(dim=0),  # max over the cameras
            "loss_sds": loss_sds.detach(),
            "loss_sparsity": loss_sparsity.detach(),
            "loss_opaque": loss_opaque.detach(),
            "grad_norm": g_out["grad_norm"],
            "overflow": out["overflow"],
            "overflow_spill": out["overflow_spill"],
        }
        return loss, aux

    def loss_and_grads(self, state: TrainState, inputs: StepInputs,
                       **shard):
        """(loss, aux, parameter grads, means2d grad) of one step; `shard`
        (group, n_shards, global_batch) goes to `batch_loss`."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in state.scene.params().items()}
        offset = torch.zeros((self.cfg.capacity, 2), dtype=torch.float32,
                             device=self.device, requires_grad=True)
        loss, aux = self.batch_loss(leaves, offset, state.scene, inputs,
                                    state.step, state.generator,
                                    state.tile_cap, **shard)
        with trace_annotation("hg.backward"):
            grads = torch.autograd.grad(loss, [*leaves.values(), offset])
        return (loss.detach(), aux, dict(zip(leaves, grads[:-1])),
                grads[-1])

    # ---- the train step ------------------------------------------------------
    def train_step(self, state: TrainState,
                   inputs: StepInputs | None = None):
        """One SDS step; `inputs` (None: sampled from the state's generator)
        may be injected. Updates the scene's parameters and the Adam
        moments in place. Returns (state, metrics); the metrics are
        tensors on the device."""
        if inputs is None:
            inputs = self.sample_step_inputs(state)
        return self.apply_grads(state, *self.loss_and_grads(state, inputs))

    def apply_grads(self, state: TrainState, loss, aux, param_grads,
                    means2d_grad):
        """The step after the gradients: the densify statistics, Adam, the
        metrics. Returns (state, metrics)."""
        with trace_annotation("hg.optim"):
            cfg = self.cfg
            scene = state.scene
            visible = aux["radii"] > 0
            if cfg.disable_hand_densification:
                dist = torch.linalg.norm(
                    scene.means[:, None, :] - self.hand_centers[None], dim=-1)
                visible = visible & ~(dist.amin(dim=-1) < cfg.hand_radius)
            densify = update_stats(state.densify, means2d_grad,
                                   aux["radii"], visible)
            new_params, adam = adam_step(
                scene.params(), param_grads, state.adam,
                self.optim_cfg.group_lrs(state.step), self.optim_cfg)
            scene = scene.replace_params(new_params)
            metrics = {
                "loss": loss,
                "loss_sds": aux["loss_sds"],
                "loss_sparsity": aux["loss_sparsity"],
                "loss_opaque": aux["loss_opaque"],
                "grad_norm": aux["grad_norm"],
                "overflow": aux["overflow"],
                "overflow_spill": aux["overflow_spill"],
                "n_alive": scene.alive.sum(),
            }
            return (state._replace(scene=scene, adam=adam, densify=densify,
                                   step=state.step + 1), metrics)

    # ---- density control (host schedule) --------------------------------
    def should_densify(self, step: int) -> bool:
        cfg = self.cfg
        return (
            cfg.densify_prune_start_step < step < cfg.densify_prune_end_step
            and step % cfg.densify_prune_interval == 0
        )

    def should_prune_only(self, step: int) -> bool:
        cfg = self.cfg
        return (
            cfg.prune_only_start_step < step < cfg.prune_only_end_step
            and step % cfg.prune_only_interval == 0
        )

    def densify_step(self, state: TrainState, use_size_threshold: bool,
                     noise: torch.Tensor | None = None):
        """Clone + split + prune; the split noise comes from the state's
        generator unless `noise` is given."""
        cfg = self.cfg
        moments = {"mu": state.adam.mu, "nu": state.adam.nu}
        scene, moments, ds, info = densify_and_prune(
            state.scene, moments, state.densify, state.generator,
            max_grad=cfg.max_grad,
            min_opacity=cfg.min_opacity,
            extent=cfg.cameras_extent,
            max_screen_size=cfg.size_threshold if use_size_threshold
            else None,
            noise=noise,
        )
        adam = AdamState(mu=moments["mu"], nu=moments["nu"],
                         count=state.adam.count)
        return state._replace(scene=scene, adam=adam, densify=ds), info

    def prune_only_step(self, state: TrainState):
        moments = {"mu": state.adam.mu, "nu": state.adam.nu}
        scene, moments, ds, info = prune_only(
            state.scene, moments, state.densify,
            min_opacity=0.005, size_thresh=self.cfg.prune_size_threshold,
        )
        adam = AdamState(mu=moments["mu"], nu=moments["nu"],
                         count=state.adam.count)
        return state._replace(scene=scene, adam=adam, densify=ds), info

    def maybe_densify(self, state: TrainState):
        """The density-control pass due at the host step, if any: (state,
        info or None). No device read decides it."""
        step = state.step
        if self.should_densify(step):
            with trace_annotation("hg.densify"):
                return self.densify_step(
                    state, step > self.cfg.size_threshold_fix_step)
        if self.should_prune_only(step):
            with trace_annotation("hg.densify"):
                return self.prune_only_step(state)
        return state, None

    @torch.no_grad()
    def guidance_eval_snapshot(self, state: TrainState, t_frac: float = 0.5,
                               num_steps: int = 20, generator=None,
                               cameras: CameraBatch | None = None,
                               latent_eps=None, noise=None) -> dict:
        """The training-time guidance visualization: render a camera
        batch, noise its latents to t = t_frac T, and return the 1-step and
        the DDIM-denoised images of both branches (`guidance_eval`) with
        "render" and "pose". The cameras, the encodes' draw (`latent_eps`,
        one [B, h, w, 4] draw shared by the rgb, depth and pose encodes, as
        the reference shares its key) and `noise` (shared by both branches)
        come from `generator` unless passed; without one, a generator
        seeded from the host step is made."""
        from humangaussian_torch.guidance.dual_branch import (
            DEPTH_MEAN,
            DEPTH_STD,
            RGB_MEAN,
            RGB_STD,
            WHOLE_MEAN,
            WHOLE_STD,
            resize_bilinear,
        )

        g = self.guidance
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                int(state.step))
        if cameras is None:
            cameras = sample_camera_batch(generator, state.step,
                                          self.camera_cfg, self.device)
        pose = self.pose_images(cameras)
        out = self.render_batch(state.scene, cameras, self.camera_cfg.height,
                                self.camera_cfg.width)
        b = out["image"].shape[0]
        s = g.cfg.image_size
        depths = out["depth"][..., None]
        dmin = depths.amin(dim=(1, 2, 3), keepdim=True)
        dmax = depths.amax(dim=(1, 2, 3), keepdim=True)
        depth3 = ((depths - dmin) / (dmax - dmin + 1e-10)).expand(
            -1, -1, -1, 3)

        if latent_eps is None:
            down = 2 ** (len(g.vae.cfg.block_out_channels) - 1)
            latent_eps = torch.randn(
                (b, s // down, s // down, g.vae.cfg.latent_channels),
                generator=generator, device=self.device)

        def encode(img):
            return g.encode_images(resize_bilinear(img, s), eps=latent_eps)

        latents = encode(out["image"])
        dep_lat = (encode(depth3) - DEPTH_MEAN) / DEPTH_STD * RGB_STD \
            + RGB_MEAN
        whole = (encode(pose) - WHOLE_MEAN) / WHOLE_STD * RGB_STD + RGB_MEAN
        t = torch.full((b,), int(g.schedule.num_train_timesteps * t_frac),
                       dtype=torch.int64, device=self.device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                device=self.device)
        text2 = self.prompt_embeddings.get_text_embeddings(
            cameras.elevation, cameras.azimuth,
            cameras.camera_distances)[: 2 * b]
        strips = g.guidance_eval(
            g.schedule.add_noise(latents, noise, t),
            g.schedule.add_noise(dep_lat, noise, t), whole, t, text2,
            num_steps=num_steps)
        strips["render"] = out["image"]
        strips["pose"] = pose
        return strips

    # ---- eval ----------------------------------------------------------------
    @torch.no_grad()
    def render_eval(self, scene: GaussianScene, split: str = "val",
                    background=None):
        """The val or test orbit, rendered with the full 3x3 tile rect
        whatever the training rect, in chunks of `batch_size` cameras.
        Returns (outputs with a leading view axis, cameras)."""
        cc = self.camera_cfg
        cams = eval_camera_batch(cc, split, self.device)
        rcfg = self.raster_cfg
        if rcfg.max_tiles_per_gaussian < 9:
            rcfg = dataclasses.replace(rcfg, max_tiles_per_gaussian=9)
        chunk = max(int(cc.batch_size), 1)
        outs = []
        for i in range(0, cams.c2w.shape[0], chunk):
            part = cams._replace(c2w=cams.c2w[i:i + chunk],
                                 fovy=cams.fovy[i:i + chunk])
            outs.append(self.render_batch(scene, part, cc.eval_height,
                                          cc.eval_width, background,
                                          raster_cfg=rcfg))
        out = {k: torch.cat([o[k] for o in outs])
               for k in ("image", "depth", "alpha", "radii", "visible")}
        out["overflow"] = sum(o["overflow"] for o in outs)
        return out, cams
