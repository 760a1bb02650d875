"""DreamFusion-style text-to-NeRF system (threestudio's stock path).

Port of humangaussian_tpu/nerf/system.py: a random-camera batch
(data/cameras.py, the avatar system's sampler) -> the NeRF volume renderer
-> the standalone SD guidance (SDS) -> Adam. The loss is lambda_sds
loss_sds + lambda_sparsity mean(sqrt(opacity^2 + 0.01)) (+ lambda_opaque
times the BCE of the clamped opacity, + lambda_orient times the JAX
module's proxy on the composited normal, mean(relu(|n|^2 - 1))). The
renders are camera_cfg.height square (JAX uses the height for both
sides); timesteps are uniform in [int(0.02 T), int(0.98 T) - 1].

Differences from the JAX module, which is one jitted function of a PRNG
key:

- The geometry, material and background are `nn.Module`s on the system's
  device (`self.renderer.field`); `init_state(seed)` redraws their
  parameters from a CPU generator seeded with `seed` and builds the Adam
  and the step's `torch.Generator` on the device.
- The optimizer is `torch.optim.Adam` (beta 0.9 / 0.999, eps 1e-8 outside
  the square root, no eps_root), which is optax.adam's update; its bias
  corrections are float64 where optax's are float32, a difference of
  2.4e-7 relative at step 1 (tests/test_torch_nerf_system.py holds the
  update against optax's on one gradient tree). Every parameter gets a
  gradient each step (zeros where unused), so that, as in optax, every
  moment decays.
- `train_step(state, inputs)` takes injected draws (`DFStepInputs`:
  cameras, timesteps, the render's jitter and importance uniforms, the
  encode's eps and the gradient's noise), which is how the parity tests
  feed the JAX draws; without them it draws cameras, timesteps and jitter
  from the state's generator, then the guidance its eps and noise.
- The batch's cameras are rendered in one call (the JAX module vmaps the
  per-camera render).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from humangaussian_torch import resolve_device
from humangaussian_torch.data.cameras import (
    CameraBatch,
    RandomCameraConfig,
    sample_camera_batch,
)
from humangaussian_torch.guidance.dual_branch import sample_timesteps
from humangaussian_torch.nerf.background import (
    NeuralEnvironmentMapBackground,
    SolidColorBackground,
)
from humangaussian_torch.nerf.geometry import (
    ImplicitVolume,
    ImplicitVolumeConfig,
)
from humangaussian_torch.nerf.material import (
    DiffuseWithPointLightMaterial,
    NoMaterial,
)
from humangaussian_torch.nerf.renderer import NerfVolumeRenderer, \
    RendererConfig


@dataclasses.dataclass(frozen=True)
class DreamFusionConfig:
    geometry: ImplicitVolumeConfig = ImplicitVolumeConfig()
    renderer: RendererConfig = RendererConfig()
    material: str = "diffuse-with-point-light-material"
    background: str = "neural-environment-map-background"
    lambda_sds: float = 1.0
    lambda_sparsity: float = 1.0
    lambda_opaque: float = 0.0
    lambda_orient: float = 0.0
    learning_rate: float = 0.01
    render_normals: bool = False
    min_step_percent: float = 0.02
    max_step_percent: float = 0.98
    max_steps: int = 10000


class DFTrainState(NamedTuple):
    optimizer: torch.optim.Adam  # over renderer.field's parameters
    step: int  # host step count
    generator: torch.Generator  # on the device: every draw of a step


class DFStepInputs(NamedTuple):
    """The draws of one step. `jitter` [B, H*W, S] and `fine_u` [B, H*W,
    n] are unit uniforms (None: stratum centres); `latent_eps` and `noise`
    [B, h, w, 4] (None: drawn by the guidance)."""

    cameras: CameraBatch
    t: torch.Tensor  # [B] int64
    jitter: torch.Tensor | None = None
    fine_u: torch.Tensor | None = None
    latent_eps: torch.Tensor | None = None
    noise: torch.Tensor | None = None


class DreamFusionSystem:
    """Configuration, renderer modules, prior and prompt embeddings; the
    step and the evaluation render."""

    def __init__(self, cfg: DreamFusionConfig, guidance, prompt_embeddings,
                 camera_cfg: RandomCameraConfig = RandomCameraConfig(),
                 device="cuda"):
        self.cfg = cfg
        self.guidance = guidance
        self.prompt_embeddings = prompt_embeddings
        self.camera_cfg = camera_cfg
        self.device = dev = resolve_device(device)
        geometry = ImplicitVolume(cfg.geometry, dev)
        material = (NoMaterial() if cfg.material == "no-material"
                    else DiffuseWithPointLightMaterial())
        background = (SolidColorBackground(device=dev)
                      if cfg.background == "solid-color-background"
                      else NeuralEnvironmentMapBackground(device=dev))
        self.renderer = NerfVolumeRenderer(geometry, material, background,
                                           cfg.renderer)
        self.params = dict(self.renderer.field.named_parameters())

    def init_state(self, seed: int = 0) -> DFTrainState:
        self.renderer.reset_parameters(torch.Generator().manual_seed(seed))
        optimizer = torch.optim.Adam(
            self.params.values(), lr=self.cfg.learning_rate,
            betas=(0.9, 0.999), eps=1e-8)
        return DFTrainState(
            optimizer=optimizer, step=0,
            generator=torch.Generator(device=self.device).manual_seed(seed))

    @property
    def timestep_range(self) -> tuple[int, int]:
        n_t = self.guidance.schedule.num_train_timesteps
        return (int(self.cfg.min_step_percent * n_t),
                int(self.cfg.max_step_percent * n_t) - 1)

    def sample_step_inputs(self, state: DFTrainState) -> DFStepInputs:
        """Cameras, timesteps and the render's uniforms, drawn from the
        state's generator."""
        gen = state.generator
        cams = sample_camera_batch(gen, state.step, self.camera_cfg,
                                   self.device)
        b = cams.c2w.shape[0]
        t = sample_timesteps(b, *self.timestep_range, gen, self.device)
        rc = self.cfg.renderer
        rays = int(self.camera_cfg.height) ** 2
        jitter = fine_u = None
        if rc.randomized:
            jitter = torch.rand((b, rays, rc.num_samples_per_ray),
                                generator=gen, device=self.device)
            if rc.num_importance_samples > 0:
                fine_u = torch.rand((b, rays, rc.num_importance_samples),
                                    generator=gen, device=self.device)
        return DFStepInputs(cams, t, jitter, fine_u)

    def render_batch(self, inputs: DFStepInputs) -> dict:
        """The training render of the batch's cameras, [B, H, H, ...]."""
        cams = inputs.cameras
        h = int(self.camera_cfg.height)
        return self.renderer.render_image(
            cams.c2w, cams.fovy, h, h, inputs.jitter, inputs.fine_u,
            camera_position=cams.c2w[:, :3, 3], shading="albedo",
            output_normal=self.cfg.render_normals)

    def loss(self, inputs: DFStepInputs, generator=None):
        """(loss, metrics) of one step's draws; `generator` feeds the
        guidance's draws that `inputs` leaves out."""
        cfg = self.cfg
        cams = inputs.cameras
        out = self.render_batch(inputs)
        g_out = self.guidance(
            out["comp_rgb"], self.prompt_embeddings, cams.elevation,
            cams.azimuth, inputs.t, generator, cams.camera_distances,
            latent_eps=inputs.latent_eps, noise=inputs.noise)
        opacity = out["opacity"]
        loss_sparsity = torch.mean(torch.sqrt(opacity**2 + 0.01))
        loss = cfg.lambda_sds * g_out["loss_sds"] \
            + cfg.lambda_sparsity * loss_sparsity
        if cfg.lambda_opaque:
            o = torch.clamp(opacity, 1e-3, 1 - 1e-3)
            loss = loss + cfg.lambda_opaque * -torch.mean(
                o * torch.log(o) + (1 - o) * torch.log(1 - o))
        if cfg.lambda_orient and "comp_normal" in out:
            # the JAX module's proxy at the composited level
            n = out["comp_normal"]
            loss = loss + cfg.lambda_orient * torch.mean(
                torch.clamp_min(torch.sum(n * n, -1) - 1.0, 0.0))
        return loss, {"loss_sds": g_out["loss_sds"].detach(),
                      "loss_sparsity": loss_sparsity.detach()}

    def loss_and_grads(self, inputs: DFStepInputs, generator=None):
        """(loss, metrics, grads): grads keyed as `self.params`, zeros for
        a parameter the loss does not reach."""
        loss, metrics = self.loss(inputs, generator)
        grads = torch.autograd.grad(loss, list(self.params.values()),
                                    materialize_grads=True)
        return loss.detach(), metrics, dict(zip(self.params, grads))

    def train_step(self, state: DFTrainState,
                   inputs: DFStepInputs | None = None):
        """One SDS step with Adam, in place on the field's parameters (whose
        `.grad` holds the step's gradients until the next step). Returns
        (state, metrics); the metrics are tensors on the device."""
        if inputs is None:
            inputs = self.sample_step_inputs(state)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics, grads = self.loss_and_grads(inputs, state.generator)
        self.apply_grads(state, grads)
        metrics["loss"] = loss
        return state._replace(step=state.step + 1), metrics

    def apply_grads(self, state: DFTrainState, grads: dict):
        """Adam on `grads` (keyed as `self.params`)."""
        for name, p in self.params.items():
            p.grad = grads[name]
        state.optimizer.step()

    @torch.no_grad()
    def render_eval(self, state: DFTrainState, c2w, fovy, height: int,
                    width: int) -> dict:
        """A render without jitter, as JAX's `render_eval` (no key)."""
        return self.renderer.render_image(c2w, fovy, height, width)
