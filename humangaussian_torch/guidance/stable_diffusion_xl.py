"""Stable Diffusion XL base 1.0 guidance for the avatar trainer.

The prior is `SingleUNet(SDXL_BASE_CONFIG)` (guidance/unet.py: 2.6B
parameters, transformer stacks 1 / 2 / 10 deep, cross-attention over the
77 x 2048 rows of SDXL's two CLIP encoders, the text-time embedding of
the pooled 1280-wide row and the 6 size ids) and the sdxl-vae
(`SDXL_VAE_CONFIG`, scale 0.13025), on SDXL's schedule (scaled-linear
0.00085 -> 0.012 over 1000 steps, epsilon prediction: `sd_eps_schedule`).

One call (`SDXLSystemGuidance.__call__`, the dual-branch guidance's
signature; `system.guidance.type: stable-diffusion-xl`):

  1. the render, mapped to [-1, 1], is VAE-encoded at `image_size` (1024^2
     for the avatar's renders: no resize) under `torch.utils.checkpoint`
     when `remat_encode` is on, so the backward recomputes the encoder
     instead of keeping its activations; the VAE's mid-block attention
     over 16,384 tokens runs in query chunks (guidance/vae.py);
  2. the UNet scores the noisy latents with the size ids (original H x W,
     crop top-left, target H x W) and the pooled rows of the step's views
     beside the token rows, on the 3-way [cond | neg | null] batch, and
     the dual-branch guidance's ANPG rule (`anpg_score`) makes the score
     (the system's `mode`, which must be `anpg`);
  3. w(t) = 1 - alpha_bar, the per-pixel norm clip, the C() clamp and the
     reparameterized loss 0.5 ||latents - sg(latents - grad)||^2 / B
     (`sds_result`).

The pose image and the depth are taken and ignored: SDXL is a single-
branch prior (the reference's `texture_structure_joint: false`). The
draws are the encode's `latent_eps`, then the gradient's `noise`, from the
generator in that order or injected. The time ids are made on the device
once, so a step copies no host value for them. Spans: `hg.guidance.encode`
(the encode and, inside the checkpointed function, its recompute) and
`hg.guidance.unet` (the UNet pass and the gradient).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from humangaussian_torch.guidance.dual_branch import (
    _repeat,
    anpg_score,
    clip_pixel_norm,
)
from humangaussian_torch.guidance.schedule import DiffusionSchedule
from humangaussian_torch.guidance.stable_diffusion import sds_result
from humangaussian_torch.guidance.unet import UNetConfig
from humangaussian_torch.guidance.vae import sample_latent
from humangaussian_torch.ops.resize import resize_bilinear
from humangaussian_torch.utils.profiling import trace_annotation


# SDXL's shape at test widths: three levels, no attention at the first,
# stacks 1 and 2 deep, the text-time embedding of 24-wide pooled rows
TINY_SDXL_CONFIG = UNetConfig(
    in_channels=4,
    out_channels=4,
    block_out_channels=(32, 64, 64),
    layers_per_block=1,
    cross_attention_dim=48,
    attn_heads=(2, 2, 2),
    down_block_has_attn=(False, True, True),
    transformer_layers_per_block=(1, 1, 2),
    pooled_text_dim=24,
    addition_time_embed_dim=8,
    norm_num_groups=8,
    dtype=torch.float32,
)


@dataclasses.dataclass(frozen=True)
class SDXLGuidanceConfig:
    guidance_scale: float = 7.5
    weighting_strategy: str = "sds"
    mode: str = "anpg"  # the only mode
    anpg_boundary_t: int = 200
    grad_clip_pixel: bool = True
    grad_clip_threshold: float = 1.0
    original_size: int = 1024
    target_size: int = 1024
    image_size: int = 1024
    remat_encode: bool = True


class SDXLGuidance:
    """The frozen SDXL prior (UNet, VAE, schedule) and its SDS math."""

    def __init__(self, unet, vae, schedule: DiffusionSchedule,
                 cfg: SDXLGuidanceConfig = SDXLGuidanceConfig()):
        if cfg.mode != "anpg":
            raise ValueError(f"the SDXL guidance has the 'anpg' mode only, "
                             f"not {cfg.mode!r}")
        self.unet = unet.eval().requires_grad_(False)
        self.vae = vae.eval().requires_grad_(False)
        self.schedule = schedule
        self.cfg = cfg
        o, s = cfg.original_size, cfg.target_size
        self.time_ids = torch.tensor([[o, o, 0, 0, s, s]],
                                     dtype=torch.float32, device=self.device)

    @property
    def device(self) -> torch.device:
        return self.schedule.alphas_cumprod.device

    def latent_shape(self, b: int) -> tuple:
        down = 2 ** (len(self.vae.cfg.block_out_channels) - 1)
        size = self.cfg.image_size // down
        return (b, size, size, self.vae.cfg.latent_channels)

    # ---- VAE transport ---------------------------------------------------
    def encode_images(self, imgs, generator=None, eps=None):
        """[B, H, W, 3] in [0, 1] -> sampled latents [B, h, w, 4] times the
        VAE's scaling factor; `eps` replaces the generator's draw."""
        mean, logvar = self.vae.encode(imgs * 2.0 - 1.0)
        return (sample_latent(mean, logvar, generator, eps)
                * self.vae.cfg.scaling_factor)

    def encode(self, rgb, eps):
        """The render's latents, differentiable: resized only when its size
        is not `image_size`, recomputed in the backward under
        `remat_encode`."""
        def fn(x):
            with trace_annotation("hg.guidance.encode"):
                return self.encode_images(x, eps=eps)

        with trace_annotation("hg.guidance.encode"):
            x = (rgb if rgb.shape[1:3] == (self.cfg.image_size,) * 2
                 else resize_bilinear(rgb, self.cfg.image_size))
        if self.cfg.remat_encode and x.requires_grad:
            return checkpoint(fn, x, use_reentrant=False)
        return fn(x)

    # ---- UNet scoring ----------------------------------------------------
    def _unet_eps(self, lat_in, t, text, pooled):
        with torch.no_grad():
            return self.unet(lat_in, t, text, text_embeds=pooled,
                             time_ids=self.time_ids.expand(
                                 lat_in.shape[0], -1))

    def compute_grad(self, latents, t, text, pooled, noise):
        """The ANPG gradient [B, h, w, 4] of `latents`; text [3B, L, D] and
        pooled [3B, P] in [cond | neg | null] order."""
        c = self.cfg
        b = latents.shape[0]
        noisy = self.schedule.add_noise(latents, noise, t)
        pred = self._unet_eps(_repeat(noisy, 3), t.repeat(3), text, pooled)
        score = anpg_score(pred, t, c.guidance_scale, c.anpg_boundary_t)
        w = self.schedule.sds_weight(t, c.weighting_strategy)
        grad = w.reshape(b, 1, 1, 1) * score
        if c.grad_clip_pixel:
            grad = clip_pixel_norm(grad, c.grad_clip_threshold)
        return grad


class SDXLSystemGuidance:
    """SDXLGuidance behind the dual-branch guidance's call, for the avatar
    trainer (train/system.py), which hands it the pooled rows of the
    step's views as `pooled`."""

    def __init__(self, xl: SDXLGuidance):
        self.xl = xl

    @property
    def schedule(self) -> DiffusionSchedule:
        return self.xl.schedule

    @property
    def device(self) -> torch.device:
        return self.xl.device

    def step_draws(self, b: int, generator=None) -> dict:
        """The draws `__call__` makes for a batch of `b`, in its order, as
        its keyword arguments (dist/parallel.py)."""
        shape = self.xl.latent_shape(b)
        return {k: torch.randn(shape, generator=generator,
                               device=self.device)
                for k in ("latent_eps", "noise")}

    def __call__(self, pose_image, rgb, depth, text_embeddings, t,
                 generator=None, grad_clip_val=None, pooled=None,
                 latent_eps=None, noise=None, elevation=None, azimuth=None,
                 camera_distances=None):
        """rgb [B, H, W, 3] in [0, 1] (differentiable); text_embeddings
        [3B, L, D] and pooled [3B, P] in [cond | neg | null] order; t [B]
        int. pose_image, depth and the angles are ignored. Returns
        {loss_sds, grad_norm, grad}."""
        if pooled is None:
            raise ValueError("the SDXL guidance needs the pooled text rows "
                             "(PromptEmbeddings.pooled)")
        xl = self.xl
        b = rgb.shape[0]
        shape = xl.latent_shape(b)
        if latent_eps is None:
            latent_eps = torch.randn(shape, generator=generator,
                                     device=self.device)
        if noise is None:
            noise = torch.randn(shape, generator=generator,
                                device=self.device)
        latents = xl.encode(rgb, latent_eps)
        with torch.no_grad(), trace_annotation("hg.guidance.unet"):
            grad = xl.compute_grad(latents.detach(), t, text_embeddings,
                                   pooled, noise)
        return sds_result(latents, grad, grad_clip_val)
