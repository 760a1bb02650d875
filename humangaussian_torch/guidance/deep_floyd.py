"""DeepFloyd IF guidance: pixel-space SDS, no VAE.

Port of humangaussian_tpu/guidance/deep_floyd.py. The IF-I stage-1 model
scores 64 x 64 pixel images: the render is mapped to [-1, 1] and resized
to `image_size`^2 with the anti-aliased bilinear filter (`resize_bilinear`,
a 16x shrink from 1024^2); the UNet's 6 output channels are the epsilon
prediction and the learned variance, which SDS drops; the CFG takes the
text prediction as its base term (e_text + s (e_text - e_uncond)), or
Perp-Neg's 4-way batch; the schedule is IF's cosine DDPM (`if_schedule`).
The text conditioning is T5 embeddings (4096 wide at full size), which
`SingleUNet`'s `encoder_hid_proj` maps to the cross-attention width.

`DeepFloydSystemGuidance` gives it the dual-branch guidance's call, so
the avatar trainer (train/system.py) trains against IF: the pose and
depth images are ignored, the first two segments of the [cond | neg |
null] text drive the 2-way CFG, and with `use_perp_neg` the per-camera
angles the system forwards rebuild the 4-way Perp-Neg batch from the
prompt embeddings.

IF_I_XL_CONFIG leaves `flash_attention` off, as the reference does, so
its self-attention takes the UNet's chunked matrix-product branch
(guidance/unet.py), not kernel K4; its GroupNorms run the fused forward
kernel. The UNet runs without gradients: the render's gradient flows back
through the resize alone. The noise comes from a `torch.Generator` or is injected
(`noise=`); the reference's per-sample key folding has no counterpart
(guidance/dual_branch.py says why).
"""
from __future__ import annotations

import dataclasses

import torch

from humangaussian_torch.guidance.dual_branch import _repeat, resize_bilinear
from humangaussian_torch.guidance.prompt import get_text_embeddings_perp_neg
from humangaussian_torch.guidance.schedule import (  # noqa: F401
    DiffusionSchedule,
    if_schedule,
)
from humangaussian_torch.guidance.stable_diffusion import (
    perp_neg_cfg,
    sds_result,
    text_as_base_cfg,
)
from humangaussian_torch.guidance.unet import UNetConfig

# the real IF-I-XL configuration (UNet2DConditionModel of IF-I-XL-v1.0)
IF_I_XL_CONFIG = UNetConfig(
    in_channels=3,
    out_channels=6,
    block_out_channels=(704, 1408, 2816, 2816),
    layers_per_block=3,
    cross_attention_dim=2816,
    encoder_hid_dim=4096,
    attn_heads=(11, 22, 44, 44),
    down_block_has_attn=(True, True, True, True),
)

TINY_IF_CONFIG = UNetConfig(
    in_channels=3,
    out_channels=6,
    block_out_channels=(32, 64),
    layers_per_block=1,
    cross_attention_dim=32,
    encoder_hid_dim=48,
    attn_heads=(2, 2),
    down_block_has_attn=(True, True),
    norm_num_groups=8,
    dtype=torch.float32,
)


@dataclasses.dataclass(frozen=True)
class DeepFloydConfig:
    guidance_scale: float = 20.0
    weighting_strategy: str = "sds"
    view_dependent_prompting: bool = True
    use_perp_neg: bool = False
    image_size: int = 64


class DeepFloydGuidance:
    """The frozen IF UNet, its schedule and the pixel-space SDS math."""

    def __init__(self, unet, schedule: DiffusionSchedule,
                 cfg: DeepFloydConfig = DeepFloydConfig()):
        self.unet = unet.eval().requires_grad_(False)
        self.schedule = schedule
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.schedule.alphas_cumprod.device

    def _unet_eps(self, x, t, text):
        """[kB, s, s, 3] -> eps [kB, s, s, 3], the variance half dropped."""
        with torch.no_grad():
            return self.unet(x, t, text)[..., :3]

    def _weighted(self, noise_pred, noise, t):
        w = self.schedule.sds_weight(t, self.cfg.weighting_strategy)
        return w.reshape(-1, 1, 1, 1) * (noise_pred - noise)

    def compute_grad_sds(self, latents, t, text2, noise):
        """Text-as-base 2-way CFG over text2 [2B, L, D] = [cond | uncond]."""
        noisy = self.schedule.add_noise(latents, noise, t)
        pred = self._unet_eps(_repeat(noisy, 2), t.repeat(2), text2)
        return self._weighted(
            text_as_base_cfg(pred, self.cfg.guidance_scale)[0], noise, t)

    def compute_grad_sds_perp_neg(self, latents, t, text4, neg_weights,
                                  noise):
        """Perp-Neg over text4 [4B, L, D], weights [B, 2]."""
        noisy = self.schedule.add_noise(latents, noise, t)
        pred = self._unet_eps(_repeat(noisy, 4), t.repeat(4), text4)
        return self._weighted(
            perp_neg_cfg(pred, neg_weights, self.cfg.guidance_scale), noise,
            t)

    def pixels(self, rgb):
        """[B, H, W, 3] in [0, 1] -> [B, s, s, 3] in [-1, 1]."""
        return resize_bilinear(rgb * 2.0 - 1.0, self.cfg.image_size)

    def grad(self, latents, t, noise, text2=None, embeddings=None,
             elevation=None, azimuth=None, camera_distances=None):
        """The SDS gradient of the pixels `latents`: Perp-Neg from
        `embeddings` and the angles with `use_perp_neg`, else the 2-way CFG
        over `text2`."""
        with torch.no_grad():
            if self.cfg.use_perp_neg:
                text4, neg_w = get_text_embeddings_perp_neg(
                    embeddings, elevation, azimuth, camera_distances)
                return self.compute_grad_sds_perp_neg(latents, t, text4,
                                                      neg_w, noise)
            return self.compute_grad_sds(latents, t, text2, noise)

    def __call__(self, rgb, embeddings, elevation, azimuth, t,
                 generator=None, camera_distances=None, grad_clip_val=None,
                 rgb_as_latents: bool = False, noise=None):
        """rgb [B, H, W, 3] in [0, 1], embeddings a PromptEmbeddings,
        elevation / azimuth [B] degrees, t [B] int; `noise` [B, s, s, 3]
        replaces the generator's draw. Returns {loss_sds, grad_norm,
        grad}."""
        if rgb_as_latents:
            raise ValueError("DeepFloyd IF is a pixel-space model; "
                             "rgb_as_latents does not apply")
        b = rgb.shape[0]
        latents = self.pixels(rgb)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                device=self.device)
        text2 = None
        if not self.cfg.use_perp_neg:
            text2 = embeddings.get_text_embeddings(
                elevation, azimuth, camera_distances,
                self.cfg.view_dependent_prompting)[: 2 * b]
        grad = self.grad(latents.detach(), t, noise, text2, embeddings,
                         elevation, azimuth, camera_distances)
        return sds_result(latents, grad, grad_clip_val)


class DeepFloydSystemGuidance:
    """DeepFloydGuidance behind the dual-branch guidance's call, for the
    avatar trainer (`system.guidance.type: deep-floyd`, the reference's
    texture_structure_joint=false configuration). `embeddings` (the
    prompt processor's PromptEmbeddings) is what Perp-Neg rebuilds its
    batch from."""

    def __init__(self, df: DeepFloydGuidance, embeddings=None):
        self.df = df
        self.embeddings = embeddings

    @property
    def schedule(self) -> DiffusionSchedule:
        return self.df.schedule

    @property
    def device(self) -> torch.device:
        return self.df.device

    def step_draws(self, b: int, generator=None) -> dict:
        """The draw `__call__` makes for a batch of `b` (`noise`), as its
        keyword argument (dist/parallel.py)."""
        s = self.df.cfg.image_size
        return {"noise": torch.randn((b, s, s, 3), generator=generator,
                                     device=self.device)}

    def __call__(self, pose_image, rgb, depth, text_embeddings, t,
                 generator=None, grad_clip_val=None, elevation=None,
                 azimuth=None, camera_distances=None, noise=None):
        """The dual-branch call: pose_image and depth are ignored;
        text_embeddings [3B, L, D] = [cond | neg | null]."""
        b = rgb.shape[0]
        df = self.df
        latents = df.pixels(rgb)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                device=df.device)
        if df.cfg.use_perp_neg and (self.embeddings is None
                                    or azimuth is None):
            raise ValueError(
                "use_perp_neg on the system path needs the PromptEmbeddings "
                "and the per-camera elevation and azimuth")
        grad = df.grad(latents.detach(), t, noise, text_embeddings[: 2 * b],
                       self.embeddings, elevation, azimuth,
                       camera_distances)
        return sds_result(latents, grad, grad_clip_val)
