"""Standalone Stable-Diffusion SDS guidance (no depth branch).

Port of humangaussian_tpu/guidance/stable_diffusion.py, the guidance of
`texture_structure_joint: false` and of the stock text-to-3D systems:

- 2-way CFG SDS with the text prediction as the base term, e_text +
  s (e_text - e_uncond), optionally std-rescaled (`guidance_rescale`);
- Perp-Neg: a 4B batch [pos | uncond | neg1, neg2], each negative score
  projected perpendicular to the positive direction and summed with the
  view-dependent decay weights of `get_text_embeddings_perp_neg`;
- the weighting strategies sds / uniform / fantasia3d;
- `rgb_as_latents` takes the render as latents; otherwise it is resized
  to `image_size`^2 and VAE-encoded (under `torch.utils.checkpoint` when
  the render is differentiated: the encoder is recomputed in the backward,
  as the reference's `jax.checkpoint` does);
- the scalar grad clamp and the reparameterized loss
  0.5 ||latents - sg(latents - grad)||^2 / B.

The backbone is `SingleUNet` at SD 2.1-base width (`SD2_SINGLE_CONFIG`)
with the epsilon-prediction schedule `sd_eps_schedule`. The UNet runs
without gradients. Noise comes from a `torch.Generator` (the encode's
draw, then the gradient's) or is injected (`latent_eps=`, `noise=`); the
reference's per-sample key folding (`per_sample_normal`) has no
counterpart (guidance/dual_branch.py says why).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from humangaussian_torch.guidance.dual_branch import (
    VAE_SCALE,
    _repeat,
    rescale_noise_cfg,
    resize_bilinear,
)
from humangaussian_torch.guidance.prompt import (
    get_text_embeddings_perp_neg,
    perpendicular_component,
)
from humangaussian_torch.guidance.schedule import DiffusionSchedule
from humangaussian_torch.guidance.vae import sample_latent


def text_as_base_cfg(pred, guidance_scale: float):
    """pred [2B, ...] = [text | uncond] -> e_text + s (e_text - e_uncond)
    (and e_text, for the rescale)."""
    e_text, e_uncond = pred.chunk(2, dim=0)
    return e_text + guidance_scale * (e_text - e_uncond), e_text


def perp_neg_cfg(pred, neg_weights, guidance_scale: float):
    """pred [4B, ...] = [pos | uncond | neg1, neg2 interleaved], weights
    [B, 2] -> e_uncond + s (e_pos + sum_i w_i perp(e_neg_i - e_uncond,
    e_pos)), e_pos = e_text - e_uncond."""
    b = neg_weights.shape[0]
    e_text, e_uncond, e_neg = pred[:b], pred[b:2 * b], pred[2 * b:]
    e_pos = e_text - e_uncond
    accum = torch.zeros_like(e_pos)
    for i in range(2):
        w = neg_weights[:, i].reshape(b, *([1] * (e_pos.dim() - 1)))
        accum = accum + w * perpendicular_component(e_neg[i::2] - e_uncond,
                                                    e_pos)
    return e_uncond + guidance_scale * (e_pos + accum)


def sds_result(latents, grad, grad_clip_val):
    """nan_to_num and clamp `grad`, then the reparameterized loss:
    {loss_sds, grad_norm, grad}."""
    grad = torch.nan_to_num(grad)
    if grad_clip_val is not None:
        grad = grad.clamp(-grad_clip_val, grad_clip_val)
    target = (latents - grad).detach()
    return {
        "loss_sds": 0.5 * ((latents - target) ** 2).sum() / latents.shape[0],
        "grad_norm": torch.linalg.vector_norm(grad),
        "grad": grad.detach(),
    }


@dataclasses.dataclass(frozen=True)
class SDGuidanceConfig:
    guidance_scale: float = 100.0
    weighting_strategy: str = "sds"
    guidance_rescale: float = 0.0
    view_dependent_prompting: bool = True
    use_perp_neg: bool = False
    latent_size: int = 64
    image_size: int = 512


class StableDiffusionGuidance:
    """The frozen SD prior (SingleUNet, VAE, schedule) and its SDS math."""

    def __init__(self, unet, vae, schedule: DiffusionSchedule,
                 cfg: SDGuidanceConfig = SDGuidanceConfig()):
        self.unet = unet.eval().requires_grad_(False)
        self.vae = vae.eval().requires_grad_(False)
        self.schedule = schedule
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.schedule.alphas_cumprod.device

    # ---- VAE transport ---------------------------------------------------
    def encode_images(self, imgs, generator=None, eps=None):
        """[B, H, W, 3] in [0, 1] -> sampled latents [B, h, w, 4] times
        VAE_SCALE; `eps` replaces the generator's draw."""
        mean, logvar = self.vae.encode(imgs * 2.0 - 1.0)
        return sample_latent(mean, logvar, generator, eps) * VAE_SCALE

    def decode_latents(self, latents):
        img = self.vae.decode(latents / VAE_SCALE)
        return (img * 0.5 + 0.5).clamp(0.0, 1.0)

    def _unet_eps(self, lat_in, t, text):
        with torch.no_grad():
            return self.unet(lat_in, t, text)

    # ---- SDS gradients -----------------------------------------------------
    def _weighted(self, noise_pred, noise, t):
        w = self.schedule.sds_weight(t, self.cfg.weighting_strategy)
        return w.reshape(-1, 1, 1, 1) * (noise_pred - noise)

    def compute_grad_sds(self, latents, t, text2, noise):
        """2-way CFG over text2 [2B, L, D] = [cond | uncond]."""
        noisy = self.schedule.add_noise(latents, noise, t)
        pred = self._unet_eps(_repeat(noisy, 2), t.repeat(2), text2)
        noise_pred, e_text = text_as_base_cfg(pred, self.cfg.guidance_scale)
        if self.cfg.guidance_rescale > 0.0:
            noise_pred = rescale_noise_cfg(noise_pred, e_text,
                                           self.cfg.guidance_rescale)
        return self._weighted(noise_pred, noise, t)

    def compute_grad_sds_perp_neg(self, latents, t, text4, neg_weights,
                                  noise):
        """Perp-Neg over text4 [4B, L, D] = [pos | uncond | neg1, neg2
        interleaved], weights [B, 2]."""
        noisy = self.schedule.add_noise(latents, noise, t)
        pred = self._unet_eps(_repeat(noisy, 4), t.repeat(4), text4)
        return self._weighted(
            perp_neg_cfg(pred, neg_weights, self.cfg.guidance_scale), noise,
            t)

    # ---- the public step ---------------------------------------------------
    def __call__(self, rgb, embeddings, elevation, azimuth, t,
                 generator=None, camera_distances=None,
                 rgb_as_latents: bool = False, grad_clip_val=None,
                 latent_eps=None, noise=None):
        """rgb [B, H, W, 3] (the differentiable render; [B, h, w, 4] latents
        with `rgb_as_latents`), embeddings a PromptEmbeddings, elevation /
        azimuth / camera_distances [B] degrees, t [B] int. `latent_eps`
        replaces the encode's draw and `noise` the gradient's. Returns
        {loss_sds, grad_norm, grad}."""
        c = self.cfg
        b = rgb.shape[0]
        if rgb_as_latents:
            latents = resize_bilinear(rgb, c.latent_size)
        else:
            img = resize_bilinear(rgb, c.image_size)
            down = 2 ** (len(self.vae.cfg.block_out_channels) - 1)
            if latent_eps is None:
                latent_eps = torch.randn(
                    (b, c.image_size // down, c.image_size // down,
                     self.vae.cfg.latent_channels), generator=generator,
                    device=self.device)

            def fn(x):
                return self.encode_images(x, eps=latent_eps)

            latents = (checkpoint(fn, img, use_reentrant=False)
                       if img.requires_grad else fn(img))
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                device=self.device)
        with torch.no_grad():
            lat = latents.detach()
            if c.use_perp_neg:
                text4, neg_w = get_text_embeddings_perp_neg(
                    embeddings, elevation, azimuth, camera_distances)
                grad = self.compute_grad_sds_perp_neg(lat, t, text4, neg_w,
                                                      noise)
            else:
                text3 = embeddings.get_text_embeddings(
                    elevation, azimuth, camera_distances,
                    c.view_dependent_prompting)
                grad = self.compute_grad_sds(lat, t, text3[: 2 * b], noise)
        return sds_result(latents, grad, grad_clip_val)
