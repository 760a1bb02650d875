"""ControlNet-conditioned SDS guidance (the reference's skeleton-
conditioning alternative, `stable-diffusion-controlnet-guidance`).

Port of humangaussian_tpu/guidance/controlnet.py:

- `UNet2D`: the single-stream SD UNet (`SingleUNet` of guidance/unet.py
  at SD 1.5 geometry) whose forward adds ControlNet residuals to its skips
  and to the mid block's output;
- `ControlNet`: the conditioning embedding (a conv stack taking the 512^2
  condition image, the openpose skeleton render, to latent resolution),
  a copy of the UNet's time embedding, conv_in, down path and mid block,
  and a zero-initialized 1 x 1 convolution on every skip and on the mid
  output;
- `ControlNetGuidance`: SDS through the ControlNet-conditioned UNet:
  the render and the condition resized to `image_size`^2 (antialiased,
  as `jax.image.resize` shrinks), the render VAE-encoded (differentiated,
  not recomputed), plain 2-way CFG e_uncond + s (e_text - e_uncond) over
  [cond | uncond] text, and the reparameterized loss
  0.5 ||latents - sg(latents - grad)||^2 / B.

Module names are diffusers' (`ControlNetModel`: `controlnet_cond_embedding
.{conv_in,blocks.N,conv_out}`, `controlnet_down_blocks.N`,
`controlnet_mid_block`, the trunk's `down_blocks...`), so a diffusers file
loads with `load_state_dict`. So are the shapes: the embedding's block 2i
keeps its input width and block 2i + 1 (stride 2) widens it, where the
JAX module's `cond_block_{i}a` already widens and `cond_block_{i}b`
keeps the width; the two agree only where consecutive embedding widths
are equal (ROADMAP queue 3). `convert.controlnet_state_dict_from_flax`
maps `cond_block_{i}a` / `b` to `blocks.{2i}` / `{2i + 1}`.

Noise: the encode's draw, then the gradient's, from a `torch.Generator`
in that order, or passed in (`latent_eps=`, `noise=`), as in
guidance/dual_branch.py; the reference's per-sample key folding
(`per_sample_normal`) has no counterpart. The UNet and the ControlNet run
without gradients. Layout: images, latents and residuals are channel-
minor (`[B, H, W, C]`); inside, the networks keep channels-first tensors
in the `channels_last` memory format.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from humangaussian_torch.guidance.dual_branch import VAE_SCALE, _repeat, \
    resize_bilinear
from humangaussian_torch.guidance.schedule import DiffusionSchedule
from humangaussian_torch.guidance.unet import (
    MidBlock,
    SingleUNet,
    TimestepEmbedding,
    UNetConfig,
    _down_blocks,
    _stem,
    cast_weights,
    sinusoidal_embedding,
)
from humangaussian_torch.guidance.vae import sample_latent

SD15_CONFIG = UNetConfig(
    in_channels=4,
    out_channels=4,
    cross_attention_dim=768,
    attn_heads=(8, 8, 8, 8),
    use_linear_projection=False,
    num_time_ids=0,  # SD 1.5 has no size conditioning
)

TINY_SD_CONFIG = dataclasses.replace(
    SD15_CONFIG,
    block_out_channels=(32, 64),
    layers_per_block=1,
    cross_attention_dim=32,
    attn_heads=(2, 2),
    down_block_has_attn=(True, False),
    norm_num_groups=8,
    dtype=torch.float32,
)

COND_EMBED_CHANNELS = (16, 32, 96, 256)  # diffusers' default


class UNet2D(SingleUNet):
    """The single-stream UNet2DConditionModel; `forward(sample, t, text,
    down_residuals=, mid_residual=)` injects ControlNet residuals."""

    def __init__(self, cfg: UNetConfig = SD15_CONFIG):
        super().__init__(cfg)


class ControlNetConditioningEmbedding(nn.Module):
    """conv_in, SiLU, then per widening step a 3 x 3 convolution at the
    input width and a stride-2 one to the next width, each with a SiLU,
    then the zero-initialized conv_out to the UNet's first width."""

    def __init__(self, out_channels: int,
                 channels: Sequence[int] = COND_EMBED_CHANNELS,
                 in_channels: int = 3):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, channels[0], 3, padding=1)
        blocks = []
        for c_in, c_out in zip(channels[:-1], channels[1:]):
            blocks.append(nn.Conv2d(c_in, c_in, 3, padding=1))
            blocks.append(nn.Conv2d(c_in, c_out, 3, padding=1, stride=2))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(channels[-1], out_channels, 3, padding=1)
        nn.init.zeros_(self.conv_out.weight)
        nn.init.zeros_(self.conv_out.bias)

    def forward(self, x):
        h = nn.functional.silu(self.conv_in(x))
        for conv in self.blocks:
            h = nn.functional.silu(conv(h))
        return self.conv_out(h)


def _zero_conv(ch: int) -> nn.Conv2d:
    conv = nn.Conv2d(ch, ch, 1)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


class ControlNet(nn.Module):
    """diffusers' ControlNetModel: the UNet's down path and mid block on
    the noisy latents plus the embedded condition, with a zero 1 x 1
    convolution tap on every skip and on the mid output."""

    def __init__(self, cfg: UNetConfig = SD15_CONFIG,
                 cond_embed_channels: Sequence[int] = COND_EMBED_CHANNELS):
        super().__init__()
        self.cfg = cfg
        chs = list(cfg.block_out_channels)
        n = len(chs)
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chs[0], cfg.time_embed_dim)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(
            chs[0], cond_embed_channels)
        self.down_blocks = _down_blocks(cfg, n)
        self.mid_block = MidBlock(chs[-1], cfg.time_embed_dim,
                                  cfg.attn_heads[-1], cfg)
        skips = [chs[0]]
        for i in range(n):
            skips += [chs[i]] * cfg.layers_per_block
            if i < n - 1:
                skips.append(chs[i])
        self.controlnet_down_blocks = nn.ModuleList(
            [_zero_conv(ch) for ch in skips])
        self.controlnet_mid_block = _zero_conv(chs[-1])
        cast_weights(self, cfg.dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(self, sample, timesteps, encoder_hidden_states, cond_image):
        """sample [B, h, w, 4], timesteps [B], encoder_hidden_states
        [B, L, cross_attention_dim], cond_image [B, 8h, 8w, 3] in [0, 1]
        -> (down residuals, one [B, h_i, w_i, C_i] per UNet skip; the mid
        residual [B, h / 2^(n-1), w / 2^(n-1), C])."""
        cfg = self.cfg
        dtype = self.dtype
        emb = self.time_embedding(sinusoidal_embedding(
            timesteps, cfg.block_out_channels[0]).to(dtype))
        context = encoder_hidden_states.to(dtype)
        cond = self.controlnet_cond_embedding(_stem(cond_image, dtype))
        h = self.conv_in(_stem(sample, dtype)) + cond
        res = [h]
        for blk in self.down_blocks:
            h, rs = blk(h, emb, context)
            res += rs
        h = self.mid_block(h, emb, context)
        down = [tap(r).permute(0, 2, 3, 1)
                for tap, r in zip(self.controlnet_down_blocks, res)]
        return down, self.controlnet_mid_block(h).permute(0, 2, 3, 1)


class ControlNetGuidance:
    """The frozen ControlNet prior (UNet2D, ControlNet, VAE, schedule) and
    its SDS step: the skeleton image conditions the score."""

    def __init__(self, unet: UNet2D, controlnet: ControlNet, vae,
                 schedule: DiffusionSchedule, guidance_scale: float = 7.5,
                 weighting_strategy: str = "sds", image_size: int = 512,
                 condition_scale: float = 1.0):
        self.unet = unet.eval().requires_grad_(False)
        self.controlnet = controlnet.eval().requires_grad_(False)
        self.vae = vae.eval().requires_grad_(False)
        self.schedule = schedule
        self.guidance_scale = guidance_scale
        self.weighting_strategy = weighting_strategy
        self.image_size = image_size
        self.condition_scale = condition_scale

    @property
    def device(self) -> torch.device:
        return self.schedule.alphas_cumprod.device

    def encode_images(self, imgs, generator=None, eps=None):
        """[B, H, W, 3] in [0, 1] -> sampled latents [B, h, w, 4] times
        VAE_SCALE; `eps` replaces the generator's draw."""
        mean, logvar = self.vae.encode(imgs * 2.0 - 1.0)
        return sample_latent(mean, logvar, generator, eps) * VAE_SCALE

    def noise_pred(self, noisy, t, text_embeddings, cond):
        """The CFG'd epsilon of noisy latents [B, h, w, 4] under the
        condition images `cond` [B, S, S, 3] and text [2B, L, D] = [cond |
        uncond], without gradients."""
        lat2, cond2, t2 = _repeat(noisy, 2), _repeat(cond, 2), t.repeat(2)
        with torch.no_grad():
            down, mid = self.controlnet(lat2, t2, text_embeddings, cond2)
            s = self.condition_scale
            pred = self.unet(lat2, t2, text_embeddings,
                             down_residuals=[r * s for r in down],
                             mid_residual=mid * s)
        e_text, e_uncond = pred.chunk(2, dim=0)
        return e_uncond + self.guidance_scale * (e_text - e_uncond)

    def __call__(self, control_image, rgb, text_embeddings, t,
                 generator=None, latent_eps=None, noise=None):
        """control_image, rgb [B, H, W, 3] (rgb the differentiable render);
        text_embeddings [2B, L, D] = [cond | uncond]; t [B] int.
        `latent_eps` and `noise` [B, h, w, 4] replace the generator's
        draws. Returns {loss_sds, grad_norm, grad}."""
        b = rgb.shape[0]
        s = self.image_size
        rgb_s = resize_bilinear(rgb, s)
        cond_s = resize_bilinear(control_image, s)
        down = 2 ** (len(self.vae.cfg.block_out_channels) - 1)
        shape = (b, s // down, s // down, self.vae.cfg.latent_channels)
        if latent_eps is None:
            latent_eps = torch.randn(shape, generator=generator,
                                     device=self.device)
        if noise is None:
            noise = torch.randn(shape, generator=generator,
                                device=self.device)
        latents = self.encode_images(rgb_s, eps=latent_eps)
        with torch.no_grad():
            noisy = self.schedule.add_noise(latents.detach(), noise, t)
            e = self.noise_pred(noisy, t, text_embeddings, cond_s.detach())
            w = self.schedule.sds_weight(t, self.weighting_strategy)
            grad = torch.nan_to_num(w.reshape(b, 1, 1, 1) * (e - noise))
        target = (latents - grad).detach()
        return {
            "loss_sds": 0.5 * ((latents - target) ** 2).sum() / b,
            "grad_norm": torch.linalg.vector_norm(grad),
            "grad": grad,
        }
