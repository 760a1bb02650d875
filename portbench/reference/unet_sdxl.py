"""The plain SDXL UNet: Stable Diffusion XL base 1.0's UNet2DConditionModel
in plain PyTorch, for the benchmark's reference. It imports the frozen
building blocks of `reference/unet.py` (ResNet block, transformer block,
time embedding, resampling conv, sinusoid) and nothing of the program.

The published `unet/config.json` (stabilityai/stable-diffusion-xl-base-1.0):
block_out_channels [320, 640, 1280], layers_per_block 2, down blocks
[DownBlock2D, CrossAttnDownBlock2D, CrossAttnDownBlock2D], up blocks
[CrossAttnUpBlock2D, CrossAttnUpBlock2D, UpBlock2D], UNetMidBlock2DCrossAttn,
transformer_layers_per_block [1, 2, 10] (the mid block takes the last, the
up blocks the mirrored list), attention_head_dim [5, 10, 20] (diffusers
reads it as the head count: heads of 64), cross_attention_dim 2048,
use_linear_projection true, addition_embed_type "text_time" with
addition_time_embed_dim 256 and projection_class_embeddings_input_dim
2816 (the pooled 1280-wide text row, then the 6 time ids through a
256-wide sinusoid), in/out channels 4, norm_num_groups 32, silu,
flip_sin_to_cos true, freq_shift 0.

Departures from diffusers, none of which changes the function:

- `forward` takes and returns channel-minor arrays ([B, h, w, C]), the
  program's public layout;
- every GroupNorm is `common.GroupNormAct` (float32 statistics, the SiLU
  after it fused into one module), with diffusers' parameter names;
- attention computes float32 logits and softmax, in one pass for self-
  attention (`common.self_attention`, one sample at a time) and over
  chunks of (sample x head) rows for cross-attention; diffusers runs
  `scaled_dot_product_attention` in the model's dtype;
- dropout is left out (0 in the config) and no layer is fused.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.common import GroupNormAct
from portbench.reference.unet import (
    BasicTransformerBlock,
    ResnetBlock2D,
    TimestepEmbedding,
    _Resample,
    cast_weights,
    sinusoidal_embedding,
)


@dataclasses.dataclass(frozen=True)
class SDXLUNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 2048
    attn_heads: Sequence[int] = (5, 10, 20)
    down_block_has_attn: Sequence[bool] = (False, True, True)
    transformer_layers_per_block: Sequence[int] = (1, 2, 10)
    pooled_text_dim: int = 1280
    addition_time_embed_dim: int = 256
    num_time_ids: int = 6
    norm_num_groups: int = 32
    dtype: torch.dtype = torch.float32

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


class Transformer2D(nn.Module):
    """GroupNorm, the linear input projection, `depth` transformer blocks,
    the linear output projection and the residual."""

    def __init__(self, dim, context_dim, heads, groups, depth):
        super().__init__()
        self.norm = GroupNormAct(groups, dim, eps=1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, context_dim, heads, True)
             for _ in range(depth)])
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x, context):
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(
            b, hh * ww, c))
        for blk in self.transformer_blocks:
            h = blk(h, context)
        h = self.proj_out(h).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return h + x


class Down(nn.Module):
    def __init__(self, cfg, level):
        super().__init__()
        chs = cfg.block_out_channels
        c_in, c = chs[max(level - 1, 0)], chs[level]
        g, temb = cfg.norm_num_groups, cfg.time_embed_dim
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(c_in if i == 0 else c, c, temb, g)
             for i in range(cfg.layers_per_block)])
        self.attentions = nn.ModuleList(
            [Transformer2D(c, cfg.cross_attention_dim, cfg.attn_heads[level],
                           g, cfg.transformer_layers_per_block[level])
             for _ in range(cfg.layers_per_block)]
        ) if cfg.down_block_has_attn[level] else None
        self.downsamplers = (nn.ModuleList([_Resample(c, 2)])
                             if level < len(chs) - 1 else None)

    def forward(self, x, temb, context):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0].conv(x)
            skips.append(x)
        return x, skips


class Up(nn.Module):
    """Up block `i` (0 at the bottom): layers_per_block + 1 ResNets, each
    on the previous output concatenated with a skip off the stack."""

    def __init__(self, cfg, i, skip_chs):
        super().__init__()
        chs = cfg.block_out_channels
        n = len(chs)
        level = n - 1 - i
        c, c_prev = chs[level], chs[min(level + 1, n - 1)]
        g, temb = cfg.norm_num_groups, cfg.time_embed_dim
        self.resnets = nn.ModuleList(
            [ResnetBlock2D((c_prev if j == 0 else c) + s, c, temb, g)
             for j, s in enumerate(skip_chs)])
        self.attentions = nn.ModuleList(
            [Transformer2D(c, cfg.cross_attention_dim, cfg.attn_heads[level],
                           g, cfg.transformer_layers_per_block[level])
             for _ in skip_chs]
        ) if cfg.down_block_has_attn[level] else None
        self.upsamplers = (nn.ModuleList([_Resample(c, 1)])
                           if i < n - 1 else None)

    def forward(self, x, skips, temb, context):
        for j, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[j](x, context)
        if self.upsamplers is not None:
            x = self.upsamplers[0].conv(
                F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return x


class Mid(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c = cfg.block_out_channels[-1]
        g, temb = cfg.norm_num_groups, cfg.time_embed_dim
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(c, c, temb, g) for _ in range(2)])
        self.attentions = nn.ModuleList(
            [Transformer2D(c, cfg.cross_attention_dim, cfg.attn_heads[-1], g,
                           cfg.transformer_layers_per_block[-1])])

    def forward(self, x, temb, context):
        x = self.attentions[0](self.resnets[0](x, temb), context)
        return self.resnets[1](x, temb)


def _skip_channels(cfg) -> list:
    """Each up block's skip channels, in the order it pops them."""
    chs = list(cfg.block_out_channels)
    n = len(chs)
    stack = [chs[0]]
    for i in range(n):
        stack += [chs[i]] * cfg.layers_per_block
        if i < n - 1:
            stack.append(chs[i])
    out = []
    for _ in range(n):
        take = stack[-(cfg.layers_per_block + 1):]
        stack = stack[:-(cfg.layers_per_block + 1)]
        out.append(list(reversed(take)))
    return out


class SDXLUNet(nn.Module):
    """SDXL's UNet: [B, h, w, 4] noisy latents, [B] timesteps, [B, 77,
    2048] text rows, [B, 1280] pooled rows and [B, 6] time ids -> [B, h,
    w, 4] float32 epsilon."""

    def __init__(self, cfg: SDXLUNetConfig = SDXLUNetConfig()):
        super().__init__()
        self.cfg = cfg
        chs = list(cfg.block_out_channels)
        temb = cfg.time_embed_dim
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chs[0], temb)
        self.add_embedding = TimestepEmbedding(
            cfg.pooled_text_dim
            + cfg.num_time_ids * cfg.addition_time_embed_dim, temb)
        self.down_blocks = nn.ModuleList(
            [Down(cfg, i) for i in range(len(chs))])
        self.mid_block = Mid(cfg)
        self.up_blocks = nn.ModuleList(
            [Up(cfg, i, s) for i, s in enumerate(_skip_channels(cfg))])
        self.conv_norm_out = GroupNormAct(cfg.norm_num_groups, chs[0],
                                          eps=1e-5, silu=True)
        self.conv_out = nn.Conv2d(chs[0], cfg.out_channels, 3, padding=1)
        cast_weights(self, cfg.dtype)

    def forward(self, sample, timesteps, text, pooled, time_ids):
        cfg = self.cfg
        dt = self.conv_in.weight.dtype
        b = sample.shape[0]
        emb = self.time_embedding(
            sinusoidal_embedding(timesteps, cfg.block_out_channels[0]).to(dt))
        ids = sinusoidal_embedding(time_ids.reshape(-1),
                                   cfg.addition_time_embed_dim).reshape(b, -1)
        emb = emb + self.add_embedding(
            torch.cat([pooled.float(), ids], dim=-1).to(dt))
        context = text.to(dt)
        h = self.conv_in(sample.to(dt).permute(0, 3, 1, 2))
        skips = [h]
        for blk in self.down_blocks:
            h, s = blk(h, emb, context)
            skips += s
        h = self.mid_block(h, emb, context)
        for blk in self.up_blocks:
            h = blk(h, skips, emb, context)
        out = self.conv_out(self.conv_norm_out(h)).float()
        return out.permute(0, 2, 3, 1)
