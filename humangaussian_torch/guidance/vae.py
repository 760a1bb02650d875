"""AutoencoderKL (the Stable Diffusion VAE) as torch modules.

Port of humangaussian_tpu/guidance/vae.py: the architecture of
`stabilityai/sd-vae-ft-mse`, which carries every image <-> latent transport
of the guidance. Encoder: conv_in -> 4 down blocks (2 resnets each and a
strided-conv downsample with the VAE's asymmetric (0, 1) padding) -> mid
(resnet, single-head attention, resnet) -> GroupNorm / SiLU -> conv_out ->
2 x latent moments -> quant_conv. The decoder mirrors it with 3 resnets per
up block and nearest-neighbour upsampling. The scaling factor (0.18215) is
applied by the guidance, not here.

Parameter names are diffusers' (`encoder.down_blocks.0.resnets.0.norm1
.weight`, ...), so an `AutoencoderKL` state dict loads without a
converter. Its one attention, single-head over the 512 channels of the
mid block, runs in ops/vae_attention.py's kernels wherever they apply
(`vae_attention.kernel_applies`: a CUDA bfloat16 q of width 512 and a
multiple of 64 tokens, which every bf16 VAE on the card meets at 4,096 and
16,384 tokens): a fused forward that never writes the logits, and a
backward whose logits pass writes bf16 P and dS for three bf16 products.
Elsewhere (CPU tensors, the float32 tiny VAEs) it is the reference's plain
matrix product (`attend`); where its float32 logits would take more than
`ATTN_CAP_BYTES` the queries run in chunks under the cap
(`chunked_attention`), each chunk recomputed in the backward instead of
keeping its logits and probabilities; each row's arithmetic is the same.
The latent scale is the configuration's `scaling_factor`
(0.18215 for sd-vae-ft-mse, 0.13025 for `SDXL_VAE_CONFIG`, sdxl-vae).

Norms: every GroupNorm, and the SiLU after it where there is one, is the
port's `GroupNormAct` (ops/groupnorm.py: kernels K3 / K3a forward, K5 / K5a
backward), with the parameter names `weight` and `bias` of diffusers'
`nn.GroupNorm`. The reference keeps flax `nn.GroupNorm` + `nn.silu` here
because of a measurement on a TPU; both compute GroupNorm with f32
statistics followed by SiLU, so the output is the same function (in
bfloat16 it is rounded once, after the SiLU, instead of also before it).
On the card the fused op with its kernel backward is what lets the VAE
keep the `channels_last` layout: the library GroupNorm copies every
`channels_last` activation to contiguous and back.

Layout: `encode` and `decode` take and return channel-minor arrays
(`[B, H, W, 3]` images, `[B, h, w, 4]` latents), the reference's public
layout. Inside, activations are `channels_last` `[B, C, H, W]` tensors,
which is what cuDNN's bf16 convolutions want and makes the `[B, H, W, C]`
view `GroupNormAct` normalizes free of copies; `apps.launch.build_guidance`
puts the weights in `channels_last` too. The computation runs in the dtype
of the weights (bfloat16 under `half_precision_weights`; the norms'
parameters stay float32 under `cast_weights`), outputs are float32.

Convolutions: every one is a `BiasConv2d`, an `nn.Conv2d` with the same
parameters. On a CUDA tensor it runs the convolution without its bias and
adds the bias with the port's kernel (ops/conv_bias.py), bit for bit the
library's add at close to the card's bandwidth; on a CPU tensor it is
`nn.Conv2d.forward`.

With rows split across blocks, K3's and K5's f32 atomics add in no fixed
order, so the encoder's forward recomputed under `torch.utils.checkpoint`
(the guidance's `remat_encode`) may differ from the first forward in the
last bits of its statistics; the gradient it feeds is that of the
recomputed forward, which is harmless.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from humangaussian_torch.ops import conv_bias, vae_attention
from humangaussian_torch.ops.groupnorm import GroupNormAct


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.bfloat16


# stabilityai/sdxl-vae: sd-vae-ft-mse's architecture, its own scale
SDXL_VAE_CONFIG = VAEConfig(scaling_factor=0.13025)

ATTN_CAP_BYTES = 1 << 30  # float32 logits of the mid block's attention


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(
        block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8,
        dtype=torch.float32,
    )


class BiasConv2d(nn.Conv2d):
    """`nn.Conv2d` whose bias, on a CUDA tensor, is added by the conv bias
    kernel after the convolution. The kernel adds outside autograd, which
    leaves the input's and the weight's gradients exact (d(y + b)/dy is the
    identity, and the convolution saves no output) but gives the bias none,
    so a bias that requires grad raises while grad is enabled: the guidance
    freezes its VAE."""

    def forward(self, x):
        if x.is_cpu:
            return super().forward(x)
        if self.bias.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                "BiasConv2d adds its bias outside autograd on the card; "
                "freeze the VAE (requires_grad_(False)) or disable grad")
        y = self._conv_forward(x, self.weight, None)
        return conv_bias.conv_bias_add(y, self.bias)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch, out_ch, groups):
        super().__init__()
        self.norm1 = GroupNormAct(groups, in_ch, eps=1e-6, silu=True)
        self.conv1 = BiasConv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNormAct(groups, out_ch, eps=1e-6, silu=True)
        self.conv2 = BiasConv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (
            BiasConv2d(in_ch, out_ch, 1) if in_ch != out_ch else None
        )

    def forward(self, x):
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head full-channel spatial self-attention (the mid block):
    f32 logits and softmax, probabilities cast to the working dtype; the
    fused kernels where `vae_attention.kernel_applies`, `attend` or
    `chunked_attention` elsewhere."""

    def __init__(self, ch, groups):
        super().__init__()
        self.group_norm = GroupNormAct(groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        res = x
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        if vae_attention.kernel_applies(q):
            h = vae_attention.vae_attention(q, k, v)
        else:
            rows = attention_chunk_rows(b, hh * ww)
            h = (attend(q, k, v) if rows >= hh * ww
                 else chunked_attention(q, k, v, rows))
        h = self.to_out[0](h)
        return res + h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


def attention_chunk_rows(b: int, n: int) -> int:
    """Query rows a chunk so that [b, rows, n] float32 logits take at most
    ATTN_CAP_BYTES; n or more means one pass."""
    return max(1, ATTN_CAP_BYTES // (b * n * 4))


def attend(q, k, v):
    """softmax(q k^T / sqrt(C)) v: float32 logits and softmax, the
    probabilities cast to v's dtype; q [B, m, C], k and v [B, n, C]."""
    logits = q.float() @ k.float().transpose(-1, -2) / q.shape[-1]**0.5
    return torch.softmax(logits, dim=-1).to(v.dtype) @ v


def chunked_attention(q, k, v, rows: int):
    """`attend` over chunks of `rows` queries; with grad enabled each chunk
    runs under `torch.utils.checkpoint`, so only q, k and v are kept and
    the backward recomputes one chunk's logits at a time."""
    grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    outs = []
    for s in range(0, q.shape[1], rows):
        qc = q[:, s:s + rows]
        outs.append(checkpoint(attend, qc, k, v, use_reentrant=False)
                    if grad else attend(qc, k, v))
    return torch.cat(outs, dim=1)


class _Resample(nn.Module):
    """diffusers wraps a resampling conv as `{down,up}samplers.0.conv`."""

    def __init__(self, ch, stride, padding):
        super().__init__()
        self.conv = BiasConv2d(ch, ch, 3, stride=stride, padding=padding)


class _Down(nn.Module):
    def __init__(self, in_ch, out_ch, layers, groups, add_downsample):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(in_ch if i == 0 else out_ch, out_ch, groups)
             for i in range(layers)]
        )
        self.downsamplers = (
            nn.ModuleList([_Resample(out_ch, 2, 0)]) if add_downsample
            else None
        )

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            # the VAE pads (0, 1, 0, 1) and then convolves with stride 2
            x = self.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        return x


class _Up(nn.Module):
    def __init__(self, in_ch, out_ch, layers, groups, add_upsample):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(in_ch if i == 0 else out_ch, out_ch, groups)
             for i in range(layers)]
        )
        self.upsamplers = (
            nn.ModuleList([_Resample(out_ch, 1, 1)]) if add_upsample else None
        )

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0].conv(
                F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return x


class _Mid(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(ch, ch, groups), ResnetBlock(ch, ch, groups)]
        )
        self.attentions = nn.ModuleList([AttnBlock(ch, groups)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs = list(cfg.block_out_channels)
        g = cfg.norm_num_groups
        self.conv_in = BiasConv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            [_Down(chs[max(i - 1, 0)], ch, cfg.layers_per_block, g,
                   add_downsample=i < len(chs) - 1)
             for i, ch in enumerate(chs)]
        )
        self.mid_block = _Mid(chs[-1], g)
        self.conv_norm_out = GroupNormAct(g, chs[-1], eps=1e-6, silu=True)
        self.conv_out = BiasConv2d(chs[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(self.conv_norm_out(h))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        self.conv_in = BiasConv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _Mid(rev[0], g)
        self.up_blocks = nn.ModuleList(
            [_Up(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1, g,
                 add_upsample=i < len(rev) - 1)
             for i, ch in enumerate(rev)]
        )
        self.conv_norm_out = GroupNormAct(g, rev[-1], eps=1e-6, silu=True)
        self.conv_out = BiasConv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    """`encode` returns the latent moments; sample with `sample_latent`."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = BiasConv2d(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1)
        self.post_quant_conv = BiasConv2d(cfg.latent_channels,
                                         cfg.latent_channels, 1)
        self.to(cfg.dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def _channels_first(self, x):
        """[B, H, W, C] -> `channels_last` [B, C, H, W] in the model's type
        (a view of the channel-minor input when it is contiguous)."""
        return x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)

    def encode(self, x):
        """[B, H, W, 3] in [-1, 1] -> (mean, logvar) [B, h, w, latent] f32,
        logvar clipped to [-30, 20]."""
        moments = self.quant_conv(self.encoder(self._channels_first(x)))
        mean, logvar = moments.float().permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        """[B, h, w, latent] -> [B, H, W, 3] f32 (before any clamp)."""
        img = self.decoder(self.post_quant_conv(self._channels_first(z)))
        return img.float().permute(0, 2, 3, 1)


_LEGACY_ATTN_NAMES = {"query": "to_q", "key": "to_k", "value": "to_v",
                      "proj_attn": "to_out.0"}


def upgrade_vae_state_dict(sd: dict) -> dict:
    """A diffusers AutoencoderKL state dict with the attention block's
    older names (`query`, `key`, `value`, `proj_attn`, possibly as 1 x 1
    convolution weights) renamed to `to_q`, `to_k`, `to_v`, `to_out.0`
    linear weights; other keys pass through."""
    out = {}
    for key, value in sd.items():
        parts = key.split(".")
        if "attentions" in parts and parts[-2] in _LEGACY_ATTN_NAMES:
            parts[-2] = _LEGACY_ATTN_NAMES[parts[-2]]
            key = ".".join(parts)
            if value.dim() == 4:
                value = value[:, :, 0, 0]
        out[key] = value
    return out


def sample_latent(mean, logvar, generator=None, eps=None):
    """mean + exp(logvar / 2) eps, with eps drawn from `generator` unless it
    is passed in."""
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                          device=mean.device)
    return mean + torch.exp(0.5 * logvar) * eps
