"""Frozen plain copy of `humangaussian_torch/guidance/unet.py` for the benchmark's
reference (imports rewritten; kernel calls replaced by plain torch in
`portbench/reference/common.py`). Original docstring:

The dual-branch SD2 UNet (Texture-Structure Joint Model) as torch modules.

Port of humangaussian_tpu/guidance/unet.py: a Stable-Diffusion-2-base UNet
(320 / 640 / 1280 / 1280 channels, 2 layers per block, cross-attention width
1024, linear attention projections) with a structure (depth) branch:

- branch copies of conv_in, the first `copy_first_n_block` down blocks, the
  last `copy_last_n_block` up blocks, conv_norm_out and conv_out;
- the two stems are fused (averaged) after `copy_first_n_block` down
  blocks; the shared trunk, the mid block and the shared up blocks run
  once;
- the branch's last up block(s) run on a copy of the shared feature with
  the branch's own skip stack (its stem skips, then the trunk's);
- size micro-conditioning: 6 ids (original H x W, crop, target H x W)
  through a 256-wide sinusoid and an MLP, added to the time embedding
  (`num_time_ids=0` builds no `add_embedding` and takes the time_ids
  argument for nothing; the JAX module cannot initialize a zero-width
  Dense, so no JAX configuration uses it);
- the forward takes two 8-channel inputs (4 noisy latent + 4 pose latent
  channels each) and returns the channel-concat of the rgb and the depth
  prediction.

`branch_num > 1` adds structure branches (`conv_in_branch.{i}`,
`down_blocks_branch.{i}`, `up_blocks_branch.{i}`, `conv_norm_out_branch.{i}`,
`conv_out_branch.{i}`), each fed its own input, fused with the main stem by
`fusion` (`avg`, `sum`, or `learn`: a 3 x 3 `fusion_conv` over the
channel-concat of the stems). `SingleUNet` is the plain diffusers
UNet2DConditionModel (no branch, no size micro-conditioning), with
`encoder_hid_proj` when `encoder_hid_dim` is set (DeepFloyd IF's T5 width):
the backbone of guidance/stable_diffusion.py and guidance/deep_floyd.py.
`use_linear_projection` off gives SD 1.5's transformer projections, 1 x 1
convolutions (guidance/controlnet.py).

Kernels: every GroupNorm is `GroupNormAct` (ops/groupnorm.py, the fused
forward kernel, K5 backward) and self-attention with `flash_attention` on and a token count that is a
multiple of 128 is `self_attention` (ops/attention.py, kernel K4).
Cross-attention, the 8 x 8 mid block (64 tokens) and every site of a
configuration without `flash_attention` (IF_I_XL_CONFIG) take the
matrix-product branch, as in the reference. That branch runs over chunks
of the (batch x heads) rows so that one chunk's float32 logits stay under
`ATTN_CHUNK_BYTES`: XLA's fusion keeps the reference's one-pass form from
materializing its [B, heads, 4096, 4096] logits, eager torch would not
(about 12 GB at IF's first level, batch 16). Each row's arithmetic is
that of the one pass.

Parameter names are diffusers' `unet_ema` names (`down_blocks.0.resnets.0
.norm1.weight`, `conv_in_branch.0.weight`, ...), so a state dict loads
without a converter. Weights are `cfg.dtype` (bfloat16 at full width),
GroupNorm parameters float32, the output float32; the computation runs in
`cfg.dtype` (`cast_weights`; the launcher rounds the weights through
bfloat16 first when `half_precision_weights` is on).

Layout: `forward` takes and returns channel-minor arrays (`[B, h, w, C]`),
the reference's public layout; inside, activations are channels-first
tensors in the `channels_last` memory format, which is what cuDNN's bf16
convolutions want and makes the `[B, h, w, C]` view GroupNormAct and the
transformer blocks need free.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.common import self_attention
from portbench.reference.common import GroupNormAct


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attn_heads: Sequence[int] = (5, 10, 20, 20)  # per level
    down_block_has_attn: Sequence[bool] = (True, True, True, False)
    norm_num_groups: int = 32
    addition_time_embed_dim: int = 256
    num_time_ids: int = 6
    encoder_hid_dim: int | None = None  # e.g. 4096 for DeepFloyd's T5
    branch_num: int = 1
    copy_first_n_block: int = 1
    copy_last_n_block: int = 1
    fusion: str = "avg"
    use_linear_projection: bool = True  # False: SD 1.5's 1 x 1 convolutions
    flash_attention: bool = False  # kernel K4 for self-attention
    dtype: torch.dtype = torch.bfloat16

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


SD2_BASE_CONFIG = UNetConfig(flash_attention=True)

TINY_TEST_CONFIG = UNetConfig(
    block_out_channels=(32, 64),
    layers_per_block=1,
    cross_attention_dim=32,
    attn_heads=(2, 2),
    down_block_has_attn=(True, False),
    norm_num_groups=8,
    addition_time_embed_dim=16,
    dtype=torch.float32,
)


ATTN_CHUNK_BYTES = 1 << 30  # float32 logits of one matrix-product chunk


def sinusoidal_embedding(timesteps, dim: int):
    """diffusers' Timesteps as SD2 configures it (cosines first, no
    frequency shift): [B] -> [B, dim]."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, out_dim)
        self.linear_2 = nn.Linear(out_dim, out_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch, out_ch, temb_dim, groups):
        super().__init__()
        self.norm1 = GroupNormAct(groups, in_ch, eps=1e-5, silu=True)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = GroupNormAct(groups, out_ch, eps=1e-5, silu=True)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (
            nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None
        )

    def forward(self, x, temb):
        h = self.conv1(self.norm1(x))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, query_dim, context_dim, heads, use_flash=False):
        super().__init__()
        self.heads = heads
        self.use_flash = use_flash
        ctx = query_dim if context_dim is None else context_dim
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(ctx, query_dim, bias=False)
        self.to_v = nn.Linear(ctx, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, n, inner = x.shape
        h = self.heads
        d = inner // h
        q = self.to_q(x).reshape(b, n, h, d)
        k = self.to_k(ctx).reshape(b, -1, h, d)
        v = self.to_v(ctx).reshape(b, -1, h, d)
        if self.use_flash and context is None and n % 128 == 0:
            # kernel K4: the matrix-product branch would materialize
            # [b, h, 4096, 4096] logits at the first level
            out = self_attention(q, k, v).reshape(b, n, inner)
        else:
            out = matmul_attention(q, k, v)
        return self.to_out[0](out)


def matmul_attention(q, k, v):
    """softmax(q k^T / sqrt(d)) v with float32 logits and softmax, the
    probabilities cast to v's dtype before the second product: q [b, n, h,
    d], k and v [b, m, h, d] -> [b, n, h * d]. The (batch x heads) rows
    run in chunks whose float32 logits take at most ATTN_CHUNK_BYTES."""
    b, n, h, d = q.shape
    m = k.shape[1]
    step = max(1, ATTN_CHUNK_BYTES // (n * m * 4))
    qh, kh, vh = (x.permute(0, 2, 1, 3).reshape(b * h, -1, d)
                  for x in (q, k, v))
    out = torch.empty((b * h, n, d), dtype=v.dtype, device=v.device)
    for s in range(0, b * h, step):
        logits = torch.bmm(qh[s:s + step].float(),
                           kh[s:s + step].float().transpose(1, 2)
                           ) / math.sqrt(d)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out[s:s + step] = torch.bmm(attn, vh[s:s + step])
    return out.reshape(b, h, n, d).permute(0, 2, 1, 3).reshape(b, n, h * d)


class GEGLU(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.proj = nn.Linear(dim, dim * 8)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact (erf) gelu


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        # diffusers' layout: net.0 GEGLU, net.1 dropout, net.2 projection
        self.net = nn.ModuleList(
            [GEGLU(dim), nn.Dropout(0.0), nn.Linear(dim * 4, dim)]
        )

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, context_dim, heads, use_flash):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, None, heads, use_flash)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, context_dim, heads)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """The norm, the input projection, one transformer block and the output
    projection, with the residual. The projections are linear layers
    (SD2's `use_linear_projection`, weights [C, C]) or, with
    `use_linear_projection` off, 1 x 1 convolutions (SD 1.5, weights
    [C, C, 1, 1]), as diffusers builds them."""

    def __init__(self, dim, context_dim, heads, groups, use_flash=False,
                 use_linear_projection=True):
        super().__init__()
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNormAct(groups, dim, eps=1e-6)
        if use_linear_projection:
            self.proj_in = nn.Linear(dim, dim)
            self.proj_out = nn.Linear(dim, dim)
        else:
            self.proj_in = nn.Conv2d(dim, dim, 1)
            self.proj_out = nn.Conv2d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, context_dim, heads, use_flash)]
        )

    def forward(self, x, context):
        b, c, hh, ww = x.shape
        res = x
        h = self.norm(x)
        if not self.use_linear_projection:
            h = self.proj_in(h)
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        if self.use_linear_projection:
            h = self.proj_in(h)
        h = self.transformer_blocks[0](h, context)
        if self.use_linear_projection:
            h = self.proj_out(h)
        h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        if not self.use_linear_projection:
            h = self.proj_out(h)
        return h + res


class _Resample(nn.Module):
    """diffusers wraps a resampling conv as `{down,up}samplers.0.conv`."""

    def __init__(self, ch, stride):
        super().__init__()
        # the UNet's downsampler pads symmetrically (padding 1), unlike the
        # VAE's asymmetric (0, 1)
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=1)


class DownBlock(nn.Module):
    """CrossAttnDownBlock2D or DownBlock2D, by `has_attn`."""

    def __init__(self, in_ch, out_ch, temb_dim, has_attn, heads,
                 add_downsample, cfg: UNetConfig):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, temb_dim,
                           cfg.norm_num_groups)
             for i in range(cfg.layers_per_block)]
        )
        self.attentions = nn.ModuleList(
            [_transformer(out_ch, heads, cfg)
             for _ in range(cfg.layers_per_block)]
        ) if has_attn else None
        self.downsamplers = (
            nn.ModuleList([_Resample(out_ch, 2)]) if add_downsample else None
        )

    def forward(self, x, temb, context):
        res = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0].conv(x)
            res.append(x)
        return x, res


class UpBlock(nn.Module):
    def __init__(self, prev_ch, skip_chs, out_ch, temb_dim, has_attn, heads,
                 add_upsample, cfg: UNetConfig):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D((prev_ch if i == 0 else out_ch) + skip, out_ch,
                           temb_dim, cfg.norm_num_groups)
             for i, skip in enumerate(skip_chs)]
        )
        self.attentions = nn.ModuleList(
            [_transformer(out_ch, heads, cfg) for _ in skip_chs]
        ) if has_attn else None
        self.upsamplers = (
            nn.ModuleList([_Resample(out_ch, 1)]) if add_upsample else None
        )

    def forward(self, x, res_stack, temb, context):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, res_stack.pop()], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
        if self.upsamplers is not None:
            x = self.upsamplers[0].conv(
                F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return x


class MidBlock(nn.Module):
    def __init__(self, ch, temb_dim, heads, cfg: UNetConfig):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ch, ch, temb_dim, cfg.norm_num_groups)
             for _ in range(2)]
        )
        self.attentions = nn.ModuleList([_transformer(ch, heads, cfg)])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


def _transformer(ch, heads, cfg: UNetConfig):
    return Transformer2DModel(ch, cfg.cross_attention_dim, heads,
                              cfg.norm_num_groups, cfg.flash_attention,
                              cfg.use_linear_projection)


def cast_weights(module: nn.Module, dtype: torch.dtype,
                 round_to_bf16: bool = False) -> nn.Module:
    """Cast a model's weights to `dtype`, keeping every GroupNormAct's
    parameters float32 (the op reads them as f32 and its statistics are
    f32 whatever the activation's type). With `round_to_bf16`, every
    floating parameter, the GroupNormAct ones included, is first rounded
    through bfloat16 (the reference's `half_precision_weights` storage)."""
    norm = {id(p) for m in module.modules() if isinstance(m, GroupNormAct)
            for p in m.parameters()}
    with torch.no_grad():
        for p in module.parameters():
            if not p.is_floating_point():
                continue
            if round_to_bf16:
                p.copy_(p.to(torch.bfloat16))
            p.data = p.data.to(torch.float32 if id(p) in norm else dtype)
    return module


def _down_blocks(cfg: UNetConfig, count: int) -> nn.ModuleList:
    """The first `count` down blocks."""
    chs = cfg.block_out_channels
    n = len(chs)
    return nn.ModuleList(
        [DownBlock(chs[max(i - 1, 0)], chs[i], cfg.time_embed_dim,
                   cfg.down_block_has_attn[i], cfg.attn_heads[i], i < n - 1,
                   cfg)
         for i in range(count)]
    )


def _up_blocks(cfg: UNetConfig, first: int) -> nn.ModuleList:
    """Up blocks `first` .. n - 1, with diffusers' skip-channel bookkeeping:
    the channels are reversed and each block takes layers_per_block + 1
    skips off the stack."""
    chs = list(cfg.block_out_channels)
    n = len(chs)
    rev = list(reversed(chs))
    rev_attn = list(reversed(cfg.down_block_has_attn))
    rev_heads = list(reversed(cfg.attn_heads))
    skips = [chs[0]]  # bottom of the stack first
    for i in range(n):
        skips += [chs[i]] * cfg.layers_per_block
        if i < n - 1:
            skips.append(chs[i])
    take = cfg.layers_per_block + 1
    blocks = []
    for i in range(n):
        skip_chs = list(reversed(skips[-take:]))
        skips = skips[:-take]
        if i >= first:
            blocks.append(UpBlock(
                rev[max(i - 1, 0)], skip_chs, rev[i], cfg.time_embed_dim,
                rev_attn[i], rev_heads[i], i < n - 1, cfg))
    return nn.ModuleList(blocks)


def _stem(x, dtype):
    """[B, h, w, C] -> channels-first in the channels_last memory format."""
    return x.to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


class SingleUNet(nn.Module):
    """The plain diffusers UNet2DConditionModel: no depth branch, no size
    micro-conditioning; `encoder_hid_proj` maps the text embeddings to the
    cross-attention width when `cfg.encoder_hid_dim` is set."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        chs = list(cfg.block_out_channels)
        n = len(chs)
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chs[0], cfg.time_embed_dim)
        self.encoder_hid_proj = (
            nn.Linear(cfg.encoder_hid_dim, cfg.cross_attention_dim)
            if cfg.encoder_hid_dim is not None else None)
        self.down_blocks = _down_blocks(cfg, n)
        self.mid_block = MidBlock(chs[-1], cfg.time_embed_dim,
                                  cfg.attn_heads[-1], cfg)
        self.up_blocks = _up_blocks(cfg, 0)
        self.conv_norm_out = GroupNormAct(g, chs[0], eps=1e-5, silu=True)
        self.conv_out = nn.Conv2d(chs[0], cfg.out_channels, 3, padding=1)
        cast_weights(self, cfg.dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(self, sample, timesteps, encoder_hidden_states,
                down_residuals=None, mid_residual=None):
        """sample [B, h, w, in_channels], timesteps [B],
        encoder_hidden_states [B, L, encoder_hid_dim or
        cross_attention_dim] -> [B, h, w, out_channels] float32.
        `down_residuals` (one [B, h_i, w_i, C_i] per skip, conv_in's
        first) and `mid_residual` are added to the skips and to the mid
        block's output (ControlNet injection, guidance/controlnet.py)."""
        cfg = self.cfg
        dtype = self.dtype
        emb = self.time_embedding(sinusoidal_embedding(
            timesteps, cfg.block_out_channels[0]).to(dtype))
        context = encoder_hidden_states.to(dtype)
        if self.encoder_hid_proj is not None:
            context = self.encoder_hid_proj(context)
        h = self.conv_in(_stem(sample, dtype))
        res = [h]
        for blk in self.down_blocks:
            h, rs = blk(h, emb, context)
            res += rs
        h = self.mid_block(h, emb, context)
        if down_residuals is not None:
            if len(down_residuals) != len(res):
                raise ValueError(f"{len(down_residuals)} down residuals for "
                                 f"{len(res)} skips")
            res = [r + d.permute(0, 3, 1, 2).to(dtype)
                   for r, d in zip(res, down_residuals)]
        if mid_residual is not None:
            h = h + mid_residual.permute(0, 3, 1, 2).to(dtype)
        for blk in self.up_blocks:
            h = blk(h, res, emb, context)
        out = self.conv_out(self.conv_norm_out(h)).float()
        return out.permute(0, 2, 3, 1)


SD2_SINGLE_CONFIG = dataclasses.replace(SD2_BASE_CONFIG, in_channels=4)

TINY_SINGLE_CONFIG = dataclasses.replace(TINY_TEST_CONFIG, in_channels=4)


class DualBranchUNet(nn.Module):
    def __init__(self, cfg: UNetConfig = SD2_BASE_CONFIG):
        super().__init__()
        if cfg.fusion not in ("avg", "sum", "learn"):
            raise ValueError(
                f"unknown fusion {cfg.fusion!r}; expected avg, sum or learn")
        self.cfg = cfg
        chs = list(cfg.block_out_channels)
        n = len(chs)
        temb_dim = cfg.time_embed_dim
        g = cfg.norm_num_groups
        bn = cfg.branch_num

        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.conv_in_branch = nn.ModuleList(
            [nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
             for _ in range(bn)]
        )
        self.time_embedding = TimestepEmbedding(chs[0], temb_dim)
        self.add_embedding = TimestepEmbedding(
            cfg.addition_time_embed_dim * cfg.num_time_ids, temb_dim
        ) if cfg.num_time_ids else None
        if cfg.fusion == "learn":
            fused = chs[cfg.copy_first_n_block - 1]
            self.fusion_conv = nn.Conv2d((1 + bn) * fused, fused, 3,
                                         padding=1)

        self.down_blocks = _down_blocks(cfg, n)
        self.down_blocks_branch = nn.ModuleList(
            [_down_blocks(cfg, cfg.copy_first_n_block) for _ in range(bn)]
        )
        self.mid_block = MidBlock(chs[-1], temb_dim, cfg.attn_heads[-1], cfg)
        self.up_blocks = _up_blocks(cfg, 0)
        self.up_blocks_branch = nn.ModuleList(
            [_up_blocks(cfg, n - cfg.copy_last_n_block) for _ in range(bn)]
        )

        self.conv_norm_out = GroupNormAct(g, chs[0], eps=1e-5, silu=True)
        self.conv_out = nn.Conv2d(chs[0], cfg.out_channels, 3, padding=1)
        self.conv_norm_out_branch = nn.ModuleList(
            [GroupNormAct(g, chs[0], eps=1e-5, silu=True) for _ in range(bn)]
        )
        self.conv_out_branch = nn.ModuleList(
            [nn.Conv2d(chs[0], cfg.out_channels, 3, padding=1)
             for _ in range(bn)]
        )
        cast_weights(self, cfg.dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(self, sample, sample_branch, timesteps,
                encoder_hidden_states, time_ids):
        """sample [B, h, w, in_channels]: the noisy rgb latent with the pose
        latent appended; sample_branch: the same for the depth latent, or a
        list of `branch_num` such inputs; timesteps [B];
        encoder_hidden_states [B, L, cross_attention_dim]; time_ids
        [B, num_time_ids]. Returns [B, h, w, (1 + branch_num) *
        out_channels] float32: the rgb prediction, then each branch's."""
        cfg = self.cfg
        dtype = self.dtype
        n = len(cfg.block_out_channels)
        first_n, last_n = cfg.copy_first_n_block, cfg.copy_last_n_block
        b = time_ids.shape[0]
        branches = (list(sample_branch)
                    if isinstance(sample_branch, (list, tuple))
                    else [sample_branch])
        if len(branches) != cfg.branch_num:
            raise ValueError(f"got {len(branches)} branch inputs for "
                             f"branch_num={cfg.branch_num}")

        emb = self.time_embedding(sinusoidal_embedding(
            timesteps, cfg.block_out_channels[0]).to(dtype))
        if self.add_embedding is not None:
            size_emb = sinusoidal_embedding(
                time_ids.reshape(-1), cfg.addition_time_embed_dim
            ).reshape(b, cfg.num_time_ids * cfg.addition_time_embed_dim)
            emb = emb + self.add_embedding(size_emb.to(dtype))
        context = encoder_hidden_states.to(dtype)

        h = self.conv_in(_stem(sample, dtype))
        h_brs = [conv(_stem(x, dtype))
                 for conv, x in zip(self.conv_in_branch, branches)]
        res_main = [h]
        res_brs = [[hb] for hb in h_brs]
        for blk in self.down_blocks[:first_n]:
            h, rs = blk(h, emb, context)
            res_main += rs
        for i, blocks in enumerate(self.down_blocks_branch):
            for blk in blocks:
                h_brs[i], rs = blk(h_brs[i], emb, context)
                res_brs[i] += rs

        if cfg.fusion == "learn":
            h = self.fusion_conv(torch.cat([h, *h_brs], dim=1))
        else:
            h = sum(h_brs, h)
            if cfg.fusion == "avg":
                h = h / (1.0 + cfg.branch_num)

        for blk in self.down_blocks[first_n:]:
            h, rs = blk(h, emb, context)
            res_main += rs
            for rb in res_brs:
                rb += rs

        h = self.mid_block(h, emb, context)

        layers_up = cfg.layers_per_block + 1
        for blk in self.up_blocks[: n - last_n]:
            h = blk(h, res_main, emb, context)
            for rb in res_brs:  # the branch stacks pop in lockstep
                del rb[-layers_up:]

        h_bs = []
        for i, blocks in enumerate(self.up_blocks_branch):
            h_b = h
            for blk in blocks:
                h_b = blk(h_b, res_brs[i], emb, context)
            h_bs.append(h_b)
        for blk in self.up_blocks[n - last_n:]:
            h = blk(h, res_main, emb, context)

        outs = [self.conv_out(self.conv_norm_out(h)).float()]
        outs += [conv(norm(h_b)).float() for conv, norm, h_b in zip(
            self.conv_out_branch, self.conv_norm_out_branch, h_bs)]
        return torch.cat(outs, dim=1).permute(0, 2, 3, 1)
