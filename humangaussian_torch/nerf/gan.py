"""GAN volume renderer: a low-resolution NeRF and a VQGAN-style upsampling
generator.

Port of humangaussian_tpu/nerf/gan.py (the reference's
`gan-volume-renderer` and its GAN network zoo):

- `GResBlock`: norm, swish, conv twice, with the 64-wide global code
  projected and added after the first conv (`temb`);
- `LocalEncoder` (the GAN VAE's encoder: mean | logvar at 1/4 size),
  `Generator` (its decoder: [lr rgb | z] at 1/4 size, upsampled through
  code-conditioned blocks to a logit-space residual on the bilinearly
  upsampled low-resolution rgb), `GlobalEncoder` (MobileNetV3 blocks,
  `_InvertedResidual`, to a 64-wide code of a 224^2 view),
  `NLayerDiscriminator` (the PatchGAN with GroupNorm, as the JAX module);
- the diagonal-Gaussian functions and the hinge losses;
- `GANVolumeRenderer`: the base renderer at 1/scale of the resolution
  with a latent-emitting material (3 rgb + 2 z channels, with
  `hybrid-rgb-latent-material`), decoded to full resolution; with
  `multi_level_guidance` and a ground truth, one of three generator
  levels: (0) z sampled from the render's posterior, coded from the
  low-resolution rgb; (1) the same z coded from the ground truth; (2) z
  sampled from the local encoder's posterior of the ground truth.

What the port does differently:

- Every GroupNorm (Flax `GroupNorm`, eps 1e-6, the JAX module's group
  count: min(32, C) lowered until it divides C) is the port's
  `GroupNormAct`, with the SiLU fused where a swish follows: on the card
  its forward launches the GroupNorm forward kernel once and its
  backward K5 and K5a.
- Flax's convolutions pad "SAME": (k - 1) split with the smaller half
  first, after the stride is accounted for. For a stride-2 3 x 3 conv on
  an even size that is (0, 1), not torch's (1, 1); the discriminator's 4
  x 4 convs pad (1, 1) at stride 2 and (1, 2) at stride 1. `SameConv2d`
  pads explicitly where the two sides differ.
- `jax.image.resize` is `resize_bilinear` (antialiased when it shrinks,
  as JAX's is) and, for the 2x "nearest" upsample, `F.interpolate`
  nearest, which picks the same source pixels.
- The level switch and both posterior samples draw from a
  `torch.Generator` after the base render's draws (level, then z, then
  level 2's z), or are injected (`level=`, `z_eps=`, `z2_eps=`); the
  level is a host integer, as in the reference's torch code, where the
  JAX module switches inside jit.
- The networks run channels-first in the `channels_last` memory format;
  they take and return channel-minor `[B, H, W, C]` tensors, as the JAX
  modules do. Parameter names are the port's (`convert.py::
  gan_state_dict_from_flax` maps Flax's automatic names onto them).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from humangaussian_torch import resolve_device
from humangaussian_torch.guidance.dual_branch import resize_bilinear
from humangaussian_torch.ops.groupnorm import GroupNormAct


def norm_groups(channels: int) -> int:
    """The JAX module's group count: min(32, C), lowered until it divides
    C."""
    g = min(32, channels)
    while channels % g:
        g -= 1
    return g


def _norm(channels: int, silu: bool = False) -> GroupNormAct:
    return GroupNormAct(norm_groups(channels), channels, eps=1e-6, silu=silu)


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """nn.Conv2d with Flax's "SAME" padding, computed from the input's
    size."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, groups=1,
                 bias=True):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         groups=groups, bias=bias)

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = _same_pad(x.shape[2], kh, sh)
        left, right = _same_pad(x.shape[3], kw, sw)
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (top, left), 1, self.groups)
        return F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight,
                        self.bias, self.stride, 0, 1, self.groups)


def _nchw(x):
    """[B, H, W, C] -> a channels_last [B, C, H, W] (a view when x is
    contiguous)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class GResBlock(nn.Module):
    """norm-swish-conv x2, the code projected after the first conv when
    `temb`, a 1 x 1 shortcut when the width changes."""

    def __init__(self, in_ch: int, out_ch: int, temb: bool = False,
                 code_dim: int = 64):
        super().__init__()
        self.norm1 = _norm(in_ch, silu=True)
        self.conv1 = SameConv2d(in_ch, out_ch, 3)
        self.temb_proj = nn.Linear(code_dim, out_ch) if temb else None
        self.norm2 = _norm(out_ch, silu=True)
        self.conv2 = SameConv2d(out_ch, out_ch, 3)
        self.nin_shortcut = (nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch
                             else None)

    def forward(self, x, code=None):
        h = self.conv1(self.norm1(x))
        if self.temb_proj is not None and code is not None:
            h = h + self.temb_proj(F.silu(code))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class LocalEncoder(nn.Module):
    """conv_in, a ch_mult pyramid of resnet blocks with stride-2 convs
    between levels, two more blocks, norm / swish / conv_out to 2 z
    channels (mean | logvar)."""

    def __init__(self, ch: int = 32, ch_mult: Sequence[int] = (1, 2, 4),
                 num_res_blocks: int = 1, z_channels: int = 4,
                 in_channels: int = 3):
        super().__init__()
        self.conv_in = SameConv2d(in_channels, ch, 3)
        blocks, resamples = [], []
        width = ch
        for i, mult in enumerate(ch_mult):
            for _ in range(num_res_blocks):
                blocks.append(GResBlock(width, ch * mult))
                width = ch * mult
            if i != len(ch_mult) - 1:
                resamples.append(SameConv2d(width, width, 3, stride=2))
        blocks += [GResBlock(width, width), GResBlock(width, width)]
        self.blocks = nn.ModuleList(blocks)
        self.resamples = nn.ModuleList(resamples)
        self.levels = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.norm_out = _norm(width, silu=True)
        self.conv_out = SameConv2d(width, 2 * z_channels, 3)

    def forward(self, x):
        """[B, H, W, 3] -> [B, H / 2^(L-1), W / 2^(L-1), 2 z]."""
        h = self.conv_in(_nchw(x))
        k = 0
        for i in range(self.levels):
            for _ in range(self.num_res_blocks):
                h = self.blocks[k](h)
                k += 1
            if i != self.levels - 1:
                h = self.resamples[i](h)
        h = self.blocks[k + 1](self.blocks[k](h))
        return _nhwc(self.conv_out(self.norm_out(h)))


class Generator(nn.Module):
    """[lr rgb (3) | z] at 1/4 size -> the full-size rgb: conv_in, per
    level (top down) num_res_blocks + 1 code-conditioned blocks and a
    nearest 2x upsample + conv between levels, norm / swish / conv_out to
    a residual added in logit space to the bilinearly upsampled rgb."""

    def __init__(self, ch: int = 64, ch_mult: Sequence[int] = (1, 2, 4),
                 num_res_blocks: int = 1, z_channels: int = 4,
                 out_ch: int = 3, code_dim: int = 64):
        super().__init__()
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        width = ch * ch_mult[-1]
        self.conv_in = SameConv2d(3 + z_channels, width, 3)
        blocks, resamples = [], []
        for i_level in reversed(range(len(ch_mult))):
            for _ in range(num_res_blocks + 1):
                blocks.append(GResBlock(width, ch * ch_mult[i_level],
                                        temb=True, code_dim=code_dim))
                width = ch * ch_mult[i_level]
            if i_level != 0:
                resamples.append(SameConv2d(width, width, 3))
        self.blocks = nn.ModuleList(blocks)
        self.resamples = nn.ModuleList(resamples)
        self.norm_out = _norm(width, silu=True)
        self.conv_out = SameConv2d(width, out_ch, 3)

    def forward(self, z, code):
        """z [B, h, w, 3 + z_channels], code [B, code_dim] -> [B, h s,
        w s, 3] in (0, 1), s = 2^(levels - 1)."""
        rgb = z[..., :3]
        h = self.conv_in(_nchw(z))
        k = 0
        for j, i_level in enumerate(reversed(range(len(self.ch_mult)))):
            for _ in range(self.num_res_blocks + 1):
                h = self.blocks[k](h, code)
                k += 1
            if i_level != 0:
                h = self.resamples[j](
                    F.interpolate(h, scale_factor=2.0, mode="nearest"))
        h = _nhwc(self.conv_out(self.norm_out(h)))
        scale = 2 ** (len(self.ch_mult) - 1)
        rgb_up = resize_bilinear(rgb, (rgb.shape[1] * scale,
                                       rgb.shape[2] * scale))
        c = rgb_up.clamp(1e-3, 1 - 1e-3)
        return torch.sigmoid(torch.log(c / (1.0 - c)) + h)


class _InvertedResidual(nn.Module):
    """MobileNetV3 bneck: 1 x 1 expand, depthwise 3 x 3 (stride), squeeze-
    excite, 1 x 1 project, each conv followed by a norm (hard swish after
    the first two); a residual when the stride is 1 and the width stays."""

    def __init__(self, in_ch: int, out_ch: int, exp: int, stride: int = 1,
                 se: bool = True):
        super().__init__()
        self.residual = stride == 1 and in_ch == out_ch
        self.expand = nn.Conv2d(in_ch, exp, 1, bias=False)
        self.norm_expand = _norm(exp)
        self.depthwise = SameConv2d(exp, exp, 3, stride=stride, groups=exp,
                                    bias=False)
        self.norm_depthwise = _norm(exp)
        if se:
            self.se_reduce = nn.Linear(exp, max(exp // 4, 8))
            self.se_expand = nn.Linear(max(exp // 4, 8), exp)
        else:
            self.se_reduce = self.se_expand = None
        self.project = nn.Conv2d(exp, out_ch, 1, bias=False)
        self.norm_project = _norm(out_ch)

    def forward(self, x):
        h = F.hardswish(self.norm_expand(self.expand(x)))
        h = F.hardswish(self.norm_depthwise(self.depthwise(h)))
        if self.se_reduce is not None:
            s = F.relu(self.se_reduce(h.mean(dim=(2, 3))))
            h = h * F.hardsigmoid(self.se_expand(s))[:, :, None, None]
        h = self.norm_project(self.project(h))
        return h + x if self.residual else h


# (out channels, expansion, stride) of the global encoder's bnecks
_MOBILENET_BLOCKS = ((16, 16, 2), (24, 72, 2), (24, 88, 1), (40, 96, 2),
                     (48, 144, 1), (96, 288, 2))


class GlobalEncoder(nn.Module):
    """MobileNetV3 (n_class = code_dim): the global style code of a 224^2
    view of the image."""

    def __init__(self, code_dim: int = 64, in_channels: int = 3):
        super().__init__()
        self.conv_stem = SameConv2d(in_channels, 16, 3, stride=2, bias=False)
        self.norm_stem = _norm(16)
        blocks, width = [], 16
        for out_ch, exp, stride in _MOBILENET_BLOCKS:
            blocks.append(_InvertedResidual(width, out_ch, exp, stride))
            width = out_ch
        self.blocks = nn.ModuleList(blocks)
        self.conv_head = nn.Conv2d(width, 576, 1, bias=False)
        self.norm_head = _norm(576)
        self.fc1 = nn.Linear(576, 256)
        self.fc2 = nn.Linear(256, code_dim)

    def forward(self, x):
        """[B, H, W, 3] -> [B, code_dim]."""
        h = F.hardswish(self.norm_stem(self.conv_stem(_nchw(x))))
        for blk in self.blocks:
            h = blk(h)
        h = F.hardswish(self.norm_head(self.conv_head(h))).mean(dim=(2, 3))
        return self.fc2(F.hardswish(self.fc1(h)))


class NLayerDiscriminator(nn.Module):
    """PatchGAN: 4 x 4 convs (stride 2, the last hidden one stride 1) with
    leaky ReLU, then 1-channel patch logits."""

    def __init__(self, ndf: int = 64, n_layers: int = 3,
                 in_channels: int = 3):
        super().__init__()
        self.conv_in = SameConv2d(in_channels, ndf, 4, stride=2)
        convs, norms, width = [], [], ndf
        for n in range(1, n_layers + 1):
            out = ndf * min(2 ** n, 8)
            convs.append(SameConv2d(width, out, 4,
                                    stride=2 if n < n_layers else 1,
                                    bias=False))
            norms.append(_norm(out))
            width = out
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        self.conv_out = SameConv2d(width, 1, 4)

    def forward(self, x):
        """[B, H, W, C] -> patch logits [B, h, w, 1]."""
        h = F.leaky_relu(self.conv_in(_nchw(x)), 0.2)
        for conv, norm in zip(self.convs, self.norms):
            h = F.leaky_relu(norm(conv(h)), 0.2)
        return _nhwc(self.conv_out(h))


# ---- the diagonal Gaussian (pure functions) -------------------------------


def diag_gaussian_split(params):
    """params [..., 2z] -> (mean, logvar) with logvar clamped to [-30,
    20]."""
    mean, logvar = params.chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


def diag_gaussian_sample(params, generator=None, eps=None):
    """mean + exp(logvar / 2) eps; eps drawn from `generator` unless
    given."""
    mean, logvar = diag_gaussian_split(params)
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                          device=mean.device)
    return mean + torch.exp(0.5 * logvar) * eps


def diag_gaussian_mode(params):
    return diag_gaussian_split(params)[0]


def diag_gaussian_kl(params):
    """KL to the standard normal, summed over all but the batch axis."""
    mean, logvar = diag_gaussian_split(params)
    kl = 0.5 * (mean ** 2 + torch.exp(logvar) - 1.0 - logvar)
    return kl.flatten(1).sum(dim=1)


# ---- hinge GAN losses -------------------------------------------------


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (F.relu(1.0 - logits_real).mean()
                  + F.relu(1.0 + logits_fake).mean())


def generator_loss(discriminator, reconstructions):
    return -discriminator(reconstructions).mean()


def discriminator_loss(discriminator, inputs, reconstructions):
    return hinge_d_loss(discriminator(inputs.detach()),
                        discriminator(reconstructions.detach()))


@dataclasses.dataclass(frozen=True)
class GANRendererConfig:
    ch_mult: Sequence[int] = (1, 2, 4)
    z_channels: int = 4
    code_dim: int = 64


class GANVolumeRenderer:
    """The base renderer at H / scale with a latent-emitting material,
    decoded to full resolution by the generator. `base` is a NeRF renderer
    (`render_image(c2w, fovy, h, w, generator=...)`) whose comp_rgb
    carries 3 + 2 z_channels channels. `nets` holds the four networks
    (generator, local_encoder, global_encoder, discriminator), built with
    torch's initializers on `device`."""

    def __init__(self, base, cfg: GANRendererConfig = GANRendererConfig(),
                 device="cuda"):
        self.base = base
        self.cfg = cfg
        z = cfg.z_channels
        self.generator = Generator(ch=64, ch_mult=tuple(cfg.ch_mult),
                                   z_channels=z, code_dim=cfg.code_dim)
        self.local_encoder = LocalEncoder(ch=32, ch_mult=tuple(cfg.ch_mult),
                                          z_channels=z)
        self.global_encoder = GlobalEncoder(cfg.code_dim)
        self.discriminator = NLayerDiscriminator()
        self.nets = nn.ModuleDict({
            "generator": self.generator,
            "local_encoder": self.local_encoder,
            "global_encoder": self.global_encoder,
            "discriminator": self.discriminator,
        }).to(resolve_device(device), memory_format=torch.channels_last)

    @property
    def scale_ratio(self) -> int:
        return 2 ** (len(self.cfg.ch_mult) - 1)

    def _decode(self, lr_rgb, z_map, code_src):
        code = self.global_encoder(resize_bilinear(code_src, 224))
        return self.generator(torch.cat([lr_rgb, z_map], dim=-1), code)

    def render_image(self, c2w, fovy, height: int, width: int,
                     generator=None, gt_rgb=None,
                     multi_level_guidance: bool = False, level=None,
                     z_eps=None, z2_eps=None, **kwargs) -> dict:
        """One camera (c2w [4, 4]; outputs [H, W, ...]) or a batch (c2w
        [B, 4, 4], fovy [B]; gt_rgb [B, H, W, 3]). The base render's
        outputs plus comp_lr_rgb, comp_gan_rgb, comp_rgb (the low-
        resolution rgb upsampled), posterior_kl and generator_level. With
        `multi_level_guidance` and `gt_rgb`, the level and the posterior
        samples come from `generator` (or are injected); otherwise z is
        the posterior's mode and the level 0."""
        s = self.scale_ratio
        out = self.base.render_image(c2w, fovy, height // s, width // s,
                                     generator=generator, **kwargs)
        single = out["comp_rgb"].dim() == 3
        full = out["comp_rgb"][None] if single else out["comp_rgb"]
        lr_rgb, latent = full[..., :3], full[..., 3:]
        drawn = generator is not None or level is not None
        if multi_level_guidance and gt_rgb is not None and drawn:
            gt = gt_rgb[None] if single else gt_rgb
            dev = latent.device
            if level is None:
                level = int(torch.randint(0, 3, (), generator=generator,
                                          device=generator.device))
            z_map = diag_gaussian_sample(latent, generator, z_eps)
            if level == 0:
                gan_rgb = self._decode(lr_rgb, z_map, lr_rgb)
            elif level == 1:
                gan_rgb = self._decode(lr_rgb, z_map, gt)
            else:
                enc = self.local_encoder(gt.to(dev))
                z2 = diag_gaussian_sample(enc, generator, z2_eps)
                gan_rgb = self._decode(lr_rgb, z2, gt)
        else:
            level = 0
            gan_rgb = self._decode(lr_rgb, diag_gaussian_mode(latent),
                                   lr_rgb)
        kl = diag_gaussian_kl(latent)
        comp_rgb = resize_bilinear(lr_rgb, (height, width))
        if single:
            lr_rgb, gan_rgb, comp_rgb, kl = (lr_rgb[0], gan_rgb[0],
                                             comp_rgb[0], kl[0])
        out.update(comp_lr_rgb=lr_rgb, comp_gan_rgb=gan_rgb,
                   comp_rgb=comp_rgb, posterior_kl=kl,
                   generator_level=int(level))
        return out
