"""LPIPS perceptual distance (VGG16 backbone).

Port of humangaussian_tpu/perceptual.py (itself a port of the vendored
lpipsPyTorch used by the PSNR / SSIM / LPIPS eval protocol): VGG16 feature
taps after relu{1_2,2_2,3_3,4_3,5_3}, channel-unit-normalized differences
weighted by 1x1 "lin" layers, averaged over space and summed over taps.

The modules work in NCHW (the JAX module in NHWC). `VGG16Features.features`
is laid out as torchvision's `vgg16().features` up to conv5_3, so a
torchvision state dict loads under its own names. Weights are not bundled:
`load_lpips_params` builds the `LPIPS` state dict from a torchvision VGG16
state dict and the lpips lin weights (dicts or local files); without lin
weights each lin layer is 1/C, as in the JAX module. With seeded weights
the module still defines a valid (untrained) perceptual metric.
"""
from __future__ import annotations

import torch
from torch import nn

# VGG16 conv plan: (out_channels, layers) per stage; a tap after each stage
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# the torchvision `features` index of each conv, in order
VGG_CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
# the `features` index of each stage's last ReLU, whose output is a tap
VGG_TAP_IDS = (3, 8, 15, 22, 29)

# ImageNet normalization as used by lpips' scaling layer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16 up to conv5_3 (torchvision `features[:30]`), returning the 5
    LPIPS taps."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for si, (ch, n) in enumerate(VGG_STAGES):
            for _ in range(n):
                layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
                cin = ch
            if si + 1 < len(VGG_STAGES):
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> list:
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in VGG_TAP_IDS:
                taps.append(x)
        return taps


class LPIPS(nn.Module):
    """lpips(x, y) -> [B] for [B,3,H,W] inputs in [0, 1]."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (ch, _) in enumerate(VGG_STAGES):
            lin = nn.Conv2d(ch, 1, 1, bias=False)
            nn.init.constant_(lin.weight, 1.0 / ch)
            self.add_module(f"lin{i}", lin)
        self.register_buffer(
            "shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1),
            persistent=False)
        self.register_buffer(
            "scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1),
            persistent=False)

    def _prep(self, img):
        return (img * 2.0 - 1.0 - self.shift) / self.scale  # lpips: [-1, 1]

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.vgg(self._prep(x))
        fy = self.vgg(self._prep(y))
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin{i}")((a - b) ** 2)
            total = total + w.mean(dim=(1, 2, 3))
        return total


def _state(src) -> dict:
    if src is None or isinstance(src, dict):
        return src or {}
    return torch.load(src, map_location="cpu", weights_only=True)


def load_lpips_params(vgg_state_dict, lin_state_dict=None) -> dict:
    """A torchvision VGG16 state dict (keys `features.{i}.weight / .bias`)
    plus the optional lpips lin weights (keys `lin{i}.model.1.weight`),
    each a dict or a file `torch.load` reads, -> the `LPIPS` state dict.
    A lin layer the weights lack is 1/C."""
    vgg, lins = _state(vgg_state_dict), _state(lin_state_dict)
    sd = {}
    for tid in VGG_CONV_IDS:
        for leaf in ("weight", "bias"):
            sd[f"vgg.features.{tid}.{leaf}"] = torch.as_tensor(
                vgg[f"features.{tid}.{leaf}"], dtype=torch.float32)
    for i, (ch, _) in enumerate(VGG_STAGES):
        key = f"lin{i}.model.1.weight"
        sd[f"lin{i}.weight"] = (
            torch.as_tensor(lins[key], dtype=torch.float32) if key in lins
            else torch.full((1, ch, 1, 1), 1.0 / ch))
    return sd

