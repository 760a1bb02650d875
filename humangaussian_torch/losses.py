"""Photometric losses and metrics: L1, L2, SSIM (11x11 Gaussian), PSNR.

Port of humangaussian_tpu/losses.py, used by the photo-supervised 3DGS
trainer (train/photo.py) and its PSNR / SSIM evaluation. Images are
[H,W,C] or [B,H,W,C] float in [0,1] at the interface, as in the JAX
package; `ssim` permutes to torch's NCHW inside.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def psnr(pred, target):
    """Per-batch-mean PSNR."""
    mse = torch.mean((pred - target) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs**2) / (2.0 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM with the 11x11 sigma-1.5 Gaussian window and SAME (zero)
    padding, as a depthwise convolution."""
    if img1.dim() == 3:
        img1 = img1[None]
        img2 = img2[None]
    img1 = img1.permute(0, 3, 1, 2)  # NHWC -> NCHW
    img2 = img2.permute(0, 3, 1, 2)
    c = img1.shape[1]
    win = torch.from_numpy(_gaussian_window(window_size, sigma)).to(
        img1.device, img1.dtype)
    kernel = win[None, None].expand(c, 1, window_size, window_size)

    def blur(x):
        return F.conv2d(x, kernel, padding=window_size // 2, groups=c)

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return torch.mean(ssim_map)


def photometric_loss(pred, target, lambda_dssim: float = 0.2):
    """(1-l)*L1 + l*(1-SSIM), the vanilla 3DGS objective."""
    return (1.0 - lambda_dssim) * l1_loss(pred, target) + lambda_dssim * (
        1.0 - ssim(pred, target)
    )
