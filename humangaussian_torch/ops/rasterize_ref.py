"""Brute-force oracle rasterizer: exact compositing semantics, any device.

Port of humangaussian_tpu/ops/rasterize_ref.py. O(N * pixels): every pixel
scans every Gaussian in depth order, in chunks, with the CUDA renderCUDA
per-pixel semantics expressed as a log-transmittance recurrence:

  pass_i  = (power_i <= 0) & (alpha_i >= 1/255) & (pixel in tile-rect_i)
  T_i     = prod_{j<i, contrib_j} (1 - alpha_j)
  trigger = pass_i & (T_i (1 - alpha_i) < 1e-4)      (the CUDA "done")
  contrib = pass_i & no trigger at any j <= i        (latched stop)
  C      += T_i alpha_i c_i  [rgb, depth];  final T -> alpha, background

It shares no code with binning or the compositing kernels, which makes it
the ground truth for the whole tiled render: its outputs for the forward,
torch autograd through it for the six gradients.
"""
from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from humangaussian_torch.core.camera import Camera
from humangaussian_torch.ops.projection import (
    ProjectedGaussians,
    RasterizeConfig,
    project_gaussians,
)


def depth_order(prims: ProjectedGaussians) -> torch.Tensor:
    """Gaussian indices by view depth, invisible last, ties by index."""
    key = torch.where(prims.visible, prims.depths, float("inf"))
    return torch.sort(key, stable=True).indices


def rasterize_prims(prims: ProjectedGaussians, order: torch.Tensor,
                    background: torch.Tensor, height: int, width: int,
                    cfg: RasterizeConfig, chunk: int = 256):
    """Composite depth-ordered primitives over every pixel.
    Returns (image [H,W,3], depth [H,W], alpha [H,W]). Differentiable by
    torch autograd (the gradient oracle): when a gradient is wanted, each
    chunk is checkpointed, so its [pixels, chunk] intermediates are
    recomputed in the backward instead of kept and the memory of a
    gradient stays that of one chunk."""
    dev = prims.depths.device
    p = height * width
    mxy = prims.means2d[order]
    con = prims.conics[order]
    col = prims.rgb[order]
    opa = prims.opacities[order]
    dep = prims.depths[order]
    rct = prims.rect[order]
    vis = prims.visible[order]

    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    pix_x = xs.reshape(p).to(torch.float32)
    pix_y = ys.reshape(p).to(torch.float32)
    pix_tx = (xs // cfg.tile).reshape(p)
    pix_ty = (ys // cfg.tile).reshape(p)
    log_eps = math.log(cfg.transmittance_eps)

    def step(log_t, done, acc, c_mxy, c_con, c_col, c_opa, c_dep, c_rct,
             c_vis):
        dx = c_mxy[:, 0][None, :] - pix_x[:, None]  # [P, G]
        dy = c_mxy[:, 1][None, :] - pix_y[:, None]
        power = (
            -0.5 * (c_con[:, 0][None] * dx * dx + c_con[:, 2][None] * dy * dy)
            - c_con[:, 1][None] * dx * dy
        )
        alpha = torch.clamp_max(
            c_opa[None, :] * torch.exp(torch.clamp_max(power, 0.0)),
            cfg.alpha_max,
        )
        in_rect = (
            (pix_tx[:, None] >= c_rct[None, :, 0])
            & (pix_tx[:, None] < c_rct[None, :, 2])
            & (pix_ty[:, None] >= c_rct[None, :, 1])
            & (pix_ty[:, None] < c_rct[None, :, 3])
        )
        pass_ = (c_vis[None, :] & in_rect & (power <= 0.0)
                 & (alpha >= cfg.alpha_min))
        log1ma = torch.where(
            pass_, torch.log1p(-torch.where(pass_, alpha, 0.0)), 0.0
        )
        cum = torch.cumsum(log1ma, dim=1)
        log_t_before = log_t[:, None] + cum - log1ma
        trigger = pass_ & (log_t_before + log1ma < log_eps)
        done_upto = done[:, None] | (torch.cumsum(trigger.to(torch.int32),
                                                  dim=1) > 0)
        contrib = pass_ & ~done_upto
        w = torch.where(contrib, torch.exp(log_t_before) * alpha, 0.0)
        g = c_mxy.shape[0]
        feats = torch.cat(
            [c_col, c_dep[:, None],
             torch.ones((g, 1), dtype=torch.float32, device=dev)], dim=1
        )
        return (log_t + torch.where(contrib, log1ma, 0.0).sum(dim=1),
                done_upto[:, -1], acc + w @ feats)

    log_t = torch.zeros((p,), dtype=torch.float32, device=dev)
    done = torch.zeros((p,), dtype=torch.bool, device=dev)
    acc = torch.zeros((p, 5), dtype=torch.float32, device=dev)
    n = order.shape[0]
    checkpoint = torch.is_grad_enabled() and any(
        x.requires_grad for x in (mxy, con, col, opa, dep))
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(c0 + chunk, n))
        args = (log_t, done, acc, mxy[sl], con[sl], col[sl], opa[sl], dep[sl],
                rct[sl], vis[sl])
        if checkpoint:
            log_t, done, acc = torch.utils.checkpoint.checkpoint(
                step, *args, use_reentrant=False)
        else:
            log_t, done, acc = step(*args)

    t_final = torch.exp(log_t)
    image = acc[:, :3] + t_final[:, None] * background[None, :]
    return (
        image.reshape(height, width, 3),
        acc[:, 3].reshape(height, width),
        (1.0 - t_final).reshape(height, width),
    )


def rasterize_reference(
    means,
    scales,
    quats,
    features,
    opacities,
    alive,
    camera: Camera,
    background: torch.Tensor,
    sh_degree: int = 0,
    cfg: RasterizeConfig = RasterizeConfig(),
    scale_modifier: float = 1.0,
    means2d_offset: torch.Tensor | None = None,
    chunk: int = 256,
) -> dict:
    """Oracle render: image [H,W,3], depth [H,W], alpha [H,W], radii [N]
    int32, visible [N]."""
    prims = project_gaussians(
        means, scales, quats, features, opacities, alive, camera,
        sh_degree, cfg, scale_modifier, means2d_offset,
    )
    order = depth_order(prims)
    image, depth_img, alpha_img = rasterize_prims(
        prims, order, background.to(torch.float32), camera.height,
        camera.width, cfg, chunk,
    )
    return {
        "image": image,
        "depth": depth_img,
        "alpha": alpha_img,
        "radii": prims.radii,
        "visible": prims.visible,
    }
