"""The plain renderer: projection and binning (frozen copies), then
front-to-back compositing of each tile's depth-sorted pairs, written here
as one differentiable torch function.

For a pixel and its tile's pairs in order, with
power = -(a dx^2 + c dy^2) / 2 - b dx dy and
alpha = min(opacity exp(min(power, 0)), alpha_max), a pair passes when
power <= 0 and alpha >= alpha_min, and contributes while the
transmittance after it stays at or above `transmittance_eps` (upstream
3DGS's early stop). Colour and depth are the contributions weighted by
alpha times the transmittance before the pair; alpha is one minus the
final transmittance; the background fills what is left. The
transmittance is carried as a cumulative sum of log(1 - alpha).

Tiles are served in buckets of similar pair counts, each padded to its
longest list; with gradients each bucket runs under activation
checkpointing, so a batch of 1024^2 views fits.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference.binning import build_pair_lists
from portbench.reference.projection import RasterizeConfig, project_gaussians

BUCKET_ELEMENTS = 1 << 26  # tiles x pixels x pairs of one bucket


def feature_rows(prims) -> torch.Tensor:
    """[N, 10]: mean x, y, conic a, b, c, rgb, opacity, depth."""
    return torch.cat([prims.means2d, prims.conics, prims.rgb,
                      prims.opacities[:, None], prims.depths[:, None]],
                     dim=1).float()


def _bucket(feats, gids, pair_idx, px, py, alpha_min, alpha_max, log_eps):
    """Composite G tiles: pair_idx [G, K] (-1 pads), px / py [G, PIX].
    Returns (rgb + depth [G, PIX, 4], log final transmittance [G, PIX])."""
    valid = pair_idx >= 0
    f = feats[gids[pair_idx.clamp_min(0)].long()]  # [G, K, 10]
    dx = f[:, None, :, 0] - px[:, :, None]  # [G, PIX, K]
    dy = f[:, None, :, 1] - py[:, :, None]
    power = (-0.5 * (f[:, None, :, 2] * dx * dx + f[:, None, :, 4] * dy * dy)
             - f[:, None, :, 3] * dx * dy)
    alpha = torch.clamp_max(
        f[:, None, :, 8] * torch.exp(torch.clamp_max(power, 0.0)), alpha_max)
    passed = valid[:, None, :] & (power <= 0.0) & (alpha >= alpha_min)
    log1ma = torch.where(passed, torch.log1p(-torch.where(passed, alpha, 0.0)),
                         0.0)
    cum = torch.cumsum(log1ma, dim=-1)
    contrib = passed & (cum >= log_eps)
    w = torch.where(contrib, torch.exp(cum - log1ma) * alpha, 0.0)
    rgbd = torch.einsum("gpk,gkc->gpc", w, f[..., [5, 6, 7, 9]])
    return (rgbd, torch.where(contrib, log1ma, 0.0).sum(dim=-1),
            contrib.sum().detach())


def composite(feats, gids, starts, counts, background, tiles_x: int,
              tiles_y: int, cfg: RasterizeConfig, with_grad: bool = False):
    """image [B, H, W, 3], depth [B, H, W], alpha [B, H, W] of the pair
    lists; differentiable in `feats` when `with_grad`."""
    dev = feats.device
    tile = cfg.tile
    pix = tile * tile
    tiles = tiles_x * tiles_y
    n_blocks = counts.shape[0]
    b = n_blocks // tiles
    log_eps = math.log(cfg.transmittance_eps)
    lin = torch.arange(pix, device=dev)
    cnt = counts.cpu().numpy().astype(np.int64)
    st = starts.cpu().numpy().astype(np.int64)
    order = np.argsort(-cnt, kind="stable")
    order = order[cnt[order] > 0]
    rgbd_parts, logt_parts, tile_parts = [], [], []
    contribs = torch.zeros((), dtype=torch.int64, device=dev)
    i = 0
    while i < order.shape[0]:
        k = int(cnt[order[i]])
        g = max(1, min(order.shape[0] - i, BUCKET_ELEMENTS // (pix * k)))
        ids = order[i:i + g]
        i += g
        kk = np.arange(k)
        idx = np.where(kk[None, :] < cnt[ids][:, None],
                       st[ids][:, None] + kk[None, :], -1)
        ids_t = torch.from_numpy(ids).to(dev)
        t_local = ids_t % tiles
        px = ((t_local % tiles_x)[:, None] * tile + lin % tile).float()
        py = ((t_local // tiles_x)[:, None] * tile + lin // tile).float()
        args = (feats, gids, torch.from_numpy(idx).to(dev), px, py,
                cfg.alpha_min, cfg.alpha_max, log_eps)
        if with_grad:
            rgbd, logt, n = checkpoint(_bucket, *args, use_reentrant=False)
        else:
            rgbd, logt, n = _bucket(*args)
        contribs += n
        rgbd_parts.append(rgbd)
        logt_parts.append(logt)
        tile_parts.append(ids_t)
    rgbd = torch.zeros((n_blocks, pix, 4), dtype=torch.float32, device=dev)
    logt = torch.zeros((n_blocks, pix), dtype=torch.float32, device=dev)
    if tile_parts:
        ids_all = torch.cat(tile_parts)
        rgbd = rgbd.index_copy(0, ids_all, torch.cat(rgbd_parts))
        logt = logt.index_copy(0, ids_all, torch.cat(logt_parts))

    def to_image(x):  # [B * tiles, PIX, ...] -> [B, H, W, ...]
        rest = x.shape[2:]
        x = x.reshape(b, tiles_y, tiles_x, tile, tile, *rest)
        x = x.permute(0, 1, 3, 2, 4, *range(5, 5 + len(rest)))
        return x.reshape(b, tiles_y * tile, tiles_x * tile, *rest)

    t_final = torch.exp(logt)
    image = rgbd[..., :3] + t_final[..., None] * background
    return {"image": to_image(image), "depth": to_image(rgbd[..., 3]),
            "alpha": to_image(1.0 - t_final), "contribs": contribs}


def render(means, scales, quats, features, opacities, alive, cams,
           background, sh_degree: int, cfg: RasterizeConfig,
           tile_capacity: int = 4096, with_grad: bool = False,
           feature_dtype=torch.float32) -> dict:
    """Render each camera of the list `cams` (all of one size): image,
    depth, alpha with a leading camera axis, radii [B, N], visible,
    overflow (pairs cut by the per-tile cap), pairs, contributions
    (pair-pixels composited), visible Gaussians. `feature_dtype`
    bfloat16 rounds the projected rows to it (the control)."""
    h, w = cams[0].height, cams[0].width
    tiles_x, tiles_y = w // cfg.tile, h // cfg.tile
    prims = [project_gaussians(means, scales, quats, features, opacities,
                               alive, cam, sh_degree, cfg) for cam in cams]
    pairs = build_pair_lists(prims, tiles_x, tiles_y, tile_capacity, cfg)
    feats = torch.cat([feature_rows(p) for p in prims])
    feats = feats.to(feature_dtype).float()
    out = composite(feats, pairs.gids, pairs.starts[:-1], pairs.counts,
                    background.float(), tiles_x, tiles_y, cfg, with_grad)
    out["radii"] = torch.stack([p.radii for p in prims])
    out["visible"] = torch.stack([p.visible for p in prims])
    out["overflow"] = pairs.overflow
    out["pairs"] = int(pairs.counts.sum())
    out["n_visible"] = int(out["visible"].sum())
    out["tiles"] = int(pairs.counts.shape[0])
    return out
