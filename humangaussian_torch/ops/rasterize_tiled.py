"""Production tiled rasterizer (forward): project -> bin -> composite.

Port of humangaussian_tpu/ops/rasterize_tiled.py (`rasterize_tiled`,
`rasterize_tiled_batch`), forward only. Same contract: a dict with
image [H,W,3], depth [H,W], alpha [H,W], radii [N] int32, visible [N] and
the `overflow` / `overflow_spill` diagnostics (leading camera axis in the
batched form).

Compositing is kernel K1, `humangaussian_torch/csrc/rasterize_fwd.cu`, the
Hopper port of the JAX `_fwd_kernel`. `composite` launches it for CUDA
tensors and takes `composite_plain`, the same function in plain torch, for
CPU tensors; on a CUDA tensor it launches the kernel or raises.

TPU-only mechanics of the JAX kernel that are not ported: the
feature-major [16, P] pair array and its row gather (the kernel gathers
feature rows by pair index itself, as upstream renderCUDA does), the
128-lane DMA windows and `_lane_shift`, the MXU triangular cumsum, the
Newton-corrected `log1p` for Mosaic, and the channel-major [T, 8, PIX]
output with its transpose in `_assemble` (the kernel writes [B, H, W, .]
directly).
"""
from __future__ import annotations

import math

import torch

from humangaussian_torch.core.camera import Camera
from humangaussian_torch.kernels import RASTERIZE_FWD
from humangaussian_torch.ops.binning import build_pair_lists
from humangaussian_torch.ops.projection import (
    ProjectedGaussians,
    RasterizeConfig,
    project_gaussians,
)

# per-Gaussian feature row read by K1 (order of csrc/rasterize_fwd.cu)
FX, FY, FCA, FCB, FCC, FR, FG, FB, FOPA, FDEPTH = range(10)
NUM_FEATURES = 10
KERNEL_TILE = 32  # the tile edge K1 is compiled for
PLAIN_CHUNK = 32  # pairs per step of composite_plain ([tiles, pix, 32] temps)


def feature_matrix(prims: ProjectedGaussians) -> torch.Tensor:
    """[N, 10] rows: mean x, y, conic a, b, c, rgb, opacity, depth."""
    return torch.stack(
        [
            prims.means2d[:, 0], prims.means2d[:, 1],
            prims.conics[:, 0], prims.conics[:, 1], prims.conics[:, 2],
            prims.rgb[:, 0], prims.rgb[:, 1], prims.rgb[:, 2],
            prims.opacities, prims.depths,
        ],
        dim=1,
    ).to(torch.float32).contiguous()


def _check_composite_args(feats, gids, starts, counts, background,
                          tiles_x, tiles_y):
    dev = feats.device
    for name, x, dtype, ndim in (
        ("feats", feats, torch.float32, 2),
        ("gids", gids, torch.int32, 1),
        ("starts", starts, torch.int32, 1),
        ("counts", counts, torch.int32, 1),
        ("background", background, torch.float32, 1),
    ):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, feats on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if feats.shape[1] != NUM_FEATURES:
        raise ValueError(f"feats must be [M, {NUM_FEATURES}], got "
                         f"{tuple(feats.shape)}")
    if background.shape[0] != 3:
        raise ValueError("background must be [3]")
    tiles = tiles_x * tiles_y
    if tiles <= 0 or counts.shape[0] % tiles or starts.shape != counts.shape:
        raise ValueError(
            f"starts/counts must both be [B * {tiles}], got "
            f"{tuple(starts.shape)} / {tuple(counts.shape)}"
        )


def composite(feats, gids, starts, counts, background, tiles_x: int,
              tiles_y: int, cfg: RasterizeConfig = RasterizeConfig()) -> dict:
    """K1 wrapper: front-to-back compositing of each tile's pair segment.

    feats [M,10] f32 per-Gaussian rows (all cameras), gids [P] int32
    depth-sorted pair -> row, starts/counts [B*tiles] int32 segment per
    tile, background [3]. Returns image [B,H,W,3], depth/alpha/final_t
    [B,H,W] f32 and n_contrib [B,H,W] int32 (one past the segment-local
    index of each pixel's last contributing pair).
    """
    _check_composite_args(feats, gids, starts, counts, background,
                          tiles_x, tiles_y)
    if feats.device.type == "cpu":
        return composite_plain(feats, gids, starts, counts, background,
                               tiles_x, tiles_y, cfg)
    if cfg.tile != KERNEL_TILE:
        raise ValueError(f"the CUDA kernel is built for tile {KERNEL_TILE}, "
                         f"got {cfg.tile}")
    if feats.device.type != "cuda":
        raise ValueError(f"no compositing kernel for device {feats.device}")
    n_blocks = counts.shape[0]
    b = n_blocks // (tiles_x * tiles_y)
    h, w = tiles_y * cfg.tile, tiles_x * cfg.tile
    dev = feats.device
    image = torch.empty((b, h, w, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    alpha = torch.empty_like(depth)
    final_t = torch.empty_like(depth)
    n_contrib = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        RASTERIZE_FWD.launch(
            feats.data_ptr(), gids.data_ptr(), starts.data_ptr(),
            counts.data_ptr(), background.data_ptr(), n_blocks, tiles_x,
            tiles_y, cfg.alpha_min, cfg.alpha_max, cfg.transmittance_eps,
            image.data_ptr(), depth.data_ptr(), alpha.data_ptr(),
            final_t.data_ptr(), n_contrib.data_ptr(), stream,
        )
    return {"image": image, "depth": depth, "alpha": alpha,
            "final_t": final_t, "n_contrib": n_contrib}


def composite_plain(feats, gids, starts, counts, background, tiles_x: int,
                    tiles_y: int, cfg: RasterizeConfig = RasterizeConfig()
                    ) -> dict:
    """K1's function in plain torch, vectorized over (tile, pixel) and over
    PLAIN_CHUNK pairs at a time.

    The recurrence is carried as log-transmittance, the identity the JAX
    kernel and oracle use: per chunk an inclusive cumsum of log(1 - alpha)
    over the passing pairs gives the UNFROZEN log T before each pair; it
    only decreases, so "pixel not yet done" is simply u_before + log(1 -
    alpha) >= log(eps), which is the CUDA done latch. It equals the
    kernel's product form up to f32 rounding.

    Returns `composite`'s dict plus two work counters of this input:
    `visits`, the pair-pixel evaluations a per-pixel early stop needs, and
    `contribs`, the pair-pixel contributions."""
    dev = feats.device
    tile = cfg.tile
    pix = tile * tile
    tiles = tiles_x * tiles_y
    n_blocks = counts.shape[0]
    b = n_blocks // tiles
    log_eps = math.log(cfg.transmittance_eps)
    lin = torch.arange(pix, device=dev)
    t_local = torch.arange(n_blocks, device=dev) % tiles
    px = ((t_local % tiles_x)[:, None] * tile + lin % tile).to(torch.float32)
    py = ((t_local // tiles_x)[:, None] * tile + lin // tile).to(torch.float32)

    log_t_u = torch.zeros((n_blocks, pix), dtype=torch.float32, device=dev)
    log_t_f = torch.zeros_like(log_t_u)
    acc = torch.zeros((n_blocks, pix, 4), dtype=torch.float32, device=dev)
    last = torch.zeros((n_blocks, pix), dtype=torch.int64, device=dev)
    visits = torch.zeros((), dtype=torch.int64, device=dev)
    contribs = torch.zeros((), dtype=torch.int64, device=dev)
    starts64 = starts.to(torch.int64)
    counts64 = counts.to(torch.int64)
    max_count = int(counts64.max()) if n_blocks else 0
    n_pairs = gids.shape[0]
    for k0 in range(0, max_count, PLAIN_CHUNK):
        if not bool((log_t_u >= log_eps).any()):
            break  # every pixel saturated
        k = k0 + torch.arange(PLAIN_CHUNK, device=dev)
        valid = k[None, :] < counts64[:, None]  # [G, C]
        idx = torch.where(valid, starts64[:, None] + k[None, :], 0)
        f = feats[gids[idx.clamp_max(max(n_pairs - 1, 0))].to(torch.int64)]
        x = f[..., FX][:, None, :]  # [G, 1, C]
        y = f[..., FY][:, None, :]
        ca = f[..., FCA][:, None, :]
        cb = f[..., FCB][:, None, :]
        cc = f[..., FCC][:, None, :]
        opa = f[..., FOPA][:, None, :]
        dxv = x - px[:, :, None]  # [G, PIX, C]
        dyv = y - py[:, :, None]
        power = -0.5 * (ca * dxv * dxv + cc * dyv * dyv) - cb * dxv * dyv
        alpha = torch.clamp_max(opa * torch.exp(torch.clamp_max(power, 0.0)),
                                cfg.alpha_max)
        pass_ = valid[:, None, :] & (power <= 0.0) & (alpha >= cfg.alpha_min)
        log1ma = torch.where(pass_, torch.log1p(-torch.where(pass_, alpha,
                                                             0.0)), 0.0)
        cum = torch.cumsum(log1ma, dim=-1)
        u_before = log_t_u[:, :, None] + cum - log1ma
        contrib = pass_ & (u_before + log1ma >= log_eps)
        w = torch.where(contrib, torch.exp(u_before) * alpha, 0.0)
        acc = acc + torch.bmm(w, f[..., [FR, FG, FB, FDEPTH]])
        log_t_f = log_t_f + torch.where(contrib, log1ma, 0.0).sum(dim=-1)
        last = torch.maximum(last, torch.where(contrib, k + 1, 0).amax(dim=-1))
        visits += (valid[:, None, :] & (u_before >= log_eps)).sum()
        contribs += contrib.sum()
        log_t_u = log_t_u + cum[..., -1]

    def to_image(x):  # [G, PIX, ...] -> [B, H, W, ...]
        rest = x.shape[2:]
        x = x.reshape(b, tiles_y, tiles_x, tile, tile, *rest)
        x = x.permute(0, 1, 3, 2, 4, *range(5, 5 + len(rest)))
        return x.reshape(b, tiles_y * tile, tiles_x * tile, *rest)

    t_final = torch.exp(log_t_f)
    image = acc[..., :3] + t_final[..., None] * background
    return {
        "image": to_image(image),
        "depth": to_image(acc[..., 3]),
        "alpha": to_image(1.0 - t_final),
        "final_t": to_image(t_final),
        "n_contrib": to_image(last.to(torch.int32)),
        "visits": visits,
        "contribs": contribs,
    }


def composite_inputs(means, scales, quats, features, opacities, alive, cams,
                     sh_degree, cfg, scale_modifier=1.0, means2d_offset=None,
                     tile_capacity=4096):
    """Project each camera of the list `cams` and bin the batch.

    Returns (prims, pairs, args, (tiles_x, tiles_y)); `args` are
    `composite`'s feats, gids, starts and counts."""
    h, w = cams[0].height, cams[0].width
    if h % cfg.tile or w % cfg.tile:
        raise ValueError(f"image {h}x{w} must be a multiple of tile {cfg.tile}")
    tiles_x, tiles_y = w // cfg.tile, h // cfg.tile
    prims = [
        project_gaussians(means, scales, quats, features, opacities, alive,
                          cam, sh_degree, cfg, scale_modifier, means2d_offset)
        for cam in cams
    ]
    pairs = build_pair_lists(prims, tiles_x, tiles_y, tile_capacity, cfg)
    feats = torch.cat([feature_matrix(p) for p in prims])
    args = (feats, pairs.gids, pairs.starts[:-1].contiguous(), pairs.counts)
    return prims, pairs, args, (tiles_x, tiles_y)


def _rasterize(means, scales, quats, features, opacities, alive, cams,
               background, sh_degree, cfg, scale_modifier, means2d_offset,
               tile_capacity):
    prims, pairs, args, tiles = composite_inputs(
        means, scales, quats, features, opacities, alive, cams, sh_degree,
        cfg, scale_modifier, means2d_offset, tile_capacity)
    out = composite(*args, background.to(torch.float32).contiguous(),
                    *tiles, cfg)
    return {
        "image": out["image"],
        "depth": out["depth"],
        "alpha": out["alpha"],
        "radii": torch.stack([p.radii for p in prims]),
        "visible": torch.stack([p.visible for p in prims]),
        "overflow": pairs.overflow,
        "overflow_spill": torch.zeros_like(pairs.overflow),
    }


def rasterize_tiled(
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
    tile_capacity: int = 4096,
) -> dict:
    """Tiled render of one camera: image [H,W,3], depth [H,W], alpha
    [H,W], radii [N] int32, visible [N], overflow, overflow_spill.
    `tile_capacity` caps the pairs composited per tile (deepest dropped,
    counted in `overflow`)."""
    out = _rasterize(means, scales, quats, features, opacities, alive,
                     [camera], background, sh_degree, cfg, scale_modifier,
                     means2d_offset, tile_capacity)
    for key in ("image", "depth", "alpha", "radii", "visible"):
        out[key] = out[key][0]
    return out


def rasterize_tiled_batch(
    means,
    scales,
    quats,
    features,
    opacities,
    alive,
    cameras: Camera,
    background: torch.Tensor,
    sh_degree: int = 0,
    cfg: RasterizeConfig = RasterizeConfig(),
    scale_modifier: float = 1.0,
    means2d_offset: torch.Tensor | None = None,
    tile_capacity: int = 4096,
) -> dict:
    """Batched render over B cameras (a Camera with a leading batch axis)
    sharing one scene: projection per camera, one binning sort and ONE
    compositing launch for the whole batch. Outputs carry a leading B."""
    return _rasterize(means, scales, quats, features, opacities, alive,
                      [cameras[i] for i in range(len(cameras))],
                      background, sh_degree, cfg,
                      scale_modifier, means2d_offset, tile_capacity)
