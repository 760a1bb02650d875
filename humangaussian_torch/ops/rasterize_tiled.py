"""Production tiled rasterizer: project -> bin -> composite, differentiable.

Port of humangaussian_tpu/ops/rasterize_tiled.py (`rasterize_tiled`,
`rasterize_tiled_batch`), forward and backward. Same contract: a dict with
image [H,W,3], depth [H,W], alpha [H,W], radii [N] int32, visible [N] and
the `overflow` / `overflow_spill` diagnostics (leading camera axis in the
batched form).

Compositing is kernel K1, `humangaussian_torch/csrc/rasterize_fwd.cu`, the
Hopper port of the JAX `_fwd_kernel`; its backward is kernel K2,
`humangaussian_torch/csrc/rasterize_bwd.cu`, the port of `_bwd_kernel`,
which writes each pair's ten gradient sums over each sub-tile as a row at
the pair's sorted position, and kernel K2b in the same file, the port of
the routing and sums after `_bwd_call`, which adds each Gaussian's pair
rows in candidate order (binning's `cand_pos` / `row_starts`, the JAX
`pos2`), sub-tile by sub-tile, into its feature-row gradient. Every sum
has a fixed order, so the backward repeats bit for bit. K1 and K2 serve
each 32x32 tile with SUBTILE x SUBTILE blocks that skip the pairs which
cannot pass the alpha gate anywhere in their sub-tile
(`csrc/rasterize_subtile.cuh`; `subtile_pair_mask` is the rule in plain
torch); every output is what a walk of the whole segment gives.
`composite` ties them together in a `torch.autograd.Function` (the
counterpart of the JAX `_render_core` custom_vjp): it returns the gradient
of the per-Gaussian feature rows only, and projection, SH, the
`means2d_offset` tap and the activations stay ordinary torch autograd. For
CUDA tensors `composite` launches K1 and its backward launches K2 and K2b;
for CPU tensors they take `composite_plain`, `composite_backward_pairs_plain`
and `feature_row_grads_plain`, the same functions in plain torch. On a
CUDA tensor a kernel launches or the call raises.

TPU-only mechanics of the JAX kernels that are not ported: the
feature-major [16, P] pair array and its row gather (the kernels gather
feature rows by pair index themselves, as upstream renderCUDA does), the
128-lane DMA windows and `_lane_shift`, the MXU triangular cumsum, the
Newton-corrected `log1p` for Mosaic, the channel-major [T, 8, PIX]
output with its transpose in `_assemble` (K1 writes [B, H, W, .]
directly), and the backward's page buffers, candidate-key row, sort
routing and tile-centred monomial matmul.
"""
from __future__ import annotations

import math

import torch

from humangaussian_torch.core.camera import Camera
from humangaussian_torch.kernels import (
    RASTERIZE_BWD,
    RASTERIZE_BWD_ROWS,
    RASTERIZE_FWD,
)
from humangaussian_torch.ops.binning import build_pair_lists, tile_alpha_bound
from humangaussian_torch.ops.projection import (
    ProjectedGaussians,
    RasterizeConfig,
    project_gaussians,
)

# per-Gaussian feature row read by K1 (order of csrc/rasterize_fwd.cu)
FX, FY, FCA, FCB, FCC, FR, FG, FB, FOPA, FDEPTH = range(10)
NUM_FEATURES = 10
KERNEL_TILE = 32  # the tile edge K1 is compiled for
SUBTILE = 8  # edge of the sub-tile one block of K1 / K2 serves
KERNEL_SUBTILES = (KERNEL_TILE // SUBTILE) ** 2  # K2's rows a pair
SKIP_MARGIN = 1e-3  # binning's cull margin, reused by the sub-tile skip
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


def _composite_forward(feats, gids, starts, counts, background, tiles_x,
                       tiles_y, cfg) -> dict:
    """K1 for CUDA tensors, `composite_plain` for CPU tensors."""
    if feats.device.type == "cpu":
        return composite_plain(feats, gids, starts, counts, background,
                               tiles_x, tiles_y, cfg)
    _check_kernel_device(feats, cfg)
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


def _check_kernel_device(feats, cfg):
    if cfg.tile != KERNEL_TILE:
        raise ValueError(f"the CUDA kernel is built for tile {KERNEL_TILE}, "
                         f"got {cfg.tile}")
    if feats.device.type != "cuda":
        raise ValueError(f"no compositing kernel for device {feats.device}")
    if feats.data_ptr() % 8:
        raise ValueError("feats must be 8-byte aligned (the kernels copy "
                         "feature rows 8 bytes at a time)")


def _check_routing(routing, feats, n_pairs: int):
    cand_pos, row_starts = routing
    for name, x, n in (("cand_pos", cand_pos, n_pairs),
                       ("row_starts", row_starts, feats.shape[0] + 1)):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int32 \
                or tuple(x.shape) != (n,) or x.device != feats.device \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 [{n}] on "
                             f"{feats.device}")


def composite_backward_pairs(feats, gids, starts, counts, background, saved,
                             grads, tiles_x: int, tiles_y: int,
                             cfg: RasterizeConfig = RasterizeConfig()
                             ) -> tuple:
    """K2 wrapper: (rows [P,16,10] f32, mask [P,16] uint8): each pair's
    ten gradient sums over each of its tile's sub-tiles (SUBTILE x SUBTILE
    pixels, row-major), at the pairs' positions in `gids`, and a mask byte
    of 1 where a row holds a non-zero sum (`composite_backward_pairs_plain`
    says which sums). Rows whose byte is 0, and the rows and bytes of pairs
    past their segment's count, are left unwritten (K2b never reads them).

    `saved` holds `composite`'s image, depth, final_t and n_contrib for
    the same inputs; `grads` the cotangents (g_image [B,H,W,3], g_depth,
    g_alpha [B,H,W]). K2 for CUDA tensors, `composite_backward_pairs_plain`
    for CPU tensors."""
    _check_composite_args(feats, gids, starts, counts, background,
                          tiles_x, tiles_y)
    if feats.device.type == "cpu":
        return composite_backward_pairs_plain(feats, gids, starts, counts,
                                              background, saved, grads,
                                              tiles_x, tiles_y, cfg)
    _check_kernel_device(feats, cfg)
    dev = feats.device
    n_blocks = counts.shape[0]
    b = n_blocks // (tiles_x * tiles_y)
    h, w = tiles_y * cfg.tile, tiles_x * cfg.tile
    ins = []
    for name, x, dtype, shape in (
        ("image", saved["image"], torch.float32, (b, h, w, 3)),
        ("depth", saved["depth"], torch.float32, (b, h, w)),
        ("final_t", saved["final_t"], torch.float32, (b, h, w)),
        ("n_contrib", saved["n_contrib"], torch.int32, (b, h, w)),
        ("g_image", grads[0], torch.float32, (b, h, w, 3)),
        ("g_depth", grads[1], torch.float32, (b, h, w)),
        ("g_alpha", grads[2], torch.float32, (b, h, w)),
    ):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name} must be {dtype} {shape} on {dev}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
        ins.append(x.contiguous())
    rows = torch.empty((gids.shape[0], KERNEL_SUBTILES, NUM_FEATURES),
                       dtype=torch.float32, device=dev)
    mask = torch.empty((gids.shape[0], KERNEL_SUBTILES), dtype=torch.uint8,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        RASTERIZE_BWD.launch(
            feats.data_ptr(), gids.data_ptr(), starts.data_ptr(),
            counts.data_ptr(), n_blocks, tiles_x, tiles_y, cfg.alpha_min,
            cfg.alpha_max, cfg.transmittance_eps,
            *(x.data_ptr() for x in ins), rows.data_ptr(), mask.data_ptr(),
            stream,
        )
    return rows, mask


def feature_row_grads(rows, mask, cand_pos, row_starts, feats
                      ) -> torch.Tensor:
    """K2b wrapper: the gradient of the feature rows, [M,10] f32, from
    K2's sub-tile rows [P,16,10] and mask [P,16], the routing (`cand_pos`
    [P], `row_starts` [M+1], int32) and the rows `feats` [M,10]. Every row
    is written (zeros where a row has no masked pair row). K2b for CUDA
    tensors, `feature_row_grads_plain` for CPU tensors."""
    _check_routing((cand_pos, row_starts), feats, rows.shape[0])
    n = cand_pos.shape[0]
    for name, x, dtype, shape in (
            ("rows", rows, torch.float32, (n, KERNEL_SUBTILES, NUM_FEATURES)),
            ("mask", mask, torch.uint8, (n, KERNEL_SUBTILES))):
        if x.dtype != dtype or x.device != feats.device \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                             f"on {feats.device}")
    if feats.device.type == "cpu":
        return feature_row_grads_plain(rows, mask, cand_pos, row_starts,
                                       feats)
    if feats.device.type != "cuda":
        raise ValueError(f"no compositing kernel for device {feats.device}")
    dfeats = torch.empty_like(feats)
    with torch.cuda.device(feats.device):
        RASTERIZE_BWD_ROWS.launch(
            rows.data_ptr(), mask.data_ptr(), cand_pos.data_ptr(),
            row_starts.data_ptr(), feats.data_ptr(), feats.shape[0],
            dfeats.data_ptr(),
            torch.cuda.current_stream(feats.device).cuda_stream)
    return dfeats


def composite_backward(feats, gids, starts, counts, background, saved,
                       grads, tiles_x: int, tiles_y: int,
                       cfg: RasterizeConfig = RasterizeConfig(),
                       routing=None) -> torch.Tensor:
    """The gradient of the feature rows, [M,10] f32: K2 then K2b
    (`composite_backward_pairs`, `feature_row_grads`). `routing` is the
    pair list's (cand_pos, row_starts) (binning's `PairLists`), rebuilt by
    `pair_routing` when not given."""
    _check_composite_args(feats, gids, starts, counts, background,
                          tiles_x, tiles_y)
    if feats.device.type != "cpu":
        _check_kernel_device(feats, cfg)
    if routing is None:
        routing = pair_routing(gids, starts, counts, feats.shape[0])
    _check_routing(routing, feats, gids.shape[0])
    rows, mask = composite_backward_pairs(feats, gids, starts, counts,
                                          background, saved, grads, tiles_x,
                                          tiles_y, cfg)
    return feature_row_grads(rows, mask, *routing, feats)


class _Composite(torch.autograd.Function):
    """K1 forward / K2 backward (their plain versions on the CPU).

    Differentiable in `feats` only; image, depth and alpha carry
    gradients, final_t and n_contrib (and the plain version's work
    counters) are marked non-differentiable."""

    @staticmethod
    def forward(ctx, feats, gids, starts, counts, background, tiles_x,
                tiles_y, cfg, cand_pos, row_starts):
        out = _composite_forward(feats, gids, starts, counts, background,
                                 tiles_x, tiles_y, cfg)
        ctx.save_for_backward(feats, gids, starts, counts, background,
                              out["image"], out["depth"], out["final_t"],
                              out["n_contrib"], cand_pos, row_starts)
        ctx.geometry = (tiles_x, tiles_y, cfg)
        extras = tuple(out.get(k) for k in ("visits", "contribs"))
        ctx.mark_non_differentiable(
            out["final_t"], out["n_contrib"],
            *(x for x in extras if x is not None))
        return (out["image"], out["depth"], out["alpha"], out["final_t"],
                out["n_contrib"], *extras)

    @staticmethod
    def backward(ctx, g_image, g_depth, g_alpha, *_):
        (feats, gids, starts, counts, background, image, depth, final_t,
         n_contrib, cand_pos, row_starts) = ctx.saved_tensors
        saved = {"image": image, "depth": depth, "final_t": final_t,
                 "n_contrib": n_contrib}
        dfeats = composite_backward(
            feats, gids, starts, counts, background, saved,
            (g_image, g_depth, g_alpha), *ctx.geometry,
            routing=None if cand_pos is None else (cand_pos, row_starts))
        return dfeats, None, None, None, None, None, None, None, None, None


def composite(feats, gids, starts, counts, background, tiles_x: int,
              tiles_y: int, cfg: RasterizeConfig = RasterizeConfig(),
              routing=None) -> dict:
    """Front-to-back compositing of each tile's pair segment, with its
    gradient (K1 / K2 + K2b behind a `torch.autograd.Function`).

    feats [M,10] f32 per-Gaussian rows (all cameras), gids [P] int32
    depth-sorted pair -> row, starts/counts [B*tiles] int32 segment per
    tile, background [3]; `routing` the backward's (cand_pos, row_starts)
    (binning's; rebuilt by `pair_routing` when not given). Returns image
    [B,H,W,3], depth/alpha [B,H,W] f32, differentiable with respect to
    `feats`, and the two tensors the backward replays from: final_t
    [B,H,W] f32 and n_contrib [B,H,W] int32 (one past the segment-local
    index of each pixel's last contributing pair). For CPU tensors the dict
    also carries `composite_plain`'s work counters.
    """
    _check_composite_args(feats, gids, starts, counts, background,
                          tiles_x, tiles_y)
    if routing is not None:
        _check_routing(routing, feats, gids.shape[0])
    keys = ("image", "depth", "alpha", "final_t", "n_contrib", "visits",
            "contribs")
    out = _Composite.apply(feats, gids, starts, counts, background, tiles_x,
                           tiles_y, cfg, *(routing or (None, None)))
    return {k: v for k, v in zip(keys, out) if v is not None}


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


def composite_backward_plain(feats, gids, starts, counts, background, saved,
                             grads, tiles_x: int, tiles_y: int,
                             cfg: RasterizeConfig = RasterizeConfig(),
                             routing=None) -> torch.Tensor:
    """The backward's function (K2 then K2b) in plain torch:
    `composite_backward_pairs_plain`, then `feature_row_grads_plain` with
    `routing` (rebuilt by `pair_routing` when not given)."""
    if routing is None:
        routing = pair_routing(gids, starts, counts, feats.shape[0])
    rows, mask = composite_backward_pairs_plain(
        feats, gids, starts, counts, background, saved, grads, tiles_x,
        tiles_y, cfg)
    return feature_row_grads_plain(rows, mask, *routing, feats)


def composite_backward_pairs_plain(feats, gids, starts, counts, background,
                                   saved, grads, tiles_x: int, tiles_y: int,
                                   cfg: RasterizeConfig = RasterizeConfig()
                                   ) -> tuple:
    """K2's function in plain torch: the analytic replay VJP of
    `composite_plain`, vectorized over (tile, pixel) and PLAIN_CHUNK pairs
    at a time, as each pair's ten sums over each sub-tile's pixels (the
    (tile / SUBTILE)^2 sub-tiles of its tile, row-major), rows [P,16,10]
    at the pairs' positions in `gids`, and mask [P,16] uint8, 1 where a
    row holds a non-zero sum (rows and bytes 0 for pairs that add
    nothing): [sum dpower dx, sum dpower dy, sum dpower dx^2,
    sum dpower dx dy, sum dpower dy^2, sum g_r w, sum g_g w, sum g_b w,
    sum dalpha_raw exp(power), sum g_depth w]. `feature_row_grads_plain`
    turns each Gaussian's sums into its feature-row gradient. It is written
    from the formula, not taken by autograd through `composite_plain`
    (autograd is the tests' second oracle).

    Derivation. Per pixel, with F_i = [r, g, b, depth] of pair i, the
    cotangents g = [g_r, g_g, g_b, g_depth] of the accumulators,
    phi_i = F_i . g, T_i the transmittance before pair i and
    w_i = T_i alpha_i, the loss depends on alpha_i through its own weight
    (T_i phi_i) and through every later T_j = T_i (1 - alpha_i) ..., the
    final transmittance included:
        dL/dalpha_i = T_i phi_i - (S - P_i) / max(1 - alpha_i, 1e-6)
    where P_i is the inclusive prefix of w_j phi_j and
    S = sum_j w_j phi_j + g_logT, g_logT = dL/dlog T_fin. The outputs are
    image = acc + T_fin bg and alpha = 1 - T_fin, so
        g_logT = T_fin (g_image . bg - g_alpha),
        sum_j w_j phi_j = g_image . (image - T_fin bg) + g_depth depth,
    both from saved outputs (the background terms cancel in S; K2 uses the
    cancelled form, this function the long one). Then, as jax.grad of the
    JAX reference gives: no gradient through the alpha_max clamp
    (dalpha_raw = dalpha only where opa exp(power) < alpha_max);
    dpower = dalpha_raw opa exp(power) only where power < 0, while
    dopacity = sum_p dalpha_raw exp(power) has no such gate (a pair at
    exactly power == 0 passes the forward gate);
    dmean_x = -(ca gx + cb gy), dmean_y = -(cc gy + cb gx) with
    gx = sum_p dpower dx, dx = mean_x - px; dconic a, b, c =
    -1/2 sum dpower dx^2, -sum dpower dx dy, -1/2 sum dpower dy^2 (linear
    in the sums with the Gaussian's own conic, so applied to its summed
    pair rows); drgb = sum_p g_rgb w, ddepth = sum_p g_depth w. Pairs that
    fail a gate, pairs at or after a pixel's done latch and pairs past the
    tile's capped count get exactly 0."""
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

    def from_image(x):  # [B, H, W, ...] -> [G, PIX, ...]
        rest = x.shape[3:]
        x = x.reshape(b, tiles_y, tile, tiles_x, tile, *rest)
        x = x.permute(0, 1, 3, 2, 4, *range(5, 5 + len(rest)))
        return x.reshape(n_blocks, pix, *rest)

    g_image, g_depth, g_alpha = (from_image(g.to(torch.float32))
                                 for g in grads)
    g4 = torch.cat([g_image, g_depth[..., None]], dim=-1)  # [G, PIX, 4]
    t_fin = from_image(saved["final_t"])
    acc_rgb = from_image(saved["image"]) - t_fin[..., None] * background
    s_tot = ((g_image * acc_rgb).sum(-1) + g_depth * from_image(saved["depth"])
             + t_fin * ((g_image * background).sum(-1) - g_alpha))

    per_edge = tile // SUBTILE
    n_subs = per_edge * per_edge
    pair_rows = torch.zeros((gids.shape[0], n_subs, NUM_FEATURES),
                            dtype=torch.float32, device=dev)

    def by_sub(x):  # [G, PIX, ...] -> [G, subs, SUBTILE^2, ...]
        rest = x.shape[2:]
        x = x.reshape(x.shape[0], per_edge, SUBTILE, per_edge, SUBTILE, *rest)
        x = x.permute(0, 1, 3, 2, 4, *range(5, 5 + len(rest)))
        return x.reshape(x.shape[0], n_subs, SUBTILE * SUBTILE, *rest)

    log_t_u = torch.zeros((n_blocks, pix), dtype=torch.float32, device=dev)
    prefix = torch.zeros_like(log_t_u)
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
        gid = gids[idx.clamp_max(max(n_pairs - 1, 0))].to(torch.int64)
        f = feats[gid]
        ca = f[..., FCA][:, None, :]  # [G, 1, C]
        cb = f[..., FCB][:, None, :]
        cc = f[..., FCC][:, None, :]
        opa = f[..., FOPA][:, None, :]
        dxv = f[..., FX][:, None, :] - px[:, :, None]  # [G, PIX, C]
        dyv = f[..., FY][:, None, :] - py[:, :, None]
        # the forward's arithmetic, so the same pairs pass and latch
        power = -0.5 * (ca * dxv * dxv + cc * dyv * dyv) - cb * dxv * dyv
        e = torch.exp(torch.clamp_max(power, 0.0))
        alpha_raw = opa * e
        alpha = torch.clamp_max(alpha_raw, cfg.alpha_max)
        pass_ = valid[:, None, :] & (power <= 0.0) & (alpha >= cfg.alpha_min)
        log1ma = torch.where(pass_, torch.log1p(-torch.where(pass_, alpha,
                                                             0.0)), 0.0)
        cum = torch.cumsum(log1ma, dim=-1)
        u_before = log_t_u[:, :, None] + cum - log1ma
        contrib = pass_ & (u_before + log1ma >= log_eps)
        t_i = torch.exp(u_before)
        w = torch.where(contrib, t_i * alpha, 0.0)

        f4 = f[..., [FR, FG, FB, FDEPTH]]  # [G, C, 4]
        phi = torch.bmm(g4, f4.transpose(1, 2))  # [G, PIX, C]
        p_incl = prefix[:, :, None] + torch.cumsum(w * phi, dim=-1)
        dalpha = torch.where(
            contrib,
            t_i * phi - (s_tot[:, :, None] - p_incl)
            / torch.clamp_min(1.0 - alpha, 1e-6),
            0.0)
        dalpha_raw = torch.where(alpha_raw < cfg.alpha_max, dalpha, 0.0)
        dpow = torch.where(power < 0.0, dalpha_raw * alpha_raw, 0.0)
        # sums over each sub-tile's pixels: [G, subs, C] each
        dcol = torch.einsum("gspc,gspf->gscf", by_sub(w),
                            by_sub(g4))  # [G, subs, C, 4]: drgb, ddepth
        rows = torch.stack(
            [
                by_sub(dpow * dxv).sum(2), by_sub(dpow * dyv).sum(2),
                by_sub(dpow * dxv * dxv).sum(2),
                by_sub(dpow * dxv * dyv).sum(2),
                by_sub(dpow * dyv * dyv).sum(2),
                dcol[..., 0], dcol[..., 1], dcol[..., 2],
                by_sub(dalpha_raw * e).sum(2),
                dcol[..., 3],
            ],
            dim=-1,
        ).transpose(1, 2)  # [G, C, subs, 10]
        pair_rows[idx[valid]] = rows[valid]
        prefix = p_incl[..., -1]
        log_t_u = log_t_u + cum[..., -1]
    return pair_rows, (pair_rows != 0.0).any(dim=-1).to(torch.uint8)


def feature_row_grads_plain(rows, mask, cand_pos, row_starts, feats
                            ) -> torch.Tensor:
    """K2b's function in plain torch: for each feature row i, its pairs
    (cand_pos[row_starts[i] : row_starts[i + 1]], -1 for a pair cut by its
    tile's cap) in that order and each pair's sub-tile rows in sub-tile
    order where `mask` is set, added starting from 0, then the feature-row
    gradient [-(ca S0 + cb S1), -(cc S1 + cb S0), -S2 / 2, -S3, -S4 / 2,
    S5, ..., S9] with the row's conic (ca, cb, cc); zeros for a row
    without a masked pair row. Bit for bit what a loop over each row's
    candidates and sub-tiles gives."""
    n_rows = feats.shape[0]
    first = row_starts[:-1].to(torch.int64)
    n_cand = row_starts[1:].to(torch.int64) - first
    most = int(n_cand.max()) if n_rows else 0
    acc = torch.zeros((n_rows, NUM_FEATURES), dtype=torch.float32,
                      device=feats.device)
    has = torch.zeros(n_rows, dtype=torch.bool, device=feats.device)
    for j in range(most):
        k = torch.where(j < n_cand, first + j, 0)
        p = cand_pos[k].to(torch.int64)
        pair = (j < n_cand) & (p >= 0)
        p = p.clamp_min(0)
        for sub in range(rows.shape[1]):
            take = pair & (mask[p, sub] != 0)
            acc = torch.where(take[:, None], acc + rows[p, sub], acc)
            has |= take
    ca, cb, cc = feats[:, FCA], feats[:, FCB], feats[:, FCC]
    s = acc.unbind(1)
    grad = torch.stack(
        [-(ca * s[0] + cb * s[1]), -(cc * s[1] + cb * s[0]), -0.5 * s[2],
         -s[3], -0.5 * s[4], *s[5:]], dim=1)
    return torch.where(has[:, None], grad, 0.0)


def pair_routing(gids, starts, counts, rows: int):
    """The backward's routing of a pair list, (cand_pos, row_starts):
    each feature row's pairs in order of their position in `gids` (a stable
    sort by row), the pairs past their segment's count marked -1, and
    `row_starts` [rows + 1] int32 where each row's pairs begin. For
    binning's lists this is its own routing (`PairLists.cand_pos`,
    `row_starts`: candidate order is each row's pairs in sorted order)."""
    _, _, pos = counted_pairs(starts, counts)
    counted = torch.zeros(gids.shape[0], dtype=torch.bool,
                          device=gids.device)
    counted[pos] = True
    by_row, order = torch.sort(gids, stable=True)
    cand_pos = torch.where(counted[order], order, -1).to(torch.int32)
    row_starts = torch.searchsorted(
        by_row, torch.arange(rows + 1, dtype=gids.dtype, device=gids.device))
    return cand_pos, row_starts.to(torch.int32)


def counted_pairs(starts, counts):
    """(segment, segment-local index, position in `gids`) of every pair
    below its segment's count, int64 [Pc] each, in segment order."""
    counts64 = counts.to(torch.int64)
    seg = torch.repeat_interleave(
        torch.arange(counts64.shape[0], device=counts.device), counts64)
    local = (torch.arange(seg.shape[0], device=counts.device)
             - (torch.cumsum(counts64, 0) - counts64)[seg])
    return seg, local, starts.to(torch.int64)[seg] + local


def subtile_pair_mask(feats, gids, starts, counts, tiles_x: int,
                      tiles_y: int, cfg: RasterizeConfig = RasterizeConfig()
                      ) -> torch.Tensor:
    """K1 / K2's sub-tile skip rule in plain torch: [P, (tile / SUBTILE)^2]
    bool, True where the sub-tile's block walks pair p of `gids`.

    Each tile is served by (tile / SUBTILE)^2 blocks of SUBTILE^2 pixels,
    numbered row-major inside the tile. A block skips a pair of its tile's
    segment whose best-case alpha over the sub-tile's pixel-centre box,
    opa exp(-qmin / 2) with qmin from binning's exact `tile_alpha_bound`,
    is below alpha_min (1 - SKIP_MARGIN), binning's own cull margin: such a
    pair fails the alpha gate at every pixel of the sub-tile, so skipping
    it changes no output. A pair whose conic is not positive definite is
    always walked (the box bound assumes a convex quadratic). Pairs at or
    past their tile's count are False in every column."""
    per_edge = cfg.tile // SUBTILE
    n_sub = per_edge * per_edge
    dev = feats.device
    tile_of, _, pos = counted_pairs(starts, counts)
    f = feats[gids[pos].to(torch.int64)][:, None, :]  # [Pc, 1, 10]
    t_local = tile_of % (tiles_x * tiles_y)
    s = torch.arange(n_sub, device=dev)
    sx = ((t_local % tiles_x)[:, None] * per_edge + s % per_edge)
    sy = ((t_local // tiles_x)[:, None] * per_edge + s // per_edge)
    ca, cb, cc = f[..., FCA], f[..., FCB], f[..., FCC]
    qmin = tile_alpha_bound(f[..., FX], f[..., FY], ca, cb, cc,
                            sx.to(torch.float32), sy.to(torch.float32),
                            SUBTILE)
    bound = f[..., FOPA] * torch.exp(-0.5 * qmin)
    convex = (ca > 0.0) & (cc > 0.0) & (ca * cc > cb * cb)
    walked = ~convex | (bound >= cfg.alpha_min * (1.0 - SKIP_MARGIN))
    mask = torch.zeros((gids.shape[0], n_sub), dtype=torch.bool, device=dev)
    mask[pos] = walked
    return mask


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
                    *tiles, cfg, (pairs.cand_pos, pairs.row_starts))
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
