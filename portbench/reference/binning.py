"""Frozen plain copy of `humangaussian_torch/ops/binning.py` for the benchmark's
reference (imports rewritten; kernel calls replaced by plain torch in
`portbench/reference/common.py`). Original docstring:

Tile binning: depth-ordered (tile, Gaussian) pair lists per tile.

Port of humangaussian_tpu/ops/binning.py (`build_pair_lists` and the exact
tile-ellipse cull `_tile_alpha_bound`). The pair lists are sized
dynamically, as upstream CUDA `duplicateWithKeys` + radix sort sizes them:

1. per Gaussian, its rect tiles (at most rect_side^2) that survive the
   exact tile-ellipse cull;
2. compacting that candidate mask with `nonzero` (a count, an exclusive
   scan and an expand) gives the (tile, Gaussian) pairs of every camera;
3. each pair's int64 key is `global_tile << 32 | depth_bits`, where
   `global_tile` = camera * tiles + tile and `depth_bits` is the view
   depth's float32 bit pattern (exact order for the positive depths that
   pass the near cull);
4. one stable `torch.sort` orders the pairs of the whole camera batch;
5. `searchsorted` finds each tile's segment.

`tile_capacity` caps each tile's segment, dropping the deepest pairs
first, and the dropped pairs are reported in `overflow`.

The sort's permutation is kept as the backward's routing (the JAX
`pos2`): `pair_cand` gives each sorted pair's candidate index (its place
in candidate order: feature row, then rect tile), `cand_pos` its inverse,
the sorted position of each candidate, -1 where the cap cut the pair, and
`row_starts` where each feature row's candidates begin. The backward
stores each pair's gradient rows at its candidate index (K2) and adds
each row's span in that order (K2b). Candidate order is each row's pairs
in sorted order, so `rasterize_tiled.pair_routing` rebuilds the same
routing from any pair list.

TPU-only machinery with no counterpart here: the static class chain and
its class-depth sort, the candidate domain, the `pair_capacity` budget and
`active_cap`. `overflow_spill` (class-chain demotion) is always 0.

Known difference: pairs with bit-equal depths in one tile are ordered by
Gaussian index here and by (class, depth) candidate position in JAX.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from portbench.reference.projection import ProjectedGaussians, RasterizeConfig


def tile_alpha_bound(mx, my, ca, cb, cc, tx, ty, tile):
    """Exact min of Q(d) = ca dx^2 + 2 cb dx dy + cc dy^2 over a tile's
    pixel-centre box, per candidate (the JAX `_tile_alpha_bound`).

    A candidate whose best-case alpha opa exp(-Q/2) over the whole tile is
    below alpha_min contributes to no pixel there, so culling it is exact.
    Pixel centres of tile (tx, ty) span [tx T, tx T + T - 1]; for convex Q
    the box minimum is 0 if the mean is inside, else on one of 4 edges,
    each a 1-D quadratic minimized at its clamped vertex."""
    t = float(tile)
    dx_hi = mx - tx * t
    dx_lo = dx_hi - (t - 1.0)
    dy_hi = my - ty * t
    dy_lo = dy_hi - (t - 1.0)
    ca_s = torch.clamp_min(ca, 1e-12)
    cc_s = torch.clamp_min(cc, 1e-12)

    def q(dx, dy):
        return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

    def edge_dx(c):  # dx fixed at c, minimize over dy
        dy = torch.clamp(-cb * c / cc_s, dy_lo, dy_hi)
        return q(c, dy)

    def edge_dy(c):  # dy fixed at c, minimize over dx
        dx = torch.clamp(-cb * c / ca_s, dx_lo, dx_hi)
        return q(dx, c)

    qedge = torch.minimum(
        torch.minimum(edge_dx(dx_lo), edge_dx(dx_hi)),
        torch.minimum(edge_dy(dy_lo), edge_dy(dy_hi)),
    )
    inside = (dx_lo <= 0.0) & (0.0 <= dx_hi) & (dy_lo <= 0.0) & (0.0 <= dy_hi)
    return torch.clamp_min(torch.where(inside, 0.0, qedge), 0.0)


class PairLists(NamedTuple):
    """Sorted pairs of a camera batch (dynamic size P)."""

    gids: torch.Tensor  # [P] int32 feature row (camera * N + Gaussian)
    sorted_tile: torch.Tensor  # [P] int64 global tile (camera * tiles + tile)
    starts: torch.Tensor  # [B*tiles + 1] int32 segment starts
    counts: torch.Tensor  # [B*tiles] int32 pairs per tile, capped
    overflow: torch.Tensor  # [] int64 pairs dropped by the per-tile cap
    cand_pos: torch.Tensor  # [P] int32 sorted position per candidate, or -1
    row_starts: torch.Tensor  # [B*N + 1] int32 first candidate of each row
    pair_cand: torch.Tensor  # [P] int32 candidate index per sorted pair


def _candidates(prims: ProjectedGaussians, tiles_x: int,
                cfg: RasterizeConfig):
    """[N, side*side] tile ids of each Gaussian's rect and their validity
    (inside the rect, visible, passing the tile-ellipse cull)."""
    side = cfg.rect_side
    dev = prims.rect.device
    j = torch.arange(side * side, device=dev)
    rect = prims.rect
    tx = rect[:, 0:1] + (j % side)[None, :]
    ty = rect[:, 1:2] + (j // side)[None, :]
    valid = (tx < rect[:, 2:3]) & (ty < rect[:, 3:4]) & prims.visible[:, None]
    m2d = prims.means2d.detach()
    conic = prims.conics.detach()
    qmin = tile_alpha_bound(
        m2d[:, 0:1], m2d[:, 1:2], conic[:, 0:1], conic[:, 1:2],
        conic[:, 2:3], tx.to(torch.float32), ty.to(torch.float32), cfg.tile,
    )
    bound = prims.opacities.detach()[:, None] * torch.exp(-0.5 * qmin)
    # the 1e-3 margin keeps float rounding between this bound and the
    # compositing gate from culling a pair the kernel would pass
    valid = valid & (bound >= cfg.alpha_min * (1.0 - 1e-3))
    return ty * tiles_x + tx, valid


def build_pair_lists(
    prims_batch: Sequence[ProjectedGaussians],
    tiles_x: int,
    tiles_y: int,
    capacity: int,
    cfg: RasterizeConfig,
) -> PairLists:
    """Pair lists for a batch of cameras (one ProjectedGaussians each,
    all with the same N), ordered by (camera, tile, depth)."""
    tiles = tiles_x * tiles_y
    n_cams = len(prims_batch)
    dev = prims_batch[0].depths.device
    keys, gids, per_row = [], [], []
    for b, prims in enumerate(prims_batch):
        n = prims.depths.shape[0]
        tile_id, valid = _candidates(prims, tiles_x, cfg)
        g, j = valid.nonzero(as_tuple=True)
        depth_bits = prims.depths.detach().view(torch.int32)[g].to(torch.int64)
        tile_g = tile_id[g, j].to(torch.int64) + b * tiles
        keys.append((tile_g << 32) | depth_bits)
        gids.append(g + b * n)
        per_row.append(valid.sum(dim=1))
    keys = torch.cat(keys)
    gids = torch.cat(gids)
    sorted_keys, perm = torch.sort(keys, stable=True)
    sorted_tile = sorted_keys >> 32
    starts = torch.searchsorted(
        sorted_tile, torch.arange(n_cams * tiles + 1, device=dev)
    )
    seg_len = starts[1:] - starts[:-1]
    counts = torch.clamp_max(seg_len, capacity)
    # the routing: the sort's permutation and its inverse, cap-cut pairs -1
    sorted_pos = torch.arange(perm.shape[0], device=dev)
    kept = sorted_pos - starts[sorted_tile] < counts[sorted_tile]
    cand_pos = torch.empty_like(perm)
    cand_pos[perm] = torch.where(kept, sorted_pos, -1)
    row_starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.cumsum(torch.cat(per_row), 0)])
    return PairLists(
        gids=gids[perm].to(torch.int32),
        sorted_tile=sorted_tile,
        starts=starts.to(torch.int32),
        counts=counts.to(torch.int32),
        overflow=(seg_len - counts).sum(),
        cand_pos=cand_pos.to(torch.int32),
        row_starts=row_starts.to(torch.int32),
        pair_cand=perm.to(torch.int32),
    )
