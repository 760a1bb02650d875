"""K1 / K2's sub-tile skip rule, through its plain version
`subtile_pair_mask` (the kernels run only on a card).

(a) On seeded random pair lists (random segments as the kernel tests use,
    binned projections of a random scene, anisotropic rotated conics, and
    pairs placed at the 1/255 knife-edge with their means outside the
    sub-tile or the tile), no pair that the rule drops for a sub-tile
    passes the alpha gate at any pixel of that sub-tile, evaluated with
    the kernels' own float32 arithmetic; and the rule does drop pairs.
(b) `composite_plain` and `composite_backward_plain` on the pair lists
    restricted per sub-tile to the walked pairs (a dropped pair's slot
    points at a null row of opacity 0, so every pair keeps its position
    and segment-local index) give bit-equal image, depth, alpha, final_t
    and n_contrib on the sub-tile's pixels, and bit-equal gradients for
    cotangents that vanish outside the sub-tile, compared with the whole
    segments.
"""
import numpy as np
import pytest
import torch

from humangaussian_torch.ops.projection import RasterizeConfig
from humangaussian_torch.ops.rasterize_tiled import (
    SUBTILE,
    composite_backward_plain,
    composite_plain,
    counted_pairs,
    subtile_pair_mask,
)
from port_parity_torch import projected_composite_args, random_composite_args

torch.set_num_threads(1)
CFG = RasterizeConfig()
PER_EDGE = CFG.tile // SUBTILE


def knife_edge_args(seed=0, n=400, tiles_x=2, tiles_y=2):
    """One segment per tile of pairs whose best-case alpha over a sub-tile
    sits within 0.3% of 1/255: the mean a few pixels outside the sub-tile's
    box (often outside the tile, or the image), at the pixel nearest the
    mean opa exp(-Q/2) = alpha_min (1 + eps), rotated anisotropic conics."""
    rng = np.random.RandomState(seed)
    tile = CFG.tile
    feats = np.zeros((n, 10), np.float32)
    for i in range(n):
        t = rng.randint(tiles_x * tiles_y)
        s = rng.randint(PER_EDGE * PER_EDGE)
        x0 = (t % tiles_x) * tile + (s % PER_EDGE) * SUBTILE
        y0 = (t // tiles_x) * tile + (s // PER_EDGE) * SUBTILE
        # nearest pixel centre of the box, and the mean just outside it
        side = rng.randint(4)
        gap = rng.uniform(0.5, 12.0)
        px = x0 + rng.randint(SUBTILE)
        py = y0 + rng.randint(SUBTILE)
        if side == 0:
            px, mx, my = x0, x0 - gap, py
        elif side == 1:
            px, mx, my = x0 + SUBTILE - 1, x0 + SUBTILE - 1 + gap, py
        elif side == 2:
            py, mx, my = y0, px, y0 - gap
        else:
            py, mx, my = y0 + SUBTILE - 1, px, y0 + SUBTILE - 1 + gap
        theta = rng.uniform(0, np.pi)
        lam = rng.uniform(0.005, 0.5, 2)
        rot = np.array([[np.cos(theta), -np.sin(theta)],
                        [np.sin(theta), np.cos(theta)]])
        conic = rot @ np.diag(lam) @ rot.T
        d = np.array([mx - px, my - py])
        q = float(d @ conic @ d)
        eps = rng.uniform(-3e-3, 3e-3)
        opa = min(CFG.alpha_min * (1 + eps) * np.exp(0.5 * q), 0.99)
        feats[i] = [mx, my, conic[0, 0], conic[0, 1], conic[1, 1],
                    *rng.rand(3), opa, rng.uniform(0.5, 3.0)]
    gids, starts, counts = [], [], []
    for t in range(tiles_x * tiles_y):
        ids = rng.permutation(n)[:n // 2]
        ids = ids[np.argsort(feats[ids, 9], kind="stable")]
        starts.append(len(gids))
        counts.append(len(ids))
        gids.extend(ids.tolist())

    def tt(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype)

    return (tt(feats, torch.float32), tt(gids, torch.int32),
            tt(starts, torch.int32), tt(counts, torch.int32),
            tt([0.2, 0.3, 0.4], torch.float32), tiles_x, tiles_y)


CASES = {
    "random_segments": lambda: (random_composite_args(
        seed=5, tiles_x=3, tiles_y=2, cams=2, n=300, pairs_per_tile=120),
        CFG),
    "broad_random_segments": lambda: (random_composite_args(
        seed=6, tiles_x=2, tiles_y=2, n=200, pairs_per_tile=100), CFG),
    "projected_2x2_rect": lambda: projected_composite_args(
        seed=3, cams=3, max_tiles=4),
    "projected_3x3_rect": lambda: projected_composite_args(
        seed=4, n=400, hw=(64, 96), cams=2, max_tiles=9, spread=0.3),
    "knife_edge": lambda: (knife_edge_args(seed=7), CFG),
}


def pixel_gate(feats, gids, starts, counts, tiles_x, tiles_y, cfg):
    """[P, subs, sub^2] bool: pair p passes the alpha gate at that pixel of
    its tile's sub-tile, in the kernels' float32 arithmetic (power term in
    K1's order, alpha clamped; every pixel of the sub-tile is tested)."""
    tile_of, _, pos = counted_pairs(starts, counts)
    f = feats[gids[pos].to(torch.int64)]
    t_local = tile_of % (tiles_x * tiles_y)
    s = torch.arange(PER_EDGE * PER_EDGE)
    lin = torch.arange(SUBTILE * SUBTILE)
    px = ((t_local % tiles_x)[:, None, None] * cfg.tile
          + (s % PER_EDGE)[None, :, None] * SUBTILE
          + (lin % SUBTILE)[None, None, :]).to(torch.float32)
    py = ((t_local // tiles_x)[:, None, None] * cfg.tile
          + (s // PER_EDGE)[None, :, None] * SUBTILE
          + (lin // SUBTILE)[None, None, :]).to(torch.float32)
    col = [f[:, j][:, None, None] for j in range(10)]
    dx = col[0] - px
    dy = col[1] - py
    quad = col[2] * dx * dx + col[4] * dy * dy
    power = -0.5 * quad - col[3] * dx * dy
    alpha = torch.clamp_max(col[8] * torch.exp(power), cfg.alpha_max)
    passes = (power <= 0.0) & (alpha >= cfg.alpha_min)
    full = torch.zeros((gids.shape[0],) + passes.shape[1:], dtype=torch.bool)
    full[pos] = passes
    return full


@pytest.mark.parametrize("case", sorted(CASES))
def test_skip_rule_drops_no_pair_that_passes_the_gate(case):
    args, cfg = CASES[case]()
    feats, gids, starts, counts, _, tx, ty = args
    mask = subtile_pair_mask(feats, gids, starts, counts, tx, ty, cfg)
    passes = pixel_gate(feats, gids, starts, counts, tx, ty, cfg)
    assert mask.shape == (gids.shape[0], PER_EDGE * PER_EDGE)
    wrongly = (~mask)[..., None] & passes
    assert not bool(wrongly.any()), int(wrongly.any(-1).sum())
    # every pair that passes somewhere is walked; the rule drops others
    reaches = passes.any(-1)
    assert bool(mask[reaches].all())
    assert int((~mask & ~reaches).sum()) > 0


def restricted(args, keep):
    """The pair lists with every slot not in `keep` pointing at an
    appended null row (opacity 0: it fails the gate everywhere)."""
    feats, gids, starts, counts, bg, tx, ty = args
    null = torch.zeros((1, 10), dtype=torch.float32)
    null[0, 2] = null[0, 4] = 1.0
    feats_r = torch.cat([feats, null])
    gids_r = torch.where(keep, gids, feats.shape[0]).to(torch.int32)
    return (feats_r, gids_r, starts, counts, bg, tx, ty)


def subtile_pixels(s, b, tiles_x, tiles_y, tile):
    """[B, H, W] bool: the pixels of sub-tile s in every tile."""
    lin_y = torch.arange(tiles_y * tile) % tile // SUBTILE
    lin_x = torch.arange(tiles_x * tile) % tile // SUBTILE
    sub = lin_y[:, None] * PER_EDGE + lin_x[None, :]
    return (sub == s)[None].expand(b, -1, -1)


# smaller inputs: every sub-tile of every case runs both plain versions
RESTRICTED_CASES = {
    "random_segments": lambda: (random_composite_args(
        seed=5, tiles_x=2, tiles_y=2, n=200, pairs_per_tile=80), CFG),
    "projected_2x2_rect": lambda: projected_composite_args(
        seed=3, n=300, hw=(64, 64), cams=2, max_tiles=4),
    "knife_edge": lambda: (knife_edge_args(seed=7, n=200, tiles_x=2,
                                           tiles_y=1), CFG),
}


@pytest.mark.parametrize("case", sorted(RESTRICTED_CASES))
def test_restricted_plain_walk_is_bit_equal(case):
    args, cfg = RESTRICTED_CASES[case]()
    feats, gids, starts, counts, bg, tx, ty = args
    mask = subtile_pair_mask(feats, gids, starts, counts, tx, ty, cfg)
    whole = composite_plain(*args, cfg)
    b = whole["depth"].shape[0]
    g = torch.Generator().manual_seed(len(case))
    cot = [torch.randn(whole[k].shape, generator=g)
           for k in ("image", "depth", "alpha")]
    dropped = 0
    for s in range(PER_EDGE * PER_EDGE):
        args_r = restricted(args, mask[:, s])
        dropped += int((~mask[:, s]).sum())
        part = composite_plain(*args_r, cfg)
        on = subtile_pixels(s, b, tx, ty, cfg.tile)
        for key in ("image", "depth", "alpha", "final_t", "n_contrib"):
            assert torch.equal(part[key][on], whole[key][on]), (s, key)
        cot_s = [torch.where(on[..., None] if c.dim() == 4 else on, c, 0.0)
                 for c in cot]
        want = composite_backward_plain(*args[:5], whole, cot_s, tx, ty, cfg)
        got = composite_backward_plain(*args_r[:5], part, cot_s, tx, ty, cfg)
        assert torch.equal(got[:-1], want), s
        assert float(want.abs().max()) > 0
    assert dropped > 0


def test_plain_rule_and_kernels_share_the_sub_tile():
    """The plain rule's sub-tile edge and margin are the ones K1 and K2
    are compiled with (csrc/rasterize_subtile.cuh)."""
    import os
    import re

    from humangaussian_torch.kernels import CSRC_DIR
    from humangaussian_torch.ops.rasterize_tiled import SKIP_MARGIN

    src = open(os.path.join(CSRC_DIR, "rasterize_subtile.cuh")).read()
    assert int(re.search(r"constexpr int kSub = (\d+);", src)[1]) == SUBTILE
    assert int(re.search(r"constexpr int kTile = (\d+);", src)[1]) == CFG.tile
    margin = float(re.search(r"constexpr float kSkipMargin = ([0-9.e-]+)f;",
                             src)[1])
    assert margin == SKIP_MARGIN
