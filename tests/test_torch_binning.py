"""PyTorch port vs JAX: per-tile depth-ordered pair lists.

For every tile the port's ordered Gaussian ids must equal those of the JAX
`build_pair_lists` (whenever JAX reports overflow == 0), and a small
per-tile `tile_capacity` must drop the same (deepest) pairs and report the
same overflow. Both sides bin the same projected primitives' rects, which
test_torch_projection.py holds equal.
"""
import numpy as np
import pytest
import torch

from humangaussian_torch.ops.binning import build_pair_lists as t_bin
from humangaussian_torch.ops.binning import tile_alpha_bound
from humangaussian_torch.ops.projection import RasterizeConfig as TCfg
from humangaussian_torch.ops.projection import project_gaussians as t_project
from humangaussian_tpu.ops.binning import _tile_alpha_bound
from humangaussian_tpu.ops.binning import build_pair_lists as j_bin
from humangaussian_tpu.ops.projection import RasterizeConfig as JCfg
from humangaussian_tpu.ops.projection import project_gaussians as j_project
from port_parity import (jax_args, jax_camera, make_scene, np_,
                         torch_args, torch_camera_from_jax)

torch.set_num_threads(1)


def _jax_lists(pairs, tiles):
    gid, starts, counts = (np_(pairs.sorted_gid), np_(pairs.starts),
                           np_(pairs.counts))
    return [gid[starts[t]:starts[t] + counts[t]].tolist()
            for t in range(tiles)]


def _torch_lists(pairs, tiles, n, cam=0):
    gid, starts, counts = (np_(pairs.gids), np_(pairs.starts),
                           np_(pairs.counts))
    out = []
    for t in range(cam * tiles, (cam + 1) * tiles):
        out.append((gid[starts[t]:starts[t] + counts[t]] - cam * n).tolist())
    return out


def _both(seed, hw, max_tiles, capacity, n=400):
    scene = make_scene(n=n, n_dead=30, seed=seed)
    jcam = jax_camera(*hw)
    jp = j_project(*jax_args(scene), jcam, 0,
                   JCfg(max_tiles_per_gaussian=max_tiles))
    tp = t_project(*torch_args(scene), torch_camera_from_jax(jcam), 0,
                   TCfg(max_tiles_per_gaussian=max_tiles))
    tiles_x, tiles_y = hw[1] // 32, hw[0] // 32
    jpairs = j_bin(jp, tiles_x, tiles_y, capacity,
                   JCfg(max_tiles_per_gaussian=max_tiles))
    tpairs = t_bin([tp], tiles_x, tiles_y, capacity,
                   TCfg(max_tiles_per_gaussian=max_tiles))
    return jpairs, tpairs, tiles_x * tiles_y


@pytest.mark.parametrize("max_tiles", [4, 9, 16])
@pytest.mark.parametrize("seed,hw", [(0, (64, 64)), (5, (96, 64))])
def test_pair_lists_match(max_tiles, seed, hw):
    jpairs, tpairs, tiles = _both(seed, hw, max_tiles, capacity=4096)
    assert int(jpairs.overflow) == 0
    assert int(tpairs.overflow) == 0
    jl = _jax_lists(jpairs, tiles)
    tl = _torch_lists(tpairs, tiles, 400)
    assert sum(map(len, jl)) > 200
    assert tl == jl


def test_tile_capacity_drops_the_same_pairs():
    jpairs, tpairs, tiles = _both(2, (64, 64), 9, capacity=24)
    assert int(tpairs.overflow) > 0
    assert int(tpairs.overflow) == int(jpairs.overflow)
    assert _torch_lists(tpairs, tiles, 400) == _jax_lists(jpairs, tiles)
    assert max(np_(tpairs.counts)) == 24


def test_batch_segments_are_per_camera():
    """Two cameras in one sort: camera 1's segments are its own lists,
    with feature rows offset by N."""
    scene = make_scene(n=300, n_dead=0, seed=4)
    cams = [jax_camera(64, 64), jax_camera(64, 64, eye=(-1.0, 0.5, 2.5))]
    cfg_j, cfg_t = JCfg(), TCfg()
    tps = [t_project(*torch_args(scene), torch_camera_from_jax(c), 0, cfg_t)
           for c in cams]
    tpairs = t_bin(tps, 2, 2, 4096, cfg_t)
    for i, c in enumerate(cams):
        jp = j_project(*jax_args(scene), c, 0, cfg_j)
        jpairs = j_bin(jp, 2, 2, 4096, cfg_j)
        assert _torch_lists(tpairs, 4, 300, cam=i) == _jax_lists(jpairs, 4)


def test_tile_alpha_bound():
    rng = np.random.RandomState(0)
    m = 512
    args = [rng.rand(m).astype(np.float32) * 96 - 16,
            rng.rand(m).astype(np.float32) * 96 - 16,
            rng.rand(m).astype(np.float32) * 0.5 + 0.01,
            (rng.rand(m).astype(np.float32) - 0.5) * 0.1,
            rng.rand(m).astype(np.float32) * 0.5 + 0.01,
            rng.randint(0, 3, m).astype(np.float32),
            rng.randint(0, 3, m).astype(np.float32)]
    want = np_(_tile_alpha_bound(*args, 32))
    got = np_(tile_alpha_bound(*[torch.from_numpy(a) for a in args], 32))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (want == 0).any() and (want > 0).any()


def test_empty_scene_has_no_pairs():
    scene = make_scene(n=64, n_dead=64, seed=1)
    tp = t_project(*torch_args(scene),
                   torch_camera_from_jax(jax_camera()), 0, TCfg())
    pairs = t_bin([tp], 2, 2, 4096, TCfg())
    assert pairs.gids.numel() == 0
    assert np_(pairs.counts).tolist() == [0, 0, 0, 0]
    assert int(pairs.overflow) == 0


@pytest.mark.parametrize("capacity", [4096, 24])
def test_routing_maps_candidates_to_their_pairs(capacity):
    """The kept permutation of the sort (`cand_pos`, the JAX `pos2`) maps
    each candidate, in candidate order (camera, Gaussian, rect tile), to
    its sorted pair: `gids` there is the candidate's feature row;
    `row_starts` bounds each row's candidates; the pairs the cap cut are
    -1 and no other; every counted pair is reached once; `pair_cand`
    gives each sorted pair its candidate (the inverse of `cand_pos` on the
    kept pairs, a permutation); and `pair_routing` rebuilds the same
    routing from the sorted lists."""
    from humangaussian_torch.ops.binning import _candidates
    from humangaussian_torch.ops.rasterize_tiled import (counted_pairs,
                                                         pair_routing)

    scene = make_scene(n=300, n_dead=20, seed=6)
    cams = [jax_camera(64, 64), jax_camera(64, 64, eye=(-1.0, 0.5, 2.5))]
    cfg = TCfg(max_tiles_per_gaussian=9)
    tps = [t_project(*torch_args(scene), torch_camera_from_jax(c), 0, cfg)
           for c in cams]
    pairs = t_bin(tps, 2, 2, capacity, cfg)
    rows = []
    for b, tp in enumerate(tps):
        g, _ = _candidates(tp, 2, cfg)[1].nonzero(as_tuple=True)
        rows.append(g + b * 300)
    cand_rows = torch.cat(rows)
    cand_pos = pairs.cand_pos.to(torch.int64)
    kept = cand_pos >= 0
    assert cand_pos.shape == cand_rows.shape == pairs.gids.shape
    assert torch.equal(pairs.gids.to(torch.int64)[cand_pos[kept]],
                       cand_rows[kept])
    per_row = torch.bincount(cand_rows, minlength=600)
    assert pairs.row_starts.tolist() == [0] + torch.cumsum(
        per_row, 0).tolist()
    assert int((~kept).sum()) == int(pairs.overflow)
    assert (int(pairs.overflow) > 0) == (capacity == 24)
    _, _, counted = counted_pairs(pairs.starts[:-1], pairs.counts)
    assert sorted(cand_pos[kept].tolist()) == sorted(counted.tolist())
    pair_cand = pairs.pair_cand.to(torch.int64)
    assert pairs.pair_cand.dtype == torch.int32
    assert torch.equal(torch.sort(pair_cand).values,
                       torch.arange(pair_cand.shape[0]))
    assert torch.equal(pair_cand[cand_pos[kept]],
                       torch.nonzero(kept).flatten())
    assert torch.equal(cand_rows[pair_cand], pairs.gids.to(torch.int64))
    want = pair_routing(pairs.gids, pairs.starts[:-1], pairs.counts, 600)
    assert torch.equal(pairs.cand_pos, want[0])
    assert torch.equal(pairs.row_starts, want[1])
    assert torch.equal(pairs.pair_cand, want[2])
