"""PyTorch port vs JAX: the render backward (K2's plain version on the CPU).

(a) `composite_backward_plain`, the analytic replay VJP, against torch
    autograd through `composite_plain`: 3e-5 of each column's max-|grad|
    (f32 sums in another order; both replay the same gates).
(b) the port's `rasterize_tiled` gradients of means, log-scales, quats,
    sh, opacity logits and the `means2d_offset` tap against `jax.grad` of
    the JAX `rasterize_tiled` (Pallas backward in interpret mode), of the
    JAX oracle, and against autograd through the port's brute-force
    oracle: 3e-5 of max-|grad| (ROADMAP.md tolerances).
(c) the six recorded gradients of every tests/fixtures/cuda/*.npz at
    2e-4 of max-|grad| (tests/test_cuda_fixtures.py GRAD_RTOL), on the
    JAX-built camera as the forward replay does.
(d) special cases, exact: a pair at power == 0 feeds dopacity but not the
    conic or the mean; a clamped pair (opa exp >= 0.99) passes no gradient
    to opacity, mean or conic; pairs past a pixel's done latch and past
    the tile's capped count get exactly 0; a batch of 2 cameras sums both
    cameras' gradients.
(e) K2b's plain version (`feature_row_grads_plain`), each feature row's
    candidates in order and each candidate's masked sub-tile rows in
    order: bit-equal to a Python loop over each row's candidates, within
    1e-6 of each column's max of an `index_add_` in float64, and pairs cut
    by a tile's cap add nothing; K2's plain sub-tile rows add up to the
    whole tile's (1e-5 of each column's max), sit at each pair's candidate
    index and sum, bit for bit, as the sorted layout summed them; an
    emulation of K2b's chunked staging (warp spans, chunks cut by the
    stage) is bit-equal to the plain version.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.ops.projection import RasterizeConfig as TCfg
from humangaussian_torch.ops.rasterize_ref import rasterize_reference as t_ref
from humangaussian_torch.ops.rasterize_tiled import (
    composite,
    composite_plain,
    feature_row_grads,
    feature_row_grads_plain,
    pair_routing,
    rasterize_tiled as t_tiled,
    rasterize_tiled_batch as t_tiled_batch,
)
from humangaussian_tpu.core.camera import camera_from_c2w as j_camera
from humangaussian_tpu.ops.projection import RasterizeConfig as JCfg
from humangaussian_tpu.ops.rasterize_ref import rasterize_reference as j_ref
from humangaussian_tpu.ops.rasterize_tiled import rasterize_tiled as j_tiled
from port_parity import (jax_camera, make_scene, np_,
                         stack_jax_cameras, torch_args, torch_camera_from_jax)
from port_parity_torch import long_row_routing, random_composite_args

torch.set_num_threads(1)
GRAD_TOL = 3e-5  # of max-|grad| per tensor
FIXTURE_GRAD_TOL = 2e-4
BG = np.array([0.1, 0.2, 0.3], np.float32)
FIXTURES = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "fixtures", "cuda", "*.npz")))
GRAD_KEYS = ("means", "scales", "quats", "sh", "opacities", "means2d_offset")


def _cotangents(shape_hw, seed, batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return (rng.standard_normal(lead + shape_hw + (3,)).astype(np.float32),
            rng.standard_normal(lead + shape_hw).astype(np.float32),
            rng.standard_normal(lead + shape_hw).astype(np.float32))


def _scalar(out, cot):
    return ((out["image"] * cot[0]).sum() + (out["depth"] * cot[1]).sum()
            + (out["alpha"] * cot[2]).sum())


def _assert_grads_close(got, want, tol, what, keys=GRAD_KEYS):
    for key in keys:
        w = np_(want[key])
        scale = max(float(np.max(np.abs(w))), 1e-20)
        np.testing.assert_allclose(np_(got[key]) / scale, w / scale,
                                   atol=tol, err_msg=f"{what}: grad {key}")


def _torch_grads(render, params, cot):
    leaves = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in params.items()}
    loss = _scalar(render(leaves), [torch.from_numpy(c) for c in cot])
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


@pytest.mark.parametrize("cams,seed", [(1, 3), (2, 4)])
def test_backward_plain_matches_autograd(cams, seed):
    feats, gids, starts, counts, _, tx, ty = random_composite_args(
        cams=cams, tiles_x=2, tiles_y=3, n=200, pairs_per_tile=150,
        seed=seed)
    bg = torch.from_numpy(BG)
    cot = [torch.from_numpy(c) for c in _cotangents((96, 64), seed, cams)]
    ref_in = feats.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        _scalar(composite_plain(ref_in, gids, starts, counts, bg, tx, ty),
                cot), ref_in)
    got_in = feats.clone().requires_grad_(True)
    out = composite(got_in, gids, starts, counts, bg, tx, ty)
    assert not out["final_t"].requires_grad
    (got,) = torch.autograd.grad(_scalar(out, cot), got_in)
    assert int(out["n_contrib"].max()) > 100
    for j in range(10):
        scale = float(want[:, j].abs().max())
        assert scale > 0
        assert float((got[:, j] - want[:, j]).abs().max()) <= GRAD_TOL * scale


RAW_KEYS = ("means", "log_scales", "quats", "sh", "opacity_logits",
            "means2d_offset")


@pytest.mark.parametrize("hw,sh_degree,max_tiles", [
    ((64, 64), 0, 16),
    ((96, 64), 1, 9),
])
def test_tiled_grads_match_jax_and_oracle(hw, sh_degree, max_tiles):
    """Gradients of the raw parameters (log-scales and opacity logits, what
    the trainers differentiate and what the JAX package's own gradient
    test holds its kernel to the oracle in). With respect to the activated
    scales the JAX kernel's tile-centred monomial sums reach 6.4e-5 of
    max-|grad| against the JAX oracle on these scenes, while the port
    stays below 2e-6 of both oracles (ROADMAP.md queue 3)."""
    means, log_scales, quats, sh, opa_logits, alive = make_scene(
        n=256, n_dead=40, seed=sum(hw) + sh_degree, sh_degree=sh_degree)
    n = means.shape[0]
    params = dict(means=means, log_scales=log_scales, quats=quats, sh=sh,
                  opacity_logits=opa_logits,
                  means2d_offset=np.zeros((n, 2), np.float32))
    cot = _cotangents(hw, 7)
    jcam = jax_camera(*hw)
    tcam = torch_camera_from_jax(jcam)

    def j_loss(fn, **kw):
        def run(p):
            out = fn(p["means"], jnp.exp(p["log_scales"]), p["quats"],
                     p["sh"], jax.nn.sigmoid(p["opacity_logits"]),
                     jnp.asarray(alive), jcam, jnp.asarray(BG), sh_degree,
                     JCfg(max_tiles_per_gaussian=max_tiles),
                     means2d_offset=p["means2d_offset"], **kw)
            return _scalar(out, [jnp.asarray(c) for c in cot])
        return run

    def t_render(fn, **kw):
        def run(p):
            return fn(p["means"], torch.exp(p["log_scales"]), p["quats"],
                      p["sh"], torch.sigmoid(p["opacity_logits"]),
                      torch.from_numpy(alive), tcam, torch.from_numpy(BG),
                      sh_degree, TCfg(max_tiles_per_gaussian=max_tiles),
                      means2d_offset=p["means2d_offset"], **kw)
        return run

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    got = _torch_grads(t_render(t_tiled, tile_capacity=512), params, cot)
    _assert_grads_close(got, jax.grad(j_loss(j_tiled, tile_capacity=512))(jp),
                        GRAD_TOL, "vs jax.grad of rasterize_tiled", RAW_KEYS)
    _assert_grads_close(got, jax.grad(j_loss(j_ref))(jp), GRAD_TOL,
                        "vs jax.grad of the JAX oracle", RAW_KEYS)
    _assert_grads_close(got, _torch_grads(t_render(t_ref), params, cot),
                        GRAD_TOL, "vs the port's oracle", RAW_KEYS)
    assert float(np.abs(np_(got["means2d_offset"])).max()) > 0


def test_batch_sums_both_cameras_gradients():
    scene = make_scene(n=200, n_dead=10, seed=5, sh_degree=1)
    args = torch_args(scene)
    alive = args[5]
    eyes = [(0.3, 0.2, 3.0), (-2.0, 0.5, 2.0)]
    jcams = [jax_camera(64, 64, eye=e) for e in eyes]
    batch_cam = torch_camera_from_jax(stack_jax_cameras(jcams))
    cot = _cotangents((64, 64), 9, batch=2)
    params = dict(means=np_(args[0]), scales=np_(args[1]),
                  quats=np_(args[2]), sh=np_(args[3]), opacities=np_(args[4]),
                  means2d_offset=np.zeros((200, 2), np.float32))

    def run(fn, cam):
        return lambda p: fn(p["means"], p["scales"], p["quats"], p["sh"],
                            p["opacities"], alive, cam, torch.from_numpy(BG),
                            1, means2d_offset=p["means2d_offset"])

    got = _torch_grads(run(t_tiled_batch, batch_cam), params, cot)
    singles = [
        _torch_grads(run(t_tiled, torch_camera_from_jax(c)), params,
                     [x[i] for x in cot])
        for i, c in enumerate(jcams)
    ]
    want = {k: singles[0][k] + singles[1][k] for k in GRAD_KEYS}
    _assert_grads_close(got, want, GRAD_TOL, "batch of 2")


@pytest.mark.parametrize("path", FIXTURES,
                         ids=[os.path.basename(p) for p in FIXTURES])
def test_fixture_replay_gradients(path):
    fx = np.load(path, allow_pickle=False)
    n = fx["means"].shape[0]
    h, w = int(fx["height"]), int(fx["width"])
    cam = torch_camera_from_jax(
        j_camera(jnp.asarray(fx["c2w"]), float(fx["fovy"]), h, w))
    params = dict(means=fx["means"], scales=fx["scales"], quats=fx["quats"],
                  sh=fx["sh"], opacities=fx["opacities"],
                  means2d_offset=np.zeros((n, 2), np.float32))

    def render(p):
        return t_tiled(
            p["means"], p["scales"], p["quats"], p["sh"], p["opacities"],
            torch.ones(n, dtype=torch.bool), cam,
            torch.from_numpy(fx["background"]), int(fx["sh_degree"]),
            TCfg(tile=32, max_tiles_per_gaussian=16),
            scale_modifier=float(fx["scale_modifier"]),
            means2d_offset=p["means2d_offset"],
        )

    got = _torch_grads(render, params,
                       (fx["g_image"], fx["g_depth"], fx["g_alpha"]))
    want = dict(means=fx["d_means"], scales=fx["d_scales"],
                quats=fx["d_quats"], sh=fx["d_sh"],
                opacities=fx["d_opacities"], means2d_offset=fx["d_means2d"])
    _assert_grads_close(got, want, FIXTURE_GRAD_TOL, os.path.basename(path))


# ---- (d) special cases on hand-built pair lists (one 32x32 tile) ----------

def _one_tile(rows, count=None):
    """composite args for one tile holding `rows` ([x, y, ca, cb, cc, r, g,
    b, opa, depth]) in order; `count` caps the segment."""
    feats = torch.tensor(rows, dtype=torch.float32).requires_grad_(True)
    m = feats.shape[0]
    return (feats, torch.arange(m, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.tensor([m if count is None else count], dtype=torch.int32),
            torch.from_numpy(BG), 1, 1)


def _grad(args, seed=0):
    out = composite(*args)
    cot = [torch.from_numpy(c) for c in _cotangents((32, 32), seed, 1)]
    (g,) = torch.autograd.grad(_scalar(out, cot), args[0])
    return out, cot, g


def test_pair_at_zero_power_feeds_opacity_only():
    # so tight that only the pixel under the mean passes the 1/255 gate,
    # and there dx = dy = 0: power == 0 passes the forward gate
    row = [5.0, 7.0, 50.0, 0.0, 50.0, 0.3, 0.6, 0.9, 0.5, 2.0]
    out, cot, g = _grad(_one_tile([row]))
    assert int((out["n_contrib"] > 0).sum()) == 1
    assert int(out["n_contrib"][0, 7, 5]) == 1
    phi = float((cot[0][0, 7, 5] * torch.tensor(row[5:8])).sum()
                + cot[1][0, 7, 5] * row[9])
    want = phi - float((cot[0][0, 7, 5] * torch.from_numpy(BG)).sum()) \
        + float(cot[2][0, 7, 5])
    assert float(g[0, 8]) == pytest.approx(want, rel=1e-5)
    assert want != 0.0
    np.testing.assert_array_equal(g[0, :5].numpy(), 0.0)  # mean, conic
    assert float(g[0, 5]) == pytest.approx(0.5 * float(cot[0][0, 7, 5, 0]),
                                           rel=1e-6)


def test_clamped_pair_gets_no_alpha_gradient():
    row = [5.0, 7.0, 50.0, 0.0, 50.0, 0.3, 0.6, 0.9, 1.0, 2.0]
    out, cot, g = _grad(_one_tile([row]))
    assert float(out["alpha"].detach()[0, 7, 5]) == pytest.approx(0.99)
    np.testing.assert_array_equal(g[0, :5].numpy(), 0.0)
    assert float(g[0, 8]) == 0.0
    assert float(g[0, 5]) == pytest.approx(0.99 * float(cot[0][0, 7, 5, 0]),
                                           rel=1e-6)


def test_pairs_past_the_latch_and_the_cap_get_zero():
    # 8 broad opaque layers saturate every pixel of the tile; the 9th sits
    # behind the done latch
    front = [[16.0, 16.0, 1e-6, 0.0, 1e-6, 0.5, 0.5, 0.5, 0.9, 1.0 + i]
             for i in range(8)]
    back = [16.0, 16.0, 1e-3, 0.0, 1e-3, 0.9, 0.1, 0.2, 0.8, 20.0]
    out, _, g = _grad(_one_tile(front + [back]))
    assert int(out["n_contrib"].max()) < 9
    np.testing.assert_array_equal(g[8].numpy(), 0.0)
    assert float(g[0].abs().max()) > 0
    # translucent layers, all contributing, but the tile's count is capped
    rows = [[16.0, 16.0, 1e-3, 0.0, 1e-3, 0.5, 0.4, 0.3, 0.2, 1.0 + i]
            for i in range(6)]
    out, _, g = _grad(_one_tile(rows, count=4))
    assert int(out["n_contrib"].max()) == 4
    np.testing.assert_array_equal(g[4:].numpy(), 0.0)
    assert bool((g[:4].abs().amax(dim=1) > 0).all())


def test_padded_ply_scene_has_finite_gradients_on_every_row(tmp_path):
    """A scene loaded through `io/ply.load_ply` is padded to its capacity
    with zero quaternions; rendering a batch and backpropagating gives
    finite gradients on every row (0 on the dead ones), and the alive rows'
    gradients match those of the unpadded scene."""
    from humangaussian_torch.core.camera import camera_from_c2w, look_at_c2w
    from humangaussian_torch.core.scene import GaussianScene
    from humangaussian_torch.io.ply import load_ply, save_ply
    from humangaussian_torch.render import render_batch

    means, log_scales, quats, feats, opa_logits, _ = make_scene(
        n=300, n_dead=0, seed=21)
    scene = GaussianScene(
        means=torch.from_numpy(means), log_scales=torch.from_numpy(log_scales),
        quats=torch.from_numpy(quats), sh_dc=torch.from_numpy(feats[:, 0]),
        sh_rest=torch.zeros((300, 0, 3)),
        opacity_logits=torch.from_numpy(opa_logits[:, None]),
        alive=torch.ones(300, dtype=torch.bool))
    path = str(tmp_path / "scene.ply")
    save_ply(scene, path)
    padded = load_ply(path, device="cpu")
    assert padded.capacity == 512 and padded.num_alive == 300
    assert float(padded.quats[300:].abs().max()) == 0.0
    eyes = ([0.3, 0.2, 3.0], [-2.0, 0.5, 2.0])
    c2w = torch.stack([look_at_c2w(torch.tensor(e), torch.zeros(3),
                                   torch.tensor([0.0, 1.0, 0.0]))
                       for e in eyes])
    cams = camera_from_c2w(c2w, torch.tensor([0.8, 0.8]), 64, 64)
    cot = [torch.from_numpy(c) for c in _cotangents((64, 64), 22, 2)]

    def grads(sc):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in sc.params().items()}
        out = render_batch(sc.replace_params(leaves), cams,
                           torch.from_numpy(BG), cfg=TCfg(
                               max_tiles_per_gaussian=4))
        _scalar(out, cot).backward()
        return {k: v.grad for k, v in leaves.items()}

    got = grads(padded)
    for key, g in got.items():
        assert bool(torch.isfinite(g).all()), key
        if g.numel():
            assert float(g[300:].abs().max()) == 0.0, key
    want = grads(load_ply(path, capacity=300, device="cpu"))
    for key in ("means", "log_scales", "quats", "sh_dc", "opacity_logits"):
        scale = float(want[key].abs().max())
        assert scale > 0, key
        np.testing.assert_allclose(got[key][:300].numpy() / scale,
                                   want[key].numpy() / scale, atol=1e-6,
                                   err_msg=key)


# ---- (e) K2b: each feature row's pair rows, in candidate order ------------

def _routed_pair_rows(seed=0, rows=50, tiles=6, per_tile=30, cap=24):
    """Random feature rows; pair lists of `tiles` segments of `per_tile`
    random rows each (every other segment capped at `cap`), their routing,
    and sub-tile rows [P, 16, 10] at candidate index, of mixed sign and
    magnitude, with a random mask. Returns (feats, each candidate's feature
    row, the candidates the cap cut, rows, mask, cand_pos, row_starts); the
    rows the mask leaves out and those of the cut candidates are NaN."""
    rng = np.random.RandomState(seed)
    feats = torch.from_numpy(rng.randn(rows, 10).astype(np.float32))
    gids = torch.from_numpy(np.concatenate(
        [rng.choice(rows, per_tile, replace=False) for _ in range(tiles)]
    ).astype(np.int32))
    starts = torch.arange(tiles, dtype=torch.int32) * per_tile
    counts = torch.tensor([cap if t % 2 else per_tile for t in range(tiles)],
                          dtype=torch.int32)
    n = gids.shape[0]
    sub_rows = torch.from_numpy(
        (rng.randn(n, 16, 10) * 10.0 ** rng.randint(-3, 4, (n, 16, 10))
         ).astype(np.float32))
    mask = torch.from_numpy((rng.rand(n, 16) < 0.3).astype(np.uint8))
    cand_pos, row_starts, _ = pair_routing(gids, starts, counts, rows)
    cut = cand_pos < 0
    sub_rows[cut] = float("nan")
    sub_rows[mask == 0] = float("nan")
    cand_rows = torch.repeat_interleave(
        torch.arange(rows), (row_starts[1:] - row_starts[:-1]).long())
    return feats, cand_rows, cut, sub_rows, mask, cand_pos, row_starts


def _row_grad(s, f):
    """A row's gradient from its summed pair row `s` and feature row `f`."""
    return torch.stack([-(f[2] * s[0] + f[3] * s[1]),
                        -(f[4] * s[1] + f[3] * s[0]), -0.5 * s[2], -s[3],
                        -0.5 * s[4], *s[5:]])


def test_k2b_plain_is_a_loop_over_each_rows_candidates():
    feats, _, _, rows, mask, cand_pos, row_starts = _routed_pair_rows()
    got = feature_row_grads_plain(rows, mask, cand_pos, row_starts, feats)
    want = torch.zeros_like(feats)
    for i in range(feats.shape[0]):
        acc, any_row = torch.zeros(10), False
        for k in range(int(row_starts[i]), int(row_starts[i + 1])):
            for sub in range(16):
                if int(cand_pos[k]) >= 0 and int(mask[k, sub]):
                    acc = acc + rows[k, sub]
                    any_row = True
        if any_row:
            want[i] = _row_grad(acc, feats[i])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(
        feature_row_grads(rows, mask, cand_pos, row_starts, feats), got)


def test_k2b_plain_matches_index_add_in_float64():
    feats, cand_rows, cut, rows, mask, cand_pos, row_starts = \
        _routed_pair_rows(1)
    got = feature_row_grads_plain(rows, mask, cand_pos, row_starts, feats)
    per_pair = torch.where(mask[..., None] != 0, rows.double(),
                           0.0).sum(dim=1)
    sums = torch.zeros(feats.shape, dtype=torch.float64).index_add_(
        0, cand_rows[~cut], per_pair[~cut])
    f64 = feats.double()
    want = torch.stack([_row_grad(sums[i], f64[i])
                        for i in range(feats.shape[0])])
    scale = want.abs().amax(dim=0)
    assert float(((got.double() - want).abs() / scale).max()) <= 1e-6


def test_k2b_pairs_cut_by_the_cap_add_nothing():
    feats, _, cut, rows, mask, cand_pos, row_starts = _routed_pair_rows(2)
    assert int(cut.sum()) == 3 * 6 and bool(rows[cut].isnan().all())
    full = torch.where(cut[:, None], 1, mask).to(torch.uint8)
    got = feature_row_grads_plain(rows, full, cand_pos, row_starts, feats)
    assert bool(torch.isfinite(got).all())
    zeroed = torch.where(cut[:, None, None], 0.0, rows)
    assert torch.equal(got, feature_row_grads_plain(zeroed, full, cand_pos,
                                                    row_starts, feats))
    # a row whose every pair was cut gets zeros
    only_cut = [i for i in range(feats.shape[0])
                if int(row_starts[i]) < int(row_starts[i + 1])
                and bool((cand_pos[int(row_starts[i]):int(row_starts[i + 1])]
                          < 0).all())]
    for i in only_cut:
        assert torch.equal(got[i], torch.zeros(10))


def test_k2_plain_sub_tile_rows_sum_to_the_tile_sums():
    """K2's plain sub-tile rows (and their mask) add up, over the 16
    sub-tiles, to each pair's sums over its whole tile: the backward
    through K2b equals the backward through one whole-tile row a pair, and
    a row the mask leaves out is zero."""
    from humangaussian_torch.ops.rasterize_tiled import (
        composite_backward_pairs_plain,
    )

    args = random_composite_args(seed=3, cams=2, n=200, pairs_per_tile=60)
    out = composite_plain(*args)
    cot = [torch.from_numpy(c) for c in _cotangents((64, 64), 7, 2)]
    rows, mask = composite_backward_pairs_plain(*args[:5], out, cot,
                                                *args[5:])
    assert rows.shape == (args[1].shape[0], 16, 10)
    assert bool((rows[mask == 0] == 0).all()) and int(mask.sum()) > 0
    whole = torch.zeros_like(rows)
    whole[:, 0] = rows.double().sum(dim=1).float()
    routing = pair_routing(*args[1:4], args[0].shape[0])
    got = feature_row_grads_plain(rows, mask, *routing[:2], args[0])
    want = feature_row_grads_plain(whole, (whole != 0).any(-1).to(torch.uint8),
                                   *routing[:2], args[0])
    scale = want.abs().amax(dim=0).clamp_min(1e-30)
    assert float(((got - want).abs() / scale).max()) <= 1e-5


def _sorted_layout_row_grads(rows, mask, cand_pos, row_starts, feats):
    """The row sums of the sorted layout (rows and mask at each pair's
    sorted position, read through cand_pos), as the backward added them
    before K2 stored at candidate index."""
    n_rows = feats.shape[0]
    first = row_starts[:-1].to(torch.int64)
    n_cand = row_starts[1:].to(torch.int64) - first
    most = int(n_cand.max()) if n_rows else 0
    acc = torch.zeros((n_rows, 10), dtype=torch.float32)
    has = torch.zeros(n_rows, dtype=torch.bool)
    for j in range(most):
        k = torch.where(j < n_cand, first + j, 0)
        p = cand_pos[k].to(torch.int64)
        pair = (j < n_cand) & (p >= 0)
        p = p.clamp_min(0)
        for sub in range(rows.shape[1]):
            take = pair & (mask[p, sub] != 0)
            acc = torch.where(take[:, None], acc + rows[p, sub], acc)
            has |= take
    grad = torch.stack([_row_grad(acc[i], feats[i]) for i in range(n_rows)])
    return torch.where(has[:, None], grad, 0.0)


def test_k2_plain_candidate_layout_gives_the_sorted_layouts_bits():
    """K2's plain rows sit at each pair's candidate index: permuted back to
    the pairs' sorted positions they are the rows of the sorted layout, and
    the new K2b sums give, bit for bit, what the sorted layout's loop gave;
    the cap-cut candidates hold zeros and mask 0."""
    from humangaussian_torch.ops.rasterize_tiled import (
        composite_backward_pairs_plain,
        counted_pairs,
    )

    feats, gids, starts, counts, bg, tx, ty = random_composite_args(
        seed=5, cams=2, n=120, pairs_per_tile=50)
    counts = torch.where(torch.arange(counts.shape[0]) % 2 == 0,
                         counts - 13, counts).to(torch.int32)
    args = (feats, gids, starts, counts, bg, tx, ty)
    out = composite_plain(*args)
    cot = [torch.from_numpy(c) for c in _cotangents((64, 64), 11, 2)]
    routing = pair_routing(gids, starts, counts, feats.shape[0])
    cand_pos, row_starts, pair_cand = routing
    rows, mask = composite_backward_pairs_plain(*args[:5], out, cot,
                                                *args[5:], routing=routing)
    cut = cand_pos < 0
    assert int(cut.sum()) == 4 * 13 and int(mask.sum()) > 0
    assert not bool(rows[cut].any()) and not bool(mask[cut].any())
    by_pos = pair_cand.long()
    sorted_rows, sorted_mask = rows[by_pos], mask[by_pos]
    _, _, counted = counted_pairs(starts, counts)
    uncounted = torch.ones(gids.shape[0], dtype=torch.bool)
    uncounted[counted] = False
    assert not bool(sorted_rows[uncounted].any())
    got = feature_row_grads_plain(rows, mask, cand_pos, row_starts, feats)
    want = _sorted_layout_row_grads(sorted_rows, sorted_mask, cand_pos,
                                    row_starts, feats)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# K2b's launch numbers (csrc/rasterize_bwd.cu): a warp's lanes (and rows),
# the staged sub-tile rows of a chunk
K2B_LANES, K2B_STAGE = 32, 128


def _k2b_staged(rows, mask, cand_pos, row_starts, feats, lanes=K2B_LANES,
                stage=K2B_STAGE):
    """K2b's schedule in numpy float32: a warp of `lanes` lanes owns that
    many consecutive rows and walks their candidate span in chunks of at
    most `lanes` candidates whose masked rows fit `stage` slots; the slots
    follow an exclusive scan of the masked-row counts (candidate, then
    sub-tile), and each row adds its own slots in order (one lane, or ten
    lanes one sum each: the same order). Returns the gradient and, per
    chunk, (rows whose span runs past the chunk's end, whether the stage
    ended the chunk, the most slots of one row)."""
    rows, mask = rows.numpy(), mask.numpy()
    cand_pos, row_starts = cand_pos.numpy(), row_starts.numpy()
    feats = feats.numpy()
    n_rows = feats.shape[0]
    out = np.full_like(feats, np.nan)
    chunks = []
    for r0 in range(0, n_rows, lanes):
        nr = min(lanes, n_rows - r0)
        rs, re = row_starts[r0:r0 + nr], row_starts[r0 + 1:r0 + nr + 1]
        acc = np.zeros((nr, 10), np.float32)
        has = np.zeros(nr, bool)
        kc, ke = int(rs[0]), int(re[-1])
        while kc < ke:
            ks = np.arange(kc, min(kc + lanes, ke))
            n = np.where(cand_pos[ks] >= 0, (mask[ks] != 0).sum(axis=1), 0)
            incl = np.cumsum(n)
            fit = min(len(ks), int((incl <= stage).sum()))
            assert fit >= 1
            slots = [rows[k, sub] for k in ks[:fit] if cand_pos[k] >= 0
                     for sub in range(16) if mask[k, sub]]
            assert len(slots) == incl[fit - 1] <= stage
            end = np.concatenate([[0], incl[:fit]])
            most = 0
            for lane in range(nr):
                a = min(max(rs[lane] - kc, 0), fit)
                b = min(max(re[lane] - kc, 0), fit)
                most = max(most, end[b] - end[a])
                for t in range(end[a], end[b]):
                    acc[lane] = acc[lane] + slots[t]
                    has[lane] = True
            chunks.append((int(((rs < kc + fit) & (re > kc + fit)).sum()),
                           fit < len(ks), int(most)))
            kc += fit
        f = feats[r0:r0 + nr]
        ca, cb, cc = f[:, 2], f[:, 3], f[:, 4]
        s = acc.T
        grad = np.stack([-(ca * s[0] + cb * s[1]), -(cc * s[1] + cb * s[0]),
                         np.float32(-0.5) * s[2], -s[3],
                         np.float32(-0.5) * s[4], *s[5:]], axis=1)
        out[r0:r0 + nr] = np.where(has[:, None], grad, np.float32(0.0))
    return out, chunks


@pytest.mark.parametrize("lanes,stage", [(K2B_LANES, K2B_STAGE), (4, 20)])
def test_k2b_chunked_staging_gives_the_plain_bits(lanes, stage):
    """K2b's schedule, emulated, is bit-equal to `feature_row_grads_plain`
    and writes every row, on rows whose candidates cross several chunks,
    chunks that end mid-row and by the stage, chunks where one row holds
    16 slots or more (K2b adds those with ten lanes), rows with no
    candidates and rows whose every candidate was cut."""
    rows, mask, cand_pos, row_starts, feats, all_cut = long_row_routing(
        seed=lanes)
    got, chunks = _k2b_staged(rows, mask, cand_pos, row_starts, feats,
                              lanes, stage)
    want = feature_row_grads_plain(rows, mask, cand_pos, row_starts, feats)
    assert np.array_equal(got.view(np.int32), want.numpy().view(np.int32))
    n_cand = (row_starts[1:] - row_starts[:-1]).numpy()
    assert n_cand[1] == 120
    assert sum(c[0] for c in chunks) > 0  # chunks that end mid-row
    assert any(c[1] for c in chunks)  # chunks the stage ended
    assert any(c[2] >= 16 for c in chunks)  # long rows
    assert (n_cand == 0).sum() > 0
    assert bool((want[n_cand == 0] == 0).all())
    assert len(all_cut) == 2 and bool((want[all_cut] == 0).all())
    assert bool((want != 0).any())
