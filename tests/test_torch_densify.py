"""PyTorch port vs JAX: adaptive density control (densify.py).

The same scene, Adam moments and densify statistics go through both
packages; the split noise is the JAX draw, passed to the port as `noise`.
`alive`, the five `DensifyInfo` counts and the slot every child lands in
must be equal; parameters, both moments and the statistics agree to 1e-6
absolute (exp / sigmoid / the rotation product in f32 on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch import densify as t_densify
from humangaussian_torch.convert import (
    densify_state_from_numpy,
    scene_from_numpy,
)
from humangaussian_tpu import densify as j_densify
from humangaussian_tpu.core.scene import GaussianScene as JScene
from port_parity import assert_tree_close, densify_leaves, np_, scene_leaves

torch.set_num_threads(1)
EXTENT = 2.0  # percent_dense * extent = 0.02 separates clone from split


def _state(capacity, n_alive, log_scale_choices, seed, hit_fraction=0.5):
    """A JAX scene, moments {mu, nu} and DensifyState with random gradient
    statistics; `log_scale_choices` are drawn per Gaussian."""
    rng = np.random.default_rng(seed)
    c = capacity
    alive = np.arange(c) < n_alive
    rng.shuffle(alive)  # free slots scattered, not a tail
    log_scales = (rng.choice(log_scale_choices, size=(c, 1))
                  + 0.1 * rng.standard_normal((c, 3))).astype(np.float32)
    opacity = rng.uniform(-3.0, 3.0, (c, 1)).astype(np.float32)
    opacity[rng.random(c) < 0.15] = -6.0  # below min_opacity: pruned
    scene = JScene(
        means=jnp.asarray(rng.standard_normal((c, 3)), jnp.float32),
        log_scales=jnp.asarray(np.where(alive[:, None], log_scales, -10.0)),
        quats=jnp.asarray(rng.standard_normal((c, 4)), jnp.float32),
        sh_dc=jnp.asarray(rng.standard_normal((c, 3)), jnp.float32),
        sh_rest=jnp.asarray(rng.standard_normal((c, 3, 3)), jnp.float32),
        opacity_logits=jnp.asarray(np.where(alive[:, None], opacity, -10.0)),
        alive=jnp.asarray(alive),
    )
    moments = {
        name: {k: jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
               for k, v in scene.params().items()}
        for name in ("mu", "nu")
    }
    hit = rng.random(c) < hit_fraction
    ds = j_densify.DensifyState(
        grad_accum=jnp.asarray(np.where(hit, 3e-3, 1e-5)
                               * rng.uniform(1, 4, c), jnp.float32),
        denom=jnp.asarray(rng.integers(0, 5, c), jnp.float32),
        max_radii2d=jnp.asarray(rng.uniform(0, 30, c), jnp.float32),
    )
    return scene, moments, ds


def _to_torch(scene, moments, ds):
    return (scene_from_numpy(scene_leaves(scene), "cpu"),
            {name: {k: torch.from_numpy(np.array(v)) for k, v in g.items()}
             for name, g in moments.items()},
            densify_state_from_numpy(densify_leaves(ds), "cpu"))


def _assert_same(got, want):
    g_scene, g_mom, g_ds, g_info = got
    w_scene, w_mom, w_ds, w_info = want
    np.testing.assert_array_equal(np_(g_scene.alive), np.asarray(w_scene.alive))
    assert_tree_close(g_scene.params(), w_scene.params(), atol=1e-6,
                      what="param")
    for name in ("mu", "nu"):
        assert_tree_close(g_mom[name], w_mom[name], atol=1e-6, what=name)
    assert_tree_close(g_ds._asdict(), w_ds._asdict(), atol=1e-6, what="stats")
    for k, v in w_info._asdict().items():
        assert int(getattr(g_info, k)) == int(v), k


def test_update_stats():
    rng = np.random.default_rng(0)
    c = 40
    _, _, ds = _state(c, 30, [-4.0], seed=1)
    grad = rng.standard_normal((c, 2)).astype(np.float32)
    radii = rng.integers(0, 20, c).astype(np.int32)
    want = j_densify.update_stats(ds, jnp.asarray(grad), jnp.asarray(radii),
                                  jnp.asarray(radii > 0))
    got = t_densify.update_stats(
        densify_state_from_numpy(densify_leaves(ds), "cpu"),
        torch.from_numpy(grad), torch.from_numpy(radii),
        torch.from_numpy(radii > 0))
    assert_tree_close(got._asdict(), want._asdict(), atol=1e-6)
    zero = t_densify.init_densify_state(c, "cpu")
    assert float(sum(v.abs().sum() for v in zero)) == 0.0


@pytest.mark.parametrize("case,capacity,n_alive,log_scales,screen", [
    ("clones_only", 96, 40, [-6.0], None),
    ("splits_only", 96, 24, [-3.0], None),
    ("capacity_runs_out", 64, 56, [-6.0, -3.0], None),
    ("max_screen_size", 96, 30, [-6.0, -3.0, -1.0], 20.0),
])
def test_densify_and_prune(case, capacity, n_alive, log_scales, screen):
    scene, moments, ds = _state(capacity, n_alive, log_scales, seed=7)
    key = jax.random.PRNGKey(3)
    kw = dict(max_grad=2e-4, min_opacity=0.005, extent=EXTENT,
              max_screen_size=screen)
    want = j_densify.densify_and_prune(scene, moments, ds, key, **kw)
    noise = np.asarray(jax.random.normal(key, (2 * capacity, 3)))
    got = t_densify.densify_and_prune(
        *_to_torch(scene, moments, ds), noise=torch.from_numpy(noise.copy()), **kw)
    _assert_same(got, want)
    info = got[3]
    if case == "clones_only":
        assert int(info.n_cloned) > 0 and int(info.n_split) == 0
    elif case == "splits_only":
        assert int(info.n_split) > 0 and int(info.n_cloned) == 0
    elif case == "capacity_runs_out":
        assert int(info.n_dropped) > 0
        assert int(info.n_cloned) > 0 and int(info.n_split) > 0
    else:
        big = np.asarray(jnp.max(scene.scales, axis=-1) > 0.1 * EXTENT)
        assert (big & np.asarray(scene.alive)).any()
        assert int(info.n_pruned) > 0
    assert int(info.n_alive) == int(got[0].alive.sum())
    assert float(got[2].grad_accum.abs().sum()) == 0.0  # stats reset


def test_split_noise_from_generator_is_reproducible():
    scene, moments, ds = _state(96, 24, [-3.0], seed=7)
    kw = dict(max_grad=2e-4, min_opacity=0.005, extent=EXTENT,
              max_screen_size=None)
    runs = [
        t_densify.densify_and_prune(
            *_to_torch(scene, moments, ds),
            torch.Generator().manual_seed(5), **kw)
        for _ in range(2)
    ]
    np.testing.assert_array_equal(np_(runs[0][0].means), np_(runs[1][0].means))
    assert int(runs[0][3].n_split) > 0
    # the inputs were not written to
    np.testing.assert_array_equal(
        np_(_to_torch(scene, moments, ds)[0].means), np.asarray(scene.means))


def test_prune_only_survivors_keep_stats():
    scene, moments, ds = _state(96, 60, [-6.0, -3.0], seed=9)
    want = j_densify.prune_only(scene, moments, ds, min_opacity=0.005,
                                size_thresh=0.008)
    got = t_densify.prune_only(*_to_torch(scene, moments, ds),
                               min_opacity=0.005, size_thresh=0.008)
    _assert_same(got, want)
    assert 0 < int(got[3].n_pruned) < 60
    keep = np_(got[0].alive)
    np.testing.assert_array_equal(np_(got[2].denom)[keep],
                                  np.asarray(ds.denom)[keep])
