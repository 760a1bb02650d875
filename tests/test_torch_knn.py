"""PyTorch port vs JAX: the on-device windowed k-NN (ops/knn.py).

The same numpy clouds, made from a seed, go through both packages on the
CPU. Tolerances: Morton codes equal; `mean_knn_sq_dist` within 1e-6
relative (both sum the same squared distances in float32; the candidate
sets are equal because the codes and the stable order are).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.ops import knn as tknn
from humangaussian_tpu.ops import knn as jknn


def _surface(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v += rng.normal(scale=0.01, size=v.shape)
    return v.astype(np.float32)


def _uniform(n, seed=1):
    return np.random.default_rng(seed).uniform(size=(n, 3)).astype(
        np.float32)


CLOUDS = {"surface": _surface, "uniform": _uniform}


def _brute_force(points, k=3):
    d2 = ((points[:, None, :].astype(np.float64)
           - points[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return np.sort(d2, axis=1)[:, :k].mean(axis=1)


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_morton_codes_equal(cloud):
    v = CLOUDS[cloud](2000)
    want = np.asarray(jknn.morton_codes(jnp.asarray(v))).astype(np.int64)
    got = tknn.morton_codes(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cloud,window,k", [
    ("surface", 64, 3), ("uniform", 48, 3), ("uniform", 32, 5)])
def test_mean_knn_sq_dist_matches_jax(cloud, window, k):
    v = CLOUDS[cloud](2000)
    want = np.asarray(jknn.mean_knn_sq_dist(jnp.asarray(v), window=window,
                                            k=k))
    got = tknn.mean_knn_sq_dist(torch.from_numpy(v), window=window,
                                k=k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)


def test_mean_3nn_sq_dist_never_underestimates():
    """The windowed search only misses neighbours, so it never reports a
    smaller distance than the exact one."""
    v = _uniform(1500)
    got = tknn.mean_3nn_sq_dist(torch.from_numpy(v), window=16).numpy()
    exact = _brute_force(v)
    assert np.all(got >= exact * (1 - 1e-5))
    host = tknn.mean_3nn_sq_dist_host(v).numpy()
    np.testing.assert_allclose(host, exact, rtol=1e-4)
    # with the default window most points are exact (the JAX package's
    # own bound for a uniform cloud, tests/test_knn.py)
    full = tknn.mean_3nn_sq_dist(torch.from_numpy(v)).numpy()
    assert np.median(np.abs(full - exact) / exact) < 1e-5


def test_small_cloud_pads_missing_neighbours_with_zero():
    """Fewer points than k + 1: the JAX module fills the missing
    neighbours with 0 before the mean; so does the port."""
    v = _uniform(3)
    want = np.asarray(jknn.mean_knn_sq_dist(jnp.asarray(v), window=4, k=3))
    got = tknn.mean_knn_sq_dist(torch.from_numpy(v), window=4, k=3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
