"""Mean squared distance to the k nearest neighbours (scene init).

Port of humangaussian_tpu/ops/knn.py:

- `mean_3nn_sq_dist_host`: the exact KD-tree query (numpy + scipy) that
  initializes the Gaussian scales (upstream distCUDA2). Scene init is a
  one-time host-side event, so this is what the trainers call.
- `mean_knn_sq_dist` / `mean_3nn_sq_dist`: the on-device windowed
  variant, as torch ops on the points' device. Each point takes the 2W
  neighbours of its window along three axis-permuted Morton orderings;
  the candidates are deduplicated by neighbour index and the k smallest
  squared distances averaged. A missed neighbour only overestimates.

Differences from the JAX module: the Morton bit spreading multiplies and
masks in int64 (torch's uint32 has few operations); the 32-bit masks
make the result equal to the JAX uint32 arithmetic. The sort is
`torch.sort(stable=True)`, so equal codes keep input order.
"""
from __future__ import annotations

import numpy as np
import torch

_PERMS = ((0, 1, 2), (1, 2, 0), (2, 0, 1))


def mean_3nn_sq_dist_host(points) -> torch.Tensor:
    """[N,3] array-like -> [N] f32 CPU tensor of the mean squared distance
    to each point's 3 nearest neighbours."""
    from scipy.spatial import cKDTree

    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    pts = np.asarray(points, np.float32)
    d, _ = cKDTree(pts).query(pts, k=4)  # self + 3 neighbours
    return torch.from_numpy((d[:, 1:] ** 2).mean(axis=1).astype(np.float32))


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd bit (Morton); int64 in and out, equal to
    the uint32 arithmetic because every mask fits in 32 bits."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """[N,3] -> [N] int64 10-bit-per-axis 3D Morton codes (the JAX
    module's uint32 codes, simple_knn.cu:45-61)."""
    lo = points.amin(dim=0)
    hi = points.amax(dim=0)
    # a true division: `1023.0 / tensor` rounds through the reciprocal
    scale = torch.full_like(hi, 1023.0) / torch.clamp_min(hi - lo, 1e-12)
    q = torch.clamp((points - lo) * scale, 0.0, 1023.0).to(torch.int64)
    return ((_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1)
            | _expand_bits(q[:, 2]))


def _windowed_candidates(points: torch.Tensor, perm: tuple, window: int):
    """One Morton ordering of the axis-permuted points -> per point, the
    squared distances [N, 2W] and neighbour indices [N, 2W] (-1 outside
    the cloud) of its window, distances in the original space."""
    n = points.shape[0]
    dev = points.device
    codes = morton_codes(points[:, list(perm)])
    _, order = torch.sort(codes, stable=True)
    sorted_pts = points[order]

    offs = torch.cat([torch.arange(-window, 0, device=dev),
                      torch.arange(1, window + 1, device=dev)])  # [2W]
    idx = torch.arange(n, device=dev)[:, None] + offs[None, :]
    valid = (idx >= 0) & (idx < n)
    idx = idx.clamp(0, n - 1)
    neigh = sorted_pts[idx]  # [N, 2W, 3]
    d2 = ((neigh - sorted_pts[:, None, :]) ** 2).sum(dim=-1)
    d2 = torch.where(valid, d2, torch.inf)
    gidx = torch.where(valid, order[idx], -1)
    # un-permute rows back to input order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    return d2[inv], gidx[inv]


def mean_knn_sq_dist(points: torch.Tensor, window: int = 48,
                     k: int = 3) -> torch.Tensor:
    """[N,3] points -> [N] mean squared distance to the k nearest
    neighbours, on the points' device.

    Unions the candidates of three axis-permuted Morton orderings (points
    split across a cell boundary in one curve are adjacent in another)
    and counts a neighbour found by several curves once."""
    points = points.to(torch.float32)
    ds, idxs = zip(*[_windowed_candidates(points, p, window)
                     for p in _PERMS])
    d2 = torch.cat(ds, dim=1)  # [N, 6W]
    gidx = torch.cat(idxs, dim=1)

    # dedupe: sort each row by neighbour index, mask repeats
    gidx_s, order = torch.sort(gidx, dim=1, stable=True)
    d2_s = torch.gather(d2, 1, order)
    dup = torch.zeros_like(gidx_s, dtype=torch.bool)
    dup[:, 1:] = gidx_s[:, 1:] == gidx_s[:, :-1]
    d2_s = torch.where(dup | (gidx_s < 0), torch.inf, d2_s)

    smallest = torch.topk(d2_s, k, dim=1, largest=False, sorted=True).values
    smallest = torch.where(torch.isfinite(smallest), smallest, 0.0)
    return smallest.mean(dim=-1)


def mean_3nn_sq_dist(points: torch.Tensor, window: int = 64) -> torch.Tensor:
    """distCUDA2 equivalent on the points' device (windowed: a missed
    neighbour only overestimates); `mean_3nn_sq_dist_host` is exact."""
    return mean_knn_sq_dist(points, window=window, k=3)
