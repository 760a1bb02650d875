"""Mean squared distance to the 3 nearest neighbours (scene init).

Port of humangaussian_tpu/ops/knn.py::mean_3nn_sq_dist_host, the exact
KD-tree query that initializes the Gaussian scales (upstream distCUDA2).
Scene init is a one-time host-side event, so numpy + scipy is the right
tool. The JAX module's on-device windowed variant is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch


def mean_3nn_sq_dist_host(points) -> torch.Tensor:
    """[N,3] array-like -> [N] f32 CPU tensor of the mean squared distance
    to each point's 3 nearest neighbours."""
    from scipy.spatial import cKDTree

    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    pts = np.asarray(points, np.float32)
    d, _ = cKDTree(pts).query(pts, k=4)  # self + 3 neighbours
    return torch.from_numpy((d[:, 1:] ** 2).mean(axis=1).astype(np.float32))
