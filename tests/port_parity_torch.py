"""JAX-free helpers of the PyTorch-port tests: synthetic inputs of the
compositing kernels (tests/port_parity.py imports JAX; the card-only tests
run where there is none)."""
import numpy as np
import torch


def random_composite_args(device="cpu", seed=0, tiles_x=2, tiles_y=2, cams=1,
                          n=64, pairs_per_tile=40):
    """(feats, gids, starts, counts, background, tiles_x, tiles_y): random
    feature rows and, per tile, a depth-sorted segment of random rows of
    the tile's camera."""
    rng = np.random.RandomState(seed)
    tile = 32
    w, h = tiles_x * tile, tiles_y * tile
    feats = np.zeros((cams * n, 10), np.float32)
    feats[:, 0] = rng.rand(cams * n) * w
    feats[:, 1] = rng.rand(cams * n) * h
    feats[:, 2] = rng.rand(cams * n) * 0.05 + 0.01
    feats[:, 3] = (rng.rand(cams * n) - 0.5) * 0.01
    feats[:, 4] = rng.rand(cams * n) * 0.05 + 0.01
    feats[:, 5:8] = rng.rand(cams * n, 3)
    feats[:, 8] = rng.rand(cams * n) * 0.9 + 0.05
    feats[:, 9] = rng.rand(cams * n) * 3 + 0.5
    tiles = tiles_x * tiles_y * cams
    gids, starts, counts = [], [], []
    for t in range(tiles):
        cam = t // (tiles_x * tiles_y)
        ids = cam * n + rng.choice(n, pairs_per_tile, replace=False)
        ids = ids[np.argsort(feats[ids, 9], kind="stable")]
        starts.append(len(gids))
        counts.append(len(ids))
        gids.extend(ids.tolist())

    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return (t(feats, torch.float32), t(gids, torch.int32),
            t(starts, torch.int32), t(counts, torch.int32),
            t([0.2, 0.3, 0.4], torch.float32), tiles_x, tiles_y)
