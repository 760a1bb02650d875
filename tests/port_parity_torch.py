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


def random_groupnorm_args(device="cpu", seed=0, n=2, rows=37, c=48,
                          dtype=torch.float32):
    """(x3, dz3, gamma, beta) for the GroupNorm statistics kernels: x3 and
    dz3 [n, rows, c] in `dtype`, gamma and beta [c] float32."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, rows, c) * 1.5 + 0.7).astype(np.float32)
    dz = rng.randn(n, rows, c).astype(np.float32)
    gamma = (1 + 0.2 * rng.randn(c)).astype(np.float32)
    beta = (0.2 * rng.randn(c)).astype(np.float32)
    return (torch.tensor(x, device=device).to(dtype),
            torch.tensor(dz, device=device).to(dtype),
            torch.tensor(gamma, device=device),
            torch.tensor(beta, device=device))


def random_qkv(device="cpu", seed=0, b=2, s=128, h=2, d=64,
               dtype=torch.float32, m=None):
    """q [b, s, h, d] and k, v [b, m, h, d] standard normal."""
    rng = np.random.RandomState(seed)
    shapes = ((b, s, h, d), (b, m or s, h, d), (b, m or s, h, d))
    return tuple(torch.tensor(rng.randn(*sh).astype(np.float32),
                              device=device).to(dtype) for sh in shapes)


def tiny_port_guidance(seed=0, **guidance_cfg):
    """The port's DualBranchGuidance at the tiny widths (16^2 images, 8^2
    latents) on the CPU, weights from torch's initializers under `seed`."""
    from humangaussian_torch.guidance import dual_branch, unet, vae
    from humangaussian_torch.guidance.schedule import DiffusionSchedule

    cfg = dict(latent_size=8, image_size=16, guidance_scale=7.5,
               remat_encode=False)
    cfg.update(guidance_cfg)
    torch.manual_seed(seed)
    return dual_branch.DualBranchGuidance(
        unet.DualBranchUNet(unet.TINY_TEST_CONFIG),
        vae.AutoencoderKL(vae.tiny_vae_config()),
        DiffusionSchedule.create(device="cpu"),
        dual_branch.GuidanceConfig(**cfg))
