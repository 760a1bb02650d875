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


def long_row_routing(device="cpu", seed=0, n_rows=150, longest=120):
    """K2b's inputs with candidate spans of every length: (rows [P, 16, 10]
    f32, mask [P, 16] uint8, cand_pos [P], row_starts [n_rows + 1] int32,
    feats [n_rows, 10], the rows whose every candidate was cut). Rows
    without candidates, rows of 1-8 (rows 3-89 hold 0 or 1), rows of 40 to
    `longest` (row 1 the longest: past several of K2b's chunks),
    candidates cut at random
    (cand_pos -1) and two rows whose every candidate was cut; masks dense
    enough that K2b's stage ends chunks. The rows the mask leaves out are
    NaN (never read)."""
    rng = np.random.RandomState(seed)
    n_cand = rng.choice([0, 0, 1, 3, 8, 40, longest], n_rows).astype(np.int64)
    n_cand[:3] = [0, longest, 0]
    n_cand[3:90] = rng.choice([0, 0, 1], 87)  # a run of light rows
    row_starts = np.concatenate([[0], np.cumsum(n_cand)]).astype(np.int32)
    p = int(row_starts[-1])
    cand_pos = np.where(rng.rand(p) < 0.15, -1, rng.randint(0, p, p))
    all_cut = np.nonzero(n_cand == 3)[0][:2]
    for i in all_cut:
        cand_pos[row_starts[i]:row_starts[i + 1]] = -1
    mask = (rng.rand(p, 16) < rng.choice([0.05, 0.3, 0.8], (p, 1)))
    rows = (rng.randn(p, 16, 10)
            * 10.0 ** rng.randint(-3, 4, (p, 16, 10))).astype(np.float32)
    rows[~mask] = np.nan
    feats = rng.randn(n_rows, 10).astype(np.float32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return (t(rows), t(mask.astype(np.uint8)), t(cand_pos.astype(np.int32)),
            t(row_starts), t(feats), all_cut)


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


def projected_composite_args(device="cpu", seed=0, n=600, hw=(96, 64),
                             cams=2, max_tiles=4, spread=0.5):
    """composite's (feats, gids, starts, counts, background, tiles_x,
    tiles_y) and the RasterizeConfig, built by projection and binning from
    a seeded random scene seen by `cams` look-at cameras around it with a
    rect of `max_tiles` tiles."""
    from humangaussian_torch.core.camera import camera_from_c2w, look_at_c2w
    from humangaussian_torch.ops.projection import RasterizeConfig
    from humangaussian_torch.ops.rasterize_tiled import composite_inputs

    rng = np.random.RandomState(seed)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    means = t(rng.randn(n, 3) * spread)
    scales = t(np.exp(rng.randn(n, 3) * 0.5 - 3.0))
    quats = t(rng.randn(n, 4))
    sh = t(rng.randn(n, 1, 3) * 0.3)
    opa = t(1.0 / (1.0 + np.exp(-rng.randn(n))))
    alive = torch.ones(n, dtype=torch.bool, device=device)
    angles = np.linspace(0.0, 2.0 * np.pi, cams, endpoint=False)
    c2w = torch.stack([
        look_at_c2w(t([3.0 * np.sin(a), 0.4, 3.0 * np.cos(a)]),
                    t([0.0, 0.0, 0.0]), t([0.0, 1.0, 0.0]))
        for a in angles])
    cameras = camera_from_c2w(c2w, t([0.8] * cams), hw[0], hw[1])
    cfg = RasterizeConfig(max_tiles_per_gaussian=max_tiles)
    with torch.no_grad():
        _, _, args, (tx, ty) = composite_inputs(
            means, scales, quats, sh, opa, alive,
            [cameras[i] for i in range(cams)], 0, cfg)
    return (*args, t([0.2, 0.3, 0.4]), tx, ty), cfg


def tiny_prompt_arrays(seed=0, n=7, d=32) -> dict:
    """numpy PromptEmbeddings fields at the tiny prior's widths."""
    rs = np.random.RandomState(seed)
    return {"text_vd": rs.randn(4, n, d).astype(np.float32),
            "uncond_vd": rs.randn(4, n, d).astype(np.float32),
            "text": (0.1 * rs.randn(n, d)).astype(np.float32),
            "uncond": (0.1 * rs.randn(n, d)).astype(np.float32),
            "null": np.zeros((n, d), np.float32)}


def tiny_port_system(seed=0, capacity=2048, batch=2, tile_capacity=256,
                     max_tiles=16, **cfg):
    """The port's GaussianDreamerSystem at the sizes of
    `port_parity.tiny_system_pair` (64^2 renders, 500 points, the tiny
    prior from torch's initializers under `seed`) on the CPU, without
    JAX: every process that builds it with the same arguments holds the
    same system."""
    from humangaussian_torch.convert import prompt_embeddings_from_numpy
    from humangaussian_torch.data.cameras import RandomCameraConfig
    from humangaussian_torch.ops.projection import RasterizeConfig
    from humangaussian_torch.smplx.model import toy_model
    from humangaussian_torch.smplx.skeleton import Skeleton
    from humangaussian_torch.train import system

    sys_cfg = dict(
        capacity=capacity, pts_num=500, pose_image_size=64,
        tile_capacity=tile_capacity, densify_prune_start_step=2,
        densify_prune_interval=3, densify_prune_end_step=100,
        prune_only_start_step=100, prune_only_end_step=200,
        prune_only_interval=3)
    sys_cfg.update(cfg)
    return system.GaussianDreamerSystem(
        system.GaussianDreamerConfig(**sys_cfg),
        Skeleton(style="humansd", apose=True).load_smplx(
            toy_model()).scale(-10),
        tiny_port_guidance(seed, remat_encode=True),
        prompt_embeddings_from_numpy(tiny_prompt_arrays(seed), device="cpu"),
        camera_cfg=RandomCameraConfig(
            batch_size=batch, height=64, width=64, eval_height=64,
            eval_width=64, n_val_views=2, n_test_views=3),
        raster_cfg=RasterizeConfig(tile=32, max_tiles_per_gaussian=max_tiles),
        device="cpu")
