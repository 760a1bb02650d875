#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (humangaussian_torch).

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, or without the package
next to it). Builds every kernel from csrc/ with nvcc (one process per
source, started together), then:

1. prints the card (name, power limit), torch and CUDA versions and the
   kernels' build time;
2. holds K1 (csrc/rasterize_fwd.cu) and K2 (csrc/rasterize_bwd.cu) against
   their plain torch versions on the same inputs: a small random scene at
   96x64, then a 100k-Gaussian avatar at one 1024^2 view. K1's limits:
   1e-4 absolute on image and alpha, 1e-3 on depth, at most 1e-4 of the
   pixels past them (the 1e-4 saturation knife-edge and exp rounding).
   K2's: with random cotangents for image, depth and alpha, every column
   of the feature-row gradient within 1e-4 of the column's max-|grad|, at
   most 1e-4 of the rows past that (a pair flipped at the knife-edge moves
   a row by its whole contribution); the largest difference between two
   K2 launches on the same input is printed (atomics are unordered);
3. holds the whole tiled render against the brute-force oracle at 20k
   Gaussians and 256^2: outputs with K1's limits, and the six gradients
   (means, scales, quats, sh, opacities, the means2d tap) through K1 + K2
   against autograd through the oracle at 2e-4 of max-|grad|;
4. writes a procedural SMPL-X npz (~10.4k vertices, 20.6k faces), a
   100k-Gaussian avatar PLY and an 8-frame AMASS-schema motion, and runs
   the serving entry point `humangaussian_torch.apps.animate.main` at
   1024^2 over the 8 frames: the video must exist, every frame be finite,
   and K1 launched once per frame;
5. renders the 120-view test orbit (eval_camera_batch "test", 1024^2, 3x3
   tile rect) in batches of 8 cameras, one K1 launch per batch, and holds
   K1 on the first batch's inputs (8 cameras in one launch) and that
   batch's rendered output against the plain version, with phase 2's
   limits; prints on which pixels K1's and the plain version's last
   contributor differ and the image error there and elsewhere;
6. writes a Blender-layout dataset (24 train + 4 test views of the avatar
   at 1024^2, rendered by the port from seeded views of the test orbit,
   PNG files and transforms_{train,test}.json) and runs the training entry
   point `humangaussian_torch.apps.launch.main` on configs/photo.yaml at
   full width (capacity 131072, SH degree 3, 100k initial points) for 40
   steps with density control from step 10 every 10: K1 and K2 must each
   launch once per step (K1 once more per test view), the mean loss of
   the last 5 steps be below that of the first 5, a density-control pass
   raise the number of alive Gaussians, `last.ply` load with finite
   parameters; the test PSNR is printed;
7. times with CUDA events (medians after a warm-up) K1 and K2 per 1024^2
   avatar view and at the first training view, the end-to-end ms per
   animated frame, per orbit view and per training step (split into
   forward render, loss, backward, statistics + Adam) and per densify
   pass;
8. profiles 4 animated frames, 2 orbit batches and 4 training steps with
   torch.profiler, and prints the `kernels` JSON line and, last, the
   device JSON line.

Any failed check raises, so the script exits non-zero and prints no
result line. Weights and data are random, made from fixed seeds.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_AVATAR = 100_000  # the shipped config's pts_num
SIZE = 1024
N_ORACLE, ORACLE_SIZE = 20_000, 256
N_FRAMES = 8
ORBIT_BATCH = 8
# K1's per pair-pixel work, in issued fp32 instructions (K1's round-to-
# nearest intrinsics rule out contraction, so a mul and an add are two):
# every pair a pixel visits costs the power term (2 subs, 7 muls, 2 adds),
# the power gate, the opacity product, the alpha clamp and its gate (15)
# plus one exp; a contributing pair adds 1 - alpha, the T product and test,
# w = alpha T, 4 fused multiply-adds and the last-contributor update (9)
OPS_PER_VISIT = 15
OPS_PER_CONTRIB = 9
# the data sheet's 67 TFLOP/s fp32 counts an FMA as two flops: 128 lanes
# per SM per clock over 132 SMs; the exp's ex2 runs on the SFU at 16 lanes
# per SM per clock, an eighth of that, and takes an issue slot as well
H100_FP32_FLOPS = 67e12  # non-tensor fp32, H100 SXM data sheet
H100_INSTR_PER_S = H100_FP32_FLOPS / 2
H100_SFU_PER_S = H100_INSTR_PER_S / 8
H100_BYTES_PER_S = 3.35e12  # HBM3
# K2 replays K1's walk (the same per-visit work) over the pairs up to each
# pixel's last contributor; a contributing pair adds the transmittance
# update (4), phi (4), the prefix (1), 1 / max(1 - alpha, 1e-6) (3), dalpha
# (3), the two gates (4), the ten per-pixel products (10) and at least one
# add per product for the sum over pixels (10)
OPS_PER_CONTRIB_BWD = 39
TOL = {"image": 1e-4, "alpha": 1e-4, "depth": 1e-3}
MAX_BAD_FRACTION = 1e-4
GRAD_TOL = 1e-4  # K2 vs plain, of each column's max-|grad|
ORACLE_GRAD_TOL = 2e-4  # K1 + K2 vs autograd through the oracle
FEATURE_NAMES = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "r",
                 "g", "b", "opacity", "depth")
TRAIN_VIEWS, TEST_VIEWS = 24, 4
TRAIN_STEPS = 40
TRAIN_CAPACITY = 131072  # configs/photo.yaml
# The photo trainer's statistic is the pixel-space gradient of a loss
# averaged over the image, which at 1024^2 stays far below the config
# default of 2e-4 in the first 40 steps; this threshold lets the passes at
# steps 20, 30 and 40 clone and split
TRAIN_GRAD_THRESHOLD = 2e-7


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median ms of fn() over `reps` runs, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, got, want) -> float:
    """Hold kernel outputs against the plain version; returns max abs err."""
    worst = 0.0
    for key, atol in TOL.items():
        err = (got[key] - want[key]).abs()
        if err.dim() == 4:
            err = err.amax(dim=-1)
        bad = int((err > atol).sum())
        mx = float(err.max())
        worst = max(worst, mx)
        allowed = max(1, int(err.numel() * MAX_BAD_FRACTION))
        print(f"  {name} {key}: max_abs_err={mx:.3e} pixels_over_{atol:g}="
              f"{bad} (allowed {allowed})")
        check(bad <= allowed, f"{name} {key}: {bad} pixels exceed {atol}")
    check(bool(torch.isfinite(got["image"]).all()),
          f"{name}: non-finite image")
    return worst


def random_cotangents(out, seed):
    """Standard-normal cotangents for image, depth and alpha."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(
        torch.randn(out[k].shape, generator=g).to(out[k].device)
        for k in ("image", "depth", "alpha"))


def compare_grads(name, got, want, names, tol, max_bad_fraction=0.0):
    """Hold gradient tensors against a reference, each relative to the
    reference's max-|grad|; with `max_bad_fraction`, that share of a
    tensor's rows may exceed `tol`. Returns (max abs err, max rel err)."""
    worst_abs = worst_rel = 0.0
    for key, g, w in zip(names, got, want):
        scale = max(float(w.abs().max()), 1e-20)
        err = (g - w).abs()
        rel = err / scale
        bad = int((rel.reshape(rel.shape[0], -1).amax(dim=1) > tol).sum())
        allowed = int(rel.shape[0] * max_bad_fraction)
        worst_abs = max(worst_abs, float(err.max()))
        worst_rel = max(worst_rel, float(rel.max()))
        print(f"  {name} d{key}: max|grad|={scale:.3e} max_err/max|grad|="
              f"{float(rel.max()):.3e} rows_over_{tol:g}={bad} "
              f"(allowed {allowed})")
        check(bad <= allowed, f"{name} d{key}: {bad} rows exceed {tol}")
        check(bool(torch.isfinite(g).all()), f"{name} d{key}: non-finite")
    return worst_abs, worst_rel


def k2_vs_plain(name, kargs, bg, tiles, cfg, fwd, plain_fwd, seed):
    """K2 on K1's saved outputs against the plain backward on the plain
    forward's, and K2's run-to-run difference. Returns the errors, the
    cotangents and K2's gradient."""
    from humangaussian_torch.ops.rasterize_tiled import (
        composite_backward,
        composite_backward_plain,
    )

    cot = random_cotangents(fwd, seed)
    got = composite_backward(*kargs, bg, fwd, cot, *tiles, cfg)
    again = composite_backward(*kargs, bg, fwd, cot, *tiles, cfg)
    torch.cuda.synchronize()
    want = composite_backward_plain(*kargs, bg, plain_fwd, cot, *tiles, cfg)
    errs = compare_grads(name, got.unbind(1), want.unbind(1), FEATURE_NAMES,
                         GRAD_TOL, MAX_BAD_FRACTION)
    scale = want.abs().amax(dim=0).clamp_min(1e-20)
    print(f"  {name}: K2 run-to-run max difference / max|grad| = "
          f"{float(((got - again).abs() / scale).max()):.3e}")
    return errs, cot, got


def last_contributor_account(name, got, plain):
    """Where K1 (product-form T) and the plain version (log T) stop at a
    different pair, and the image error there and elsewhere."""
    differ = got["n_contrib"] != plain["n_contrib"]
    err = (got["image"] - plain["image"]).abs().amax(dim=-1)
    n = int(differ.sum())
    there = float(err[differ].max()) if n else 0.0
    elsewhere = float(err[~differ].max())
    print(f"  {name}: last contributor differs on {n} of {differ.numel()} "
          f"pixels; max image error there {there:.3e}, elsewhere "
          f"{elsewhere:.3e}")


def k2_bound(kargs, tiles, fwd, contribs):
    """(bound ms, bound by, bytes ms, ops ms) of K2 on these inputs: every
    input read once (feature rows, pair ids, segment table, the four saved
    images, the three cotangents) and the gradient rows written once, over
    the memory rate; the replayed pair-pixel visits (up to each pixel's
    last contributor) and the contributions over the instruction rate."""
    feats, gids = kargs[0], kargs[1]
    pixels = fwd["depth"].numel()
    n_bytes = (2 * feats.numel() * 4 + gids.numel() * 4
               + 2 * tiles[0] * tiles[1] * 4 + pixels * (6 + 5) * 4)
    visits = int(fwd["n_contrib"].sum())
    bytes_ms = n_bytes / H100_BYTES_PER_S * 1e3
    ops_ms = max(
        (visits * (OPS_PER_VISIT + 1) + contribs * OPS_PER_CONTRIB_BWD)
        / H100_INSTR_PER_S, visits / H100_SFU_PER_S) * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, bytes_ms, ops_ms, visits


def k1_bound(kargs, tiles, pixels, visits, contribs):
    """(bound ms, bound by, bytes ms, instruction ms, SFU ms) of K1."""
    in_bytes = (kargs[0].numel() * 4 + kargs[1].numel() * 4
                + 2 * tiles[0] * tiles[1] * 4 + 12)
    bytes_ms = (in_bytes + pixels * 7 * 4) / H100_BYTES_PER_S * 1e3
    alu_ms = ((visits * (OPS_PER_VISIT + 1) + contribs * OPS_PER_CONTRIB)
                / H100_INSTR_PER_S * 1e3)
    sfu_ms = visits / H100_SFU_PER_S * 1e3
    ops_ms = max(alu_ms, sfu_ms)
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, bytes_ms, alu_ms, sfu_ms


def write_blender_dataset(root, avatar, orbit, black, seed=0):
    """24 train + 4 test views of the avatar at SIZE^2, rendered by the
    port from seeded views of the test orbit, in the NeRF-synthetic layout
    (PNG files, transforms_{train,test}.json)."""
    from humangaussian_torch.core.camera import camera_from_c2w
    from humangaussian_torch.render import render
    from humangaussian_torch.utils.saving import save_image

    rng = np.random.default_rng(seed)
    picks = rng.choice(orbit.c2w.shape[0], TRAIN_VIEWS + TEST_VIEWS,
                       replace=False)
    fovy = float(orbit.fovy[0])
    check(bool((orbit.fovy == orbit.fovy[0]).all()), "orbit fovy varies")
    os.makedirs(root, exist_ok=True)
    for split, idx in (("train", picks[:TRAIN_VIEWS]),
                       ("test", picks[TRAIN_VIEWS:])):
        frames = []
        for i in idx:
            c2w = orbit.c2w[int(i)]
            cam = camera_from_c2w(c2w, fovy, SIZE, SIZE)
            with torch.no_grad():
                image = render(avatar, cam, black)["image"]
            name = f"{split}_{int(i):03d}"
            save_image(os.path.join(root, name + ".png"),
                       image.clamp(0, 1).cpu().numpy())
            frames.append({"file_path": f"./{name}",
                           "transform_matrix": c2w.cpu().tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            # square images: the horizontal field of view equals fovy
            json.dump({"camera_angle_x": fovy, "frames": frames}, f)


def profile_device_time(label, fn, top=8):
    """Run fn under torch.profiler; print the device-busy share of the
    wall time and the kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    if not by_name:
        print(f"  {label}: device time not measured (the profiler saw no "
              f"device kernels)")
        return
    busy_us = sum(by_name.values())
    print(f"  {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share "
          f"{max(0.0, 1 - busy_us / wall_us):.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}%  "
              f"{name[:90]}")


def random_scene(n, seed, device, spread=0.5):
    """Activated random Gaussians (means, scales, quats, feats, opa, alive)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    means = torch.randn(n, 3, generator=g) * spread
    scales = torch.exp(torch.randn(n, 3, generator=g) * 0.5 - 3.0)
    quats = torch.randn(n, 4, generator=g)
    feats = torch.randn(n, 1, 3, generator=g) * 0.3
    opa = torch.sigmoid(torch.randn(n, generator=g))
    alive = torch.ones(n, dtype=torch.bool)
    return tuple(x.to(device) for x in (means, scales, quats, feats, opa,
                                         alive))


def sample_surface(verts, faces, n, rng):
    """Area-weighted uniform points on a triangle mesh, with the face
    normal of each point."""
    a, b, c = (verts[faces[:, i]].astype(np.float64) for i in range(3))
    cross = np.cross(b - a, c - a)
    area = 0.5 * np.linalg.norm(cross, axis=1)
    idx = rng.choice(faces.shape[0], size=n, p=area / area.sum())
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    pts = ((1 - r1)[:, None] * a[idx] + (r1 * (1 - r2))[:, None] * b[idx]
           + (r1 * r2)[:, None] * c[idx])
    normals = cross[idx] / (2 * area[idx])[:, None]
    return pts, normals


def write_assets(tmp: str, seed: int = 0):
    """Procedural SMPL-X npz, 100k-Gaussian avatar PLY, 8-frame motion."""
    from scipy.spatial import cKDTree

    from humangaussian_torch.core.scene import GaussianScene
    from humangaussian_torch.io.ply import save_ply
    from humangaussian_torch.smplx.model import toy_model

    # ~10.4k vertices / 20.6k faces, near the release's 10,475 / 20,908;
    # a wider tube than the default so the splats cover more tiles
    m = toy_model(n_ring=64, n_seg_per_bone=27, radius=0.2)
    v = m.v_template.shape[0]
    kintree = np.zeros((2, 55), np.int64)
    kintree[0] = m.parents
    smplx_path = os.path.join(tmp, "SMPLX_NEUTRAL.npz")
    np.savez(
        smplx_path, v_template=m.v_template,
        shapedirs=np.zeros((v, 3, 400), np.float32), posedirs=m.posedirs,
        J_regressor=m.j_regressor, kintree_table=kintree,
        weights=m.lbs_weights, f=m.faces,
        hands_meanl=np.zeros(45, np.float32),
        hands_meanr=np.zeros(45, np.float32),
    )

    # the avatar on the normalized rest surface (the animator's frame),
    # offset along the normal by at most 5e-3 so the binding keeps it
    rng = np.random.default_rng(seed)
    vt = m.v_template
    center = (vt.max(0) + vt.min(0)) / 2
    scale = 0.6 / np.max(vt.max(0) - vt.min(0)) * 1.1 ** 10
    pts, normals = sample_surface((vt - center) * scale, m.faces, N_AVATAR,
                                  rng)
    pts = pts + normals * rng.uniform(-5e-3, 5e-3, (N_AVATAR, 1))
    d2, _ = cKDTree(pts).query(pts, k=4)
    mean_sq = np.mean(d2[:, 1:] ** 2, axis=1)
    log_scale = np.log(np.sqrt(np.maximum(mean_sq, 1e-7)))
    rgb = np.clip(np.array([0.8, 0.6, 0.5])
                  + rng.normal(0, 0.1, (N_AVATAR, 3)), 0, 1)
    opa = rng.uniform(0.3, 0.95, (N_AVATAR, 1))
    quats = rng.normal(size=(N_AVATAR, 4))

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))

    # stored in the training frame: the loader's axis shim swaps y/z back
    scene = GaussianScene(
        means=t(pts[:, [0, 2, 1]]),
        log_scales=t(np.repeat(log_scale[:, None], 3, axis=1)),
        quats=t(quats),
        sh_dc=t((rgb - 0.5) / 0.28209479177387814),
        sh_rest=torch.zeros((N_AVATAR, 0, 3)),
        opacity_logits=t(np.log(opa / (1 - opa))),
        alive=torch.ones(N_AVATAR, dtype=torch.bool),
    )
    ply = os.path.join(tmp, "last.ply")
    save_ply(scene, ply)

    # AMASS schema: poses [T, 165] axis-angle (global, 21 body, jaw, eyes,
    # hands), trans, betas, gender, mocap_framerate
    poses = np.zeros((N_FRAMES, 165), np.float32)
    phase = np.linspace(0, 2 * np.pi, N_FRAMES, endpoint=False)
    poses[:, 3:66] = (0.3 * np.sin(phase)[:, None]
                      * rng.normal(size=(1, 63))).astype(np.float32)
    motion = os.path.join(tmp, "motion.npz")
    np.savez(motion, poses=poses, trans=np.zeros((N_FRAMES, 3), np.float32),
             betas=np.zeros(16, np.float32), gender="neutral",
             mocap_framerate=np.float32(30))
    return smplx_path, ply, motion, (v, m.faces.shape[0])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import humangaussian_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: humangaussian_torch not found next to the "
              f"script: {exc}", file=sys.stderr)
        return 2
    return run(torch.device("cuda"))


def run(dev) -> int:
    """The phases of the module docstring on `dev` (main passes the card)."""
    from humangaussian_torch import kernels
    from humangaussian_torch.apps import animate
    from humangaussian_torch.core.camera import camera_from_c2w
    from humangaussian_torch.data.cameras import (
        RandomCameraConfig,
        eval_camera_batch,
    )
    from humangaussian_torch.io.ply import load_ply
    from humangaussian_torch.ops.projection import RasterizeConfig
    from humangaussian_torch.ops.rasterize_ref import rasterize_reference
    from humangaussian_torch.ops.rasterize_tiled import (
        composite,
        composite_backward,
        composite_backward_plain,
        composite_inputs,
        composite_plain,
        rasterize_tiled,
    )
    from humangaussian_torch.render import render_batch
    from humangaussian_torch.apps import launch
    from humangaussian_torch.config import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    # -- phase 1: card and build ---------------------------------------
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"built {len(kernels.KERNELS)} kernel(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for k in kernels.KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {k.name}: {line.strip()}")
    cfg = RasterizeConfig()

    # -- phase 2a: K1 vs plain, small random scene ----------------------
    print("phase 2: K1 and K2 vs plain")
    from humangaussian_torch.core.camera import look_at_c2w

    def orbit_cam(h, w, eye):
        c2w = look_at_c2w(torch.tensor(eye, device=dev),
                          torch.zeros(3, device=dev),
                          torch.tensor([0.0, 1.0, 0.0], device=dev))
        return camera_from_c2w(c2w, 0.8, h, w)

    small = random_scene(2000, 1, dev)
    _, pairs, kargs, (tx, ty) = composite_inputs(
        *small, [orbit_cam(96, 64, [0.3, 0.2, 3.0])], 0, cfg)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    got = composite(*kargs, bg, tx, ty, cfg)
    torch.cuda.synchronize()
    plain = composite_plain(*kargs, bg, tx, ty, cfg)
    k1_err = compare("small 96x64", got, plain)
    k2_err, _, _ = k2_vs_plain("small 96x64", kargs, bg, (tx, ty), cfg, got,
                               plain, seed=3)

    # -- assets (the avatar feeds phase 2b, 4 and 5) --------------------
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build)
    tmp = tmp_dir.name
    t0 = time.perf_counter()
    smplx_path, ply, motion, (nv, nf) = write_assets(tmp)
    print(f"assets: SMPL-X stand-in {nv} vertices / {nf} faces, "
          f"{N_AVATAR} Gaussians, {N_FRAMES} frames "
          f"({time.perf_counter() - t0:.1f} s)")
    avatar = load_ply(ply, device=dev)  # the training frame (z up)
    avatar_args = (avatar.means, avatar.scales, avatar.quats,
                   avatar.features, avatar.opacities, avatar.alive)

    # -- phase 2b: K1 vs plain at full size -----------------------------
    orbit_cfg = RandomCameraConfig()
    orbit = eval_camera_batch(orbit_cfg, "test", device=dev)
    view0 = camera_from_c2w(orbit.c2w[0], orbit.fovy[0], SIZE, SIZE)
    black = torch.zeros(3, device=dev)
    _, pairs, kargs, (tx, ty) = composite_inputs(
        *avatar_args, [view0], avatar.max_sh_degree, cfg)
    got = composite(*kargs, black, tx, ty, cfg)
    torch.cuda.synchronize()
    plain = composite_plain(*kargs, black, tx, ty, cfg)
    k1_err = max(k1_err, compare(f"avatar {SIZE}x{SIZE}", got, plain))
    n_pairs = int(pairs.gids.numel())
    visits, contribs = int(plain["visits"]), int(plain["contribs"])
    print(f"  avatar view: pairs={n_pairs} overflow={int(pairs.overflow)} "
          f"pair-pixel visits={visits} contributions={contribs} "
          f"alpha>0.5 pixels={int((got['alpha'] > 0.5).sum())}")
    busy = pairs.counts[pairs.counts > 0].to(torch.float64)
    print(f"  avatar view tiles: {busy.numel()} of {tx * ty} hold pairs, "
          f"pairs per busy tile mean {float(busy.mean()):.1f} max "
          f"{int(busy.max())}")
    check(float(got["alpha"].max()) > 0.9, "avatar not in view")
    last_contributor_account("avatar view", got, plain)
    errs, avatar_cot, _ = k2_vs_plain(
        f"avatar {SIZE}x{SIZE}", kargs, black, (tx, ty), cfg, got, plain,
        seed=4)
    k2_err = tuple(max(a, b) for a, b in zip(k2_err, errs))
    avatar_fwd = {k: got[k] for k in ("image", "depth", "final_t",
                                      "n_contrib")}
    avatar_k2_bound = k2_bound(kargs, (tx, ty), got, contribs)
    print(f"  avatar view: K2 replays {avatar_k2_bound[4]} pair-pixel "
          f"visits")

    # -- phase 3: whole render vs the oracle -----------------------------
    print("phase 3: rasterize_tiled vs rasterize_reference")
    scene_o = random_scene(N_ORACLE, 2, dev, spread=0.4)
    cam_o = orbit_cam(ORACLE_SIZE, ORACLE_SIZE, [0.5, 0.3, 2.5])
    # the oracle has no per-tile cap, so neither may the tiled render here
    tiled = rasterize_tiled(*scene_o, cam_o, bg, 0, cfg,
                            tile_capacity=N_ORACLE)
    ref = rasterize_reference(*scene_o, cam_o, bg, 0, cfg)
    compare(f"{N_ORACLE} Gaussians {ORACLE_SIZE}^2", tiled, ref)
    check(torch.equal(tiled["radii"], ref["radii"]), "radii differ")
    check(int(tiled["overflow"]) == 0, "oracle scene overflowed")

    def scene_grads(fn, **kw):
        leaves = [x.clone().requires_grad_(True) for x in scene_o[:5]]
        offset = torch.zeros((N_ORACLE, 2), device=dev, requires_grad=True)
        out = fn(*leaves, scene_o[5], cam_o, bg, 0, cfg,
                 means2d_offset=offset, **kw)
        loss = sum((out[k] * c).sum() for k, c in zip(
            ("image", "depth", "alpha"), oracle_cot))
        return torch.autograd.grad(loss, [*leaves, offset])

    oracle_cot = random_cotangents(ref, seed=5)
    kernels.reset_launch_counts()
    got_grads = scene_grads(rasterize_tiled, tile_capacity=N_ORACLE)
    torch.cuda.synchronize()
    check(kernels.launch_counts() == {"rasterize_fwd": 1, "rasterize_bwd": 1},
          f"gradient launches {kernels.launch_counts()}")
    compare_grads(
        f"{N_ORACLE} Gaussians {ORACLE_SIZE}^2 vs the oracle", got_grads,
        scene_grads(rasterize_reference),
        ("means", "scales", "quats", "sh", "opacities", "means2d"),
        ORACLE_GRAD_TOL)
    del got_grads

    # -- phase 4: the serving entry point --------------------------------
    print("phase 4: apps.animate at 1024^2")
    video = os.path.join(tmp, "animation.mp4")
    anim_argv = ["--ply", ply, "--motion", motion, "--smplx_path",
                 smplx_path, "--out", video, "--size", str(SIZE),
                 "--rotate", "--device", dev.type]
    kernels.reset_launch_counts()
    path, frames = animate.main(anim_argv)
    torch.cuda.synchronize()
    anim_launches = kernels.launch_counts()["rasterize_fwd"]
    print(f"  wrote {os.path.basename(path)} ({os.path.getsize(path)} "
          f"bytes), K1 launches {anim_launches}")
    check(os.path.exists(path) and os.path.getsize(path) > 0, "no video")
    check(anim_launches == N_FRAMES, f"K1 launched {anim_launches} times "
          f"for {N_FRAMES} frames")
    check(len(frames) == N_FRAMES, "frame count")
    check(all(np.isfinite(f).all() and f.shape == (SIZE, SIZE, 3)
              for f in frames), "non-finite or misshapen frame")
    check(all(f.min() < 0.9 for f in frames), "avatar missing from a frame")

    # -- phase 5: the test orbit as render_eval renders it ---------------
    print("phase 5: 120-view test orbit")
    orbit_rcfg = RasterizeConfig(max_tiles_per_gaussian=9)
    n_views = orbit.c2w.shape[0]

    def orbit_cams(i):
        return camera_from_c2w(orbit.c2w[i:i + ORBIT_BATCH],
                               orbit.fovy[i:i + ORBIT_BATCH], SIZE, SIZE)

    def orbit_batch(i):
        return render_batch(avatar, orbit_cams(i), black, cfg=orbit_rcfg)

    kernels.reset_launch_counts()
    overflow = 0
    first = None
    for i in range(0, n_views, ORBIT_BATCH):
        out = orbit_batch(i)
        check(bool(torch.isfinite(out["image"]).all()), "orbit non-finite")
        check(out["image"].shape[1:] == (SIZE, SIZE, 3), "orbit shape")
        overflow += int(out["overflow"])
        first = out if first is None else first
    torch.cuda.synchronize()
    orbit_launches = kernels.launch_counts()["rasterize_fwd"]
    want_launches = math.ceil(n_views / ORBIT_BATCH)
    print(f"  {n_views} views, K1 launches {orbit_launches}, "
          f"overflow {overflow}")
    check(orbit_launches == want_launches,
          f"orbit launched K1 {orbit_launches} times, want {want_launches}")

    # K1 over a whole batch (per-camera gid offsets, cam = block / tiles)
    # against the plain version on the inputs render_batch builds
    cams0 = orbit_cams(0)
    _, opairs, okargs, (otx, oty) = composite_inputs(
        *avatar_args, [cams0[i] for i in range(len(cams0))],
        avatar.max_sh_degree, orbit_rcfg)
    got = composite(*okargs, black, otx, oty, orbit_rcfg)
    torch.cuda.synchronize()
    plain = composite_plain(*okargs, black, otx, oty, orbit_rcfg)
    k1_err = max(k1_err, compare(f"orbit batch of {len(cams0)}", got, plain))
    compare(f"orbit batch of {len(cams0)} as rendered", first, plain)
    last_contributor_account(f"orbit batch of {len(cams0)}", got, plain)
    print(f"  orbit batch 0: pairs={int(opairs.gids.numel())} over "
          f"{len(cams0)} views, blocks={okargs[3].numel()}")
    del got, plain, first

    # -- phase 6: the training entry point --------------------------------
    print(f"phase 6: apps.launch (photo-3dgs-system) at {SIZE}^2, capacity "
          f"{TRAIN_CAPACITY}, SH degree 3, {N_AVATAR} initial points")
    t0 = time.perf_counter()
    data_root = os.path.join(tmp, "blender")
    write_blender_dataset(data_root, avatar, orbit, black)
    print(f"  dataset: {TRAIN_VIEWS} train + {TEST_VIEWS} test views "
          f"({time.perf_counter() - t0:.1f} s)")
    repo = os.path.dirname(os.path.abspath(__file__))
    train_overrides = [
        f"data.dataroot={data_root}", f"exp_root_dir={tmp}/outputs",
        f"system.capacity={TRAIN_CAPACITY}", "system.sh_degree=3",
        f"system.init_points={N_AVATAR}",
        "system.densify_from_iter=10", "system.densification_interval=10",
        f"system.densify_grad_threshold={TRAIN_GRAD_THRESHOLD:.1e}",  # YAML float
        f"trainer.max_steps={TRAIN_STEPS}", "trainer.log_every=1",
    ]
    kernels.reset_launch_counts()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        trial = launch.main(["--config",
                             os.path.join(repo, "configs", "photo.yaml"),
                             "--train", "--device", dev.type,
                             *train_overrides])
    torch.cuda.synchronize()
    train_launches = kernels.launch_counts()
    train_s = time.perf_counter() - t0
    steps = re.findall(r"photo step (\d+): loss=([0-9.eE+-]+) alive=(\d+)",
                       log.getvalue())
    losses = [float(x[1]) for x in steps]
    alive_counts = [int(x[2]) for x in steps]
    psnr_line = re.search(r"photo eval: psnr=([0-9.]+) ssim=([0-9.]+)",
                          log.getvalue())
    print("  " + "\n  ".join(log.getvalue().strip().splitlines()[-6:]))
    print(f"  {len(steps)} steps in {train_s:.1f} s (dataset load and eval "
          f"included), launches {train_launches}, loss first 5 "
          f"{statistics.mean(losses[:5]):.5f} last 5 "
          f"{statistics.mean(losses[-5:]):.5f}, alive {alive_counts[0]} -> "
          f"{alive_counts[-1]} (max {max(alive_counts)})")
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} steps logged")
    check(train_launches == {"rasterize_fwd": TRAIN_STEPS + TEST_VIEWS,
                             "rasterize_bwd": TRAIN_STEPS},
          f"training launches {train_launches}")
    check(statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
          "the loss did not fall")
    check(max(alive_counts) > alive_counts[0],
          "no density-control pass cloned or split a Gaussian")
    check(psnr_line is not None, "no test PSNR printed")
    print(f"  test PSNR {psnr_line.group(1)} SSIM {psnr_line.group(2)}")
    trained = load_ply(os.path.join(trial, "save", "last.ply"), device=dev)
    check(trained.num_alive > 0 and all(
        bool(torch.isfinite(v[trained.alive]).all())
        for v in trained.params().values()), "last.ply: non-finite")
    print(f"  last.ply: {trained.num_alive} Gaussians, SH degree "
          f"{trained.max_sh_degree}")
    del trained

    # -- phase 7: timing -------------------------------------------------
    print("phase 7: timing (CUDA events, medians after warm-up)")
    k1_ms = cuda_ms(lambda: composite(*kargs, black, tx, ty, cfg), reps=20)
    plain_ms = cuda_ms(lambda: composite_plain(*kargs, black, tx, ty, cfg),
                       reps=3)
    bound_ms, bound_by, bytes_ms, alu_ms, sfu_ms = k1_bound(
        kargs, (tx, ty), SIZE * SIZE, visits, contribs)
    print(f"  K1 {SIZE}^2 avatar view: {k1_ms:.4f} ms (plain {plain_ms:.3f} "
          f"ms), {n_pairs} pairs, bound {bound_ms:.5f} ms by {bound_by} "
          f"(bytes {bytes_ms:.5f} ms, instructions {alu_ms:.5f} ms, "
          f"exp on the SFU {sfu_ms:.5f} ms)")
    k2_avatar_ms = cuda_ms(
        lambda: composite_backward(*kargs, black, avatar_fwd, avatar_cot, tx,
                                   ty, cfg), reps=20)
    k2_avatar_plain_ms = cuda_ms(
        lambda: composite_backward_plain(*kargs, black, avatar_fwd,
                                         avatar_cot, tx, ty, cfg), reps=3)
    print(f"  K2 {SIZE}^2 avatar view: {k2_avatar_ms:.4f} ms (plain "
          f"{k2_avatar_plain_ms:.3f} ms), bound {avatar_k2_bound[0]:.5f} ms "
          f"by {avatar_k2_bound[1]} (bytes {avatar_k2_bound[2]:.5f} ms, "
          f"operations {avatar_k2_bound[3]:.5f} ms)")

    # the trainer as the launcher builds it, on the first training view
    cfg_train = load_config(os.path.join(repo, "configs", "photo.yaml"),
                            train_overrides)
    _, trainer, dataset, pts, colors = launch.build_system(cfg_train, dev)
    state = trainer.init_state(0, pts, colors)
    posed = dataset.train[0]
    cam_t = trainer.camera_for(posed)
    gt = torch.from_numpy(posed.image).to(dev)
    sc = state.scene
    _, tpairs, targs, (ttx, tty) = composite_inputs(
        sc.means, sc.scales, sc.quats, sc.features, sc.opacities, sc.alive,
        [cam_t], sc.max_sh_degree, trainer.raster_cfg,
        tile_capacity=trainer.cfg.tile_capacity)
    tfwd = composite(*targs, black, ttx, tty, trainer.raster_cfg)
    torch.cuda.synchronize()
    tplain = composite_plain(*targs, black, ttx, tty, trainer.raster_cfg)
    k1_err = max(k1_err, compare("first training view", tfwd, tplain))
    errs, tcot, _ = k2_vs_plain("first training view", targs, black,
                                (ttx, tty), trainer.raster_cfg, tfwd, tplain,
                                seed=6)
    k2_err = tuple(max(a, b) for a, b in zip(k2_err, errs))
    t_visits, t_contribs = int(tplain["visits"]), int(tplain["contribs"])
    busy = tpairs.counts[tpairs.counts > 0].to(torch.float64)
    print(f"  first training view: pairs={int(tpairs.gids.numel())} "
          f"overflow={int(tpairs.overflow)} on {busy.numel()} of "
          f"{ttx * tty} tiles (max {int(busy.max())}), pair-pixel visits="
          f"{t_visits} contributions={t_contribs}")
    k1_train_ms = cuda_ms(
        lambda: composite(*targs, black, ttx, tty, trainer.raster_cfg),
        reps=20)
    k1_train_bound = k1_bound(targs, (ttx, tty), SIZE * SIZE, t_visits,
                              t_contribs)
    k2_ms = cuda_ms(
        lambda: composite_backward(*targs, black, tfwd, tcot, ttx, tty,
                                   trainer.raster_cfg), reps=20)
    k2_plain_ms = cuda_ms(
        lambda: composite_backward_plain(*targs, black, tfwd, tcot, ttx, tty,
                                         trainer.raster_cfg), reps=3)
    k2_bound_ms, k2_bound_by, k2_bytes_ms, k2_ops_ms, k2_visits = k2_bound(
        targs, (ttx, tty), tfwd, t_contribs)
    print(f"  K1 first training view: {k1_train_ms:.4f} ms, bound "
          f"{k1_train_bound[0]:.5f} ms by {k1_train_bound[1]}")
    print(f"  K2 first training view: {k2_ms:.4f} ms (plain "
          f"{k2_plain_ms:.3f} ms), replays {k2_visits} visits, bound "
          f"{k2_bound_ms:.5f} ms by {k2_bound_by} (bytes {k2_bytes_ms:.5f} "
          f"ms, operations {k2_ops_ms:.5f} ms)")
    del tfwd, tplain, tcot

    def staged_step():
        """One training step with an event after each stage."""
        nonlocal state
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in state.scene.params().items()}
        offset = torch.zeros((TRAIN_CAPACITY, 2), device=dev,
                             requires_grad=True)
        live = state.scene.replace_params(leaves)
        out = rasterize_tiled(
            live.means, live.scales, live.quats, live.features,
            live.opacities, live.alive, cam_t, trainer.background,
            live.max_sh_degree, trainer.raster_cfg, means2d_offset=offset,
            tile_capacity=trainer.cfg.tile_capacity)
        ev[1].record()
        loss = photometric_loss(out["image"], gt, trainer.cfg.lambda_dssim)
        ev[2].record()
        grads = torch.autograd.grad(loss, [*leaves.values(), offset])
        ev[3].record()
        densify = update_stats(state.densify, grads[-1], out["radii"],
                               out["radii"] > 0)
        params, adam = adam_step(
            state.scene.params(), dict(zip(leaves, grads[:-1])), state.adam,
            trainer.optim_cfg.group_lrs(state.step), trainer.optim_cfg)
        ev[4].record()
        ev[4].synchronize()
        state = state._replace(scene=state.scene.replace_params(params),
                               adam=adam, densify=densify,
                               step=state.step + 1)
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]

    from humangaussian_torch.densify import update_stats
    from humangaussian_torch.losses import photometric_loss
    from humangaussian_torch.train.optim import adam_step

    staged_step()  # warm-up (cuDNN picks its convolution here)
    stages = [statistics.median(x) for x in
              zip(*[staged_step() for _ in range(10)])]

    def train_step():
        nonlocal state
        state, _ = trainer.train_step(state, posed)

    step_ms = cuda_ms(train_step, reps=10)
    print(f"  training step at {SIZE}^2 (first view, {N_AVATAR} Gaussians, "
          f"SH 3): {step_ms:.3f} ms end to end (image upload included); "
          f"staged: forward render {stages[0]:.3f} ms, loss {stages[1]:.3f} "
          f"ms, backward {stages[2]:.3f} ms (K2 {k2_ms:.3f} ms at step 0, "
          f"autograd rest {stages[2] - k2_ms:.3f} ms), statistics + Adam "
          f"{stages[3]:.3f} ms")
    densify_times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, info = trainer.densify_step(state, False)
        end.record()
        end.synchronize()
        densify_times.append(start.elapsed_time(end))
    densify_ms = statistics.median(densify_times)
    print(f"  densify pass after {state.step} steps: {densify_ms:.3f} ms "
          f"(cloned {int(info.n_cloned)}, split {int(info.n_split)}, pruned "
          f"{int(info.n_pruned)}, dropped {int(info.n_dropped)})")
    mean_grad = state.densify.grad_accum / state.densify.denom.clamp_min(1)
    seen = mean_grad[state.densify.denom > 0]
    print(f"  mean |d loss / d means2d| of {seen.numel()} visible Gaussians: "
          f"median {float(seen.median()):.3e} max {float(seen.max()):.3e}")

    args = animate.build_parser().parse_args(anim_argv)
    from humangaussian_torch.animation import (
        AvatarAnimator,
        load_amass_body_poses,
    )
    from humangaussian_torch.convert import smplx_from_numpy
    from humangaussian_torch.smplx.model import load_smplx_npz

    animator = AvatarAnimator(
        load_ply(ply, animation_convention=True, device=dev),
        smplx_from_numpy(load_smplx_npz(smplx_path), dev))
    poses = load_amass_body_poses(motion)
    white = torch.ones(3, device=dev)
    frame_times = []
    for i in range(N_FRAMES + 1):  # frame 0 twice: the first is warm-up
        j = max(i - 1, 0)
        frame_times.append(cuda_ms(
            lambda: animate.render_motion_frame(animator, poses[j], j,
                                                N_FRAMES, args, white),
            reps=1, warmup=0))
    frame_ms = statistics.median(frame_times[1:])
    batch_ms = statistics.median([
        cuda_ms(lambda: orbit_batch(i), reps=1, warmup=0)
        for i in range(0, n_views, ORBIT_BATCH)])
    view_ms = batch_ms / ORBIT_BATCH
    print(f"  end to end: {frame_ms:.3f} ms per animated {SIZE}^2 frame "
          f"(re-pose + render + copy to host), {view_ms:.3f} ms per orbit "
          f"view ({batch_ms:.3f} ms per batch of {ORBIT_BATCH})")
    print(f"  main-path launches: animate K1 {anim_launches}, orbit K1 "
          f"{orbit_launches}, training {train_launches}")

    # -- phase 8: where the time goes ------------------------------------
    print("phase 8: torch.profiler (device kernels; profiling slows the "
          "host, so the idle share is an upper bound)")
    profile_device_time(
        "4 animated frames",
        lambda: [animate.render_motion_frame(animator, poses[j], j,
                                             N_FRAMES, args, white)
                 for j in range(4)])
    profile_device_time(
        "2 orbit batches of 8",
        lambda: [orbit_batch(i) for i in (0, ORBIT_BATCH)])
    profile_device_time("4 training steps",
                        lambda: [train_step() for _ in range(4)], top=12)

    tmp_dir.cleanup()
    print(card)
    print(json.dumps({"kernels": [
        {
            "name": "rasterize_fwd",
            "route": "cuda",
            "source": "humangaussian_torch/csrc/rasterize_fwd.cu",
            "replaces": "humangaussian_tpu/ops/rasterize_tiled.py:311",
            "launches": (anim_launches + orbit_launches
                         + train_launches["rasterize_fwd"]),
            "max_abs_err": k1_err,
            "ms": k1_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "ms_first_training_view": k1_train_ms,
        },
        {
            "name": "rasterize_bwd",
            "route": "cuda",
            "source": "humangaussian_torch/csrc/rasterize_bwd.cu",
            "replaces": "humangaussian_tpu/ops/rasterize_tiled.py:405",
            "launches": train_launches["rasterize_bwd"],
            "max_abs_err": k2_err[0],
            "max_err_over_max_grad": k2_err[1],
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound_ms,
            "bound_by": k2_bound_by,
            "library_ms": None,
            "ms_avatar_view": k2_avatar_ms,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
