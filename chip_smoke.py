#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (humangaussian_torch).

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, or without the package
next to it). Builds every kernel from csrc/ with nvcc, then:

1. prints the card (name, power limit), torch and CUDA versions and the
   kernels' build time;
2. holds K1 (csrc/rasterize_fwd.cu) against its plain torch version on the
   same inputs: a small random scene at 96x64, then a 100k-Gaussian
   avatar at one 1024^2 view. Limits: 1e-4 absolute on image and alpha,
   1e-3 on depth, at most 1e-4 of the pixels past them (the 1e-4
   saturation knife-edge and exp rounding);
3. holds the whole tiled render against the brute-force oracle at 20k
   Gaussians and 256^2, with the same limits;
4. writes a procedural SMPL-X npz (~10.4k vertices, 20.6k faces), a
   100k-Gaussian avatar PLY and an 8-frame AMASS-schema motion, and runs
   the serving entry point `humangaussian_torch.apps.animate.main` at
   1024^2 over the 8 frames: the video must exist, every frame be finite,
   and K1 launched once per frame;
5. renders the 120-view test orbit (eval_camera_batch "test", 1024^2, 3x3
   tile rect) in batches of 8 cameras, one K1 launch per batch, and holds
   K1 on the first batch's inputs (8 cameras in one launch) and that
   batch's rendered output against the plain version, with phase 2's
   limits;
6. times K1 per 1024^2 view and the end-to-end ms per animated frame and
   per orbit view with CUDA events (medians after a warm-up), and prints
   the `kernels` JSON line and, last, the device JSON line.

Any failed check raises, so the script exits non-zero and prints no
result line. Weights and data are random, made from fixed seeds.
"""
from __future__ import annotations

import json
import math
import os
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
H100_ISSUE_PER_S = H100_FP32_FLOPS / 2
H100_SFU_PER_S = H100_ISSUE_PER_S / 8
H100_BYTES_PER_S = 3.35e12  # HBM3
TOL = {"image": 1e-4, "alpha": 1e-4, "depth": 1e-3}
MAX_BAD_FRACTION = 1e-4


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
        composite_inputs,
        composite_plain,
        rasterize_tiled,
    )
    from humangaussian_torch.render import render_batch

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
    print("phase 2: K1 vs plain")
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
    k1_err = compare("small 96x64", got,
                     composite_plain(*kargs, bg, tx, ty, cfg))

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
    print(f"  orbit batch 0: pairs={int(opairs.gids.numel())} over "
          f"{len(cams0)} views, blocks={okargs[3].numel()}")
    del got, plain, first
    main_path_launches = anim_launches + orbit_launches

    # -- phase 6: timing -------------------------------------------------
    print("phase 6: timing (CUDA events, medians after warm-up)")
    k1_ms = cuda_ms(lambda: composite(*kargs, black, tx, ty, cfg), reps=20)
    plain_ms = cuda_ms(lambda: composite_plain(*kargs, black, tx, ty, cfg),
                       reps=3)
    n_tiles = tx * ty
    in_bytes = (kargs[0].numel() * 4 + n_pairs * 4 + 2 * n_tiles * 4 + 12)
    out_bytes = SIZE * SIZE * (3 + 1 + 1 + 1 + 1) * 4
    bytes_ms = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    issue_ms = ((visits * (OPS_PER_VISIT + 1) + contribs * OPS_PER_CONTRIB)
                / H100_ISSUE_PER_S * 1e3)
    sfu_ms = visits / H100_SFU_PER_S * 1e3
    ops_ms = max(issue_ms, sfu_ms)
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"  K1 {SIZE}^2 view: {k1_ms:.4f} ms (plain {plain_ms:.3f} ms), "
          f"{n_pairs} pairs, bound {bound_ms:.5f} ms by {bound_by} "
          f"(bytes {bytes_ms:.5f} ms, instruction issue {issue_ms:.5f} ms, "
          f"exp on the SFU {sfu_ms:.5f} ms)")

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
    print(f"  main-path K1 launches: animate {anim_launches}, orbit "
          f"{orbit_launches}")

    # -- phase 7: where the time goes ------------------------------------
    print("phase 7: torch.profiler (device kernels; profiling slows the "
          "host, so the idle share is an upper bound)")
    profile_device_time(
        "4 animated frames",
        lambda: [animate.render_motion_frame(animator, poses[j], j,
                                             N_FRAMES, args, white)
                 for j in range(4)])
    profile_device_time(
        "2 orbit batches of 8",
        lambda: [orbit_batch(i) for i in (0, ORBIT_BATCH)])

    tmp_dir.cleanup()
    print(card)
    print(json.dumps({"kernels": [{
        "name": "rasterize_fwd",
        "route": "cuda",
        "source": "humangaussian_torch/csrc/rasterize_fwd.cu",
        "replaces": "humangaussian_tpu/ops/rasterize_tiled.py:311",
        "launches": main_path_launches,
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
