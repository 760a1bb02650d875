#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (humangaussian_torch).

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, or without the package
next to it). Builds every kernel from csrc/ with nvcc (one process per
source, started together), writes the assets, then:

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
   avatar view (shape a) and at the first training view (shape b), with
   their busy tiles, largest segment, the share of pair x pixel slots
   that the sub-tile skip removes (`subtile_pair_mask`) and two bounds:
   from the contributions alone (`needed_bounds`, the `kernels` line's
   `bound_ms`) and from every pair-pixel visit of the plain walk
   (`bound_ms_visits`), the end-to-end
   ms per animated frame, per orbit view and per training step (split
   into forward render, loss, backward, statistics + Adam) and per
   densify pass;
8. profiles 4 animated frames, 2 orbit batches and 4 training steps with
   torch.profiler;
9. holds K3 and K5 (csrc/groupnorm_stats.cu) against their plain versions
   and against float64 sums at a small float32 shape and at the main
   path's extremes ([24, 4096, 320], [24, 4096, 960], [24, 64, 2560],
   bfloat16): every sum within 1e-5 of the f64 sum of magnitudes of its
   (sample, channel); K3a (csrc/groupnorm_apply.cu) against
   `group_norm_apply_plain` on the same sums, and the fused forward of
   `group_norm_act` (K3 + K3a) against the plain op
   (`group_norm_stats_plain` + `group_norm_apply_plain`): in bfloat16
   within one ulp on all but 1e-4 of the outputs, in float32 within 1e-5
   of max |y|; times, bounds (bytes over 3.35 TB/s: the op reads x twice
   and writes y once) and, as the library yardstick, `F.group_norm` +
   `F.silu` and its autograd backward;
10. holds K4 (csrc/attention_fwd.cu) against its plain version at the
   UNet's self-attention shapes ((120, 4096, 64), (240, 1024, 64),
   (480, 256, 64) as (batch x heads, tokens, head dim), bfloat16) and at
   (120, 4096, 64) with q sharpened 8x (the online softmax's running
   maximum moves often): largest |kernel - plain| at most 2^-7 of the
   largest |output| (one bfloat16 ulp at the peak; the kernel rounds p to
   bfloat16 relative to the running maximum, the plain version relative to
   the final one), and prints the distance to a float32 softmax; prints
   the kernel's registers and shared memory, times, TFLOP/s, bound (flops
   of the two products over 989 TFLOP/s, bytes over 3.35 TB/s),
   `F.scaled_dot_product_attention` as the library yardstick;
11. writes seeded `unet_ema` and VAE state dicts in diffusers layout
   (bfloat16, `torch.save`), builds the prior from them with
   `apps.launch.build_guidance` on configs/avatar.yaml (899,719,048 UNet
   parameters) and the prompt embeddings with `dummy_encode_fn(77, 1024)`,
   holds K1 and K2 against their plain versions (phase 2's limits) on the
   step's own batch (shape c: 8 orbit views of the avatar at 1024^2 with
   configs/avatar.yaml's `system.rasterizer`, tile 32 and a 2x2 tile
   rect) and times them there beside their bounds, then renders that
   batch with `render_batch` (K1),
   min-maxes the depth per image, calls `DualBranchGuidance.__call__` with
   timesteps on both sides of 200 and backpropagates `loss_sds` to the
   Gaussian parameters (K2): loss and gradients finite on every row (the
   dead slots the PLY loader pads with included), image gradients
   non-zero, the loss equal to the norms of `grad`; one step launches K1
   and K2 once, K3 and K3a 77 times each and K4 20 times (one UNet
   forward: 54 resnet norms, 21 transformer norms, 2 heads; 10
   self-attention sites at 4096 tokens, 5 at 1024, 5 at 256). Times 3 steps end to end and staged
   (render, encodes, UNet, loss + backward), prints peak memory and one
   profile, and times a VAE encode in both memory formats;
12. runs `sample_joint` at batch 2 for 4 DDIM steps: 512^2 images and
   depths finite and in [0, 1], K3, K3a and K4 launched 4 x 77, 4 x 77 and
   4 x 20 times;
13. differentiates the full-width UNet with respect to its input latents
   (batch 2, 64^2, bfloat16): K3a and K5 launch once per K3 launch (77);
   then a
   float32 full-width UNet at 16^2 latents: the input gradient through K3 /
   K5 within 1e-3 of max-|grad| of the gradient through their plain
   versions;
and prints the `kernels` JSON line (all six kernels, each with the launches
of its own path: K1 and K2 phases 4 to 6, K3, K3a and K4 phase 11, K5
phase 13; K1's and K2's rows also carry `ms_guidance_batch`,
`bound_ms_guidance_batch` and `bound_ms_guidance_batch_visits`, shape c)
and, last, the device JSON line. `--only GROUP[,GROUP]` runs some phase
groups alone and prints no result lines.

Any failed check raises, so the script exits non-zero and prints no
result line. Weights and data are random, made from fixed seeds.
"""
from __future__ import annotations

import argparse
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


def cuda_ms(fn, reps: int, warmup: int = 1, inner: int = 1) -> float:
    """Median ms of fn() over `reps` timings with CUDA events; each timing
    spans `inner` back-to-back calls and is divided by it, so that a kernel
    shorter than its wrapper's host time is not timed as a launch gap."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def spin(fn, seconds: float = 0.25) -> None:
    """Keep the card busy with fn() for `seconds`, so that a short kernel
    timed next runs at the clocks of a loaded card (they fall while the
    host prepares inputs)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()


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


def k2_bound(kargs, tiles, fwd, contribs, visits=None):
    """(bound ms, bound by, bytes ms, ops ms, visits) of K2 on these
    inputs: every input read once (feature rows, pair ids, segment table,
    the four saved images, the three cotangents) and the gradient rows
    written once, over the memory rate; the pair-pixel visits and the
    contributions over the instruction rate. `visits` defaults to the
    replayed visits of the plain walk (up to each pixel's last
    contributor); given `contribs`, only the work any implementation must
    do is counted (see `needed_bounds`)."""
    feats, gids = kargs[0], kargs[1]
    pixels = fwd["depth"].numel()
    n_bytes = (2 * feats.numel() * 4 + gids.numel() * 4
               + 2 * tiles[0] * tiles[1] * 4 + pixels * (6 + 5) * 4)
    if visits is None:
        visits = int(fwd["n_contrib"].sum())
    bytes_ms = n_bytes / H100_BYTES_PER_S * 1e3
    ops_ms = max(
        (visits * (OPS_PER_VISIT + 1) + contribs * OPS_PER_CONTRIB_BWD)
        / H100_INSTR_PER_S, visits / H100_SFU_PER_S) * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, bytes_ms, ops_ms, visits


def raster_work(kargs, tiles, cfg, fwd):
    """Busy tiles, the largest segment, and the shares of pair x pixel
    slots that the sub-tile skip removes (before any early stop): K1's over
    each tile's count; K2's over each block's walk limit, the largest last
    contributor of the whole tile for a tile-wide block, of the sub-tile
    for a sub-tile block."""
    from humangaussian_torch.ops.rasterize_tiled import (
        SUBTILE,
        counted_pairs,
        subtile_pair_mask,
    )

    feats, gids, starts, counts = kargs
    tx, ty = tiles
    tile, per = cfg.tile, cfg.tile // SUBTILE
    counts64 = counts.to(torch.int64)
    n_blocks = counts64.numel()
    tile_of, local, pos = counted_pairs(starts, counts)
    walked = subtile_pair_mask(feats, gids, starts, counts, tx, ty,
                               cfg)[pos]  # [Pc, subs]
    nc = fwd["n_contrib"].to(torch.int64)
    b = nc.shape[0]
    sub_last = (nc.reshape(b, ty, per, SUBTILE, tx, per, SUBTILE)
                .amax(dim=(3, 6)).permute(0, 1, 3, 2, 4)
                .reshape(n_blocks, per * per))
    sub_last = torch.minimum(sub_last, counts64[:, None])
    k2_walked = walked & (local[:, None] < sub_last[tile_of])
    busy = counts64[counts64 > 0]
    return {
        "busy_tiles": int(busy.numel()),
        "max_segment": int(busy.max()) if busy.numel() else 0,
        "k1_skip_share": 1.0 - float(walked.sum()) * SUBTILE ** 2
        / max(float(counts64.sum()) * tile ** 2, 1.0),
        "k2_skip_share": 1.0 - float(k2_walked.sum()) * SUBTILE ** 2
        / max(float(sub_last.amax(dim=1).sum()) * tile ** 2, 1.0),
    }


def needed_bounds(kargs, tiles, fwd, contribs):
    """K1's and K2's bounds counted from the contributions alone: a pair
    that passes the alpha gate at a pixel before the pixel saturates is
    work every implementation does (its power term, exp and blend in K1,
    its replay and gradient in K2); a visit that fails the gate is work an
    implementation with a finer cull than the kernels' could skip, so it
    is left out. Each bound is (ms, by, bytes ms, ops ms, ...)."""
    pixels = fwd["depth"].numel()
    b1 = k1_bound(kargs, tiles, pixels, contribs, contribs)
    b1 = (*b1[:3], max(b1[3], b1[4]))
    return b1, k2_bound(kargs, tiles, fwd, contribs, visits=contribs)


def bound_text(needed, visits_bound):
    """The bound from the contributions and, beside it, the one that
    counts every visit of the plain walk."""
    return (f"bound {needed[0]:.5f} ms by {needed[1]} from the "
            f"contributions (bytes {needed[2]:.5f} ms, operations "
            f"{needed[3]:.5f} ms); counting every visit of the plain walk "
            f"{visits_bound[0]:.5f} ms by {visits_bound[1]}")


def work_line(work):
    return (f"{work['busy_tiles']} busy tiles, largest segment "
            f"{work['max_segment']}; the sub-tile skip removes "
            f"{100 * work['k1_skip_share']:.1f}% of K1's pair x pixel slots "
            f"and {100 * work['k2_skip_share']:.1f}% of K2's")


def k1_bound(kargs, tiles, pixels, visits, contribs):
    """(bound ms, bound by, bytes ms, instruction ms, SFU ms) of K1: the
    inputs read once and the seven output channels written once over the
    memory rate, the pair-pixel visits and the contributions over the
    instruction and SFU rates."""
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


PHASE_GROUPS = ("render", "norm", "attention", "guidance", "sample",
                "unet-backward")
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core rate, H100 SXM data sheet
# the main path's extremes for K3 / K3a / K5: [samples, rows, channels] at
# batch 24 (3 x 8 latents): the first level's 64^2 rows at 320 and at the
# widest concatenated input (960), and the 8^2 mid block's input at 2560
GN_SHAPES = ((2, 37, 48), (24, 4096, 320), (24, 4096, 960), (24, 64, 2560))
GN_MAIN = (24, 4096, 320)
GN_GROUPS = {48: 8}  # 32 groups everywhere at full width
GN_STATS_TOL = 1e-5  # of the f64 sum of magnitudes per (sample, channel)
GN_BAD_FRACTION = 1e-4  # of the outputs may miss plain by more than a ulp
GN_F32_TOL = 1e-5  # of max |y|: the fused op vs plain in float32
# (batch, tokens, heads) of the UNet's self-attention sites at batch 24
ATTN_SHAPES = ((24, 4096, 5), (24, 1024, 10), (24, 256, 20))
ATTN_TOL = 2.0 ** -7  # K4 vs plain, of max |out|: one bf16 ulp of the peak
# the dual-branch SD2 unet_ema with its two 8-channel conv_in (899,696,008
# when both are built for 4 input channels)
UNET_PARAMS = 899_696_008 + 2 * 4 * 320 * 9
GUIDANCE_BATCH = 8  # configs/avatar.yaml's camera batch
GUIDANCE_T = (50, 150, 300, 450, 600, 750, 900, 980)  # both sides of 200
NORMS_PER_UNET_FORWARD = 77  # 54 resnet norms, 21 transformer norms, 2 heads
ATTN_PER_UNET_FORWARD = 20  # 10 sites at 4096 tokens, 5 at 1024, 5 at 256
UNET_GRAD_TOL = 1e-3  # f32 UNet input gradient, kernels vs plain versions


@contextlib.contextmanager
def plain_versions():
    """Inside, the GroupNorm and attention wrappers take their plain
    versions whatever the device: the reference side of a comparison. Only
    the comparisons use it; the paths never do."""
    from humangaussian_torch.ops import attention, groupnorm

    saved = (groupnorm.group_norm_stats, groupnorm.group_norm_apply,
             groupnorm.group_norm_bwd_stats, attention._attention_forward)
    groupnorm.group_norm_stats = groupnorm.group_norm_stats_plain
    groupnorm.group_norm_apply = groupnorm.group_norm_apply_plain
    groupnorm.group_norm_bwd_stats = groupnorm.group_norm_bwd_stats_plain
    attention._attention_forward = attention.self_attention_plain
    try:
        yield
    finally:
        (groupnorm.group_norm_stats, groupnorm.group_norm_apply,
         groupnorm.group_norm_bwd_stats, attention._attention_forward) = saved


def bf16_ulp(x):
    """The spacing of bfloat16 (8 significant bits) at |x|, as f32."""
    _, exponent = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exponent - 8)


def sums_error(got, want64, scale64):
    """max over (sample, which, channel) of |got - want| / scale."""
    return float(((got.double() - want64).abs()
                  / scale64.clamp_min(1e-30)).max())


def norm_phase(dev) -> dict:
    """Phase 9: K3 and K5 against their plain versions and f64 sums, the
    whole op against plain, times, bounds and the library yardstick."""
    import torch.nn.functional as F

    from humangaussian_torch import kernels
    from humangaussian_torch.ops.groupnorm import (
        group_norm_act,
        group_norm_apply,
        group_norm_apply_plain,
        group_norm_bwd_stats,
        group_norm_bwd_stats_plain,
        group_norm_stats,
        group_norm_stats_plain,
        group_stats,
        rows_per_block,
    )

    print("phase 9: K3, K3a and K5 (GroupNorm) vs plain")
    g = torch.Generator(device="cpu").manual_seed(9)
    fwd = {"err": 0.0, "by_shape": {}}
    app = {"err": 0.0, "by_shape": {}}
    bwd = {"err": 0.0, "by_shape": {}}
    for n, rows, c in GN_SHAPES:
        groups = GN_GROUPS.get(c, 32)
        dtype = torch.float32 if c == 48 else torch.bfloat16
        x = (torch.randn((n, rows, c), generator=g) * 1.5 + 0.7).to(dev, dtype)
        dz = torch.randn((n, rows, c), generator=g).to(dev, dtype)
        gamma = (1 + 0.2 * torch.randn(c, generator=g)).to(dev)
        beta = (0.2 * torch.randn(c, generator=g)).to(dev)
        label = f"[{n}, {rows}, {c}] {str(dtype)[6:]}"

        # K3 against plain and against f64 sums
        got = group_norm_stats(x)
        again = group_norm_stats(x)
        torch.cuda.synchronize()
        plain = group_norm_stats_plain(x)
        x64 = x.double()
        want = torch.stack([x64.sum(1), (x64 * x64).sum(1)], 1)
        scale = torch.stack([x64.abs().sum(1), (x64 * x64).sum(1)], 1)
        e_k, e_p = sums_error(got, want, scale), sums_error(plain, want, scale)
        e_rr = sums_error(again, got.double(), scale)
        print(f"  K3 {label}: kernel vs f64 {e_k:.3e}, plain vs f64 "
              f"{e_p:.3e} (of the sum of magnitudes; limit "
              f"{GN_STATS_TOL:g}); run to run {e_rr:.3e}; "
              f"{rows_per_block(n, rows, c)} rows per block")
        check(e_k <= GN_STATS_TOL, f"K3 {label}: {e_k} off the f64 sums")
        check(e_p <= GN_STATS_TOL, f"K3 plain {label}: {e_p}")
        fwd["err"] = max(fwd["err"], float((got - plain).abs().max()))

        # K5 against plain and against f64 sums, with and without SiLU
        mu_c, rstd_c = group_stats(plain, rows, groups, 1e-5)
        for silu in (True, False):
            got5 = group_norm_bwd_stats(x, dz, mu_c, rstd_c, gamma, beta, silu)
            torch.cuda.synchronize()
            plain5 = group_norm_bwd_stats_plain(x, dz, mu_c, rstd_c, gamma,
                                                beta, silu)
            xh = (x64 - mu_c.double()[:, None]) * rstd_c.double()[:, None]
            dy = dz.double()
            if silu:
                y = xh * gamma.double() + beta.double()
                sig = torch.sigmoid(y)
                dy = dy * sig * (1 + y * (1 - sig))
            want5 = torch.stack([dy.sum(1), (dy * xh).sum(1)], 1)
            scale5 = torch.stack([dy.abs().sum(1), (dy * xh).abs().sum(1)], 1)
            e_k = sums_error(got5, want5, scale5)
            e_p = sums_error(plain5, want5, scale5)
            print(f"  K5 {label} silu={silu}: kernel vs f64 {e_k:.3e}, plain "
                  f"vs f64 {e_p:.3e}")
            check(e_k <= GN_STATS_TOL, f"K5 {label}: {e_k} off the f64 sums")
            check(e_p <= GN_STATS_TOL, f"K5 plain {label}: {e_p}")
            bwd["err"] = max(bwd["err"], float((got5 - plain5).abs().max()))
            del xh, dy, want5, scale5
        del x64, want, scale

        def off_plain(got, want):
            """Share of outputs past the limit and the largest difference:
            one bfloat16 ulp, or 1e-5 of max |y| in float32."""
            err = (got.float() - want.float()).abs()
            if dtype == torch.bfloat16:
                share = float((err > bf16_ulp(want)).float().mean())
                return share, share <= GN_BAD_FRACTION, float(err.max())
            rel = float(err.max()) / float(want.abs().max())
            return rel, rel <= GN_F32_TOL, float(err.max())

        # K3a alone on the kernel's sums, and the whole fused forward (K3 +
        # K3a) against the plain op (both plain versions)
        x4 = x.reshape(n, rows, 1, c)
        for silu in (True, False):
            y_a = group_norm_apply(x, got, gamma, beta, groups, 1e-5, silu)
            torch.cuda.synchronize()
            y_ap = group_norm_apply_plain(x, got, gamma, beta, groups, 1e-5,
                                          silu)
            how, ok, worst = off_plain(y_a, y_ap)
            app["err"] = max(app["err"], worst)
            print(f"  K3a {label} silu={silu}: "
                  f"{'share over one ulp' if dtype == torch.bfloat16 else 'of max |y|'}"
                  f" {how:.2e}, max difference {worst:.3e}")
            check(ok and bool(torch.isfinite(y_a).all()), f"K3a {label}")
            y_k = group_norm_act(x4, gamma, beta, groups, 1e-5, silu)
            with plain_versions():
                y_p = group_norm_act(x4, gamma, beta, groups, 1e-5, silu)
            how, ok, worst = off_plain(y_k, y_p)
            print(f"  group_norm_act {label} silu={silu} (K3 + K3a vs the "
                  f"plain op): {how:.2e} (limit "
                  f"{GN_BAD_FRACTION if dtype == torch.bfloat16 else GN_F32_TOL:g}),"
                  f" max difference {worst:.3e}")
            check(ok and bool(torch.isfinite(y_k).all()),
                  f"group_norm_act {label}")

        # times (each over runs of back-to-back calls): the three kernels,
        # their plain versions, the whole op, and the library's GroupNorm +
        # SiLU (forward, and its autograd backward)
        spin(lambda: group_norm_stats(x))
        k3_ms = cuda_ms(lambda: group_norm_stats(x), reps=10, inner=10)
        k3_plain_ms = cuda_ms(lambda: group_norm_stats_plain(x), reps=3,
                              inner=5)
        k3a_ms = cuda_ms(lambda: group_norm_apply(
            x, got, gamma, beta, groups, 1e-5, True), reps=10, inner=10)
        k3a_plain_ms = cuda_ms(lambda: group_norm_apply_plain(
            x, got, gamma, beta, groups, 1e-5, True), reps=3, inner=5)
        k5_ms = cuda_ms(lambda: group_norm_bwd_stats(
            x, dz, mu_c, rstd_c, gamma, beta, True), reps=10, inner=10)
        k5_plain_ms = cuda_ms(lambda: group_norm_bwd_stats_plain(
            x, dz, mu_c, rstd_c, gamma, beta, True), reps=3, inner=5)
        op_ms = cuda_ms(lambda: group_norm_act(x4, gamma, beta, groups, 1e-5,
                                               True), reps=5, inner=10)
        x_cf = x4.permute(0, 3, 1, 2)  # channels-first view, channels_last
        gd, bd = gamma.to(dtype), beta.to(dtype)
        lib_ms = cuda_ms(lambda: F.silu(F.group_norm(x_cf, groups, gd, bd,
                                                     1e-5)), reps=5, inner=10)
        xg = x4.detach().requires_grad_(True)
        y_op = group_norm_act(xg, gamma, beta, groups, 1e-5, True)
        op_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            y_op, xg, dz.reshape(y_op.shape), retain_graph=True), reps=5,
            inner=10)
        xl = x_cf.detach().requires_grad_(True)
        y_lib = F.silu(F.group_norm(xl, groups, gd, bd, 1e-5))
        dz_cf = dz.reshape(n, rows, 1, c).permute(0, 3, 1, 2)
        lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            y_lib, xl, dz_cf, retain_graph=True), reps=5, inner=10)
        item = x.element_size()
        xbytes = x.numel() * item
        sums_bytes = n * 2 * c * 4
        k3_bound = (xbytes + sums_bytes) / H100_BYTES_PER_S * 1e3
        # K3a: x and the sums, gamma, beta read once, y written once
        k3a_bound = ((2 * xbytes + sums_bytes + 2 * c * 4)
                     / H100_BYTES_PER_S * 1e3)
        # the op: x read by both passes (it does not fit in L2 at the large
        # shapes), y written once
        op_bound = (3 * xbytes + 2 * c * 4) / H100_BYTES_PER_S * 1e3
        k5_bound = ((2 * x.numel() * item + (2 * n * c + 2 * c) * 4
                     + n * 2 * c * 4) / H100_BYTES_PER_S * 1e3)
        print(f"  {label}: K3 {k3_ms:.4f} ms (plain {k3_plain_ms:.4f}, bound "
              f"{k3_bound:.5f} by bytes), K3a {k3a_ms:.4f} ms (plain "
              f"{k3a_plain_ms:.4f}, bound {k3a_bound:.5f} by bytes), K5 "
              f"{k5_ms:.4f} ms (plain {k5_plain_ms:.4f}, bound "
              f"{k5_bound:.5f} by bytes); group_norm_act forward "
              f"{op_ms:.4f} ms (bound {op_bound:.5f}) vs F.group_norm + "
              f"F.silu {lib_ms:.4f} ms, backward {op_bwd_ms:.4f} ms vs the "
              f"library's autograd {lib_bwd_ms:.4f} ms")
        fwd["by_shape"][label] = {
            "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
            "op_forward_ms": op_ms, "op_bound_ms": op_bound,
            "library_ms": lib_ms}
        app["by_shape"][label] = {
            "ms": k3a_ms, "plain_ms": k3a_plain_ms, "bound_ms": k3a_bound,
            "op_forward_ms": op_ms, "op_bound_ms": op_bound,
            "library_ms": None, "op_library_ms": lib_ms}
        bwd["by_shape"][label] = {
            "ms": k5_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound,
            "op_backward_ms": op_bwd_ms, "library_ms": lib_bwd_ms}
        del y_op, y_lib, xg, xl

    main = "[%d, %d, %d] bfloat16" % GN_MAIN
    out = {}
    for kernel, acc, source, replaces, lib_note in (
        (kernels.GROUPNORM_FWD_STATS, fwd, "groupnorm_stats.cu",
         "humangaussian_tpu/ops/groupnorm.py:70",
         "F.group_norm + F.silu forward (the whole op, not the sums alone)"),
        (kernels.GROUPNORM_FWD_APPLY, app, "groupnorm_apply.cu",
         "humangaussian_tpu/ops/groupnorm.py:206",
         "none: no one call normalizes from given sums (the whole op vs "
         "F.group_norm + F.silu is op_library_ms)"),
        (kernels.GROUPNORM_BWD_STATS, bwd, "groupnorm_stats.cu",
         "humangaussian_tpu/ops/groupnorm.py:102",
         "autograd backward of F.group_norm + F.silu (the whole backward)"),
    ):
        at = acc["by_shape"][main]
        out[kernel.name] = {
            "name": kernel.name,
            "route": "cuda",
            "source": f"humangaussian_torch/csrc/{source}",
            "replaces": replaces,
            "launches": 0,
            "max_abs_err": acc["err"],
            "ms": at["ms"],
            "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"],
            "bound_by": "bytes",
            "library_ms": at["library_ms"],
            "library_call": lib_note,
            "shape": main,
            "by_shape": acc["by_shape"],
        }
    return out


def attention_phase(dev) -> dict:
    """Phase 10: K4 against its plain version and an f32 softmax oracle,
    times, bound and scaled_dot_product_attention as the yardstick."""
    import ctypes

    import torch.nn.functional as F

    from humangaussian_torch import kernels
    from humangaussian_torch.ops.attention import (
        self_attention,
        self_attention_plain,
        softmax_attention,
    )

    print("phase 10: K4 (self-attention forward) vs plain")
    regs, smem = ctypes.c_int(), ctypes.c_int()
    lib = ctypes.CDLL(str(kernels.ATTENTION_FWD.build()))
    check(lib.hg_attention_fwd_info(ctypes.byref(regs), ctypes.byref(smem))
          == 0, "hg_attention_fwd_info failed")
    print(f"  K4: {regs.value} registers a thread at launch (setmaxnreg: "
          f"producer 24, consumers 240), {smem.value} bytes of dynamic "
          f"shared memory a block")
    g = torch.Generator(device="cpu").manual_seed(10)
    by_shape = {}
    worst = 0.0
    # the UNet's shapes, then the first again with q sharpened 8x (checked,
    # not timed)
    for (b, s, h), sharpen in [*((x, 1.0) for x in ATTN_SHAPES),
                               (ATTN_SHAPES[0], 8.0)]:
        q, k, v = (torch.randn((b, s, h, 64), generator=g).to(
            dev, torch.bfloat16) for _ in range(3))
        if sharpen != 1.0:
            q = (q.float() * sharpen).to(torch.bfloat16)
        scale = 1.0 / 8.0
        label = f"({b * h}, {s}, 64)" + (
            f" q x {sharpen:g}" if sharpen != 1.0 else "")
        got = self_attention(q, k, v)
        torch.cuda.synchronize()
        plain = self_attention_plain(q, k, v, scale)
        peak = float(plain.float().abs().max())
        err = float((got.float() - plain.float()).abs().max())
        # an f32 softmax (normalized before any rounding) on two batch
        # entries: what the bf16 rounding of p and of the output costs
        oracle = softmax_attention(q[:2].float(), k[:2].float(),
                                   v[:2].float(), scale)
        err_o = float((got[:2].float() - oracle).abs().max())
        print(f"  K4 {label}: max |kernel - plain| {err:.3e} = "
              f"{err / peak:.3e} of max |out| {peak:.3f} (limit "
              f"{ATTN_TOL:.3e}); vs the f32 softmax oracle {err_o:.3e}")
        check(err <= ATTN_TOL * peak, f"K4 {label}: {err} vs plain")
        check(bool(torch.isfinite(got).all()), f"K4 {label}: non-finite")
        worst = max(worst, err)
        del oracle, plain
        if sharpen != 1.0:
            continue

        spin(lambda: self_attention(q, k, v))
        ms = cuda_ms(lambda: self_attention(q, k, v), reps=5, inner=4)
        plain_ms = cuda_ms(lambda: self_attention_plain(q, k, v, scale),
                           reps=1, warmup=0)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                         reps=5, inner=4)
        flops = 4.0 * b * h * s * s * 64  # the two products
        ops_ms = flops / H100_BF16_FLOPS * 1e3
        bytes_ms = 4 * q.numel() * 2 / H100_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        print(f"  K4 {label}: {ms:.4f} ms = {flops / ms / 1e9:.1f} TFLOP/s of "
              f"the two products (plain {plain_ms:.3f} ms, bound "
              f"{bound:.5f} ms by {by}: operations {ops_ms:.5f}, bytes "
              f"{bytes_ms:.5f}; scaled_dot_product_attention {lib_ms:.4f} ms)")
        by_shape[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                           "bound_by": by, "library_ms": lib_ms}
    b, s, h = ATTN_SHAPES[0]
    at = by_shape[f"({b * h}, {s}, 64)"]
    return {kernels.ATTENTION_FWD.name: {
        "name": kernels.ATTENTION_FWD.name,
        "route": "cuda",
        "source": "humangaussian_torch/csrc/attention_fwd.cu",
        "replaces": "humangaussian_tpu/ops/attention.py:36",
        "launches": 0,
        "max_abs_err": worst,
        "ms": at["ms"],
        "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"],
        "library_ms": at["library_ms"],
        "library_call": "F.scaled_dot_product_attention",
        "registers": regs.value,
        "shared_memory_bytes": smem.value,
        "shape": f"({b * h}, {s}, 64)",
        "by_shape": by_shape,
    }}


def seeded_state_dict(module_fn, seed, dev):
    """The bfloat16 state dict of a module built on the card from a seed
    (torch's default initializers)."""
    torch.manual_seed(seed)
    with torch.device(dev):
        module = module_fn()
    return {k: v.to(torch.bfloat16).cpu()
            for k, v in module.state_dict().items()}


def build_prior(dev, tmp):
    """Seeded unet_ema and VAE weight files in diffusers layout, the prior
    built from them by the launcher, and the prompt embeddings."""
    from humangaussian_torch.apps import launch
    from humangaussian_torch.config import load_config
    from humangaussian_torch.guidance.prompt import (
        PromptProcessor,
        PromptProcessorConfig,
        dummy_encode_fn,
    )
    from humangaussian_torch.guidance.unet import (
        SD2_BASE_CONFIG,
        DualBranchUNet,
    )
    from humangaussian_torch.guidance.vae import AutoencoderKL, VAEConfig

    print("building the prior: seeded weights -> files -> build_guidance")
    t0 = time.perf_counter()
    model_key = os.path.join(tmp, "joint_model")
    vae_key = os.path.join(tmp, "vae")
    os.makedirs(os.path.join(model_key, "unet_ema"))
    os.makedirs(vae_key)
    torch.save(seeded_state_dict(lambda: DualBranchUNet(SD2_BASE_CONFIG), 0,
                                 dev),
               os.path.join(model_key, "unet_ema",
                            "diffusion_pytorch_model.bin"))
    torch.save(seeded_state_dict(lambda: AutoencoderKL(VAEConfig()), 1, dev),
               os.path.join(vae_key, "diffusion_pytorch_model.bin"))
    t1 = time.perf_counter()
    # the shipped avatar configuration, pointed at the seeded files
    repo = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(
        os.path.join(repo, "configs", "avatar.yaml"),
        [f"system.guidance.model_key={model_key}",
         f"system.guidance.vae_key={vae_key}",
         "system.prompt_processor.prompt=a person in a blue jacket"])
    guidance = launch.build_guidance(cfg, dev)
    torch.cuda.synchronize()
    n_unet = sum(p.numel() for p in guidance.unet.parameters())
    n_vae = sum(p.numel() for p in guidance.vae.parameters())
    print(f"  unet_ema {n_unet} parameters ({guidance.unet.dtype}), VAE "
          f"{n_vae}; files written in {t1 - t0:.1f} s, built in "
          f"{time.perf_counter() - t1:.1f} s")
    check(n_unet == UNET_PARAMS, f"UNet has {n_unet} parameters")
    check(guidance.unet.conv_norm_out.weight.dtype == torch.float32,
          "GroupNorm parameters are not float32")
    pp = cfg["system"]["prompt_processor"]
    embeddings = PromptProcessor(
        PromptProcessorConfig(
            prompt=pp["prompt"], negative_prompt=pp["negative_prompt"],
            model_path=pp["pretrained_model_name_or_path"],
            cache_dir=os.path.join(tmp, "text_embeddings")),
        dummy_encode_fn(77, 1024), device=dev)()
    check(embeddings.text_vd.shape == (4, 77, 1024), "embedding shape")
    return guidance, embeddings


def pose_stand_in(batch, size, dev, seed=11):
    """A seeded stand-in for the skeleton pose render (coloured bars on
    black): the pose image is conditioning only and takes no gradient."""
    rng = np.random.default_rng(seed)
    img = np.zeros((batch, size, size, 3), np.float32)
    for i in range(batch):
        for _ in range(18):
            x0, y0 = rng.integers(0, size - size // 16, 2)
            w = rng.integers(size // 128 + 1, size // 40 + 2)
            h = rng.integers(size // 16, size // 4)
            if rng.random() < 0.5:
                w, h = h, w
            img[i, y0:y0 + h, x0:x0 + w] = rng.random(3)
    return torch.from_numpy(img).to(dev)


def guidance_batch_kernels(avatar, cams, rcfg, bg) -> dict:
    """Shape (c): K1 and K2 on the guidance step's own batch (the orbit
    views of phase 11 at SIZE^2, the training rect) against their plain
    versions with phase 2's limits, timed (CUDA events, medians after a
    warm-up) beside their bounds, with the work the sub-tile skip
    removes."""
    from humangaussian_torch.ops.rasterize_tiled import (
        composite,
        composite_backward,
        composite_inputs,
        composite_plain,
    )

    cam_list = [cams[i] for i in range(len(cams))]
    with torch.no_grad():
        _, pairs, kargs, tiles = composite_inputs(
            avatar.means, avatar.scales, avatar.quats, avatar.features,
            avatar.opacities, avatar.alive, cam_list, avatar.max_sh_degree,
            rcfg)
    label = f"guidance batch of {len(cam_list)}"
    got = composite(*kargs, bg, *tiles, rcfg)
    torch.cuda.synchronize()
    plain = composite_plain(*kargs, bg, *tiles, rcfg)
    k1_err = compare(label, got, plain)
    last_contributor_account(label, got, plain)
    k2_err, cot, _ = k2_vs_plain(label, kargs, bg, tiles, rcfg, got, plain,
                                 seed=16)
    visits, contribs = int(plain["visits"]), int(plain["contribs"])
    del plain
    fwd = {k: got[k] for k in ("image", "depth", "final_t", "n_contrib")}

    def k1():
        composite(*kargs, bg, *tiles, rcfg)

    def k2():
        composite_backward(*kargs, bg, fwd, cot, *tiles, rcfg)

    k1_ms = cuda_ms(k1, reps=20)
    k2_ms = cuda_ms(k2, reps=20)
    b1 = k1_bound(kargs, tiles, got["depth"].numel(), visits, contribs)
    b2 = k2_bound(kargs, tiles, fwd, contribs)
    n1, n2 = needed_bounds(kargs, tiles, fwd, contribs)
    print(f"  {label}: pairs={int(pairs.gids.numel())} overflow="
          f"{int(pairs.overflow)} pair-pixel visits={visits} contributions="
          f"{contribs}; {work_line(raster_work(kargs, tiles, rcfg, fwd))}")
    print(f"  K1 {label}: {k1_ms:.4f} ms, {bound_text(n1, b1)}")
    print(f"  K2 {label}: {k2_ms:.4f} ms, replays {b2[4]} visits, "
          f"{bound_text(n2, b2)}")
    return {"k1_err": k1_err, "k2_err": k2_err, "k1_ms": k1_ms,
            "k1_bound": n1[0], "k1_bound_visits": b1[0], "k2_ms": k2_ms,
            "k2_bound": n2[0], "k2_bound_visits": b2[0]}


def guidance_phase(dev, guidance, embeddings, assets):
    """Phase 11: the avatar trainer's guidance step at full width, joined
    to the batched render: 8 orbit views at 1024^2 (K1), per-image min-max
    depth, `DualBranchGuidance.__call__` (K3, K3a, K4 in the UNet), and
    `loss_sds` backpropagated to the Gaussian parameters (K2), rendered
    with configs/avatar.yaml's training rasterizer. Returns the launch
    counts of one step and K1's and K2's numbers on its batch."""
    from humangaussian_torch import kernels
    from humangaussian_torch.apps.launch import _take
    from humangaussian_torch.config import load_config
    from humangaussian_torch.core.camera import camera_from_c2w
    from humangaussian_torch.data.cameras import (
        RandomCameraConfig,
        eval_camera_batch,
    )
    from humangaussian_torch.guidance.dual_branch import (
        DEPTH_MEAN,
        DEPTH_STD,
        RGB_MEAN,
        RGB_STD,
        WHOLE_MEAN,
        WHOLE_STD,
        resize_bilinear,
    )
    from humangaussian_torch.io.ply import load_ply
    from humangaussian_torch.ops.projection import RasterizeConfig
    from humangaussian_torch.render import render_batch

    print(f"phase 11: the guidance step (batch {GUIDANCE_BATCH}, {SIZE}^2 "
          f"renders, 512^2 encodes, 3 x {GUIDANCE_BATCH} x 64^2 latents)")
    avatar = load_ply(assets[1], device=dev)
    guidance_cfg = load_config(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "configs", "avatar.yaml"))
    orbit = eval_camera_batch(RandomCameraConfig(), "test", device=dev)
    pick = torch.arange(GUIDANCE_BATCH, device=dev) * (
        orbit.c2w.shape[0] // GUIDANCE_BATCH)
    cams = camera_from_c2w(orbit.c2w[pick], orbit.fovy[pick], SIZE, SIZE)
    # the training rasterizer of the shipped configuration (2x2 tile rect)
    rcfg = _take(RasterizeConfig, guidance_cfg["system"]["rasterizer"])
    print(f"  rasterizer: tile {rcfg.tile}, max_tiles_per_gaussian "
          f"{rcfg.max_tiles_per_gaussian}")
    white = torch.ones(3, device=dev)
    batch_row = guidance_batch_kernels(avatar, cams, rcfg, white)
    pose = pose_stand_in(GUIDANCE_BATCH, SIZE, dev)
    text = embeddings.get_text_embeddings(orbit.elevation[pick],
                                          orbit.azimuth[pick])
    check(text.shape == (3 * GUIDANCE_BATCH, 77, 1024), "text batch shape")
    t = torch.tensor(GUIDANCE_T, device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    cfg = guidance.cfg

    def render_views(leaves):
        out = render_batch(avatar.replace_params(leaves), cams, white,
                           cfg=rcfg)
        depth = out["depth"][..., None]
        dmin = depth.amin(dim=(1, 2, 3), keepdim=True)
        dmax = depth.amax(dim=(1, 2, 3), keepdim=True)
        depth3 = ((depth - dmin) / (dmax - dmin + 1e-10)).expand(-1, -1, -1, 3)
        return out["image"], depth3

    def fresh_leaves():
        return {k: v.detach().requires_grad_(True)
                for k, v in avatar.params().items()}

    # -- one step, checked ------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    leaves = fresh_leaves()
    rgb, depth3 = render_views(leaves)
    rgb.retain_grad()
    depth3.retain_grad()
    out = guidance(pose, rgb, depth3, text, t, gen)
    out["loss_sds"].backward()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    loss = float(out["loss_sds"].detach())
    grad = out["grad"]
    print(f"  loss_sds {loss:.6f}, grad_norm {float(out['grad_norm']):.6f}, "
          f"launches {counts}, peak memory {peak_gb:.2f} GiB")
    check(math.isfinite(loss) and bool(torch.isfinite(grad).all()),
          "non-finite loss or grad")
    check(grad.shape == (GUIDANCE_BATCH, 64, 64, 8), f"grad {grad.shape}")
    # latents - target is grad by construction, so the loss is its norms
    rebuilt = float((0.5 * (grad[..., :4] ** 2).sum()
                     + cfg.lw_depth * (grad[..., 4:] ** 2).sum())
                    / GUIDANCE_BATCH)
    print(f"  loss rebuilt from grad {rebuilt:.6f}")
    check(abs(rebuilt - loss) <= 1e-4 * abs(loss), "loss is not grad's norm")
    for name, g in (("rgb", rgb.grad), ("depth", depth3.grad)):
        check(g is not None and bool(torch.isfinite(g).all()),
              f"d loss / d {name}: non-finite")
        check(float(g.abs().max()) > 0, f"d loss / d {name} is zero")
        print(f"  d loss / d {name}: max {float(g.abs().max()):.3e}")
    # every row, the dead slots the PLY loader pads with zero quaternions
    # included
    reached = False
    for name, leaf in leaves.items():
        check(leaf.grad is not None, f"d loss / d {name}: no gradient")
        g = leaf.grad
        check(bool(torch.isfinite(g).all()),
              f"d loss / d {name}: {int((~torch.isfinite(g)).sum())} "
              f"non-finite values")
        peak = float(g.abs().max()) if g.numel() else 0.0
        reached = reached or peak > 0
        print(f"  d loss / d {name}: max {peak:.3e}")
    check(reached, "no gradient reached the Gaussians")
    want = {"rasterize_fwd": 1, "rasterize_bwd": 1,
            "groupnorm_fwd_stats": NORMS_PER_UNET_FORWARD,
            "groupnorm_fwd_apply": NORMS_PER_UNET_FORWARD,
            "groupnorm_bwd_stats": 0,
            "attention_fwd": ATTN_PER_UNET_FORWARD}
    check(counts == want, f"launches {counts}, want {want}")
    del out, rgb, depth3, leaves, grad

    # -- 3 steps end to end, then 3 staged by CUDA events -----------------
    def step():
        leaves = fresh_leaves()
        rgb, depth3 = render_views(leaves)
        guidance(pose, rgb, depth3, text, t, gen)["loss_sds"].backward()

    step_ms = cuda_ms(step, reps=3, warmup=0)

    def staged():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        leaves = fresh_leaves()
        rgb, depth3 = render_views(leaves)
        ev[1].record()
        lat = guidance.encode_images(resize_bilinear(rgb, cfg.image_size), gen)
        dlat = (guidance.encode_images(
            resize_bilinear(depth3, cfg.image_size), gen)
            - DEPTH_MEAN) / DEPTH_STD * RGB_STD + RGB_MEAN
        with torch.no_grad():
            whole = (guidance.encode_images(
                resize_bilinear(pose, cfg.image_size), gen)
                - WHOLE_MEAN) / WHOLE_STD * RGB_STD + RGB_MEAN
        ev[2].record()
        with torch.no_grad():
            grad = guidance.compute_grad(lat.detach(), dlat.detach(), whole,
                                         t, text, gen)
        ev[3].record()
        loss = (0.5 * ((lat - (lat - grad[..., :4]).detach()) ** 2).sum()
                + cfg.lw_depth
                * ((dlat - (dlat - grad[..., 4:]).detach()) ** 2).sum()
                ) / GUIDANCE_BATCH
        loss.backward()
        ev[4].record()
        ev[4].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]

    stages = [statistics.median(x) for x in zip(*[staged() for _ in range(3)])]
    print(f"  guidance step end to end: {step_ms:.3f} ms (render + "
          f"__call__ + backward, encodes recomputed in the backward); staged "
          f"without recomputation: render {stages[0]:.3f} ms, three "
          f"encodes {stages[1]:.3f} ms, compute_grad (UNet on "
          f"{3 * GUIDANCE_BATCH} latents) {stages[2]:.3f} ms, loss + "
          f"backward {stages[3]:.3f} ms")
    profile_device_time("1 guidance step", step, top=14)

    # the VAE's layout: one encode forward, then forward + backward, with
    # contiguous weights (as built) against channels_last weights, which
    # turn every activation after the first convolution channels_last
    img = resize_bilinear(pose, cfg.image_size)
    for fmt in (torch.contiguous_format, torch.channels_last,
                torch.contiguous_format):
        guidance.vae.to(memory_format=fmt)

        def encode_backward():
            x = img.clone().requires_grad_(True)
            guidance.encode_images(x, gen).sum().backward()

        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: guidance.encode_images(img, gen), reps=3)
        print(f"  VAE encode of {GUIDANCE_BATCH} x 512^2, {fmt}: forward "
              f"{fwd_ms:.3f} ms, forward + backward "
              f"{cuda_ms(encode_backward, reps=3):.3f} ms")
    return counts, batch_row


def sample_phase(dev, guidance, embeddings):
    """Phase 12: `sample_joint`, batch 2, 4 DDIM steps, 512^2 outputs."""
    from humangaussian_torch import kernels

    print("phase 12: sample_joint (batch 2, 4 DDIM steps)")
    pose = pose_stand_in(2, 512, dev, seed=13)
    text2 = torch.cat([embeddings.text_vd[1:3], embeddings.uncond_vd[1:3]])
    gen = torch.Generator(device=dev).manual_seed(14)
    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    images, depths = guidance.sample_joint(pose, text2, gen, num_steps=4)
    end.record()
    end.synchronize()
    counts = kernels.launch_counts()
    for name, x in (("images", images), ("depths", depths)):
        check(x.shape == (2, 512, 512, 3), f"{name} {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), f"{name}: non-finite")
        check(float(x.min()) >= 0.0 and float(x.max()) <= 1.0,
              f"{name} outside [0, 1]")
    print(f"  {start.elapsed_time(end):.3f} ms; images mean "
          f"{float(images.mean()):.4f}, depths mean {float(depths.mean()):.4f}"
          f"; launches K3 {counts['groupnorm_fwd_stats']}, K3a "
          f"{counts['groupnorm_fwd_apply']}, K4 {counts['attention_fwd']}")
    check(counts["groupnorm_fwd_stats"] == 4 * NORMS_PER_UNET_FORWARD
          and counts["groupnorm_fwd_apply"] == 4 * NORMS_PER_UNET_FORWARD
          and counts["attention_fwd"] == 4 * ATTN_PER_UNET_FORWARD,
          f"sample_joint launches {counts}")


def unet_backward_phase(dev, unet) -> dict:
    """Phase 13: K5 on a path. The full-width UNet differentiated with
    respect to its input latents (batch 2, 64^2, bfloat16): K3a and K5 must
    launch once per K3 launch. Then a float32 UNet at 16^2 latents,
    matrix-product attention: the input gradient through K3 / K3a / K5
    against the gradient through their plain versions. Returns the launch counts of the first."""
    import dataclasses

    from humangaussian_torch import kernels
    from humangaussian_torch.guidance.unet import (
        SD2_BASE_CONFIG,
        DualBranchUNet,
    )

    print("phase 13: the UNet differentiated (K5)")
    g = torch.Generator(device="cpu").manual_seed(15)

    def inputs(b, hw):
        lat = [torch.randn((b, hw, hw, 8), generator=g).to(dev)
               .requires_grad_(True) for _ in range(2)]
        t = torch.tensor([100.0, 700.0], device=dev)[:b]
        text = torch.randn((b, 77, 1024), generator=g).to(dev)
        ids = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]],
                           device=dev).repeat(b, 1)
        cot = torch.randn((b, hw, hw, 8), generator=g).to(dev)
        return lat, t, text, ids, cot

    def input_grads(model, lat, t, text, ids, cot):
        out = model(lat[0], lat[1], t, text, ids)
        return torch.autograd.grad((out * cot).sum(), lat)

    if unet is None:
        torch.manual_seed(0)
        with torch.device(dev):
            unet = DualBranchUNet(SD2_BASE_CONFIG)
        unet.to(memory_format=torch.channels_last).requires_grad_(False)
    args = inputs(2, 64)
    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    grads = input_grads(unet, *args)
    end.record()
    end.synchronize()
    counts = kernels.launch_counts()
    print(f"  bfloat16, batch 2, 64^2: forward + backward "
          f"{start.elapsed_time(end):.3f} ms, launches {counts}, max "
          f"|d out / d latents| {float(grads[0].abs().max()):.3e} / "
          f"{float(grads[1].abs().max()):.3e}")
    check(all(bool(torch.isfinite(x).all()) for x in grads),
          "non-finite input gradient")
    check(all(float(x.abs().max()) > 0 for x in grads), "zero input gradient")
    check(counts["groupnorm_fwd_stats"] == NORMS_PER_UNET_FORWARD
          and counts["groupnorm_fwd_apply"] == NORMS_PER_UNET_FORWARD
          and counts["groupnorm_bwd_stats"] == NORMS_PER_UNET_FORWARD
          and counts["attention_fwd"] == ATTN_PER_UNET_FORWARD,
          f"launches {counts}")
    del unet, grads, args

    torch.manual_seed(1)
    with torch.device(dev):
        f32 = DualBranchUNet(dataclasses.replace(
            SD2_BASE_CONFIG, dtype=torch.float32, flash_attention=False))
    f32.to(memory_format=torch.channels_last).requires_grad_(False)
    args = inputs(2, 16)
    kernels.reset_launch_counts()
    got = input_grads(f32, *args)
    torch.cuda.synchronize()
    k5 = kernels.launch_counts()["groupnorm_bwd_stats"]
    with plain_versions():
        want = input_grads(f32, *args)
    worst = 0.0
    for a, b_ in zip(got, want):
        worst = max(worst, float((a - b_).abs().max() / b_.abs().max()))
    print(f"  float32, batch 2, 16^2: input gradient through K3 / K3a / K5 vs "
          f"through the plain versions {worst:.3e} of max |grad| (limit "
          f"{UNET_GRAD_TOL:g}); K5 launches {k5}")
    check(worst <= UNET_GRAD_TOL, f"UNet input gradient off by {worst}")
    check(k5 == NORMS_PER_UNET_FORWARD, f"K5 launched {k5} times")
    return counts


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
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--only", default="",
        help=f"comma-separated phase groups of {PHASE_GROUPS} to run alone "
        "(for iterating on one part; prints no result lines)")
    args = parser.parse_args()
    only = tuple(x for x in args.only.split(",") if x)
    for name in only:
        if name not in PHASE_GROUPS:
            parser.error(f"unknown phase group {name!r}")
    return run(torch.device("cuda"), only)


def run(dev, only=()) -> int:
    """The phases of the module docstring on `dev` (main passes the card).
    With `only`, just those phase groups run and no result line is
    printed."""
    from humangaussian_torch import kernels

    def want(group):
        return not only or group in only

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
    print(f"built {len(kernels.KERNELS)} kernel(s) from "
          f"{len({k.source for k in kernels.KERNELS})} sources in "
          f"{time.perf_counter() - t0:.1f} s")
    for k in kernels.KERNELS:
        for line in k.build_log.splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Compiling entry" in line):
                print(f"  {k.source.name}: {line.strip()[:150]}")

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build)
    tmp = tmp_dir.name
    t0 = time.perf_counter()
    assets = write_assets(tmp)
    print(f"assets: SMPL-X stand-in {assets[3][0]} vertices / {assets[3][1]} "
          f"faces, {N_AVATAR} Gaussians, {N_FRAMES} frames "
          f"({time.perf_counter() - t0:.1f} s)")

    rows = {}
    if want("render"):
        rows.update(render_phases(dev, tmp, assets))
    if want("norm"):
        rows.update(norm_phase(dev))
    if want("attention"):
        rows.update(attention_phase(dev))
    if want("guidance") or want("sample"):
        guidance, embeddings = build_prior(dev, tmp)
        if want("guidance"):
            counts, batch = guidance_phase(dev, guidance, embeddings,
                                           assets)
            for name in ("groupnorm_fwd_stats", "groupnorm_fwd_apply",
                         "attention_fwd"):
                if name in rows:
                    rows[name]["launches"] = counts[name]
            for name, key, err in (("rasterize_fwd", "k1", batch["k1_err"]),
                                   ("rasterize_bwd", "k2",
                                    batch["k2_err"][0])):
                if name in rows:
                    rows[name]["max_abs_err"] = max(
                        rows[name]["max_abs_err"], err)
                    rows[name]["ms_guidance_batch"] = batch[key + "_ms"]
                    rows[name]["bound_ms_guidance_batch"] = batch[
                        key + "_bound"]
                    rows[name]["bound_ms_guidance_batch_visits"] = batch[
                        key + "_bound_visits"]
        if want("sample"):
            sample_phase(dev, guidance, embeddings)
        unet = guidance.unet
        del guidance
    else:
        unet = None
    if want("unet-backward"):
        counts = unet_backward_phase(dev, unet)
        if "groupnorm_bwd_stats" in rows:
            rows["groupnorm_bwd_stats"]["launches"] = counts[
                "groupnorm_bwd_stats"]
    tmp_dir.cleanup()

    if only:
        print(f"partial run ({', '.join(only)}): no result lines")
        return 0
    for row in rows.values():
        check(row["launches"] > 0,
              f"{row['name']} was never launched on its path")
    print(card)
    print(json.dumps({"kernels": [rows[k.name] for k in kernels.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def render_phases(dev, tmp, assets) -> dict:
    """Phases 2 to 8 (the render paths: serving and photo training);
    returns the `kernels` rows of K1 and K2."""
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

    cfg = RasterizeConfig()

    def raster_counts():
        counts = kernels.launch_counts()
        return {k: counts[k] for k in ("rasterize_fwd", "rasterize_bwd")}

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

    # -- the avatar feeds phase 2b, 4 and 5 ------------------------------
    smplx_path, ply, motion, _ = assets
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
    check(raster_counts() == {"rasterize_fwd": 1, "rasterize_bwd": 1},
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
    train_launches = raster_counts()
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
    k1_visits_bound = k1_bound(kargs, (tx, ty), SIZE * SIZE, visits,
                               contribs)
    k1_needed, k2_avatar_needed = needed_bounds(kargs, (tx, ty), avatar_fwd,
                                                contribs)
    print(f"  K1 {SIZE}^2 avatar view: {k1_ms:.4f} ms (plain {plain_ms:.3f} "
          f"ms), {n_pairs} pairs, {bound_text(k1_needed, k1_visits_bound)}")
    k2_avatar_ms = cuda_ms(
        lambda: composite_backward(*kargs, black, avatar_fwd, avatar_cot, tx,
                                   ty, cfg), reps=20)
    k2_avatar_plain_ms = cuda_ms(
        lambda: composite_backward_plain(*kargs, black, avatar_fwd,
                                         avatar_cot, tx, ty, cfg), reps=3)
    print(f"  K2 {SIZE}^2 avatar view: {k2_avatar_ms:.4f} ms (plain "
          f"{k2_avatar_plain_ms:.3f} ms), "
          f"{bound_text(k2_avatar_needed, avatar_k2_bound)}")
    print(f"  avatar view: {work_line(raster_work(kargs, (tx, ty), cfg, avatar_fwd))}")

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
    k1_train_needed, k2_needed = needed_bounds(targs, (ttx, tty), tfwd,
                                               t_contribs)
    k2_ms = cuda_ms(
        lambda: composite_backward(*targs, black, tfwd, tcot, ttx, tty,
                                   trainer.raster_cfg), reps=20)
    k2_plain_ms = cuda_ms(
        lambda: composite_backward_plain(*targs, black, tfwd, tcot, ttx, tty,
                                         trainer.raster_cfg), reps=3)
    k2_visits_bound = k2_bound(targs, (ttx, tty), tfwd, t_contribs)
    print(f"  K1 first training view: {k1_train_ms:.4f} ms, "
          f"{bound_text(k1_train_needed, k1_train_bound)}")
    print(f"  K2 first training view: {k2_ms:.4f} ms (plain "
          f"{k2_plain_ms:.3f} ms), replays {k2_visits_bound[4]} visits, "
          f"{bound_text(k2_needed, k2_visits_bound)}")
    print(f"  first training view: "
          f"{work_line(raster_work(targs, (ttx, tty), trainer.raster_cfg, tfwd))}")
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

    return {row["name"]: row for row in [
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
            "bound_ms": k1_needed[0],
            "bound_by": k1_needed[1],
            "bound_ms_visits": k1_visits_bound[0],
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
            "bound_ms": k2_needed[0],
            "bound_by": k2_needed[1],
            "bound_ms_visits": k2_visits_bound[0],
            "library_ms": None,
            "ms_avatar_view": k2_avatar_ms,
        },
    ]}


if __name__ == "__main__":
    sys.exit(main())
