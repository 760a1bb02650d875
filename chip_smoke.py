#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (humangaussian_torch).

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, or without the package
next to it). Builds every kernel from csrc/ with nvcc (one process per
source, started together), writes the assets, then:

1. prints the card (name, power limit), torch and CUDA versions and the
   kernels' build time;
2. holds K1 (csrc/rasterize_fwd.cu) and K2 + K2b (csrc/rasterize_bwd.cu:
   each pair's gradient sums, then each Gaussian's pair rows added in
   candidate order) against their plain torch versions on the same
   inputs: a small random scene at 96x64, then a 100k-Gaussian avatar at
   one 1024^2 view. K1's limits: 1e-4 absolute on image and alpha, 1e-3 on
   depth, at most 1e-4 of the pixels past them (the 1e-4 saturation
   knife-edge and exp rounding). K2 + K2b's: with random cotangents for
   image, depth and alpha, every column of the feature-row gradient within
   1e-4 of the column's max-|grad|, at most 1e-4 of the rows past that (a
   pair flipped at the knife-edge moves a row by its whole contribution);
   a second launch of K2 + K2b bit-equal to the first, and K2b alone on
   K2's pair rows bit-equal to its plain version;
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
7. times with CUDA events (medians after a warm-up) K1, K2, K2b and the
   whole backward K2 + K2b per 1024^2 avatar view (shape a) and at the
   first training view (shape b) (K2b beside its kernel launched alone,
   its bound and `index_add_` of the same pair rows), with
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
9. holds the GroupNorm forward kernel (csrc/groupnorm_fwd.cu, one
   launch for the sums and the normalize pass: "K3 + K3a" below) and its
   sums-only (K3) and normalize-only (K3a) modes, and K5
   (csrc/groupnorm_stats.cu) and K5a (csrc/groupnorm_bwd_dx.cu), against
   their plain versions at a small float32 shape, at the UNet's extremes
   ([24, 4096, 320], [24, 4096, 960], [24, 64, 2560]) and at the VAE
   encoder's shapes at batch 8 and 512^2 ([8, 262144, 128], [8, 65536,
   128], [8, 65536, 256], [8, 16384, 256], [8, 16384, 512], [8, 4096,
   512]), then at SDXL's (`sdxl_body`): the UNet's [24, 16384, 320],
   [24, 16384, 960], [24, 1024, 2560] and the sdxl-vae encoder's at 1024^2
   ([8, 1048576, 128], [8, 262144, 256], [8, 65536, 512]), bfloat16
   (the float64 sums taken a sample at a time): every sum within 1e-5
   of the f64 sum of magnitudes of its (sample, channel), the forward's
   sums and y, K5's sums and K5a's dx bit-equal on a second launch; y
   (fused, and K3a alone) against
   `group_norm_apply_plain` and K5a against `group_norm_bwd_dx_plain` on
   the same sums, and the op
   `group_norm_act` (forward K3 + K3a, backward K5 + K5a) against the
   plain op (the plain versions): in bfloat16 within one ulp on all but
   1e-4 of the outputs, in float32 within 1e-5 of the largest output;
   times (and the device time of one fused forward: the profiler's
   kernels and memsets), bounds (bytes over 3.35 TB/s: the op's forward
   two passes, x read once and y written once; its backward reads x and dz twice and
   writes dx once) and, as the library yardstick, `F.group_norm` +
   `F.silu` and its autograd backward (on the same channels_last tensors,
   and the backward also on contiguous channels-first copies);
   9c holds the conv bias kernel (csrc/conv_bias.cu) bit for bit against
   aten's `add_` at the VAE encoder's output sizes at 512^2 and at
   SDXL's 1024^2 (the first, [8, 128, 1024^2], 2 GiB), on the decoder's
   3-channel output and in float32, and times both beside the bound by
   bytes, each call on a tensor out of L2;
10. holds K4 (csrc/attention_fwd.cu) against its plain version at the
   UNet's self-attention shapes ((120, 4096, 64), (240, 1024, 64),
   (480, 256, 64) as (batch x heads, tokens, head dim), bfloat16), at
   SDXL's ((240, 4096, 64), (480, 1024, 64)) and at
   (120, 4096, 64) with q sharpened 8x (the online softmax's running
   maximum moves often): largest |kernel - plain| at most 2^-7 of the
   largest |output| (one bfloat16 ulp at the peak; the kernel rounds p to
   bfloat16 relative to the running maximum, the plain version relative to
   the final one), and prints the distance to a float32 softmax; prints
   the kernel's registers and shared memory, times, TFLOP/s, bound (flops
   of the two products over 989 TFLOP/s, bytes over 3.35 TB/s),
   `F.scaled_dot_product_attention` as the library yardstick;
10b. holds the VAE attention kernels (csrc/vae_attention.cu, one head of
   512) against their plain versions at (8, 4096, 512) and
   (8, 16384, 512), bfloat16: out, dq, dk and dv within 2^-7 of each
   one's largest |x|, the log-sum-exp within 1e-4; times the forward
   against its 2-product bound, the backward's logits pass against its 2
   and the whole backward against 5, beside the plain path and
   `F.scaled_dot_product_attention`;
11. writes seeded `unet_ema` and VAE state dicts in diffusers layout
   (bfloat16, `torch.save`) and fills the prompt processor's cache with
   `dummy_encode_fn(77, 1024)` (the card has no text encoder), then builds
   the avatar system with `apps.launch.build_system` from
   configs/avatar.yaml at full width, pointed at those files, the cache
   and phase 4's SMPL-X stand-in (899,719,048 UNet parameters, capacity
   524,288, 100,000 initial points); holds K1 and K2 + K2b against their
   plain versions (phase 2's limits and reruns) on the step's own batch
   shape (shape c: 8
   orbit views of the avatar PLY at 1024^2 with the training rasterizer,
   tile 32 and a 2x2 tile rect) and times them there beside their bounds;
   then drives `GaussianDreamerSystem.train_step` from `init_state`: one
   checked step (cameras, pose images, timesteps and text drawn from the
   state's generator; the metrics and every gradient row finite, the dead
   slots included; Adam moved alive rows and left every dead slot as it
   was; launches exactly K1 1, K2 1, K2b 1, K4 20 (10 self-attention sites at
   4096 tokens, 5 at 1024, 5 at 256) and, counted from the module trees,
   K3 + K3a once per norm of one UNet forward (77) and of five VAE
   encoder passes (rgb, depth, pose, and the rgb and depth encoders
   recomputed in the backward under `remat_encode`: 5 x 22), K5 and K5a
   once per norm of the two differentiated encoders (2 x 22), the conv
   bias kernel once per convolution of the five encoder passes (5 x 28));
   ms per `train_step` over STEP_REPS steps after 2 warm-up steps (median, min,
   max, CUDA events); the step staged by CUDA events recorded from the
   system's and the guidance's own methods, wrapped on the instances
   (inputs, render, three encodes, `compute_grad`, loss + backward, Adam +
   statistics); one profiled step (device busy, idle share, top kernels by
   name and by launching operator and input shapes, K1's, K2's and K2b's
   device ms and the GroupNorm forward's); peak memory; the densify
   statistic's quantiles; the pose images of 8 views timed with `_fma`
   and with plain float32 products (and the
   pixels where they differ); and a VAE encode with channels_last and with
   contiguous weights;
11b. the step's antialiased resize (`ops/resize.py`, float32) at 8 x
   1024^2 x 3 -> 512^2 (the rgb and depth renders) and -> 64^2 (the IF
   path), forward and backward: the card's forward within 1e-6 absolute
   and its gradient within 1e-6 of max-|grad| of the same resize on the
   CPU, within 1e-5 of `F.interpolate(..., antialias=True)` (the library
   resize the port used before) on the card, a second backward under
   strict deterministic algorithms bit-equal to the first; ms of each
   (CUDA events) beside the bound (input read once, output written once);
12. runs `sample_joint` at batch 2 for 4 DDIM steps, conditioned on the
   skeleton drawn from two validation views: 512^2 images and depths
   finite and in [0, 1], K3 + K3a launched once per norm of 4 UNet
   forwards, one encode and two decodes, K4 4 x 20 times, K5 and K5a
   never;
13. differentiates the full-width UNet with respect to its input latents
   (batch 2, 64^2, bfloat16): K3 + K3a, K5 and K5a launch once per norm
   (77); then a float32 full-width UNet at 16^2 latents and a float32
   full-width VAE at 64^2 images: the input gradient through K3 + K3a,
   K5 and K5a within 1e-3 of max-|grad| of the gradient through their
   plain versions;
13b. an SDXL base 1.0 `train_step` through `apps.launch.build_system` on
   configs/avatar_sdxl.yaml at the published widths (seeded bfloat16
   `unet/` and `vae/` files in diffusers layout, `dummy_encode_fn(77,
   2048, pooled_dim=1280)` prompts): 2,567,463,684 UNet parameters; one
   checked step (finite, Adam moved alive rows only) whose launches are
   exactly K1 1, K2 1, K2b 1, K3 + K3a once per UNet norm and twice per
   encoder norm (the 1024^2 encode and its recompute), K5 / K5a once per
   encoder norm, K4 70, the conv bias twice per encoder convolution, the
   fused VAE attention's forward in both passes and its backward once per
   image, and no `chunked_attention` call; ms per step and peak memory;
   then a float32 sdxl-vae at batch 2 and 1024^2 (its attention chunked,
   off the fused kernels): d latents / d image through K3 + K3a, K5, K5a and
   the conv bias kernel within 1e-3 of max-|grad| of the gradient through
   their plain versions, each kernel launched once per encoder norm or
   convolution;
14. runs the avatar CLI in-process, `apps.launch.main` with
   configs/avatar.yaml, `--train` and TRAINER_OVERRIDES at full width: 12
   steps, validation renders at 6 and 12, clone + split at steps 4 and 8
   and prune-only at 10 (the thresholds set as TRAINER_OVERRIDES
   says); every density-control pass must change the alive count, both
   clone and split act at 4 and 8, `it6-val.png`, `it12-val.png`, the
   orbit video (120 views, 15 K1 launches), `metrics.csv` and `ckpts/last`
   exist, `last.ply` reads back through `load_ply` with the run's alive
   count, K1 launches once a step and once per chunk of a render_eval and
   K2 and K2b once a step; then `--resume <save>/ckpts/last
   trainer.max_steps=13` takes exactly one step. Prints the phase's wall
   seconds, the seconds
   a step inside the loop and `finalize`'s seconds;
15. (with phase 11, on its system) one `train_step` with the guidance in
   mode `sjc` (finite metrics and gradients, Adam on alive rows only, the
   launches of phase 11's step), then `guidance_eval_snapshot` at 20 DDIM
   steps: its four decoded strips finite in [0, 1] at 512^2, the strip
   PNG written, K1 once, K3 + K3a once per norm of 21 UNet forwards,
   three encodes and four decodes, K4 21 x 20;
16. the avatar trainer with DeepFloyd IF guidance through
   `apps.launch.build_system` (configs/avatar.yaml with
   `system.guidance.type=deep-floyd`, `arch=if-xl`,
   `texture_structure_joint=false`): first K3 + K3a, K3 and K3a against
   their plain versions at the IF UNet's shapes ([16, 4096, 704], 22 channels a
   group; [16, 4096, 2112]; [16, 64, 5632]), then a seeded IF-I-XL
   `unet/` weight file in bfloat16 (6,831,512,518 parameters), written
   and read back through the launcher (mmap), and a prompt cache of
   `dummy_encode_fn(77, 4096)` T5 stand-ins; one checked step (as phase
   11 checks, launches exactly K1 1, K2 1, K3 + K3a once per norm of one
   IF UNet forward (90), K4, K5 and K5a never), ms per step over 3 steps
   after a warm-up, the staged step, a profiled step; then Perp-Neg on:
   one checked step (the same launches: the four segments in one UNet
   batch of 32) and 2 timed; the weight write and load seconds and the
   peak memory of each checked step; then the same path through the CLI,
   `apps.launch.main --train` for 2 steps with a validation render and
   `finalize` (metrics.csv, the validation PNG, the orbit and last.ply
   written; K1 once a step and once per chunk of 8 views of the
   validation and orbit renders, K2 once a step, K3 + K3a 90 a step);
17. the sampling CLI, `apps.sample.main` on configs/avatar.yaml with
   phase 11's prior files at 50 DDIM steps: a 1536x512 PNG, finite
   image and depth, K3 + K3a once per norm of 50 UNet forwards (the CFG
   pair in one batch), the pose encode and two decodes, K4 50 x 20;
18. `StableDiffusionGuidance` at SD2_SINGLE_CONFIG width with VAEConfig()
   (seeded weights), batch 8 at 512^2: one SDS and one Perp-Neg call,
   each differentiated through the VAE encode (under checkpoint): finite
   loss and render gradient, K3 + K3a once per norm of two encoder
   passes and one UNet forward, K5 and K5a once per encoder norm, K4 once
   per UNet site that passes its gate (15);
19. `ops.knn.mean_3nn_sq_dist` on the card at the avatar's 100,000 points
   against the exact KD-tree (`mean_3nn_sq_dist_host`): it never
   underestimates; prints the share it overestimates and both times;
20. K1 and K2 against their plain versions at 1024x576 (32 x 18 tiles,
   phase 2's limits): a view of the avatar, and the multiview trainer's
   first view as the launcher builds it (the random initial cloud keeps
   every tile busy), with ms per `train_step` there; an instant-ngp
   capture (transforms.json, OPENCV intrinsics with an off-centre
   principal point): 24 + 4 seeded orbit views at 1024x576 rendered by the
   port, and `apps.launch.main` on configs/photo.yaml with
   `data.type=multiview` at full width (capacity 131072, SH 3, 100k
   initial points) for 20 steps with density control from step 10: K1 and
   K2 launch once a step (K1 once more per test view), the mean loss of
   the last 5 steps is below that of the first 5, `last.ply` loads with
   finite parameters;
21. a CO3D-v2 sequence (frame_annotations.jgz with NDC-isotropic cameras,
   28 views at 1024x768 as RGB PNGs, masks from the alpha, float16-in-
   uint16 depth PNGs) trained the same way with `data.type=co3d`,
   `box_crop` on, at 512^2 (K1 and K2 held and the step timed at its first
   training view first);
22. LPIPS with seeded VGG16 and lin weights (through `load_lpips_params`)
   between the capture's test views and the trained scene's renders at
   1024x576: d(x, x) = 0 and d symmetric within 1e-6 of d(x, y), the
   card's value within 1e-4 relative of the CPU's; ms per pair;
23. `mesh.extract_mesh` on the avatar PLY at 128^3: the field finite, the
   mesh non-empty and inside the scene's box (widened by 3 of the largest
   scale and 2 voxels), `save_obj` read back; the field's and marching
   tetrahedra's seconds and the Gaussian-block pairs dropped past
   `block_capacity`;
24. the viewer CLI's server (`apps.viewer.build_server` with the stand-in's
   animator) on port 0 at 512^2, over HTTP: "gs", "mesh" and "skel" frames
   decode at that size and differ, K1 launches exactly once per "gs"
   frame, `POST /pose` changes the next "gs" frame, `/joints` gives 22
   finite points; one "gs" frame, before its PNG encode, against the plain
   compositing of the same view (phase 2's image limits); ms per frame in
   each mode;
25. the DreamFusion system through `apps.launch.main`: (a)
   configs/dreamfusion.yaml as shipped (the tiny prior, 200 steps): every
   logged loss finite, `save/orbit.png` written, K3 + K3a once per norm of
   one UNet forward and two encoder passes a step, K5 / K5a once per
   encoder norm, K4 never (float32, 8^2 latents); (b) at full width
   (`DF_FULL_OVERRIDES`: a 16 x 2^19 x 2 hash grid, 96 samples, the diffuse
   material, the neural environment map; SD2_SINGLE_CONFIG and VAEConfig()
   loaded from seeded bfloat16 files, the prompt cache filled by
   `dummy_encode_fn(77, 1024)`), batch 2 at 64^2: one checked step (finite
   loss and gradients, Adam moved the hash table, both MLPs and the
   background, launches exactly K3 + K3a 105, K5 / K5a 22, K4 15, K1 / K2
   0, from the module trees), ms per step over 10 steps after 2 warm-ups,
   the staged step, a profiled step with the hash grid's gather and
   scatter-add shares, the peak memory, one view of the trained field on
   the card against the CPU (1e-5 of max, depth 1e-4), and the CLI at
   this width for 5 steps;
26. `NeusVolumeRenderer` with a full-width `ImplicitSDF` and
   `NeuralRadianceMaterial` at 64^2 (96 samples), and the NeRF renderer
   with 96 + 64 importance samples on phase 25's field: card against CPU
   at the same limits (the importance pass's per-sample weights at 1e-4),
   ms per view; `export_implicit_volume` on phase 25's field at 64^3 with
   a 512^2 texture: the files written, the OBJ non-empty and inside the
   box, its seconds;
27. `ControlNetGuidance`: seeded bfloat16 SD 1.5 `unet/` (`UNet2D(
   SD15_CONFIG)`) and ControlNetModel files in diffusers layout, written and
   read back through the launcher's loader, with phase 11's VAEConfig()
   VAE, on the avatar's 8 training views at 1024^2 from phase 11's system
   with their openpose skeleton images (512^2) and `dummy_encode_fn(77,
   768)` prompts, differentiated to the render: finite loss and gradients,
   launches exactly K1 1, K2 1, K3 + K3a once per norm of one UNet forward,
   one ControlNet forward and one VAE encode (61 + 27 + 22 = 110), K5 / K5a
   22, K4 0 (SD 1.5 keeps flash attention off); ms per call with its
   backward, peak memory;
28. `TetrahedraSDFGrid` (defaults: resolution 32, 393,216 triangle slots)
   through `NVDiffRasterizer` at 256^2, forward and backward: finite,
   non-zero gradients to sdf and deformation, the card against a CPU copy
   (the winning face equal on all but 1e-3 of the pixels, elsewhere within
   the renderer's limits), ms per view; `CustomMesh` on the SMPL-X
   stand-in's template mesh at 512^2; `PatchRenderer` (patch 32,
   downsample 4) at 256^2 over phase 25's full-width field (a fresh one at
   its configuration under `--only`), card against CPU; no kernel launches;
29. `GANVolumeRenderer(GANRendererConfig())` over the full-width field of
   phase 25's configuration with `hybrid-rgb-latent-material` (11
   features), 64^2 -> 256^2: each generator level with the generator and
   discriminator losses differentiated (finite outputs and gradients to
   the generator, the discriminator and the field), K3 + K3a and K5 / K5a
   exactly once per GAN norm of the level's path (the discriminator's three
   times); ms per render;
30. `multihost_init` (NCCL at world size 1, torchrun's variables set by the
   script) and `make_dp_train_step` on phase 11's system, every kernel on
   the path and torch's deterministic algorithms on, strict (no
   `warn_only`: an op without a deterministic implementation raises; no
   wrapper swapped; `CUBLAS_WORKSPACE_CONFIG` is set to ":4096:8" at the
   top of the script, before the first cuBLAS call, so that cuBLAS's
   products qualify): `train_step` against itself from copies of one
   state bit-equal (loss relative 0, means 0.0, max_radii2d and the
   generator's state equal), one DP step against `train_step` (loss
   within 2e-4 relative, means within 1e-5, max_radii2d and the
   generator's state equal), launches exactly phase 11's, and no warning
   about determinism (cuBLAS's included); what still differs from run to
   run with the flag off, and with cuDNN's deterministic convolutions
   alone; ms per DP step beside `train_step`'s, in turns;
and prints the `kernels` JSON line (all eight kernels, each with the
launches of one `train_step` of phase 11, the main path, and
`launches_deep_floyd_step` (phase 16, Perp-Neg off),
`launches_sample_cli` (phase 17), `launches_controlnet_call` (phase 27),
`launches_dp_step` (phase 30) and `launches_sdxl_step` (phase 13b);
K1's row also carries `launches_serving_and_photo` (phases 4 to 6),
K2's and K2b's `launches_photo` (phase 6); K1's, K2's and K2b's rows
also carry `ms_guidance_batch` and `bound_ms_guidance_batch` (K1's and
K2's also
`bound_ms_guidance_batch_visits`), shape c; K2's row the whole
backward's (K2 + K2b) `ms_with_k2b`, `ms_avatar_view_with_k2b` and
`ms_guidance_batch_with_k2b`; K2b's row `ms_launch`,
`ms_launch_avatar_view` and `ms_launch_guidance_batch`, the kernel
launched without its wrapper), and `launches_photo_data`
(phases 20 and 21), K1's `launches_viewer` (phase 24), and every row's
`launches_dreamfusion_step` (phase 25b's checked step)) and, last, the
device JSON line. `--only GROUP[,GROUP]` (render, norm, attention,
guidance (phases 11 and 15), sample, unet-backward, sdxl (13b), trainer,
deep-floyd, sample-cli, sd-guidance, photo-data (phases 19 to 22), tools
(phases 23 and 24), nerf (phases 25 and 26), controlnet (27), explicit
(28), gan (29), dist (30)) runs some phase groups alone and prints no
result lines.

Any failed check raises, so the script exits non-zero and prints no
result line. Weights and data are random, made from fixed seeds.
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
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
import warnings

# cuBLAS fixes its workspace at the process's first call: phase 30's strict
# deterministic algorithms accept its products only with this setting
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

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
K2B_TOL = 0.0  # K2b vs plain on the same pair rows: the same arithmetic
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


def compare(name, got, want, keys=tuple(TOL)) -> float:
    """Hold kernel outputs against the plain version; returns max abs err."""
    worst = 0.0
    for key in keys:
        atol = TOL[key]
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


def routing_of(pairs):
    """The backward's routing of binning's pair lists."""
    return pairs.cand_pos, pairs.row_starts, pairs.pair_cand


def k2_vs_plain(name, kargs, routing, bg, tiles, cfg, fwd, plain_fwd, seed):
    """K2 + K2b on K1's saved outputs against the plain backward on the
    plain forward's; a second launch of both must give the same bits, and
    K2b alone on K2's sub-tile rows its plain version's bits. Returns K2's
    errors, the cotangents, the gradient, K2b's max abs error and the
    number of sub-tile rows K2 wrote."""
    from humangaussian_torch.ops.rasterize_tiled import (
        composite_backward,
        composite_backward_pairs,
        composite_backward_plain,
        feature_row_grads,
        feature_row_grads_plain,
    )

    cot = random_cotangents(fwd, seed)
    got = composite_backward(*kargs, bg, fwd, cot, *tiles, cfg, routing)
    again = composite_backward(*kargs, bg, fwd, cot, *tiles, cfg, routing)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{name}: K2 + K2b differ on a rerun")
    want = composite_backward_plain(*kargs, bg, plain_fwd, cot, *tiles, cfg,
                                    routing)
    errs = compare_grads(name, got.unbind(1), want.unbind(1), FEATURE_NAMES,
                         GRAD_TOL, MAX_BAD_FRACTION)
    rows, mask = composite_backward_pairs(*kargs, bg, fwd, cot, *tiles, cfg,
                                          routing)
    rows_err = float((feature_row_grads(rows, mask, *routing[:2], kargs[0])
                      - feature_row_grads_plain(rows, mask, *routing[:2],
                                                kargs[0])).abs().max())
    written = int(mask[routing[0] >= 0].sum())
    print(f"  {name}: K2 + K2b bit-equal on a rerun; K2 wrote {written} "
          f"sub-tile rows; K2b vs plain on them max_abs_err={rows_err:.3e} "
          f"(limit {K2B_TOL:g})")
    check(rows_err <= K2B_TOL, f"{name}: K2b differs from plain")
    return errs, cot, got, rows_err, written


def k2b_bound(kargs, routing, written):
    """(bound ms, bound by) of K2b on these inputs: the routing, the mask
    of the counted pairs and the `written` sub-tile rows, the conic of
    each row that has a pair read once, every gradient row written once,
    over the memory rate (its few adds a row are far under the
    instruction rate)."""
    feats = kargs[0]
    cand_pos, row_starts = routing[:2]
    kept = int((cand_pos >= 0).sum())
    rows = feats.shape[0]
    with_pairs = int((row_starts[1:] > row_starts[:-1]).sum())
    n_bytes = ((rows + 1) * 4 + cand_pos.numel() * 4 + kept * 16
               + written * 40 + with_pairs * 12 + rows * 40)
    return n_bytes / H100_BYTES_PER_S * 1e3, "bytes"


def k2_times(label, kargs, routing, bg, tiles, cfg, fwd, cot, plain=True):
    """ms (CUDA events, medians after a warm-up) of K2 alone
    (`composite_backward_pairs`), K2b alone on K2's sub-tile rows
    (`feature_row_grads`), the whole backward K2 + K2b
    (`composite_backward`, what the parent tree's K2 timing covered), with
    `plain` their plain versions, K2b's bound and the library call for
    K2b's sums (`index_add_` of the masked sub-tile rows of the kept
    candidates, each into its candidate's feature row, zeroed beforehand,
    without the per-row transform and in no fixed order)."""
    from humangaussian_torch.ops.rasterize_tiled import (
        composite_backward,
        composite_backward_pairs,
        composite_backward_pairs_plain,
        feature_row_grads,
        feature_row_grads_plain,
    )

    from humangaussian_torch.kernels import RASTERIZE_BWD_ROWS

    feats = kargs[0]
    rows, mask = composite_backward_pairs(*kargs, bg, fwd, cot, *tiles, cfg,
                                          routing)
    out = {
        "k2": cuda_ms(lambda: composite_backward_pairs(
            *kargs, bg, fwd, cot, *tiles, cfg, routing), reps=20),
        "k2b": cuda_ms(lambda: feature_row_grads(rows, mask, *routing[:2],
                                                 feats), reps=20, inner=5),
        "both": cuda_ms(lambda: composite_backward(
            *kargs, bg, fwd, cot, *tiles, cfg, routing), reps=20),
    }
    cand_pos, row_starts = routing[:2]
    # the kernel alone: launched without the wrapper's checks, allocation
    # and device switch (the wrapper's host time exceeds a short kernel's)
    dfeats = torch.empty_like(feats)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    out["k2b_launch"] = cuda_ms(lambda: RASTERIZE_BWD_ROWS.launch(
        rows.data_ptr(), mask.data_ptr(), cand_pos.data_ptr(),
        row_starts.data_ptr(), feats.data_ptr(), feats.shape[0],
        dfeats.data_ptr(), stream), reps=20, inner=5)
    del dfeats
    kept = (cand_pos >= 0).nonzero().flatten()
    pair, sub = (mask[kept] != 0).nonzero(as_tuple=True)
    lib_rows = rows[kept[pair], sub]
    cand_rows = torch.repeat_interleave(
        torch.arange(feats.shape[0], device=feats.device),
        (row_starts[1:] - row_starts[:-1]).to(torch.int64))
    lib_gids = cand_rows[kept[pair]]
    acc = torch.zeros_like(feats)
    out["k2b_library"] = cuda_ms(
        lambda: acc.index_add_(0, lib_gids, lib_rows), reps=20, inner=5)
    out["k2b_bound"] = k2b_bound(kargs, routing, lib_rows.shape[0])[0]
    # K2b's work a warp (32 consecutive feature rows): its masked rows
    per_row = torch.bincount(lib_gids, minlength=feats.shape[0])
    per_warp = torch.nn.functional.pad(
        per_row, (0, -feats.shape[0] % 32)).reshape(-1, 32).sum(1)
    print(f"  {label}: K2b reads {lib_rows.shape[0]} sub-tile rows of "
          f"{int(kept.numel())} kept candidates; a 32-row warp's rows mean "
          f"{float(per_warp.double().mean()):.1f}, max "
          f"{int(per_warp.max())}")
    del kept, pair, sub, lib_rows, cand_rows, lib_gids, acc, per_row, per_warp
    if plain:
        out["k2_plain"] = cuda_ms(lambda: composite_backward_pairs_plain(
            *kargs, bg, fwd, cot, *tiles, cfg, routing), reps=3)
        out["k2b_plain"] = cuda_ms(lambda: feature_row_grads_plain(
            rows, mask, *routing[:2], feats), reps=3)
    print(f"  {label}: K2 {out['k2']:.4f} ms, K2b {out['k2b']:.4f} ms, "
          f"its kernel launched alone {out['k2b_launch']:.4f} ms "
          f"(bound {out['k2b_bound']:.5f} ms by bytes; index_add_ of the "
          f"sub-tile rows {out['k2b_library']:.4f} ms), K2 + K2b "
          f"{out['both']:.4f} ms" + (
              f" (plain K2 {out['k2_plain']:.3f} ms, K2b "
              f"{out['k2b_plain']:.3f} ms)" if plain else ""))
    return out


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


def k2_bound(kargs, tiles, fwd, contribs, written, visits=None):
    """(bound ms, bound by, bytes ms, ops ms, visits) of K2 on these
    inputs: every input read once (feature rows, pair ids, segment table,
    the four saved images, the three cotangents) and its outputs written
    once (the 16 mask bytes of every counted pair and the `written`
    sub-tile rows), over the memory rate; the pair-pixel visits and the
    contributions over the instruction rate. `visits` defaults to the
    replayed visits of the plain walk (up to each pixel's last
    contributor); given `contribs`, only the work any implementation must
    do is counted (see `needed_bounds`)."""
    feats, gids, counts = kargs[0], kargs[1], kargs[3]
    pixels = fwd["depth"].numel()
    n_bytes = (feats.numel() * 4 + gids.numel() * 4
               + 2 * tiles[0] * tiles[1] * 4 + pixels * (6 + 5) * 4
               + int(counts.sum()) * 16 + written * 40)
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


def needed_bounds(kargs, tiles, fwd, contribs, written):
    """K1's and K2's bounds counted from the contributions alone: a pair
    that passes the alpha gate at a pixel before the pixel saturates is
    work every implementation does (its power term, exp and blend in K1,
    its replay and gradient in K2); a visit that fails the gate is work an
    implementation with a finer cull than the kernels' could skip, so it
    is left out. Each bound is (ms, by, bytes ms, ops ms, ...)."""
    pixels = fwd["depth"].numel()
    b1 = k1_bound(kargs, tiles, pixels, contribs, contribs)
    b1 = (*b1[:3], max(b1[3], b1[4]))
    return b1, k2_bound(kargs, tiles, fwd, contribs, written,
                        visits=contribs)


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


def profile_device_time(label, fn, top=8, by_shape=0):
    """Run fn under torch.profiler; print the device-busy share of the
    wall time and the kernels that took the most device time. With
    `by_shape`, also the `by_shape` largest groups of (kernel, the operator
    that launched it, that operator's input shapes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=by_shape > 0) as prof:
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
    if not by_shape:
        return by_name
    # each device kernel hangs off the innermost operator that launched it
    groups = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        for k in e.kernels:
            key = (k.name, e.name, str(e.input_shapes))
            us, calls = groups.get(key, (0.0, 0))
            groups[key] = (us + k.duration, calls + 1)
    print(f"  {label}, by launching operator and input shapes:")
    for (kname, op, shapes), (us, calls) in sorted(
            groups.items(), key=lambda kv: -kv[1][0])[:by_shape]:
        print(f"    {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}% x{calls:<4d} "
              f"{op} {shapes[:110]}\n{'':22}{kname[:100]}")
    return by_name


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


def write_assets(tmp: str, seed: int = 0, n_avatar: int | None = None):
    """Procedural SMPL-X npz, an `n_avatar`-Gaussian avatar PLY (N_AVATAR
    by default), 8-frame motion."""
    from scipy.spatial import cKDTree

    from humangaussian_torch.core.scene import GaussianScene
    from humangaussian_torch.io.ply import save_ply
    from humangaussian_torch.smplx.model import toy_model

    n_avatar = N_AVATAR if n_avatar is None else n_avatar
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
    pts, normals = sample_surface((vt - center) * scale, m.faces, n_avatar,
                                  rng)
    pts = pts + normals * rng.uniform(-5e-3, 5e-3, (n_avatar, 1))
    d2, _ = cKDTree(pts).query(pts, k=4)
    mean_sq = np.mean(d2[:, 1:] ** 2, axis=1)
    log_scale = np.log(np.sqrt(np.maximum(mean_sq, 1e-7)))
    rgb = np.clip(np.array([0.8, 0.6, 0.5])
                  + rng.normal(0, 0.1, (n_avatar, 3)), 0, 1)
    opa = rng.uniform(0.3, 0.95, (n_avatar, 1))
    quats = rng.normal(size=(n_avatar, 4))

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))

    # stored in the training frame: the loader's axis shim swaps y/z back
    scene = GaussianScene(
        means=t(pts[:, [0, 2, 1]]),
        log_scales=t(np.repeat(log_scale[:, None], 3, axis=1)),
        quats=t(quats),
        sh_dc=t((rgb - 0.5) / 0.28209479177387814),
        sh_rest=torch.zeros((n_avatar, 0, 3)),
        opacity_logits=t(np.log(opa / (1 - opa))),
        alive=torch.ones(n_avatar, dtype=torch.bool),
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
                "unet-backward", "sdxl", "trainer", "deep-floyd", "sample-cli",
                "sd-guidance", "photo-data", "tools", "nerf", "controlnet",
                "explicit", "gan", "dist")
AVATAR_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "avatar.yaml")
PROMPT = "a person in a blue jacket"
SDXL_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "configs", "avatar_sdxl.yaml")
SDXL_PROMPT = "a man in a suit"
SDXL_UNET_PARAMS = 2_567_463_684  # SDXL base 1.0's unet/config.json
SDXL_ATTN_PER_UNET_FORWARD = 70  # 10 sites at 4096 tokens, 60 at 1024
SDXL_STEP_REPS = 3  # timed SDXL train_steps of phase 13b, after a warm-up
STEP_REPS = 10  # timed train_steps of phase 11, after 2 warm-up steps
# phase 14: the avatar CLI. Density control fires clone + split at steps 4
# and 8 and prune-only at 10. The SMPL-X stand-in's initial splats are
# 0.8-3.7 mm, far below 1% of the shipped cameras_extent of 4.0 (the split
# threshold), so the extent is lowered to 0.2 (a 2 mm threshold) for split
# to act, and prune_size_threshold to 2.5 mm for prune-only to. The
# densify statistic at full width sits above the shipped max_grad of 2e-4
# (median 2.9e-4, 90% 4.0e-4 after 17 steps of phase 11, NVIDIA H100 80GB
# HBM3, 700.00 W), so the threshold is raised to about its upper quartile:
# each pass then grows the scene by about a quarter instead of doubling it
TRAINER_STEPS = 12
TRAINER_VAL = 6
TRAINER_DENSIFY_STEPS = (4, 8, 10)
TRAINER_MAX_GRAD = 3.5e-4
TRAINER_OVERRIDES = (
    f"trainer.max_steps={TRAINER_STEPS}",
    f"trainer.val_check_interval={TRAINER_VAL}", "trainer.log_every=1",
    "system.densify_prune_start_step=3", "system.densify_prune_interval=4",
    "system.densify_prune_end_step=9", "system.prune_only_start_step=9",
    "system.prune_only_interval=5", "system.prune_only_end_step=13",
    f"system.max_grad={TRAINER_MAX_GRAD:.1e}",  # a YAML float
    "system.cameras_extent=0.2", "system.prune_size_threshold=2.5e-3",
)
# phase 16: the avatar trainer with DeepFloyd IF guidance (IF-I-XL,
# 6,831,512,518 parameters, 90 GroupNorms) through apps.launch
IF_OVERRIDES = ("system.guidance.type=deep-floyd",
                "system.guidance.arch=if-xl",
                "system.texture_structure_joint=false")
IF_UNET_PARAMS = 6_831_512_518
IF_STEP_REPS = 3  # timed IF steps with Perp-Neg off, after 1 warm-up
IF_PERP_NEG_STEPS = 2  # timed IF steps with Perp-Neg on, after a checked one
IF_CLI_STEPS = 2  # steps of the IF path through apps.launch.main
# the GroupNorm forward at the IF UNet's shapes at batch 16 (the CFG pair
# of 8 views): the first level's 64^2 rows at 704 channels (22 a group: the
# 16-byte vectors straddle groups), the 704 + 1408 concatenation at 2112 (66 a
# group) and the 8^2 mid level's 2816 + 2816 concatenation at 5632
IF_GN_SHAPES = ((16, 4096, 704), (16, 4096, 2112), (16, 64, 5632))
SAMPLE_CLI_STEPS = 50  # phase 17: apps.sample's default
SD_BATCH = 8  # phase 18: the SD guidance at 512^2 renders
SNAPSHOT_STEPS = 20  # phase 15: guidance_eval_snapshot's DDIM steps
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core rate, H100 SXM data sheet
# the main path's extremes for the GroupNorm kernels: [samples, rows,
# channels] at batch 24 (3 x 8 latents): the first level's 64^2 rows at 320
# and at the widest concatenated input (960), and the 8^2 mid block's input
# at 2560
GN_SHAPES = ((2, 37, 48), (24, 4096, 320), (24, 4096, 960), (24, 64, 2560),
             # the VAE encoder's norms at batch 8 and 512^2: 512^2 x 128,
             # 256^2 x 128 and 256, 128^2 x 256 and 512, 64^2 x 512
             (8, 262144, 128), (8, 65536, 128), (8, 65536, 256),
             (8, 16384, 256), (8, 16384, 512), (8, 4096, 512),
             # SDXL's (sdxl_body): the UNet's 128^2 rows at 320 and at the
             # widest concatenated input (960), its 32^2 level's 2560; the
             # sdxl-vae encoder's at batch 8 and 1024^2: 1024^2 x 128,
             # 512^2 x 256, 256^2 x 512
             (24, 16384, 320), (24, 16384, 960), (24, 1024, 2560),
             (8, 1048576, 128), (8, 262144, 256), (8, 65536, 512))
GN_MAIN = (24, 4096, 320)
GN_GROUPS = {48: 8}  # 32 groups everywhere at full width
GN_STATS_TOL = 1e-5  # of the f64 sum of magnitudes per (sample, channel)
GN_BAD_FRACTION = 1e-4  # of the outputs may miss plain by more than a ulp
GN_F32_TOL = 1e-5  # of max |y|: the fused op vs plain in float32
# the VAE encoder's convolution outputs at batch 8 and 512^2 images, bf16
# channels_last: 512^2 x 128, 256^2 x 256, 128^2 x 512, 64^2 x 512 and
# quant_conv's 64^2 x 8 (phase 9c); then SDXL's 1024^2 images: 1024^2 x
# 128 (2 GiB, past 2^31 bytes), 512^2 x 256, 256^2 x 512 and 128^2 x 8
CONV_BIAS_SHAPES = ((8, 128, 512, 512), (8, 256, 256, 256),
                    (8, 512, 128, 128), (8, 512, 64, 64), (8, 8, 64, 64),
                    (8, 128, 1024, 1024), (8, 256, 512, 512),
                    (8, 512, 256, 256), (8, 8, 128, 128))
# (batch, tokens, heads) of the UNet's self-attention sites at batch 24:
# SD2's three levels, then SDXL's two (640 wide at 64^2, 1280 at 32^2)
ATTN_SHAPES = ((24, 4096, 5), (24, 1024, 10), (24, 256, 20),
               (24, 4096, 10), (24, 1024, 20))
ATTN_TOL = 2.0 ** -7  # K4 vs plain, of max |out|: one bf16 ulp of the peak
# (batch, tokens) of the VAE mid block's attention, timed and checked
# against the plain versions: SD2's 512^2 encode and SDXL's 1024^2, at the
# cells' batch of 8 (the plain versions take one batch entry at a time, so
# their float32 logits hold 1 GiB at 16,384 tokens)
VAE_ATTN_SHAPES = ((8, 4096), (8, 16384))
VAE_ATTN_TOL = 2.0 ** -7  # kernels vs plain, of max |x|: a bf16 ulp
# the dual-branch SD2 unet_ema with its two 8-channel conv_in (899,696,008
# when both are built for 4 input channels)
UNET_PARAMS = 899_696_008 + 2 * 4 * 320 * 9
ATTN_PER_UNET_FORWARD = 20  # 10 sites at 4096 tokens, 5 at 1024, 5 at 256
UNET_GRAD_TOL = 1e-3  # f32 UNet input gradient, kernels vs plain versions
VAE_GRAD_TOL = 1e-3  # f32 VAE input gradient, kernels vs plain versions
# this phase's numbers with the VAE on the library GroupNorm in contiguous
# NCHW, the layout before its norms became GroupNormAct (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md §5)
LIBRARY_NORM_VAE_MS = {"encode forward": 51.908,
                       "encode forward + backward": 100.117}


def norms_in(module) -> int:
    """GroupNormAct modules in a module tree: each launches the GroupNorm
    forward kernel (`groupnorm_fwd`, K3 + K3a) once a forward, K5 and K5a
    once a backward."""
    from humangaussian_torch.ops.groupnorm import GroupNormAct

    return sum(isinstance(m, GroupNormAct) for m in module.modules())


def convs_in(module) -> int:
    """The VAE's convolutions (`BiasConv2d`) in a module tree: each launches
    the conv bias kernel (`conv_bias_add`) once a forward on the card."""
    from humangaussian_torch.guidance.vae import BiasConv2d

    return sum(isinstance(m, BiasConv2d) for m in module.modules())


def encode_convs(vae) -> int:
    """Convolutions of one VAE encode: the encoder's and quant_conv."""
    return convs_in(vae.encoder) + convs_in(vae.quant_conv)


def decode_convs(vae) -> int:
    """Convolutions of one VAE decode: post_quant_conv and the decoder's."""
    return convs_in(vae.post_quant_conv) + convs_in(vae.decoder)


@contextlib.contextmanager
def plain_versions():
    """Inside, the GroupNorm, attention, conv bias and VAE attention
    wrappers take their plain versions whatever the device: the reference side of a comparison.
    Only the comparisons use it; the paths never do."""
    from humangaussian_torch.ops import (
        attention,
        conv_bias,
        groupnorm,
        vae_attention,
    )

    saved = (groupnorm.group_norm_fwd, groupnorm.group_norm_stats,
             groupnorm.group_norm_apply, groupnorm.group_norm_bwd_stats,
             groupnorm.group_norm_bwd_dx, attention._attention_forward,
             conv_bias.conv_bias_add, vae_attention._forward,
             vae_attention._backward)
    groupnorm.group_norm_fwd = groupnorm.group_norm_fwd_plain
    groupnorm.group_norm_stats = groupnorm.group_norm_stats_plain
    groupnorm.group_norm_apply = groupnorm.group_norm_apply_plain
    groupnorm.group_norm_bwd_stats = groupnorm.group_norm_bwd_stats_plain
    groupnorm.group_norm_bwd_dx = groupnorm.group_norm_bwd_dx_plain
    attention._attention_forward = attention.self_attention_plain
    conv_bias.conv_bias_add = conv_bias.conv_bias_add_plain
    vae_attention._forward = vae_attention.vae_attention_fwd_plain
    vae_attention._backward = vae_attention.vae_attention_bwd_plain
    try:
        yield
    finally:
        (groupnorm.group_norm_fwd, groupnorm.group_norm_stats,
         groupnorm.group_norm_apply, groupnorm.group_norm_bwd_stats,
         groupnorm.group_norm_bwd_dx, attention._attention_forward,
         conv_bias.conv_bias_add, vae_attention._forward,
         vae_attention._backward) = saved


def bf16_ulp(x):
    """The spacing of bfloat16 (8 significant bits) at |x|, as f32."""
    _, exponent = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exponent - 8)


def sums_error(got, want64, scale64):
    """max over (sample, which, channel) of |got - want| / scale."""
    return float(((got.double() - want64).abs()
                  / scale64.clamp_min(1e-30)).max())


def x_sums_f64(x):
    """The float64 sums a GroupNorm's forward must match for x [N, rows,
    C], [N, 2, C] (sum, sum of squares over the rows), and the sums of
    their magnitudes; a sample at a time, so that no float64 copy of the
    whole input is held (8 GiB for the sdxl-vae's first norm)."""
    want, scale = [], []
    for xi in x:
        xi = xi.double()
        sq = (xi * xi).sum(0)
        want.append(torch.stack([xi.sum(0), sq]))
        scale.append(torch.stack([xi.abs().sum(0), sq]))
    return torch.stack(want), torch.stack(scale)


def dz_sums_f64(x, dz, mu, rstd, gamma, beta, silu):
    """K5's sums in float64 ([N, 2, C]: sum of dy and of dy * x_hat over
    the rows, dy the gradient at the norm's output before any SiLU) and
    the sums of their magnitudes, x normalized by the group statistics
    `mu`, `rstd` [N, C]; a sample at a time, as `x_sums_f64`."""
    want, scale = [], []
    for xi, dzi, mi, ri in zip(x, dz, mu, rstd):
        xh = (xi.double() - mi.double()) * ri.double()
        dy = dzi.double()
        if silu:
            y = xh * gamma.double() + beta.double()
            sig = torch.sigmoid(y)
            dy = dy * sig * (1 + y * (1 - sig))
            del y, sig
        want.append(torch.stack([dy.sum(0), (dy * xh).sum(0)]))
        scale.append(torch.stack([dy.abs().sum(0), (dy * xh).abs().sum(0)]))
    return torch.stack(want), torch.stack(scale)


def device_ms_per_call(fn, sessions: int = 7):
    """Device time of one call of fn after a warm-up: the durations of the
    kernels and memsets the profiler sees in one profiled call, summed.
    The profiler can lose some of a session's device events (in a whole
    run of this script it kept one call's kernels of five), so each of
    `sessions` sessions profiles one call, and the median is taken over
    the sessions that saw the most events; None where none saw any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA]
        seen.append((len(us), sum(us)))
    most = max(n for n, _ in seen)
    if most == 0:
        return None
    return statistics.median(us for n, us in seen if n == most) / 1e3


def ms_text(ms) -> str:
    """A device time as printed: 4 decimals, or "not measured"."""
    return "not measured" if ms is None else f"{ms:.4f}"


def backward_host_cost(dev, shape=(24, 64, 2560), calls=100):
    """Host time per call (wall time of `calls` calls, then a sync) of one
    backward through autograd at a shape the device finishes early: an
    identity torch.autograd.Function, the op's, the library's, and the
    op's backward called on the main thread."""
    import torch.nn.functional as F

    from humangaussian_torch.ops import groupnorm

    class Identity(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g

    class Ctx:
        pass

    n, rows, c = shape
    g = torch.Generator(device="cpu").manual_seed(19)
    x = torch.randn((n, rows, 1, c), generator=g).to(dev, torch.bfloat16)
    dz = torch.randn((n, rows, 1, c), generator=g).to(dev, torch.bfloat16)
    gamma, beta = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    xg = x.requires_grad_(True)
    y_op = groupnorm.group_norm_act(xg, gamma, beta, 32, 1e-5, True)
    y_id = Identity.apply(xg)
    xl = x.detach().permute(0, 3, 1, 2).requires_grad_(True)
    y_lib = F.silu(F.group_norm(xl, 32, gamma.bfloat16(), beta.bfloat16(),
                                1e-5))
    ctx = Ctx()
    x3 = x.detach().reshape(n, rows, c)
    ctx.saved_tensors = (x3, gamma, beta, groupnorm.group_norm_stats(x3))
    ctx.cfg = (32, 1e-5, True, x.shape)
    ctx.needs_input_grad = (True, False, False)

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    items = (
        ("identity Function", lambda: torch.autograd.grad(
            y_id, xg, dz, retain_graph=True)),
        ("group_norm_act", lambda: torch.autograd.grad(
            y_op, xg, dz, retain_graph=True)),
        ("F.group_norm + F.silu", lambda: torch.autograd.grad(
            y_lib, xl, dz.permute(0, 3, 1, 2), retain_graph=True)),
        ("group_norm_act's backward on the main thread",
         lambda: groupnorm._GroupNormAct.backward(ctx, dz)),
    )
    print(f"  host time of one backward at {list(shape)} bfloat16 (wall "
          f"over {calls} calls): " + ", ".join(
              f"{name} {host_us(fn):.1f} us" for name, fn in items))


def norm_phase(dev) -> dict:
    """Phase 9: the GroupNorm forward kernel (K3 + K3a in one launch, and
    its sums-only and normalize-only modes K3 and K3a) and K5 against
    their plain versions and f64 sums, bit-equal reruns of the forward, K5
    and K5a, K5a against its plain version, the whole op (forward and
    backward) against the plain op, times, bounds and the library
    yardstick, at the UNet's and the VAE's shapes."""
    import torch.nn.functional as F

    from humangaussian_torch import kernels
    from humangaussian_torch.ops.groupnorm import (
        group_norm_act,
        group_norm_apply,
        group_norm_apply_plain,
        group_norm_bwd_dx,
        group_norm_bwd_dx_plain,
        group_norm_bwd_stats,
        group_norm_bwd_stats_plain,
        group_norm_fwd,
        group_norm_fwd_plain,
        group_norm_stats,
        group_norm_stats_plain,
        group_stats,
    )

    print("phase 9: the GroupNorm forward (K3 + K3a, K3, K3a), K5 and K5a "
          "vs plain")
    g = torch.Generator(device="cpu").manual_seed(9)
    fwd = {"err": 0.0, "sums_err": 0.0, "by_shape": {}}
    bwd = {"err": 0.0, "by_shape": {}}
    bdx = {"err": 0.0, "by_shape": {}}
    for n, rows, c in GN_SHAPES:
        groups = GN_GROUPS.get(c, 32)
        dtype = torch.float32 if c == 48 else torch.bfloat16
        x = (torch.randn((n, rows, c), generator=g) * 1.5 + 0.7).to(dev, dtype)
        dz = torch.randn((n, rows, c), generator=g).to(dev, dtype)
        gamma = (1 + 0.2 * torch.randn(c, generator=g)).to(dev)
        beta = (0.2 * torch.randn(c, generator=g)).to(dev)
        label = f"[{n}, {rows}, {c}] {str(dtype)[6:]}"

        # K3 (the sums-only mode) against plain and against f64 sums
        got = group_norm_stats(x)
        again = group_norm_stats(x)
        torch.cuda.synchronize()
        plain = group_norm_stats_plain(x)
        want, scale = x_sums_f64(x)
        e_k, e_p = sums_error(got, want, scale), sums_error(plain, want, scale)
        same = torch.equal(got, again)
        print(f"  K3 {label}: kernel vs f64 {e_k:.3e}, plain vs f64 "
              f"{e_p:.3e} (of the sum of magnitudes; limit "
              f"{GN_STATS_TOL:g}); two launches bit-equal: {same}")
        check(e_k <= GN_STATS_TOL, f"K3 {label}: {e_k} off the f64 sums")
        check(e_p <= GN_STATS_TOL, f"K3 plain {label}: {e_p}")
        check(same, f"K3 {label}: two launches differ")
        fwd["sums_err"] = max(fwd["sums_err"], float((got - plain).abs().max()))

        def off_plain(got, want):
            """Share of outputs past the limit and the largest difference:
            one bfloat16 ulp, or 1e-5 of max |y| in float32."""
            err = (got.float() - want.float()).abs()
            if dtype == torch.bfloat16:
                share = float((err > bf16_ulp(want)).float().mean())
                return share, share <= GN_BAD_FRACTION, float(err.max())
            rel = float(err.max()) / float(want.abs().max())
            return rel, rel <= GN_F32_TOL, float(err.max())

        limit = GN_BAD_FRACTION if dtype == torch.bfloat16 else GN_F32_TOL
        how_name = ("share over one ulp" if dtype == torch.bfloat16
                    else "of max |out|")

        # K3 + K3a, one launch: its sums against f64, its y against plain
        # on those sums, and a second launch bit for bit
        for silu in (True, False):
            y_f, s_f = group_norm_fwd(x, gamma, beta, groups, 1e-5, silu)
            y_f2, s_f2 = group_norm_fwd(x, gamma, beta, groups, 1e-5, silu)
            torch.cuda.synchronize()
            e_f = sums_error(s_f, want, scale)
            same = torch.equal(y_f, y_f2) and torch.equal(s_f, s_f2)
            y_fp = group_norm_apply_plain(x, s_f, gamma, beta, groups, 1e-5,
                                          silu)
            how, ok, worst = off_plain(y_f, y_fp)
            fwd["err"] = max(fwd["err"], worst)
            fwd["sums_err"] = max(fwd["sums_err"],
                                  float((s_f - plain).abs().max()))
            print(f"  K3 + K3a {label} silu={silu}: sums vs f64 {e_f:.3e} "
                  f"(limit {GN_STATS_TOL:g}); y {how_name} {how:.2e} (limit "
                  f"{limit:g}), max difference {worst:.3e}; two launches "
                  f"bit-equal (y and sums): {same}")
            check(e_f <= GN_STATS_TOL, f"K3 + K3a {label}: sums {e_f}")
            check(ok and bool(torch.isfinite(y_f).all()),
                  f"K3 + K3a {label}: y")
            check(same, f"K3 + K3a {label}: two launches differ")
            del y_f, y_f2, s_f, s_f2, y_fp

        # K5 against plain and against f64 sums, K5a against plain on K5's
        # sums, with and without SiLU
        # the f64 reference normalizes with the plain group statistics
        mu_c, rstd_c = group_stats(plain, rows, groups, 1e-5)
        for silu in (True, False):
            got5 = group_norm_bwd_stats(x, dz, plain, gamma, beta, groups,
                                        1e-5, silu)
            again5 = group_norm_bwd_stats(x, dz, plain, gamma, beta, groups,
                                          1e-5, silu)
            torch.cuda.synchronize()
            check(torch.equal(got5, again5),
                  f"K5 {label}: two launches differ")
            del again5
            plain5 = group_norm_bwd_stats_plain(x, dz, plain, gamma, beta,
                                                groups, 1e-5, silu)
            want5, scale5 = dz_sums_f64(x, dz, mu_c, rstd_c, gamma, beta,
                                        silu)
            e_k = sums_error(got5, want5, scale5)
            e_p = sums_error(plain5, want5, scale5)
            print(f"  K5 {label} silu={silu}: kernel vs f64 {e_k:.3e}, plain "
                  f"vs f64 {e_p:.3e}; two launches bit-equal")
            check(e_k <= GN_STATS_TOL, f"K5 {label}: {e_k} off the f64 sums")
            check(e_p <= GN_STATS_TOL, f"K5 plain {label}: {e_p}")
            bwd["err"] = max(bwd["err"], float((got5 - plain5).abs().max()))
            del want5, scale5

            dx_k = group_norm_bwd_dx(x, dz, plain, gamma, beta, got5, groups,
                                     1e-5, silu)
            dx_k2 = group_norm_bwd_dx(x, dz, plain, gamma, beta, got5,
                                      groups, 1e-5, silu)
            torch.cuda.synchronize()
            check(torch.equal(dx_k, dx_k2),
                  f"K5a {label}: two launches differ")
            del dx_k2
            dx_p = group_norm_bwd_dx_plain(x, dz, plain, gamma, beta, got5,
                                           groups, 1e-5, silu)
            how, ok, worst = off_plain(dx_k, dx_p)
            bdx["err"] = max(bdx["err"], worst)
            print(f"  K5a {label} silu={silu}: {how_name} {how:.2e} (limit "
                  f"{limit:g}), max difference {worst:.3e}; two launches "
                  f"bit-equal")
            check(ok and bool(torch.isfinite(dx_k).all()), f"K5a {label}")
            del dx_k, dx_p
        del want, scale

        # K3a alone on K3's sums, and the whole op (K3 + K3a forward, K5 +
        # K5a backward) against the plain op (the plain versions)
        x4 = x.reshape(n, rows, 1, c)
        dz4 = dz.reshape(n, rows, 1, c)
        for silu in (True, False):
            y_a = group_norm_apply(x, got, gamma, beta, groups, 1e-5, silu)
            torch.cuda.synchronize()
            y_ap = group_norm_apply_plain(x, got, gamma, beta, groups, 1e-5,
                                          silu)
            how, ok, worst = off_plain(y_a, y_ap)
            fwd["err"] = max(fwd["err"], worst)
            print(f"  K3a {label} silu={silu}: {how_name} {how:.2e}, max "
                  f"difference {worst:.3e}")
            check(ok and bool(torch.isfinite(y_a).all()), f"K3a {label}")
            del y_a, y_ap
            outs = []
            for plain_op in (False, True):
                with plain_versions() if plain_op else contextlib.nullcontext():
                    xg = x4.detach().requires_grad_(True)
                    y = group_norm_act(xg, gamma, beta, groups, 1e-5, silu)
                    (dx,) = torch.autograd.grad(y, xg, dz4)
                outs.append((y.detach(), dx))
            for what, k, p_ in (("forward", outs[0][0], outs[1][0]),
                                ("backward", outs[0][1], outs[1][1])):
                how, ok, worst = off_plain(k, p_)
                print(f"  group_norm_act {what} {label} silu={silu} (the "
                      f"kernels vs the plain op): {how:.2e} (limit "
                      f"{limit:g}), max difference {worst:.3e}")
                check(ok and bool(torch.isfinite(k).all()),
                      f"group_norm_act {what} {label}")
            del outs, y, dx, xg

        # times (each over runs of back-to-back calls): the kernels and
        # the forward's modes, their plain versions, the whole op, and the
        # library's GroupNorm + SiLU (forward, and its autograd backward)
        spin(lambda: group_norm_fwd(x, gamma, beta, groups, 1e-5, True))
        fwd_ms = cuda_ms(lambda: group_norm_fwd(
            x, gamma, beta, groups, 1e-5, True), reps=10, inner=10)
        fwd_dev = device_ms_per_call(lambda: group_norm_fwd(
            x, gamma, beta, groups, 1e-5, True))
        fwd_plain_ms = cuda_ms(lambda: group_norm_fwd_plain(
            x, gamma, beta, groups, 1e-5, True), reps=3, inner=5)
        k3_ms = cuda_ms(lambda: group_norm_stats(x), reps=10, inner=10)
        k3_plain_ms = cuda_ms(lambda: group_norm_stats_plain(x), reps=3,
                              inner=5)
        k3a_ms = cuda_ms(lambda: group_norm_apply(
            x, got, gamma, beta, groups, 1e-5, True), reps=10, inner=10)
        k3a_plain_ms = cuda_ms(lambda: group_norm_apply_plain(
            x, got, gamma, beta, groups, 1e-5, True), reps=3, inner=5)
        k5_ms = cuda_ms(lambda: group_norm_bwd_stats(
            x, dz, got, gamma, beta, groups, 1e-5, True), reps=10, inner=10)
        k5_plain_ms = cuda_ms(lambda: group_norm_bwd_stats_plain(
            x, dz, got, gamma, beta, groups, 1e-5, True), reps=3, inner=5)
        s5 = group_norm_bwd_stats(x, dz, got, gamma, beta, groups, 1e-5, True)
        k5a_ms = cuda_ms(lambda: group_norm_bwd_dx(
            x, dz, got, gamma, beta, s5, groups, 1e-5, True), reps=10,
            inner=10)
        k5a_plain_ms = cuda_ms(lambda: group_norm_bwd_dx_plain(
            x, dz, got, gamma, beta, s5, groups, 1e-5, True), reps=3,
            inner=5)
        op_ms = cuda_ms(lambda: group_norm_act(x4, gamma, beta, groups, 1e-5,
                                               True), reps=5, inner=10)
        x_cf = x4.permute(0, 3, 1, 2)  # channels-first view, channels_last
        gd, bd = gamma.to(dtype), beta.to(dtype)
        lib_ms = cuda_ms(lambda: F.silu(F.group_norm(x_cf, groups, gd, bd,
                                                     1e-5)), reps=5, inner=10)
        xg = x4.detach().requires_grad_(True)
        y_op = group_norm_act(xg, gamma, beta, groups, 1e-5, True)
        op_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            y_op, xg, dz4, retain_graph=True), reps=5, inner=10)
        dz_cf = dz4.permute(0, 3, 1, 2)
        lib_bwd = {}
        # the library on the same channels_last tensors (the yardstick, as
        # in earlier PRs), and on contiguous channels-first copies
        for fmt, xin, dzin in (
                ("channels_last", x_cf, dz_cf),
                ("contiguous", x_cf.contiguous(), dz_cf.contiguous())):
            xl = xin.detach().requires_grad_(True)
            y_lib = F.silu(F.group_norm(xl, groups, gd, bd, 1e-5))
            lib_bwd[fmt] = cuda_ms(lambda: torch.autograd.grad(
                y_lib, xl, dzin, retain_graph=True), reps=5, inner=10)
            if fmt == "channels_last":
                lib_bwd_dev = device_ms_per_call(lambda: torch.autograd.grad(
                    y_lib, xl, dzin, retain_graph=True))
            del xl, y_lib
        lib_bwd_ms = lib_bwd["channels_last"]
        op_bwd_dev = device_ms_per_call(lambda: torch.autograd.grad(
            y_op, xg, dz4, retain_graph=True))
        item = x.element_size()
        xbytes = x.numel() * item
        sums_bytes = n * 2 * c * 4
        k3_bound = (xbytes + sums_bytes) / H100_BYTES_PER_S * 1e3
        # K3a: x and the sums, gamma, beta read once, y written once
        k3a_bound = ((2 * xbytes + sums_bytes + 2 * c * 4)
                     / H100_BYTES_PER_S * 1e3)
        # K3 + K3a and the op's forward: two passes, x and gamma, beta read
        # once, y and the sums written once
        op_bound = ((2 * xbytes + sums_bytes + 2 * c * 4)
                    / H100_BYTES_PER_S * 1e3)
        # K5: x, dz, the forward's sums, gamma, beta read, the sums written
        k5_bound = ((2 * xbytes + 2 * sums_bytes + 2 * c * 4)
                    / H100_BYTES_PER_S * 1e3)
        # K5a: x, dz, both sums, gamma, beta read, dx written
        k5a_bound = ((3 * xbytes + 2 * sums_bytes + 2 * c * 4)
                     / H100_BYTES_PER_S * 1e3)
        # the op's backward: both kernels' bytes (x and dz do not stay in
        # L2 between them at the large shapes)
        op_bwd_bound = k5_bound + k5a_bound
        dev_share = ("" if fwd_dev is None else
                     f", {100 * op_bound / fwd_dev:.0f}% in device time")
        print(f"  {label}: K3 + K3a {fwd_ms:.4f} ms (device "
              f"{ms_text(fwd_dev)}; plain {fwd_plain_ms:.4f}, two-pass "
              f"bound {op_bound:.5f}: {100 * op_bound / fwd_ms:.0f}% of "
              f"it{dev_share}), K3 "
              f"{k3_ms:.4f} ms "
              f"(plain {k3_plain_ms:.4f}, bound {k3_bound:.5f}), K3a "
              f"{k3a_ms:.4f} ms (plain {k3a_plain_ms:.4f}, bound "
              f"{k3a_bound:.5f}), K5 {k5_ms:.4f} "
              f"ms (plain {k5_plain_ms:.4f}, bound {k5_bound:.5f}), K5a "
              f"{k5a_ms:.4f} ms (plain {k5a_plain_ms:.4f}, bound "
              f"{k5a_bound:.5f}), all by bytes")
        print(f"  {label}: group_norm_act forward {op_ms:.4f} ms (bound "
              f"{op_bound:.5f}) vs F.group_norm + F.silu {lib_ms:.4f} ms; "
              f"backward {op_bwd_ms:.4f} ms (bound {op_bwd_bound:.5f}) vs "
              f"the library's autograd {lib_bwd_ms:.4f} ms on the same "
              f"channels_last tensors, {lib_bwd['contiguous']:.4f} ms on "
              f"contiguous ones; device time of a backward "
              f"{ms_text(op_bwd_dev)} ms vs the library's "
              f"{ms_text(lib_bwd_dev)}")
        fwd["by_shape"][label] = {
            "ms": fwd_ms, "device_ms": fwd_dev, "plain_ms": fwd_plain_ms,
            "bound_ms": op_bound, "op_forward_ms": op_ms,
            "library_ms": lib_ms,
            "sums_only_ms": k3_ms, "sums_only_plain_ms": k3_plain_ms,
            "sums_only_bound_ms": k3_bound, "normalize_only_ms": k3a_ms,
            "normalize_only_plain_ms": k3a_plain_ms,
            "normalize_only_bound_ms": k3a_bound}
        for acc, ms, plain_ms, bound in ((bwd, k5_ms, k5_plain_ms, k5_bound),
                                         (bdx, k5a_ms, k5a_plain_ms,
                                          k5a_bound)):
            acc["by_shape"][label] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "op_backward_ms": op_bwd_ms,
                "op_backward_bound_ms": op_bwd_bound,
                "op_backward_device_ms": op_bwd_dev,
                "library_ms": lib_bwd_ms,
                "library_contiguous_ms": lib_bwd["contiguous"],
                "library_device_ms": lib_bwd_dev}
        del y_op, xg, x, dz, x4, dz4, x_cf, dz_cf, got, again, plain, s5
    backward_host_cost(dev)

    main = "[%d, %d, %d] bfloat16" % GN_MAIN
    out = {}
    whole_bwd = "autograd backward of F.group_norm + F.silu (the whole backward)"
    for kernel, acc, source, replaces, lib_note in (
        (kernels.GROUPNORM_FWD, fwd, "groupnorm_fwd.cu",
         "humangaussian_tpu/ops/groupnorm.py:70",
         "F.group_norm + F.silu forward (the same function)"),
        (kernels.GROUPNORM_BWD_STATS, bwd, "groupnorm_stats.cu",
         "humangaussian_tpu/ops/groupnorm.py:102", whole_bwd),
        (kernels.GROUPNORM_BWD_DX, bdx, "groupnorm_bwd_dx.cu",
         "humangaussian_tpu/ops/groupnorm.py:251", whole_bwd),
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
    row = out[kernels.GROUPNORM_FWD.name]
    row["also_replaces"] = ("humangaussian_tpu/ops/groupnorm.py:206-213 "
                            "(the XLA normalize of _gn_fwd :190)")
    row["sums_max_abs_err"] = fwd["sums_err"]
    row["device_ms"] = row["by_shape"][main]["device_ms"]
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


def vae_attention_phase(dev) -> dict:
    """Phase 10b: the VAE mid block's fused attention (csrc/vae_attention.cu)
    against its plain versions at SD2's and SDXL's token counts, forward
    and backward; times against the bf16 bound (2 products forward, 5
    backward: S, dP, dV, dK, dQ), the plain path's (`attend`, chunked past
    the logits cap) and scaled_dot_product_attention's as the yardstick."""
    import ctypes

    import torch.nn.functional as F

    from humangaussian_torch import kernels
    from humangaussian_torch.guidance.vae import (
        attend,
        attention_chunk_rows,
        chunked_attention,
    )
    from humangaussian_torch.ops import vae_attention as va

    print("phase 10b: the VAE attention kernels (one head of 512) vs plain")
    info = [ctypes.c_int() for _ in range(4)]
    lib = ctypes.CDLL(str(kernels.VAE_ATTENTION_FWD.build()))
    check(lib.hg_vae_attention_info(*(ctypes.byref(x) for x in info)) == 0,
          "hg_vae_attention_info failed")
    regs = {"fwd": info[0].value, "bwd": info[2].value}
    smem = {"fwd": info[1].value, "bwd": info[3].value}
    print(f"  forward {regs['fwd']} / backward logits pass {regs['bwd']} "
          f"registers a thread at launch (setmaxnreg: producer 24, consumers "
          f"240), {smem['fwd']} / {smem['bwd']} bytes of dynamic shared "
          f"memory a block")
    g = torch.Generator(device="cpu").manual_seed(23)
    worst = {"fwd": 0.0, "bwd": 0.0}
    by_shape = {"fwd": {}, "bwd": {}}
    for b, n in VAE_ATTN_SHAPES:
        q, k, v, dout = (torch.randn((b, n, 512), generator=g).to(
            dev, torch.bfloat16) for _ in range(4))
        label = f"({b}, {n}, 512)"
        out, lse = va._forward(q, k, v)
        grads = va._backward(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_out, p_lse = va.vae_attention_fwd_plain(q, k, v)
        p_grads = va.vae_attention_bwd_plain(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        errs = [float((a.float() - w.float()).abs().max()
                      / w.float().abs().max())
                for a, w in zip((out, *grads), (p_out, *p_grads))]
        lse_err = float((lse - p_lse).abs().max())
        print(f"  {label}: kernel vs plain, of each one's max |x|: out "
              f"{errs[0]:.3e}, dq {errs[1]:.3e}, dk {errs[2]:.3e}, dv "
              f"{errs[3]:.3e} (limit {VAE_ATTN_TOL:.3e}); lse max abs "
              f"{lse_err:.3e} (limit 1e-4); plain versions "
              f"{plain_s:.1f} s (host clock)")
        for name, err in zip(("out", "dq", "dk", "dv"), errs):
            check(err <= VAE_ATTN_TOL, f"VAE attention {label} {name}: "
                  f"{err} of max vs plain")
        check(lse_err <= 1e-4, f"VAE attention {label} lse: {lse_err}")
        worst["fwd"] = max(worst["fwd"], errs[0])
        worst["bwd"] = max(worst["bwd"], *errs[1:])
        del p_out, p_lse, p_grads
        check(all(bool(torch.isfinite(x).all()) for x in (out, *grads)),
              f"VAE attention {label}: non-finite")
        del grads
        torch.cuda.empty_cache()
        flops = 4.0 * b * n * n * 512  # two products
        bound_f = flops / H100_BF16_FLOPS * 1e3
        bound_b = 2.5 * bound_f  # five
        spin(lambda: va._forward(q, k, v))
        fwd_ms = cuda_ms(lambda: va._forward(q, k, v), reps=5, inner=2)
        bwd_ms = cuda_ms(lambda: va._backward(q, k, v, out, lse, dout),
                         reps=3)
        chunk = va.backward_chunk(b, n)
        p_buf = torch.empty((chunk, n, n), dtype=torch.bfloat16, device=dev)
        ds_buf = torch.empty_like(p_buf)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def logits_pass():
            for s0 in range(0, b, chunk):
                m = min(b, s0 + chunk) - s0
                kernels.VAE_ATTENTION_BWD.launch(
                    q[s0].data_ptr(), k[s0].data_ptr(), v[s0].data_ptr(),
                    out[s0].data_ptr(), dout[s0].data_ptr(),
                    lse[s0].data_ptr(), p_buf.data_ptr(), ds_buf.data_ptr(),
                    m, n, 512 ** -0.5, stream)

        pass_ms = cuda_ms(logits_pass, reps=3)
        del p_buf, ds_buf
        rows = attention_chunk_rows(b, n)

        def plain_path(grad):
            xs = [x.detach().requires_grad_(grad) for x in (q, k, v)]
            y = attend(*xs) if rows >= n else chunked_attention(*xs, rows)
            if grad:
                y.backward(dout)

        with torch.no_grad():
            path_f = cuda_ms(lambda: plain_path(False), reps=1)
        path_fb = cuda_ms(lambda: plain_path(True), reps=1)
        qh, kh, vh = (x[:, None] for x in (q, k, v))

        def lib_fb():
            xs = [x.detach().requires_grad_(True) for x in (qh, kh, vh)]
            F.scaled_dot_product_attention(*xs).backward(dout[:, None])

        try:  # the yardstick only; its math fallback may not fit
            lib_f = cuda_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh), reps=3)
            lib_fb_ms = cuda_ms(lib_fb, reps=1)
        except torch.OutOfMemoryError:
            lib_f = lib_fb_ms = None
        torch.cuda.empty_cache()
        lib_text = ("not measured (out of memory)" if lib_f is None else
                    f"forward {lib_f:.3f} ms, forward + backward "
                    f"{lib_fb_ms:.3f} ms")
        print(f"  {label}: forward {fwd_ms:.3f} ms = {flops / fwd_ms / 1e9:.1f}"
              f" TFLOP/s, {100 * bound_f / fwd_ms:.1f}% of the bound "
              f"{bound_f:.3f} ms; backward {bwd_ms:.3f} ms, "
              f"{100 * bound_b / bwd_ms:.1f}% of the bound {bound_b:.3f} ms "
              f"(its logits pass {pass_ms:.3f} ms, "
              f"{100 * 0.4 * bound_b / pass_ms:.1f}% of its 2 products; the "
              f"three bf16 GEMMs the rest); the plain path ("
              f"{'one pass' if rows >= n else f'chunks of {rows}'}) forward "
              f"{path_f:.3f} ms, forward + backward {path_fb:.3f} ms; "
              f"scaled_dot_product_attention {lib_text}")
        by_shape["fwd"][label] = {
            "ms": fwd_ms, "bound_ms": bound_f, "bound_by": "operations",
            "plain_path_ms": path_f, "library_ms": lib_f}
        by_shape["bwd"][label] = {
            "ms": pass_ms, "bound_ms": 0.4 * bound_b,
            "bound_by": "operations", "op_ms": bwd_ms, "op_bound_ms": bound_b,
            "plain_path_ms": path_fb - path_f,
            "library_ms": None if lib_f is None else lib_fb_ms - lib_f}
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    main = "({}, {}, 512)".format(*VAE_ATTN_SHAPES[-1])
    rows_out = {}
    for kern, key in ((kernels.VAE_ATTENTION_FWD, "fwd"),
                      (kernels.VAE_ATTENTION_BWD, "bwd")):
        at = by_shape[key][main]
        rows_out[kern.name] = {
            "name": kern.name, "route": "cuda",
            "source": "humangaussian_torch/csrc/vae_attention.cu",
            "replaces": "none (humangaussian_tpu/guidance/vae.py:85-87, XLA "
                        "einsums)",
            "launches": 0, "max_abs_err": worst[key], "ms": at["ms"],
            "plain_ms": at["plain_path_ms"], "bound_ms": at["bound_ms"],
            "bound_by": "operations", "library_ms": at["library_ms"],
            "library_call": "F.scaled_dot_product_attention",
            "registers": regs[key], "shared_memory_bytes": smem[key],
            "shape": main, "by_shape": by_shape[key],
            **{x: at[x] for x in ("op_ms", "op_bound_ms") if x in at}}
    return rows_out


def conv_bias_phase(dev) -> dict:
    """Phase 9c: the conv bias kernel bit for bit against aten's `add_`
    (its plain version and the path it replaces) at the VAE encoder's
    output sizes, and on the decoder's 3-channel output (the scalar path)
    and a float32 contiguous tensor; times with each call on a tensor out
    of L2, and the bound by bytes."""
    from humangaussian_torch import kernels
    from humangaussian_torch.ops.conv_bias import (
        conv_bias_add,
        conv_bias_add_plain,
    )

    print("phase 9c: the conv bias kernel against aten's add_ (bit for "
          "bit; each timed call on a tensor out of L2)")
    gen = torch.Generator(device=dev).manual_seed(9)

    def inputs(shape, dtype, layout):
        y = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        bias = torch.randn(shape[1], generator=gen, device=dev, dtype=dtype)
        return y.contiguous(memory_format=layout), bias

    for shape, dtype, layout in (
            ((8, 3, 512, 512), torch.bfloat16, torch.channels_last),
            ((2, 256, 64, 64), torch.float32, torch.contiguous_format)):
        y, bias = inputs(shape, dtype, layout)
        check(torch.equal(conv_bias_add(y.clone(), bias),
                          conv_bias_add_plain(y.clone(), bias)),
              f"conv bias {shape} {dtype} differs from aten's add_")
    by_shape = {}
    for shape in CONV_BIAS_SHAPES:
        y, bias = inputs(shape, torch.bfloat16, torch.channels_last)
        check(torch.equal(conv_bias_add(y.clone(), bias),
                          conv_bias_add_plain(y.clone(), bias)),
              f"conv bias {shape} differs from aten's add_")
        size = y.numel() * y.element_size()
        ys = [y] + [y.clone() for _ in range(-(-200_000_000 // size) - 1)]
        turn = [0]

        def next_y():
            turn[0] = (turn[0] + 1) % len(ys)
            return ys[turn[0]]

        inner = max(4, len(ys))
        ms = cuda_ms(lambda: conv_bias_add(next_y(), bias), 5, inner=inner)
        plain_ms = cuda_ms(lambda: conv_bias_add_plain(next_y(), bias), 5,
                           inner=inner)
        bound = 2 * size / H100_BYTES_PER_S * 1e3
        print(f"  {list(shape)} bfloat16: kernel {ms:.4f} ms "
              f"({100 * bound / ms:.1f}% of the bound {bound:.5f} ms by "
              f"bytes), aten add_ {plain_ms:.4f} ms")
        by_shape[str(list(shape))] = {"ms": ms, "plain_ms": plain_ms,
                                      "bound_ms": bound}
        del y, ys
    torch.cuda.empty_cache()
    first = by_shape[str(list(CONV_BIAS_SHAPES[0]))]
    return {kernels.CONV_BIAS_ADD.name: {
        "name": kernels.CONV_BIAS_ADD.name,
        "route": "cuda",
        "source": "humangaussian_torch/csrc/conv_bias.cu",
        "replaces": "none (the JAX package's XLA convolutions fuse their "
                    "bias)",
        "launches": 0,
        "max_abs_err": 0.0,
        "ms": first["ms"],
        "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"],
        "bound_by": "bytes",
        "library_ms": first["plain_ms"],
        "library_call": "aten add_ of bias.view(1, C, 1, 1), the plain "
                        "version",
        "shape": str(list(CONV_BIAS_SHAPES[0])),
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


def write_prior_files(dev, tmp) -> list:
    """Seeded unet_ema and VAE weight files in diffusers layout and the
    prompt cache filled by `dummy_encode_fn(77, 1024)` (the card has no
    text encoder); returns the configs/avatar.yaml overrides that point the
    launcher at them."""
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

    print("writing the prior: seeded weights -> diffusers files")
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
    cache = os.path.join(tmp, "text_embeddings")
    overrides = [f"system.guidance.model_key={model_key}",
                 f"system.guidance.vae_key={vae_key}",
                 f"system.prompt_processor.prompt={PROMPT}",
                 f"system.prompt_processor.cache_dir={cache}"]
    pp = load_config(AVATAR_YAML, overrides)["system"]["prompt_processor"]
    PromptProcessor(
        PromptProcessorConfig(
            prompt=pp["prompt"], negative_prompt=pp["negative_prompt"],
            model_path=pp["pretrained_model_name_or_path"], cache_dir=cache),
        dummy_encode_fn(77, 1024), device=dev)()
    print(f"  files and prompt cache written in "
          f"{time.perf_counter() - t0:.1f} s")
    return overrides


def build_avatar_system(dev, overrides):
    """`apps.launch.build_system` on configs/avatar.yaml (full width),
    pointed at the seeded files, the prompt cache and the SMPL-X stand-in."""
    from humangaussian_torch.apps import launch
    from humangaussian_torch.config import load_config

    t0 = time.perf_counter()
    system = launch.build_system(load_config(AVATAR_YAML, overrides), dev)
    torch.cuda.synchronize()
    guidance = system.guidance
    n_unet = sum(p.numel() for p in guidance.unet.parameters())
    n_vae = sum(p.numel() for p in guidance.vae.parameters())
    print(f"  build_system: unet_ema {n_unet} parameters "
          f"({guidance.unet.dtype}), VAE {n_vae}, skeleton "
          f"{system.skeleton.vertices.shape[0]} vertices, capacity "
          f"{system.cfg.capacity}, built in {time.perf_counter() - t0:.1f} s")
    check(n_unet == UNET_PARAMS, f"UNet has {n_unet} parameters")
    check(guidance.unet.conv_norm_out.weight.dtype == torch.float32
          and guidance.vae.encoder.conv_norm_out.weight.dtype
          == torch.float32, "GroupNorm parameters are not float32")
    check(guidance.vae.encoder.conv_in.weight.is_contiguous(
        memory_format=torch.channels_last), "VAE weights not channels_last")
    check(system.prompt_embeddings.text_vd.shape == (4, 77, 1024),
          "embedding shape")
    return system


def guidance_batch_kernels(avatar, cams, rcfg, bg) -> dict:
    """Shape (c): K1, K2 and K2b on the guidance step's own batch (the
    orbit views of phase 11 at SIZE^2, the training rect) against their
    plain versions with phase 2's limits (K2 + K2b bit-equal on a rerun),
    timed (CUDA events, medians after a warm-up) beside their bounds, with
    the work the sub-tile skip removes."""
    from humangaussian_torch.ops.rasterize_tiled import (
        composite,
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
    routing = routing_of(pairs)
    k2_err, cot, _, k2b_err, written = k2_vs_plain(
        label, kargs, routing, bg, tiles, rcfg, got, plain, seed=16)
    visits, contribs = int(plain["visits"]), int(plain["contribs"])
    del plain
    fwd = {k: got[k] for k in ("image", "depth", "final_t", "n_contrib")}

    k1_ms = cuda_ms(lambda: composite(*kargs, bg, *tiles, rcfg), reps=20)
    times = k2_times(label, kargs, routing, bg, tiles, rcfg, fwd, cot,
                     plain=False)
    b1 = k1_bound(kargs, tiles, got["depth"].numel(), visits, contribs)
    b2 = k2_bound(kargs, tiles, fwd, contribs, written)
    n1, n2 = needed_bounds(kargs, tiles, fwd, contribs, written)
    print(f"  {label}: pairs={int(pairs.gids.numel())} overflow="
          f"{int(pairs.overflow)} pair-pixel visits={visits} contributions="
          f"{contribs}; {work_line(raster_work(kargs, tiles, rcfg, fwd))}")
    print(f"  K1 {label}: {k1_ms:.4f} ms, {bound_text(n1, b1)}")
    print(f"  K2 {label}: {times['k2']:.4f} ms, replays {b2[4]} visits, "
          f"{bound_text(n2, b2)}")
    return {"k1_err": k1_err, "k2_err": k2_err, "k2b_err": k2b_err,
            "k1_ms": k1_ms, "k1_bound": n1[0], "k1_bound_visits": b1[0],
            "k2_ms": times["k2"], "k2_bound": n2[0],
            "k2_bound_visits": b2[0], "k2_k2b_ms": times["both"],
            "k2b_ms": times["k2b"], "k2b_launch_ms": times["k2b_launch"],
            "k2b_bound": times["k2b_bound"],
            "k2b_library_ms": times["k2b_library"]}


def launches(**counts) -> dict:
    """A full launch-count dict: the kernels named, the rest 0."""
    out = dict.fromkeys(("rasterize_fwd", "rasterize_bwd",
                         "rasterize_bwd_rows", "groupnorm_fwd",
                         "groupnorm_bwd_stats", "groupnorm_bwd_dx",
                         "attention_fwd", "conv_bias_add",
                         "vae_attention_fwd", "vae_attention_bwd"), 0)
    out.update(counts)
    return out


def vae_attention_launches(vae, tokens: int, forwards: int,
                           backwards: int = 0, batch: int = 8) -> dict:
    """The fused VAE attention's launches (ops/vae_attention.py) for
    `forwards` mid-block passes and `backwards` differentiated ones of
    `batch` images at `tokens` tokens, when `vae` takes the kernels (bf16,
    512 wide: every VAE at full width); none for the float32 tiny VAEs.
    A backward launches its logits pass once a chunk of batch entries."""
    from humangaussian_torch.ops import vae_attention

    if (vae.dtype != torch.bfloat16
            or vae.cfg.block_out_channels[-1] != vae_attention.WIDTH
            or tokens % vae_attention.ROW_MULTIPLE):
        return {}
    chunks = -(-batch // vae_attention.backward_chunk(batch, tokens))
    return {"vae_attention_fwd": forwards,
            "vae_attention_bwd": backwards * chunks}


def dual_branch_step_launches(guidance) -> dict:
    """One dual-branch train_step's launches, from the module trees: one
    UNet forward; encoder passes for rgb, depth and pose, plus the
    recomputation of the two differentiated ones in the backward under
    remat_encode; two encoder backwards."""
    enc_norms = norms_in(guidance.vae.encoder)
    passes = 3 + (2 if guidance.cfg.remat_encode else 0)
    forward = norms_in(guidance.unet) + passes * enc_norms
    return launches(rasterize_fwd=1, rasterize_bwd=1, rasterize_bwd_rows=1,
                    groupnorm_fwd=forward,
                    groupnorm_bwd_stats=2 * enc_norms,
                    groupnorm_bwd_dx=2 * enc_norms,
                    attention_fwd=ATTN_PER_UNET_FORWARD,
                    conv_bias_add=passes * encode_convs(guidance.vae),
                    **vae_attention_launches(
                        guidance.vae, (guidance.cfg.image_size // 8) ** 2,
                        passes, 2))


def flash_sites(unet, latent: int) -> int:
    """Self-attention sites of one UNet forward at `latent`^2 that pass
    K4's gate (flash_attention on, a multiple of 128 tokens), walked from
    the module tree: down block i runs at latent / 2^i, up block i at
    latent / 2^(n - 1 - i) (the branch blocks at their levels too)."""
    n = len(unet.cfg.block_out_channels)

    def sites(blocks, sizes):
        count = 0
        for blk, size in zip(blocks, sizes):
            for m in blk.modules():
                if (getattr(m, "use_flash", False)
                        and (size * size) % 128 == 0):
                    count += 1
        return count

    down = [latent >> i for i in range(n)]
    up = [latent >> (n - 1 - i) for i in range(n)]
    total = sites(unet.down_blocks, down) + sites(unet.up_blocks, up)
    total += sites([unet.mid_block], [latent >> (n - 1)])
    for blocks in getattr(unet, "down_blocks_branch", []):
        total += sites(blocks, down)
    for blocks in getattr(unet, "up_blocks_branch", []):
        total += sites(blocks, up[n - len(blocks):])
    return total


def finite_step(state, metrics, pgrads, mgrad, before, alive, label):
    """Checks of one train_step: finite metrics and gradients, some
    gradient reached the Gaussians, Adam moved alive rows only."""
    row = {k: float(v) for k, v in metrics.items()}
    check(all(math.isfinite(v) for v in row.values()),
          f"{label}: non-finite metric {row}")
    reached = False
    for name, g in [*pgrads.items(), ("means2d", mgrad)]:
        check(bool(torch.isfinite(g).all()),
              f"{label}: d loss / d {name} not finite")
        reached = reached or (g.numel() and float(g.abs().max()) > 0)
    check(reached, f"{label}: no gradient reached the Gaussians")
    moved = 0
    for name, v in state.scene.params().items():
        if not v.numel():
            continue
        delta = (v - before[name]).abs().flatten(1).amax(dim=1)
        check(float(delta[~alive].max()) == 0.0,
              f"{label}: Adam moved dead slots of {name}")
        moved = max(moved, int((delta[alive] > 0).sum()))
    check(moved > 0, f"{label}: Adam moved no alive row")
    return row, moved


def checked_step(system, state, label):
    """One train_step with its launches counted and checked by
    `finite_step`; returns (state, metrics row, launches, peak GiB, the
    step's inputs and `loss_and_grads` output)."""
    from humangaussian_torch import kernels

    captured = {}
    own = system.loss_and_grads

    def capture(st, inputs):
        captured["inputs"] = inputs
        captured["out"] = own(st, inputs)
        return captured["out"]

    system.loss_and_grads = capture
    before = {k: v.clone() for k, v in state.scene.params().items()}
    alive = state.scene.alive.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    try:
        state, metrics = system.train_step(state)
        torch.cuda.synchronize()
    finally:
        del system.loss_and_grads
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    _loss, _aux, pgrads, mgrad = captured["out"]
    row, moved = finite_step(state, metrics, pgrads, mgrad, before, alive,
                             label)
    print(f"  {label}: " + ", ".join(f"{k} {v:.6g}" for k, v in row.items())
          + f"; Adam moved {moved} of {int(alive.sum())} alive rows (dead "
          f"slots unchanged); peak memory {peak:.2f} GiB")
    return state, row, counts, peak, captured


def step_times(system, state, reps):
    """(state, [ms]) of `reps` train_steps timed by CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = system.train_step(state)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return state, times


def train_step_phase(dev, system, assets):
    """Phase 11: `GaussianDreamerSystem.train_step` of configs/avatar.yaml
    at full width. Returns the launch counts of one step, K1's and K2's
    numbers on the guidance batch (shape c) and the densify statistic's
    quantiles."""
    from humangaussian_torch.core.camera import camera_from_c2w
    from humangaussian_torch.data.cameras import eval_camera_batch
    from humangaussian_torch.guidance.dual_branch import resize_bilinear
    from humangaussian_torch.io.ply import load_ply

    cc = system.camera_cfg
    print(f"phase 11: GaussianDreamerSystem.train_step (batch "
          f"{cc.batch_size}, {cc.height}^2 renders, capacity "
          f"{system.cfg.capacity}, {system.cfg.pts_num} initial points, "
          f"pose images {system.cfg.pose_image_size}^2)")
    rcfg = system.raster_cfg
    print(f"  rasterizer: tile {rcfg.tile}, max_tiles_per_gaussian "
          f"{rcfg.max_tiles_per_gaussian}")
    # shape (c): K1 and K2 vs plain on the avatar PLY's 8 orbit views
    avatar = load_ply(assets[1], device=dev)
    orbit = eval_camera_batch(cc, "test", device=dev)
    pick = torch.arange(cc.batch_size, device=dev) * (
        orbit.c2w.shape[0] // cc.batch_size)
    cams = camera_from_c2w(orbit.c2w[pick], orbit.fovy[pick], SIZE, SIZE)
    batch_row = guidance_batch_kernels(avatar, cams, rcfg,
                                       torch.ones(3, device=dev))
    del avatar

    t0 = time.perf_counter()
    state = system.init_state(seed=0)
    torch.cuda.synchronize()
    print(f"  init_state: {int(state.scene.alive.sum())} alive of "
          f"{state.scene.capacity} slots in {time.perf_counter() - t0:.1f} s")

    # -- one step, checked -------------------------------------------------
    state, _row, counts, _peak, seen = checked_step(system, state, "step 1")
    inputs = seen["inputs"]
    print(f"  inputs: t {inputs.t.tolist()}, azimuth "
          f"{[round(a, 1) for a in inputs.cameras.azimuth.tolist()]}, "
          f"head {bool(inputs.cameras.is_head)}, back "
          f"{bool(inputs.cameras.is_back)}, pose images "
          f"{tuple(inputs.pose.shape)} covering "
          f"{float((inputs.pose.amax(-1) > 0).float().mean()):.4f}")
    check(inputs.pose.shape == (cc.batch_size, system.cfg.pose_image_size,
                                system.cfg.pose_image_size, 3),
          "pose image shape")
    check(float(inputs.pose.amax()) > 0, "empty pose images")
    _loss, _aux, pgrads, mgrad = seen["out"]
    for name, g in [*pgrads.items(), ("means2d", mgrad)]:
        print(f"  d loss / d {name}: max "
              f"{float(g.abs().max()) if g.numel() else 0.0:.3e}")
    del seen, inputs, pgrads, mgrad
    guidance = system.guidance
    want = dual_branch_step_launches(guidance)
    print(f"  launches {counts}; expected: {norms_in(guidance.unet)} UNet "
          f"norms + encoder passes x {norms_in(guidance.vae.encoder)} norms "
          f"forward, 2 x {norms_in(guidance.vae.encoder)} backward")
    check(counts == want, f"launches {counts}, want {want}")

    # -- ms per train_step: 2 warm-up steps, then STEP_REPS timed ----------
    def step():
        nonlocal state
        state, _ = system.train_step(state)

    for _ in range(2):
        step()
    state, times = step_times(system, state, STEP_REPS)
    step_ms = statistics.median(times)
    print(f"  ms per train_step over {STEP_REPS} steps: median "
          f"{step_ms:.3f}, min {min(times):.3f}, max {max(times):.3f}")

    # -- staged by CUDA events: the system's and the guidance's own
    # methods, wrapped on the instances ------------------------------------
    marks = []

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    def wrap(obj, name, before_too=False):
        fn = getattr(obj, name)

        def wrapped(*a, **k):
            if before_too:
                mark()
            out = fn(*a, **k)
            mark()
            return out

        setattr(obj, name, wrapped)

    stage_names = ("inputs", "render", "three encodes", "compute_grad",
                   "loss + backward", "Adam + statistics")
    wrap(system, "sample_step_inputs")
    wrap(system, "render_batch")
    wrap(guidance, "compute_grad", before_too=True)
    wrap(system, "loss_and_grads")
    staged = []
    for _ in range(3):
        marks.clear()
        mark()
        step()
        mark()
        marks[-1].synchronize()
        check(len(marks) == 7, f"{len(marks)} stage marks")
        staged.append([marks[i].elapsed_time(marks[i + 1])
                       for i in range(6)])
    for obj, name in ((system, "sample_step_inputs"),
                      (system, "render_batch"), (guidance, "compute_grad"),
                      (system, "loss_and_grads")):
        delattr(obj, name)
    stages = [statistics.median(x) for x in zip(*staged)]
    print("  staged (medians of 3, CUDA events): " + ", ".join(
        f"{n} {v:.3f} ms" for n, v in zip(stage_names, stages))
        + f"; sum {sum(stages):.3f}")

    by_name = profile_device_time("1 train_step", step, top=16,
                                  by_shape=16) or {}
    for label, key in (("K1", "rasterize_fwd"), ("K2", "rasterize_bwd_kernel"),
                       ("K2b", "rasterize_bwd_rows_kernel"),
                       ("the GroupNorm forward (K3 + K3a)", "groupnorm_fwd")):
        ms = sum(us for n, us in by_name.items() if key in n) / 1e3
        print(f"  {label} device time in the profiled step: {ms:.4f} ms")

    # the densify statistic after these steps, for the trainer phase's
    # threshold
    ds = state.densify
    vis = ds.denom > 0
    stat = (ds.grad_accum[vis] / ds.denom[vis]).float()
    qs = torch.quantile(stat[:1 << 24].cpu(),
                        torch.tensor([0.5, 0.9, 0.99])).tolist()
    scales = state.scene.scales.amax(-1)[state.scene.alive]
    print(f"  densify statistic over {int(vis.sum())} visible Gaussians "
          f"after {state.step} steps: median {qs[0]:.3e}, 90% {qs[1]:.3e}, "
          f"99% {qs[2]:.3e} (max_grad {system.cfg.max_grad}); max scale "
          f"median {float(scales.median()):.3e}")

    # the pose images' rounding: `_fma` (float64 products, the reference's
    # contracted rounding) against plain float32 products, on 8 orbit views
    from humangaussian_torch.smplx import pose_image

    views = orbit._replace(c2w=orbit.c2w[pick], mvp_mtx=orbit.mvp_mtx[pick],
                           azimuth=orbit.azimuth[pick])
    pose = system.pose_images(views)
    fma_ms = cuda_ms(lambda: system.pose_images(views), reps=10, inner=3)
    own_fma = pose_image._fma
    pose_image._fma = lambda a, b, c: a * b + c
    try:
        plain_pose = system.pose_images(views)
        f32_ms = cuda_ms(lambda: system.pose_images(views), reps=10, inner=3)
    finally:
        pose_image._fma = own_fma
    differ = int((plain_pose != pose).any(-1).sum())
    print(f"  pose images of {cc.batch_size} views at "
          f"{system.cfg.pose_image_size}^2: {fma_ms:.3f} ms with _fma, "
          f"{f32_ms:.3f} ms with float32 products ({differ} of "
          f"{plain_pose[..., 0].numel()} pixels differ)")
    del plain_pose

    # the VAE's layout: one encode forward, then forward + backward, with
    # channels_last weights (as built) against contiguous ones (the
    # activations stay channels_last)
    img = resize_bilinear(pose, guidance.cfg.image_size)
    gen = torch.Generator(device=dev).manual_seed(12)
    for fmt in (torch.channels_last, torch.contiguous_format,
                torch.channels_last):
        guidance.vae.to(memory_format=fmt)

        def encode_backward():
            x = img.clone().requires_grad_(True)
            guidance.encode_images(x, gen).sum().backward()

        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: guidance.encode_images(img, gen), reps=3)
        print(f"  VAE encode of {cc.batch_size} x 512^2, weights {fmt}: "
              f"forward {fwd_ms:.3f} ms, forward + backward "
              f"{cuda_ms(encode_backward, reps=3):.3f} ms (the "
              f"library-norm VAE, contiguous: "
              f"{LIBRARY_NORM_VAE_MS['encode forward']} and "
              f"{LIBRARY_NORM_VAE_MS['encode forward + backward']})")
    return counts, batch_row


RESIZE_SHAPES = ((8, 1024, 512), (8, 1024, 64))  # (batch, in, out), 3 ch
RESIZE_TOL = 1e-6  # card vs CPU: forward absolute, gradient of max-|grad|
RESIZE_LIBRARY_TOL = 1e-5  # the same, against F.interpolate(antialias=True)
RESIZE_REPS = 20


def resize_phase(dev):
    """Phase 11b: the antialiased resize of the step (`resize_bilinear`)
    on the card against its CPU result and against the library resize
    the port used before, forward and backward, timed beside it."""
    import torch.nn.functional as F

    from humangaussian_torch.ops.resize import band, resize_bilinear

    def library(x, hw):
        return F.interpolate(x.permute(0, 3, 1, 2), size=hw, mode="bilinear",
                             align_corners=False, antialias=True
                             ).permute(0, 2, 3, 1)

    print("phase 11b: the antialiased resize (ops/resize.py) against "
          "F.interpolate(antialias=True), float32, forward and backward")
    gen = torch.Generator().manual_seed(16)
    for b, n, m in RESIZE_SHAPES:
        x_cpu = torch.rand(b, n, n, 3, generator=gen).requires_grad_(True)
        g_cpu = torch.randn(b, m, m, 3, generator=gen)
        y_cpu = resize_bilinear(x_cpu, m)
        (dx_cpu,) = torch.autograd.grad(y_cpu, x_cpu, g_cpu)
        x = x_cpu.detach().to(dev).requires_grad_(True)
        g = g_cpu.to(dev)
        y, y_lib = resize_bilinear(x, m), library(x, (m, m))
        y_out, y_lib_out = y.detach(), y_lib.detach()
        with deterministic_step() as caught:  # strict
            dx, dx2 = (torch.autograd.grad(y, x, g, retain_graph=True)[0]
                       for _ in range(2))
        check(not nondeterministic_ops(caught),
              f"the resize warned: {nondeterministic_ops(caught)}")
        dx_lib, dx_lib2 = (
            torch.autograd.grad(y_lib, x, g, retain_graph=True)[0]
            for _ in range(2))
        fwd_ms, bwd_ms, lib_fwd, lib_bwd = (
            cuda_ms(fn, RESIZE_REPS) for fn in (
                lambda: resize_bilinear(x.detach(), m),
                lambda: torch.autograd.grad(y, x, g, retain_graph=True),
                lambda: library(x.detach(), (m, m)),
                lambda: torch.autograd.grad(y_lib, x, g, retain_graph=True)))
        scale = float(dx_cpu.abs().max())
        errs = (float((y_out.cpu() - y_cpu.detach()).abs().max()),
                float((dx.cpu() - dx_cpu).abs().max()) / scale,
                float((y_out - y_lib_out).abs().max()),
                float((dx - dx_lib).abs().max()) / scale)
        taps = band(n, m, dev, torch.float32)
        mb_in, mb_out = b * n * n * 3 * 4 / 1e6, b * m * m * 3 * 4 / 1e6
        bound = (mb_in + mb_out) / 3.35e3  # ms at 3.35 TB/s
        print(f"  {b} x {n}^2 x 3 -> {m}^2 ({taps.idx.shape[0]} taps an "
              f"output, {taps.idx_t.shape[0]} an input): port forward "
              f"{fwd_ms:.4f} ms, backward {bwd_ms:.4f}; library forward "
              f"{lib_fwd:.4f}, backward {lib_bwd:.4f}; bound {bound:.4f} "
              f"each way ({mb_in:.1f} MB in, {mb_out:.1f} MB out)")
        print(f"    card vs CPU: forward {errs[0]:.3e}, gradient "
              f"{errs[1]:.3e} of max-|grad|; vs the library: {errs[2]:.3e}, "
              f"{errs[3]:.3e}; second backward bit-equal: port "
              f"{torch.equal(dx, dx2)}, library "
              f"{torch.equal(dx_lib, dx_lib2)}")
        check(errs[0] <= RESIZE_TOL and errs[1] <= RESIZE_TOL,
              f"resize card vs CPU {errs[:2]}")
        check(errs[2] <= RESIZE_LIBRARY_TOL and errs[3] <= RESIZE_LIBRARY_TOL,
              f"resize vs F.interpolate {errs[2:]}")
        check(torch.equal(dx, dx2), "the resize's backward does not repeat")


def trainer_phase(dev, tmp, overrides):
    """Phase 14: the avatar CLI at full width, `apps.launch.main` on
    configs/avatar.yaml with --train for TRAINER_STEPS steps, then
    --resume for one more."""
    from humangaussian_torch import kernels
    from humangaussian_torch.apps import launch
    from humangaussian_torch.config import load_config
    from humangaussian_torch.data.cameras import RandomCameraConfig
    from humangaussian_torch.io.ply import load_ply
    from humangaussian_torch.train import loop

    print(f"phase 14: apps.launch --train (gaussiandreamer-system), "
          f"{TRAINER_STEPS} steps")
    args = ["--config", AVATAR_YAML, "--train", "--device", dev.type,
            f"exp_root_dir={tmp}/avatar_runs", *overrides,
            *TRAINER_OVERRIDES]
    seconds = {}

    def timed(name, fn):
        def wrapped(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t
            return out
        return wrapped

    own = (loop.run_training, loop.finalize)
    loop.run_training = timed("run_training", own[0])
    loop.finalize = timed("finalize", own[1])
    kernels.reset_launch_counts()
    log = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            trial = launch.main(args)
        torch.cuda.synchronize()
    finally:
        loop.run_training, loop.finalize = own
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    text = log.getvalue()
    print("  " + "\n  ".join(text.strip().splitlines()[-8:]))
    save = os.path.join(trial, "save")
    with open(os.path.join(save, "metrics.csv")) as f:
        rows = {int(r["step"]): r for r in csv.DictReader(f)}
    check(sorted(rows) == list(range(1, TRAINER_STEPS + 1)),
          f"logged steps {sorted(rows)}")
    alive = {s: int(float(r["n_alive"])) for s, r in rows.items()}
    per_step = [float(r["steps_per_s"]) for s, r in sorted(rows.items())
                if s > 2]
    print(f"  alive by step {alive}")
    for s in TRAINER_DENSIFY_STEPS:
        r = rows[s]
        cloned, split = int(float(r["n_cloned"])), int(float(r["n_split"]))
        pruned = int(float(r["n_pruned"]))
        print(f"  step {s}: cloned {cloned}, split {split}, pruned "
              f"{pruned}, dropped {int(float(r['n_dropped']))}")
        check(alive[s + 1] != alive[s],
              f"the density-control pass at step {s} changed nothing")
        if s != TRAINER_DENSIFY_STEPS[-1]:
            check(cloned > 0 and split > 0,
                  f"step {s}: clone and split did not both act")
        else:
            check(pruned > 0 and cloned == split == 0,
                  f"step {s}: prune-only did not prune")
    files = set(os.listdir(save))
    for name in ("last.ply", "metrics.csv", *(
            f"it{s}-val.png" for s in range(TRAINER_VAL, TRAINER_STEPS + 1,
                                            TRAINER_VAL))):
        check(name in files, f"{name} missing")
    video = [f for f in files if f.startswith("orbit.")]
    check(len(video) == 1, f"orbit video {video}")
    check(os.path.exists(os.path.join(save, "ckpts", "last", "state.pt")),
          "ckpts/last missing")
    # one K1 launch a step and one per chunk of batch_size views of each
    # validation render and of the test orbit
    cc = launch._take(RandomCameraConfig,
                      load_config(AVATAR_YAML, overrides)["data"])
    val_launches = (TRAINER_STEPS // TRAINER_VAL) * -(-cc.n_val_views
                                                      // cc.batch_size)
    orbit_launches = -(-cc.n_test_views // cc.batch_size)
    want_fwd = TRAINER_STEPS + val_launches + orbit_launches
    print(f"  launches {launches} (K1: {TRAINER_STEPS} steps + "
          f"{val_launches} for the validation renders + {orbit_launches} "
          f"orbit batches of {cc.batch_size})")
    check(launches["rasterize_fwd"] == want_fwd
          and launches["rasterize_bwd"] == TRAINER_STEPS
          and launches["rasterize_bwd_rows"] == TRAINER_STEPS,
          f"trainer launches {launches}")
    final = load_ply(os.path.join(save, "last.ply"), device=dev)
    last_alive = alive[TRAINER_STEPS]
    check(final.num_alive == last_alive,
          f"last.ply holds {final.num_alive} Gaussians, the run "
          f"{last_alive}")
    check(all(bool(torch.isfinite(v[final.alive]).all())
              for v in final.params().values()), "last.ply: non-finite")
    print(f"  {video[0]}, last.ply {final.num_alive} Gaussians; phase wall "
          f"{wall:.1f} s (run_training {seconds['run_training']:.1f} s, "
          f"finalize {seconds['finalize']:.1f} s); inside the loop "
          f"{statistics.median(per_step):.3f} steps/s (median over logged "
          f"steps 3-{TRAINER_STEPS}: "
          f"{1e3 / statistics.median(per_step):.1f} ms a step), "
          f"{seconds['run_training'] / TRAINER_STEPS:.3f} s a step over the "
          f"whole loop (validation renders and density control included)")
    del final

    # --resume: exactly one more step
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        trial2 = launch.main(["--resume",
                              os.path.join(save, "ckpts", "last"), *args,
                              f"trainer.max_steps={TRAINER_STEPS + 1}"])
    torch.cuda.synchronize()
    check(f"at step {TRAINER_STEPS}" in log.getvalue(), "resume message")
    with open(os.path.join(trial2, "save", "metrics.csv")) as f:
        steps2 = [int(r["step"]) for r in csv.DictReader(f)]
    check(steps2 == [TRAINER_STEPS + 1], f"resumed run logged {steps2}")
    print(f"  --resume took exactly step {steps2[0]} "
          f"({time.perf_counter() - t0:.1f} s with build and finalize)")


def sample_phase(dev, system):
    """Phase 12: `sample_joint`, batch 2, 4 DDIM steps, 512^2 outputs,
    conditioned on the skeleton drawn from two validation views."""
    from humangaussian_torch import kernels
    from humangaussian_torch.data.cameras import eval_camera_batch

    print("phase 12: sample_joint (batch 2, 4 DDIM steps)")
    guidance, embeddings = system.guidance, system.prompt_embeddings
    val = eval_camera_batch(system.camera_cfg, "val", device=dev)
    pose = system.pose_images(val._replace(
        mvp_mtx=val.mvp_mtx[:2], azimuth=val.azimuth[:2]))
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
          f"; launches {counts}")
    # 4 UNet forwards, one pose encode, two decodes, no backward
    forward = (4 * norms_in(guidance.unet) + norms_in(guidance.vae.encoder)
               + 2 * norms_in(guidance.vae.decoder))
    want = launches(groupnorm_fwd=forward,
                    attention_fwd=4 * ATTN_PER_UNET_FORWARD,
                    conv_bias_add=encode_convs(guidance.vae)
                    + 2 * decode_convs(guidance.vae),
                    **vae_attention_launches(
                        guidance.vae, guidance.cfg.latent_size ** 2, 3))
    check(counts == want, f"sample_joint launches {counts}, want {want}")


def unet_backward_phase(dev, unet) -> dict:
    """Phase 13: the full-width UNet differentiated with respect to its
    input latents (batch 2, 64^2, bfloat16): K3 + K3a, K5 and K5a launch
    once per norm. Then a float32 UNet at 16^2 latents, matrix-product
    attention, and a float32 full-width VAE at 64^2 images: the input
    gradient through K3 + K3a, K5 and K5a against the gradient through
    their plain versions. Returns the launch counts of the first."""
    import dataclasses

    from humangaussian_torch import kernels
    from humangaussian_torch.guidance.unet import (
        SD2_BASE_CONFIG,
        DualBranchUNet,
    )
    from humangaussian_torch.guidance.vae import (
        AutoencoderKL,
        VAEConfig,
        sample_latent,
    )

    print("phase 13: the UNet and the VAE differentiated (K5, K5a)")
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
    norms = norms_in(unet)
    want = launches(groupnorm_fwd=norms, groupnorm_bwd_stats=norms,
                    groupnorm_bwd_dx=norms,
                    attention_fwd=ATTN_PER_UNET_FORWARD)
    check(counts == want, f"launches {counts}, want {want}")
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
    k5a = kernels.launch_counts()["groupnorm_bwd_dx"]
    with plain_versions():
        want = input_grads(f32, *args)
    worst = 0.0
    for a, b_ in zip(got, want):
        worst = max(worst, float((a - b_).abs().max() / b_.abs().max()))
    print(f"  float32, batch 2, 16^2: input gradient through K3 + K3a, K5, "
          f"K5a vs through the plain versions {worst:.3e} of max |grad| "
          f"(limit {UNET_GRAD_TOL:g}); K5 launches {k5}, K5a {k5a}")
    check(worst <= UNET_GRAD_TOL, f"UNet input gradient off by {worst}")
    check(k5 == k5a == norms_in(f32), f"K5 / K5a launched {k5} / {k5a} times")
    del f32, got, want, args

    # the VAE's counterpart: d(latents)/d(image) of a float32 full-width
    # VAE (channels_last, as build_guidance lays it out) at 64^2
    torch.manual_seed(2)
    with torch.device(dev):
        vae = AutoencoderKL(dataclasses.replace(VAEConfig(),
                                                dtype=torch.float32))
    vae.to(memory_format=torch.channels_last).requires_grad_(False)
    img = (torch.rand((2, 64, 64, 3), generator=g) * 2 - 1).to(dev)
    eps = torch.randn((2, 8, 8, 4), generator=g).to(dev)
    cot = torch.randn((2, 8, 8, 4), generator=g).to(dev)

    def image_grad():
        x = img.clone().requires_grad_(True)
        mean, logvar = vae.encode(x)
        (sample_latent(mean, logvar, eps=eps) * cot).sum().backward()
        return x.grad

    kernels.reset_launch_counts()
    got = image_grad()
    torch.cuda.synchronize()
    vae_counts = kernels.launch_counts()
    with plain_versions():
        want = image_grad()
    worst = float((got - want).abs().max() / want.abs().max())
    enc = norms_in(vae.encoder)
    print(f"  float32 VAE, batch 2, 64^2: d latents / d image through K3 + "
          f"K3a, K5, K5a vs through the plain versions {worst:.3e} of max "
          f"|grad| {float(want.abs().max()):.3e} (limit {VAE_GRAD_TOL:g}); "
          f"launches {vae_counts}")
    check(bool(torch.isfinite(got).all()), "non-finite VAE input gradient")
    check(worst <= VAE_GRAD_TOL, f"VAE input gradient off by {worst}")
    check(all(vae_counts[k] == enc for k in (
        "groupnorm_fwd", "groupnorm_bwd_stats", "groupnorm_bwd_dx")),
        f"VAE launches {vae_counts}, want {enc} each")
    check(vae_counts["conv_bias_add"] == encode_convs(vae),
          f"VAE conv bias launches {vae_counts['conv_bias_add']}, want "
          f"{encode_convs(vae)}")
    return counts


def write_sdxl_files(dev, tmp) -> list:
    """Seeded SDXL base 1.0 `unet/` and sdxl-vae `vae/` files in diffusers
    layout (5.1 GB and 0.17 GB of bfloat16) and a prompt cache of
    `dummy_encode_fn(77, 2048, pooled_dim=1280)` stand-ins (the card has no
    text encoder); returns the configs/avatar_sdxl.yaml overrides that
    point the launcher at them."""
    from humangaussian_torch.guidance.prompt import (
        PromptProcessor,
        PromptProcessorConfig,
        dummy_encode_fn,
    )
    from humangaussian_torch.guidance.unet import SDXL_BASE_CONFIG, SingleUNet
    from humangaussian_torch.guidance.vae import SDXL_VAE_CONFIG, AutoencoderKL

    model = os.path.join(tmp, "sdxl")
    for sub, fn in (("unet", lambda: SingleUNet(SDXL_BASE_CONFIG)),
                    ("vae", lambda: AutoencoderKL(SDXL_VAE_CONFIG))):
        os.makedirs(os.path.join(model, sub))
        torch.save(seeded_state_dict(fn, 22, dev),
                   os.path.join(model, sub, "diffusion_pytorch_model.bin"))
        torch.cuda.empty_cache()
    cache = os.path.join(tmp, "text_embeddings")
    PromptProcessor(
        PromptProcessorConfig(prompt=SDXL_PROMPT, negative_prompt="blurry",
                              model_path="sdxl-stand-in", cache_dir=cache,
                              encoder_type="sdxl"),
        dummy_encode_fn(77, 2048, pooled_dim=1280), device=dev)()
    return [f"system.guidance.model_key={model}", "system.guidance.vae_key=",
            f"system.prompt_processor.prompt={SDXL_PROMPT}",
            "system.prompt_processor.negative_prompt=blurry",
            "system.prompt_processor.pretrained_model_name_or_path="
            "sdxl-stand-in",
            f"system.prompt_processor.cache_dir={cache}"]


@contextlib.contextmanager
def chunk_calls():
    """Inside, the row counts of every `guidance/vae.py::chunked_attention`
    call (the VAE mid block's attention past its logits cap) are appended
    to the list yielded."""
    from humangaussian_torch.guidance import vae

    calls, own = [], vae.chunked_attention

    def spy(q, k, v, rows):
        calls.append(rows)
        return own(q, k, v, rows)

    vae.chunked_attention = spy
    try:
        yield calls
    finally:
        vae.chunked_attention = own


def sdxl_phase(dev, tmp, smplx_path) -> dict:
    """Phase 13b: an SDXL `train_step` through the launcher at the
    published widths, its launches against the module trees; then a
    float32 sdxl-vae encode at 1024^2, d latents / d image through the
    kernels against the plain versions. Returns the step's launches."""
    from humangaussian_torch import kernels
    from humangaussian_torch.apps import launch
    from humangaussian_torch.config import load_config
    from humangaussian_torch.guidance.vae import (
        SDXL_VAE_CONFIG,
        AutoencoderKL,
        sample_latent,
    )

    print("phase 13b: an SDXL base 1.0 train_step (configs/avatar_sdxl.yaml"
          ", published widths) and the sdxl-vae at 1024^2 vs plain")
    t0 = time.perf_counter()
    overrides = write_sdxl_files(dev, tmp) + [
        f"system.smplx_path={smplx_path}"]
    print(f"  files and prompt cache written in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    system = launch.build_system(load_config(SDXL_YAML, overrides), dev)
    torch.cuda.synchronize()
    xl = system.guidance.xl
    n_unet = sum(p.numel() for p in xl.unet.parameters())
    print(f"  build_system: UNet {n_unet} parameters ({xl.unet.dtype}), VAE "
          f"{sum(p.numel() for p in xl.vae.parameters())}, built in "
          f"{time.perf_counter() - t0:.1f} s")
    check(n_unet == SDXL_UNET_PARAMS, f"SDXL UNet has {n_unet} parameters")
    check(system.prompt_embeddings.pooled.text_vd.shape == (4, 1280),
          "pooled rows' shape")
    state = system.init_state(seed=0)
    with chunk_calls() as rows:
        state, _row, counts, peak, _seen = checked_step(system, state,
                                                        "SDXL step 1")
    del _seen
    enc_norms = norms_in(xl.vae.encoder)
    passes = 2 if xl.cfg.remat_encode else 1
    sites = flash_sites(xl.unet, xl.cfg.image_size // 8)
    tokens = (xl.cfg.image_size // 8) ** 2
    fused = vae_attention_launches(xl.vae, tokens, passes, 1,
                                   system.camera_cfg.batch_size)
    want = launches(rasterize_fwd=1, rasterize_bwd=1, rasterize_bwd_rows=1,
                    groupnorm_fwd=norms_in(xl.unet) + passes * enc_norms,
                    groupnorm_bwd_stats=enc_norms,
                    groupnorm_bwd_dx=enc_norms, attention_fwd=sites,
                    conv_bias_add=passes * encode_convs(xl.vae), **fused)
    print(f"  launches {counts}; expected: {norms_in(xl.unet)} UNet norms + "
          f"{passes} encoder passes x {enc_norms} norms forward, {enc_norms} "
          f"backward, K4 at {sites} sites, the fused VAE attention {fused} "
          f"at {tokens} tokens; chunked_attention calls {rows}")
    check(sites == SDXL_ATTN_PER_UNET_FORWARD, f"{sites} K4 sites")
    check(fused.get("vae_attention_fwd") == passes,
          f"the sdxl-vae does not take the fused attention: {fused}")
    check(counts == want, f"SDXL launches {counts}, want {want}")
    check(rows == [], f"chunked_attention ran on the bf16 path: {rows}")
    state, _ = system.train_step(state)
    state, times = step_times(system, state, SDXL_STEP_REPS)
    print(f"  ms per SDXL train_step over {SDXL_STEP_REPS} steps: median "
          f"{statistics.median(times):.3f}, min {min(times):.3f}, max "
          f"{max(times):.3f}; peak memory of the checked step {peak:.2f} "
          f"GiB")
    del system, state, xl
    torch.cuda.empty_cache()

    # the sdxl-vae in float32 at batch 2 and 1024^2: the GroupNorms at
    # [2, 1048576, 128] and the 16,384-token attention in query chunks
    torch.manual_seed(3)
    with torch.device(dev):
        vae = AutoencoderKL(dataclasses.replace(SDXL_VAE_CONFIG,
                                                dtype=torch.float32))
    vae.to(memory_format=torch.channels_last).requires_grad_(False)
    g = torch.Generator(device="cpu").manual_seed(17)
    img = (torch.rand((2, 1024, 1024, 3), generator=g) * 2 - 1).to(dev)
    eps = torch.randn((2, 128, 128, 4), generator=g).to(dev)
    cot = torch.randn((2, 128, 128, 4), generator=g).to(dev)

    def image_grad():
        x = img.clone().requires_grad_(True)
        mean, logvar = vae.encode(x)
        (sample_latent(mean, logvar, eps=eps) * cot).sum().backward()
        return x.grad

    kernels.reset_launch_counts()
    with chunk_calls() as rows:
        got = image_grad()
        torch.cuda.synchronize()
    vae_counts = kernels.launch_counts()
    with plain_versions():
        want = image_grad()
    worst = float((got - want).abs().max() / want.abs().max())
    enc = norms_in(vae.encoder)
    print(f"  float32 sdxl-vae, batch 2, 1024^2: d latents / d image through "
          f"K3 + K3a, K5, K5a and the conv bias kernel vs through the plain "
          f"versions {worst:.3e} of max |grad| {float(want.abs().max()):.3e} "
          f"(limit {VAE_GRAD_TOL:g}); launches {vae_counts}; chunk rows "
          f"{rows}")
    check(bool(torch.isfinite(got).all()), "non-finite sdxl-vae gradient")
    check(worst <= VAE_GRAD_TOL, f"sdxl-vae input gradient off by {worst}")
    check(all(vae_counts[k] == enc for k in (
        "groupnorm_fwd", "groupnorm_bwd_stats", "groupnorm_bwd_dx")),
        f"sdxl-vae launches {vae_counts}, want {enc} each")
    check(vae_counts["conv_bias_add"] == encode_convs(vae),
          f"sdxl-vae conv bias launches {vae_counts['conv_bias_add']}")
    check(len(rows) == 1 and rows[0] < 16384, f"VAE attention chunks {rows}")
    del vae, got, want
    torch.cuda.empty_cache()
    return counts


def sjc_snapshot_phase(dev, system, tmp):
    """Phase 15: on phase 11's system, one train_step with the guidance in
    mode sjc, then one guidance_eval_snapshot of SNAPSHOT_STEPS DDIM steps
    and its strip."""
    from humangaussian_torch import kernels
    from humangaussian_torch.train.loop import save_guidance_strip

    g = system.guidance
    print("phase 15: a train_step with mode sjc; guidance_eval_snapshot "
          f"({SNAPSHOT_STEPS} DDIM steps)")
    own = g.cfg
    g.cfg = dataclasses.replace(own, mode="sjc")
    try:
        state = system.init_state(seed=1)
        start = time.perf_counter()
        state, _row, counts, _peak, _ = checked_step(system, state,
                                                     "sjc step")
        ms = (time.perf_counter() - start) * 1e3
    finally:
        g.cfg = own
    want = dual_branch_step_launches(g)
    print(f"  sjc step {ms:.1f} ms (host clock, first call); launches "
          f"{counts}")
    check(counts == want, f"sjc launches {counts}, want {want}")

    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    strips = system.guidance_eval_snapshot(state, num_steps=SNAPSHOT_STEPS)
    end.record()
    end.synchronize()
    counts = kernels.launch_counts()
    b, s = system.camera_cfg.batch_size, g.cfg.image_size
    for k in ("imgs_1step", "imgs_final", "depths_1step", "depths_final"):
        x = strips[k]
        check(x.shape == (b, s, s, 3) and bool(torch.isfinite(x).all())
              and 0.0 <= float(x.min()) and float(x.max()) <= 1.0,
              f"snapshot {k}: {tuple(x.shape)}")
    path = save_guidance_strip(os.path.join(tmp, "guidance.png"), strips)
    check(os.path.getsize(path) > 0, "guidance strip not written")
    # the 1-step estimate and every rollout step at or below t_start are
    # one UNet forward each; three encodes; four decodes
    forwards = 1 + SNAPSHOT_STEPS
    norm_count = (forwards * norms_in(g.unet)
                  + 3 * norms_in(g.vae.encoder)
                  + 4 * norms_in(g.vae.decoder))
    want = launches(rasterize_fwd=1, groupnorm_fwd=norm_count,
                    attention_fwd=forwards * ATTN_PER_UNET_FORWARD,
                    conv_bias_add=3 * encode_convs(g.vae)
                    + 4 * decode_convs(g.vae),
                    **vae_attention_launches(g.vae, g.cfg.latent_size ** 2,
                                             7))
    print(f"  guidance_eval_snapshot: {start.elapsed_time(end):.3f} ms; "
          f"launches {counts}")
    check(counts == want, f"snapshot launches {counts}, want {want}")


def write_if_files(dev, tmp) -> tuple:
    """Seeded IF-I-XL `unet/` weights in diffusers layout (bfloat16,
    `torch.save`) and a prompt cache of `dummy_encode_fn(77, 4096)` T5
    stand-ins; returns (the overrides that point the launcher at them,
    seconds to make and write the file)."""
    from humangaussian_torch.config import load_config
    from humangaussian_torch.guidance.deep_floyd import IF_I_XL_CONFIG
    from humangaussian_torch.guidance.prompt import (
        PromptProcessor,
        PromptProcessorConfig,
        dummy_encode_fn,
    )
    from humangaussian_torch.guidance.unet import SingleUNet

    t0 = time.perf_counter()
    model_key = os.path.join(tmp, "if_model")
    os.makedirs(os.path.join(model_key, "unet"))
    path = os.path.join(model_key, "unet", "diffusion_pytorch_model.bin")
    torch.save(seeded_state_dict(lambda: SingleUNet(IF_I_XL_CONFIG), 2, dev),
               path)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    cache = os.path.join(tmp, "if_text_embeddings")
    overrides = [*IF_OVERRIDES, f"system.guidance.model_key={model_key}",
                 f"system.prompt_processor.prompt={PROMPT}",
                 f"system.prompt_processor.cache_dir={cache}"]
    pp = load_config(AVATAR_YAML, overrides)["system"]["prompt_processor"]
    PromptProcessor(
        PromptProcessorConfig(
            prompt=pp["prompt"], negative_prompt=pp["negative_prompt"],
            model_path=pp["pretrained_model_name_or_path"], cache_dir=cache,
            encoder_type="t5"),
        dummy_encode_fn(77, 4096), device=dev)()
    print(f"  IF unet/ weights: {os.path.getsize(path) / 1e9:.2f} GB "
          f"written in {seconds:.1f} s")
    return overrides, seconds


def if_norm_shapes(dev):
    """The GroupNorm forward (fused, and its sums-only and normalize-only
    modes K3 and K3a) against its plain versions at IF_GN_SHAPES (bfloat16,
    32 groups): sums within GN_STATS_TOL of the f64 sums, y within one
    bfloat16 ulp of plain on all but GN_BAD_FRACTION of the outputs."""
    from humangaussian_torch.ops.groupnorm import (
        group_norm_apply,
        group_norm_apply_plain,
        group_norm_fwd,
        group_norm_stats,
        group_norm_stats_plain,
    )

    g = torch.Generator(device="cpu").manual_seed(16)
    for n, rows, c in IF_GN_SHAPES:
        x = (torch.randn((n, rows, c), generator=g) * 1.5 + 0.7).to(
            dev, torch.bfloat16)
        gamma = (1 + 0.2 * torch.randn(c, generator=g)).to(dev)
        beta = (0.2 * torch.randn(c, generator=g)).to(dev)
        got = group_norm_stats(x)
        torch.cuda.synchronize()
        plain = group_norm_stats_plain(x)
        want, scale = x_sums_f64(x)
        e_k, e_p = sums_error(got, want, scale), sums_error(plain, want,
                                                             scale)
        del want, scale
        check(e_k <= GN_STATS_TOL and e_p <= GN_STATS_TOL,
              f"K3 [{n}, {rows}, {c}]: {e_k}, plain {e_p}")
        y = group_norm_apply(x, got, gamma, beta, 32, 1e-5, True)
        torch.cuda.synchronize()
        y_p = group_norm_apply_plain(x, got, gamma, beta, 32, 1e-5, True)
        err = (y.float() - y_p.float()).abs()
        share = float((err > bf16_ulp(y_p)).float().mean())
        print(f"  K3 [{n}, {rows}, {c}] ({c // 32} channels a group): "
              f"kernel vs f64 {e_k:.3e}, plain {e_p:.3e}; K3a share over "
              f"one ulp {share:.2e}, max difference {float(err.max()):.3e}")
        check(share <= GN_BAD_FRACTION and bool(torch.isfinite(y).all()),
              f"K3a [{n}, {rows}, {c}]: {share}")
        y_f, sums_f = group_norm_fwd(x, gamma, beta, 32, 1e-5, True)
        torch.cuda.synchronize()
        x64 = x.double()
        e_f = sums_error(sums_f, torch.stack([x64.sum(1), (x64 * x64).sum(1)],
                                             1),
                         torch.stack([x64.abs().sum(1), (x64 * x64).sum(1)],
                                     1))
        del x64
        y_fp = group_norm_apply_plain(x, sums_f, gamma, beta, 32, 1e-5, True)
        err = (y_f.float() - y_fp.float()).abs()
        share_f = float((err > bf16_ulp(y_fp)).float().mean())
        print(f"  K3 + K3a [{n}, {rows}, {c}]: sums vs f64 {e_f:.3e}, y share "
              f"over one ulp {share_f:.2e}")
        check(e_f <= GN_STATS_TOL and share_f <= GN_BAD_FRACTION
              and bool(torch.isfinite(y_f).all()),
              f"K3 + K3a [{n}, {rows}, {c}]: {e_f}, {share_f}")


def deep_floyd_phase(dev, tmp, base_overrides) -> dict:
    """Phase 16: the avatar trainer with DeepFloyd IF guidance at
    IF_I_XL_CONFIG width, built by `apps.launch.build_system` from
    configs/avatar.yaml with IF_OVERRIDES: train_steps with Perp-Neg off,
    then on. Returns the launches of one step with Perp-Neg off."""
    from humangaussian_torch.apps import launch
    from humangaussian_torch.config import load_config
    from humangaussian_torch.guidance.deep_floyd import (
        DeepFloydSystemGuidance,
    )

    print("phase 16: the avatar trainer with DeepFloyd IF guidance "
          "(IF-I-XL, batch 8, 1024^2 renders, 64^2 pixels)")
    if_norm_shapes(dev)
    overrides, write_s = write_if_files(dev, tmp)
    t0 = time.perf_counter()
    system = launch.build_system(
        load_config(AVATAR_YAML, [*base_overrides, *overrides]), dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    g = system.guidance
    check(isinstance(g, DeepFloydSystemGuidance), f"guidance {type(g)}")
    unet = g.df.unet
    n_unet = sum(p.numel() for p in unet.parameters())
    print(f"  build_system (the IF weight file read with mmap): {n_unet} "
          f"parameters ({unet.dtype}), {load_s:.1f} s; guidance scale "
          f"{g.df.cfg.guidance_scale}, {g.df.cfg.image_size}^2 pixels, "
          f"text {tuple(system.prompt_embeddings.text_vd.shape)}")
    check(n_unet == IF_UNET_PARAMS, f"IF UNet has {n_unet} parameters")
    check(system.prompt_embeddings.text_vd.shape == (4, 77, 4096),
          "T5 stand-in shape")

    # from the module tree: one UNet forward a step (the CFG pair, or
    # Perp-Neg's four segments, in one batch); no flash attention; nothing
    # differentiated through a norm
    norm_count = norms_in(unet)
    want = launches(rasterize_fwd=1, rasterize_bwd=1, rasterize_bwd_rows=1,
                    groupnorm_fwd=norm_count)
    state = system.init_state(seed=0)
    state, _row, counts, peak, _ = checked_step(system, state, "IF step 1")
    print(f"  launches {counts}; expected {norm_count} UNet norms, K4 0")
    check(counts == want, f"IF launches {counts}, want {want}")
    state, _ = system.train_step(state)  # warm-up
    state, times = step_times(system, state, IF_STEP_REPS)
    print(f"  ms per IF train_step over {IF_STEP_REPS} steps: median "
          f"{statistics.median(times):.3f}, min {min(times):.3f}, max "
          f"{max(times):.3f}")

    # staged by CUDA events from the system's and the guidance's methods
    marks = []

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    def wrap(obj, name, before_too=False):
        fn = getattr(obj, name)

        def wrapped(*a, **k):
            if before_too:
                mark()
            out = fn(*a, **k)
            mark()
            return out

        setattr(obj, name, wrapped)

    targets = ((system, "sample_step_inputs", False),
               (system, "render_batch", False), (g.df, "grad", True),
               (system, "loss_and_grads", False))
    for obj, name, before in targets:
        wrap(obj, name, before)
    try:
        marks.clear()
        mark()
        state, _ = system.train_step(state)
        mark()
        marks[-1].synchronize()
    finally:
        for obj, name, _ in targets:
            delattr(obj, name)
    check(len(marks) == 7, f"{len(marks)} stage marks")
    stages = [marks[i].elapsed_time(marks[i + 1]) for i in range(6)]
    print("  staged (CUDA events): " + ", ".join(
        f"{n} {v:.3f} ms" for n, v in zip(
            ("inputs", "render", "resize + noise", "UNet + CFG",
             "loss + backward", "Adam + statistics"), stages))
        + f"; sum {sum(stages):.3f}")
    profile_device_time("1 IF train_step", lambda: system.train_step(state),
                        top=12)

    g.df.cfg = dataclasses.replace(g.df.cfg, use_perp_neg=True)
    state, _row, pn_counts, pn_peak, _ = checked_step(system, state,
                                                      "IF step, Perp-Neg")
    check(pn_counts == want, f"Perp-Neg launches {pn_counts}, want {want}")
    state, pn_times = step_times(system, state, IF_PERP_NEG_STEPS)
    print(f"  ms per IF train_step with Perp-Neg (4 x 8 in one UNet batch) "
          f"over {IF_PERP_NEG_STEPS} steps: median "
          f"{statistics.median(pn_times):.3f}, min {min(pn_times):.3f}, "
          f"max {max(pn_times):.3f}")
    print(f"  IF summary: weight write {write_s:.1f} s, load {load_s:.1f} s, "
          f"step {statistics.median(times):.3f} ms (peak {peak:.2f} GiB), "
          f"Perp-Neg step {statistics.median(pn_times):.3f} ms (peak "
          f"{pn_peak:.2f} GiB)")
    del system, g, unet, state
    torch.cuda.empty_cache()
    if_cli(dev, tmp, [*base_overrides, *overrides], norm_count)
    return counts


def if_cli(dev, tmp, overrides, norm_count):
    """Phase 16's path through the CLI: `apps.launch.main --train` with
    the IF overrides for IF_CLI_STEPS steps, a validation render at the
    last, and `finalize`."""
    from humangaussian_torch import kernels
    from humangaussian_torch.apps import launch
    from humangaussian_torch.config import load_config
    from humangaussian_torch.data.cameras import RandomCameraConfig

    args = ["--config", AVATAR_YAML, "--train", "--device", dev.type,
            f"exp_root_dir={tmp}/if_runs", *overrides,
            f"trainer.max_steps={IF_CLI_STEPS}",
            f"trainer.val_check_interval={IF_CLI_STEPS}",
            "trainer.log_every=1"]
    kernels.reset_launch_counts()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        trial = launch.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    save = os.path.join(trial, "save")
    with open(os.path.join(save, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    check([int(r["step"]) for r in rows] == list(range(1, IF_CLI_STEPS + 1)),
          f"IF CLI logged {[r['step'] for r in rows]}")
    check(all(math.isfinite(float(r["loss"])) for r in rows),
          "IF CLI: non-finite loss")
    files = set(os.listdir(save))
    check({"last.ply", f"it{IF_CLI_STEPS}-val.png"} <= files
          and any(f.startswith("orbit.") for f in files),
          f"IF CLI artifacts {sorted(files)}")
    cc = launch._take(RandomCameraConfig,
                      load_config(AVATAR_YAML, overrides)["data"])
    renders = (-(-cc.n_val_views // cc.batch_size)
               + -(-cc.n_test_views // cc.batch_size))
    want = launches(rasterize_fwd=IF_CLI_STEPS + renders,
                    rasterize_bwd=IF_CLI_STEPS,
                    rasterize_bwd_rows=IF_CLI_STEPS,
                    groupnorm_fwd=IF_CLI_STEPS * norm_count)
    print(f"  apps.launch --train (deep-floyd), {IF_CLI_STEPS} steps: "
          f"{wall:.1f} s with build, validation and finalize; losses "
          f"{[round(float(r['loss']), 2) for r in rows]}; launches {counts}")
    check(counts == want, f"IF CLI launches {counts}, want {want}")


def sample_cli_phase(dev, tmp, overrides) -> dict:
    """Phase 17: `apps.sample.main` on configs/avatar.yaml with phase 14's
    prior files at SAMPLE_CLI_STEPS DDIM steps. Returns its launches."""
    from humangaussian_torch import kernels
    from humangaussian_torch.apps import sample
    from humangaussian_torch.guidance.dual_branch import DualBranchGuidance

    print(f"phase 17: apps.sample ({SAMPLE_CLI_STEPS} DDIM steps)")
    seen = {}
    own = DualBranchGuidance.sample_joint

    def timed(self, *a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = own(self, *a, **k)
        end.record()
        end.synchronize()
        seen.update(guidance=self, out=out, ms=start.elapsed_time(end))
        return out

    out_png = os.path.join(tmp, "sample.png")
    DualBranchGuidance.sample_joint = timed
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        sample.main(["--config", AVATAR_YAML, "--prompt", PROMPT,
                     "--steps", str(SAMPLE_CLI_STEPS), "--out", out_png,
                     "--device", dev.type, *overrides])
        torch.cuda.synchronize()
    finally:
        DualBranchGuidance.sample_joint = own
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    from PIL import Image

    grid = np.asarray(Image.open(out_png))
    g = seen["guidance"]
    s = g.cfg.image_size
    check(grid.shape == (s, 3 * s, 3), f"sample grid {grid.shape}")
    for name, x in zip(("image", "depth"), seen["out"]):
        check(x.shape == (1, s, s, 3) and bool(torch.isfinite(x).all()),
              f"sample {name} {tuple(x.shape)}")
    # one UNet forward a step (the CFG pair in one batch), the pose
    # encode and two decodes, from the module trees
    norm_count = (SAMPLE_CLI_STEPS * norms_in(g.unet)
                  + norms_in(g.vae.encoder) + 2 * norms_in(g.vae.decoder))
    want = launches(groupnorm_fwd=norm_count,
                    attention_fwd=SAMPLE_CLI_STEPS * ATTN_PER_UNET_FORWARD,
                    conv_bias_add=encode_convs(g.vae)
                    + 2 * decode_convs(g.vae),
                    **vae_attention_launches(g.vae, g.cfg.latent_size ** 2,
                                             3))
    per_step = seen["ms"] / SAMPLE_CLI_STEPS
    print(f"  sample_joint {seen['ms']:.3f} ms ({per_step:.3f} ms a "
          f"step), the CLI {wall:.1f} s with "
          f"build; {grid.shape[1]}x{grid.shape[0]} grid; launches {counts}")
    check(counts == want, f"sample CLI launches {counts}, want {want}")
    del seen
    torch.cuda.empty_cache()
    return counts


def sd_guidance_phase(dev):
    """Phase 18: StableDiffusionGuidance at SD2_SINGLE_CONFIG width with
    VAEConfig(), batch SD_BATCH at 512^2: one SDS and one Perp-Neg call,
    each differentiated through the VAE encode."""
    from humangaussian_torch import kernels
    from humangaussian_torch.guidance.prompt import (
        PromptProcessor,
        PromptProcessorConfig,
        dummy_encode_fn,
    )
    from humangaussian_torch.guidance.schedule import sd_eps_schedule
    from humangaussian_torch.guidance.stable_diffusion import (
        SDGuidanceConfig,
        StableDiffusionGuidance,
    )
    from humangaussian_torch.guidance.unet import SD2_SINGLE_CONFIG, SingleUNet
    from humangaussian_torch.guidance.vae import AutoencoderKL, VAEConfig

    print(f"phase 18: StableDiffusionGuidance (SD2 width, batch {SD_BATCH}, "
          "512^2)")
    torch.manual_seed(18)
    with torch.device(dev):
        unet = SingleUNet(SD2_SINGLE_CONFIG)
        vae = AutoencoderKL(VAEConfig())
    unet.to(memory_format=torch.channels_last)
    vae.to(memory_format=torch.channels_last)
    n_unet = sum(p.numel() for p in unet.parameters())
    g = StableDiffusionGuidance(unet, vae, sd_eps_schedule(device=dev),
                                SDGuidanceConfig())
    emb = PromptProcessor(
        PromptProcessorConfig(prompt=PROMPT, negative_prompt="blurry",
                              use_cache=False),
        dummy_encode_fn(77, 1024), device=dev)()
    gen = torch.Generator(device=dev).manual_seed(18)
    rgb = torch.rand((SD_BATCH, 512, 512, 3), generator=gen, device=dev)
    elev = torch.rand(SD_BATCH, generator=gen, device=dev) * 60 - 30
    azim = torch.rand(SD_BATCH, generator=gen, device=dev) * 360 - 180
    t = torch.randint(20, 981, (SD_BATCH,), generator=gen, device=dev)
    enc_norms = norms_in(vae.encoder)
    sites = flash_sites(unet, g.cfg.latent_size)
    forward = 2 * enc_norms + norms_in(unet)  # encode, its recomputation
    want = launches(groupnorm_fwd=forward, groupnorm_bwd_stats=enc_norms,
                    groupnorm_bwd_dx=enc_norms, attention_fwd=sites,
                    conv_bias_add=2 * encode_convs(vae),
                    **vae_attention_launches(vae, g.cfg.latent_size ** 2, 2,
                                             1, SD_BATCH))
    for perp_neg in (False, True):
        g.cfg = dataclasses.replace(g.cfg, use_perp_neg=perp_neg)
        x = rgb.clone().requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = g(x, emb, elev, azim, t, gen)
        out["loss_sds"].backward()
        end.record()
        end.synchronize()
        counts = kernels.launch_counts()
        label = "Perp-Neg" if perp_neg else "SDS"
        print(f"  {label}: loss {float(out['loss_sds'].detach()):.6g}, grad norm "
              f"{float(out['grad_norm']):.6g}, d loss / d rgb max "
              f"{float(x.grad.abs().max()):.3e}; {start.elapsed_time(end):.3f}"
              f" ms (first call), peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {counts}")
        check(math.isfinite(float(out["loss_sds"].detach()))
              and bool(torch.isfinite(out["grad"]).all())
              and bool(torch.isfinite(x.grad).all())
              and float(x.grad.abs().max()) > 0, f"SD {label} not finite")
        check(counts == want, f"SD {label} launches {counts}, want {want}")
    print(f"  SingleUNet {n_unet} parameters, {norms_in(unet)} norms, "
          f"{sites} K4 sites a forward at 64^2")
    del g, unet, vae, out, x
    torch.cuda.empty_cache()


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

    t_run = time.perf_counter()

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
    if want("photo-data"):
        photo = photo_data_phases(dev, tmp, assets)
        for name, key in (("rasterize_fwd", "k1_err"),
                          ("rasterize_bwd", "k2_err")):
            if name in rows:
                rows[name]["launches_photo_data"] = photo["counts"][name]
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                                photo[key])
        if "rasterize_bwd_rows" in rows:
            rows["rasterize_bwd_rows"]["launches_photo_data"] = photo[
                "counts"]["rasterize_bwd_rows"]
    if want("tools"):
        viewer_launches = tools_phases(dev, tmp, assets)
        if "rasterize_fwd" in rows:
            rows["rasterize_fwd"]["launches_viewer"] = viewer_launches
    torch.cuda.empty_cache()
    if want("norm"):
        rows.update(norm_phase(dev))
        rows.update(conv_bias_phase(dev))
    if want("attention"):
        rows.update(attention_phase(dev))
        rows.update(vae_attention_phase(dev))
    avatar_groups = ("guidance", "sample", "controlnet", "dist")
    if any(want(x) for x in avatar_groups + ("trainer", "deep-floyd",
                                             "sample-cli")):
        overrides = write_prior_files(dev, tmp) + [
            f"system.smplx_path={assets[0]}"]
    unet = None
    if any(want(x) for x in avatar_groups):
        system = build_avatar_system(dev, overrides)
        if want("guidance"):
            counts, batch = train_step_phase(dev, system, assets)
            resize_phase(dev)
            sjc_snapshot_phase(dev, system, tmp)
            # every row's `launches` is the count of one train_step
            for name, row in rows.items():
                row["launches"] = counts[name]
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
            if "rasterize_bwd" in rows:
                rows["rasterize_bwd"]["ms_guidance_batch_with_k2b"] = batch[
                    "k2_k2b_ms"]
            if "rasterize_bwd_rows" in rows:
                row = rows["rasterize_bwd_rows"]
                row["max_abs_err"] = max(row["max_abs_err"], batch["k2b_err"])
                row["ms_guidance_batch"] = batch["k2b_ms"]
                row["ms_launch_guidance_batch"] = batch["k2b_launch_ms"]
                row["bound_ms_guidance_batch"] = batch["k2b_bound"]
                row["library_ms_guidance_batch"] = batch["k2b_library_ms"]
        if want("sample"):
            sample_phase(dev, system)
        if want("controlnet"):
            counts = controlnet_phase(dev, tmp, system, assets[0])
            for name, row in rows.items():
                row["launches_controlnet_call"] = counts[name]
        if want("dist"):
            counts = dist_phase(dev, system)
            for name, row in rows.items():
                row["launches_dp_step"] = counts[name]
        unet = system.guidance.unet
        del system
    if want("unet-backward"):
        unet_backward_phase(dev, unet)
    del unet
    if want("sdxl"):
        torch.cuda.empty_cache()
        sdxl_counts = sdxl_phase(dev, tmp, assets[0])
        for name, row in rows.items():
            row["launches_sdxl_step"] = sdxl_counts[name]
    if want("trainer"):
        torch.cuda.empty_cache()
        trainer_phase(dev, tmp, overrides)
    torch.cuda.empty_cache()
    if want("sample-cli"):
        cli_counts = sample_cli_phase(dev, tmp, overrides)
        for name, row in rows.items():
            row["launches_sample_cli"] = cli_counts[name]
    if want("sd-guidance"):
        sd_guidance_phase(dev)
    df_system = None
    if want("nerf"):
        df_counts, df_system = dreamfusion_phase(dev, tmp)
        neus_export_phase(dev, tmp, df_system)
        for name, row in rows.items():
            row["launches_dreamfusion_step"] = df_counts[name]
    if want("explicit"):
        explicit_phase(dev, assets, df_system)
    del df_system
    torch.cuda.empty_cache()
    if want("gan"):
        gan_phase(dev)
        torch.cuda.empty_cache()
    if want("deep-floyd"):
        if_counts = deep_floyd_phase(
            dev, tmp, [f"system.smplx_path={assets[0]}"])
        for name, row in rows.items():
            row["launches_deep_floyd_step"] = if_counts[name]
    tmp_dir.cleanup()

    if only:
        print(f"partial run ({', '.join(only)}): no result lines")
        return 0
    for row in rows.values():
        check(row["launches"] > 0,
              f"{row['name']} was never launched on its path")
    print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s after the "
          f"script's imports")
    print(card)
    print(json.dumps({"kernels": [rows[k.name] for k in kernels.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def render_phases(dev, tmp, assets) -> dict:
    """Phases 2 to 8 (the render paths: serving and photo training);
    returns the `kernels` rows of K1, K2 and K2b."""
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
    from humangaussian_torch.apps import launch
    from humangaussian_torch.config import load_config

    cfg = RasterizeConfig()

    def raster_counts():
        counts = kernels.launch_counts()
        return {k: counts[k] for k in ("rasterize_fwd", "rasterize_bwd",
                                       "rasterize_bwd_rows")}

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
    k2_err, _, _, k2b_err, _ = k2_vs_plain(
        "small 96x64", kargs, routing_of(pairs), bg,
        (tx, ty), cfg, got, plain, seed=3)

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
    avatar_routing = routing_of(pairs)
    errs, avatar_cot, _, rows_err, avatar_written = k2_vs_plain(
        f"avatar {SIZE}x{SIZE}", kargs, avatar_routing, black, (tx, ty), cfg,
        got, plain, seed=4)
    k2_err = tuple(max(a, b) for a, b in zip(k2_err, errs))
    k2b_err = max(k2b_err, rows_err)
    avatar_fwd = {k: got[k] for k in ("image", "depth", "final_t",
                                      "n_contrib")}
    avatar_k2_bound = k2_bound(kargs, (tx, ty), got, contribs,
                               avatar_written)
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
    check(raster_counts() == {"rasterize_fwd": 1, "rasterize_bwd": 1,
                              "rasterize_bwd_rows": 1},
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
                             "rasterize_bwd": TRAIN_STEPS,
                             "rasterize_bwd_rows": TRAIN_STEPS},
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
                                                contribs, avatar_written)
    print(f"  K1 {SIZE}^2 avatar view: {k1_ms:.4f} ms (plain {plain_ms:.3f} "
          f"ms), {n_pairs} pairs, {bound_text(k1_needed, k1_visits_bound)}")
    avatar_times = k2_times(f"{SIZE}^2 avatar view", kargs, avatar_routing,
                            black, (tx, ty), cfg, avatar_fwd, avatar_cot)
    k2_avatar_ms = avatar_times["k2"]
    print(f"  K2 {SIZE}^2 avatar view: {k2_avatar_ms:.4f} ms (plain "
          f"{avatar_times['k2_plain']:.3f} ms), "
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
    t_routing = routing_of(tpairs)
    errs, tcot, _, rows_err, t_written = k2_vs_plain(
        "first training view", targs, t_routing, black, (ttx, tty),
        trainer.raster_cfg, tfwd, tplain, seed=6)
    k2_err = tuple(max(a, b) for a, b in zip(k2_err, errs))
    k2b_err = max(k2b_err, rows_err)
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
                                               t_contribs, t_written)
    t_times = k2_times("first training view", targs, t_routing, black,
                       (ttx, tty), trainer.raster_cfg, tfwd, tcot)
    k2_ms, k2_plain_ms = t_times["k2"], t_times["k2_plain"]
    k2_visits_bound = k2_bound(targs, (ttx, tty), tfwd, t_contribs,
                               t_written)
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
            "launches": 0,  # phase 11's train_step sets it
            "launches_serving_and_photo": (
                anim_launches + orbit_launches
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
            "launches": 0,  # phase 11's train_step sets it
            "launches_photo": train_launches["rasterize_bwd"],
            "max_abs_err": k2_err[0],
            "max_err_over_max_grad": k2_err[1],
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
            "bound_ms": k2_needed[0],
            "bound_by": k2_needed[1],
            "bound_ms_visits": k2_visits_bound[0],
            "library_ms": None,
            "ms_avatar_view": k2_avatar_ms,
            # the whole backward, K2 + K2b (`composite_backward`)
            "ms_with_k2b": t_times["both"],
            "ms_avatar_view_with_k2b": avatar_times["both"],
        },
        {
            "name": "rasterize_bwd_rows",
            "route": "cuda",
            "source": "humangaussian_torch/csrc/rasterize_bwd.cu",
            "replaces": "humangaussian_tpu/ops/rasterize_tiled.py:956",
            "launches": 0,  # phase 11's train_step sets it
            "launches_photo": train_launches["rasterize_bwd_rows"],
            "max_abs_err": k2b_err,
            "ms": t_times["k2b"],
            # the kernel launched alone, without the wrapper's host time
            "ms_launch": t_times["k2b_launch"],
            "plain_ms": t_times["k2b_plain"],
            "bound_ms": t_times["k2b_bound"],
            "bound_by": "bytes",
            "library_ms": t_times["k2b_library"],
            "library_call": "index_add_ of the masked sub-tile rows of the "
                            "kept candidates into their feature rows, "
                            "zeroed (the sums without the per-row "
                            "transform, in no fixed order)",
            "ms_avatar_view": avatar_times["k2b"],
            "ms_launch_avatar_view": avatar_times["k2b_launch"],
            "plain_ms_avatar_view": avatar_times["k2b_plain"],
            "bound_ms_avatar_view": avatar_times["k2b_bound"],
            "library_ms_avatar_view": avatar_times["k2b_library"],
        },
    ]}


# phases 19-22 (`--only photo-data`): captures of the avatar in the two
# formats a user reconstructs from, at the sizes users run them
CAPTURE_HW = (576, 1024)  # a 16:9 multiview frame: 18 x 32 tiles
CO3D_HW = (768, 1024)  # the CO3D frame before the crop
CO3D_SIZE = 512  # data.height = data.width after the box crop
CAPTURE_STEPS = 20
# the capture's principal point, off the centre by these pixels (x, y)
CAPTURE_PP_OFFSET = (6.5, -4.25)
LPIPS_REL_TOL = 1e-4  # the card's LPIPS against the port's CPU value
MESH_RESOLUTION = 128
VIEWER_SIZE = 512
VIEWER_FRAMES = 5  # timed HTTP frames per mode, after one warm-up


def orbit_views(orbit, n, seed):
    """`n` seeded views of the test orbit: (c2w [n,4,4], fovy)."""
    rng = np.random.default_rng(seed)
    picks = rng.choice(orbit.c2w.shape[0], n, replace=False)
    return orbit.c2w[torch.from_numpy(picks).to(orbit.c2w.device)], float(
        orbit.fovy[0])


def render_views(avatar, c2ws, fovy, hw, bg):
    """The avatar rendered by the port at each c2w, at hw = (H, W)."""
    from humangaussian_torch.core.camera import camera_from_c2w
    from humangaussian_torch.render import render

    outs = []
    with torch.no_grad():
        for c2w in c2ws:
            out = render(avatar, camera_from_c2w(c2w, fovy, *hw), bg)
            outs.append({k: out[k].cpu().numpy()
                         for k in ("image", "alpha", "depth")})
    return outs


def write_multiview_capture(root, avatar, orbit, bg, seed=10):
    """An instant-ngp capture (transforms.json, OPENCV model): 24 + 4
    seeded orbit views of the avatar at CAPTURE_HW rendered by the port,
    fl_x = fl_y from the orbit's fovy, the principal point off the centre
    by CAPTURE_PP_OFFSET."""
    from humangaussian_torch.utils.saving import save_image

    h, w = CAPTURE_HW
    c2ws, fovy = orbit_views(orbit, TRAIN_VIEWS + TEST_VIEWS, seed)
    focal = 0.5 * h / math.tan(0.5 * fovy)
    gl2cv = np.diag([1.0, -1.0, -1.0, 1.0])
    os.makedirs(root, exist_ok=True)
    frames = []
    for i, out in enumerate(render_views(avatar, c2ws, fovy, CAPTURE_HW,
                                         bg)):
        name = f"frame_{i:03d}.png"
        save_image(os.path.join(root, name), np.clip(out["image"], 0, 1))
        frames.append({
            "file_path": name, "w": w, "h": h, "fl_x": focal,
            "fl_y": focal, "cx": w / 2 + CAPTURE_PP_OFFSET[0],
            "cy": h / 2 + CAPTURE_PP_OFFSET[1],
            "transform_matrix": (c2ws[i].cpu().numpy() @ gl2cv).tolist()})
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump({"camera_model": "OPENCV", "frames": frames}, f)
    return root


def write_co3d_sequence(root, avatar, orbit, bg, seed=11):
    """A CO3D-v2 sequence `<root>/avatar/seq_0`: 28 seeded orbit views of
    the avatar at CO3D_HW rendered by the port, as RGB PNGs, masks (the
    alpha) and float16-in-uint16 depth PNGs, with NDC-isotropic PyTorch3D
    cameras in `avatar/frame_annotations.jgz`."""
    import gzip

    from PIL import Image

    h, w = CO3D_HW
    seq = os.path.join(root, "avatar", "seq_0")
    for sub in ("images", "masks", "depths"):
        os.makedirs(os.path.join(seq, sub), exist_ok=True)
    c2ws, fovy = orbit_views(orbit, TRAIN_VIEWS + TEST_VIEWS, seed)
    focal_ndc = (0.5 * h / math.tan(0.5 * fovy)) / (min(h, w) / 2)
    # the loader's c2w is [R | -R T] @ diag(-1, -1, 1, 1) in OpenCV axes
    gl2p3d = np.diag([-1.0, 1.0, -1.0, 1.0])
    frames = []
    for i, out in enumerate(render_views(avatar, c2ws, fovy, CO3D_HW, bg)):
        stem = f"frame{i:06d}"
        Image.fromarray((np.clip(out["image"], 0, 1) * 255).round()
                        .astype(np.uint8)).save(
            os.path.join(seq, "images", stem + ".png"))
        Image.fromarray((np.clip(out["alpha"], 0, 1) * 255).round()
                        .astype(np.uint8)).save(
            os.path.join(seq, "masks", stem + ".png"))
        Image.fromarray(out["depth"].astype(np.float16).view(np.uint16)
                        ).save(os.path.join(seq, "depths", stem + ".png"))
        pose = c2ws[i].cpu().numpy().astype(np.float64) @ gl2p3d
        r = pose[:3, :3]
        frames.append({
            "sequence_name": "seq_0",
            "meta": {"frame_type": "train_known"},
            "image": {"path": f"avatar/seq_0/images/{stem}.png",
                      "size": [h, w]},
            "mask": {"path": f"avatar/seq_0/masks/{stem}.png"},
            "depth": {"path": f"avatar/seq_0/depths/{stem}.png",
                      "scale_adjustment": 1.0},
            "viewpoint": {"focal_length": [focal_ndc, focal_ndc],
                          "principal_point": [0.0, 0.0],
                          "R": r.tolist(), "T": (-r.T @ pose[:3, 3]).tolist()},
        })
    with gzip.open(os.path.join(root, "avatar", "frame_annotations.jgz"),
                   "wt") as fp:
        json.dump(frames, fp)
    return seq


def knn_phase(dev, avatar):
    """Phase 19: the on-device windowed 3-NN at the avatar's points against
    the exact KD-tree."""
    from humangaussian_torch.ops.knn import (
        mean_3nn_sq_dist,
        mean_3nn_sq_dist_host,
    )

    print(f"phase 19: mean_3nn_sq_dist on the card at {N_AVATAR} avatar "
          f"points")
    pts = avatar.means[avatar.alive].contiguous()
    got = mean_3nn_sq_dist(pts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact = mean_3nn_sq_dist_host(pts).to(dev)
    host_s = time.perf_counter() - t0
    ms = cuda_ms(lambda: mean_3nn_sq_dist(pts), reps=5)
    rel = (got - exact) / exact.clamp_min(1e-30)
    over = float((rel > 1e-5).to(torch.float64).mean())
    print(f"  {pts.shape[0]} points: {ms:.3f} ms on the card (window 64), "
          f"KD-tree {host_s:.3f} s on the host; overestimates "
          f"{100 * over:.3f}% of the points (median relative error "
          f"{float(rel.median()):.3e}, max {float(rel.max()):.3e}), min "
          f"relative error {float(rel.min()):.3e}")
    check(bool(torch.isfinite(got).all()), "knn: non-finite distances")
    check(float(rel.min()) >= -1e-5, "knn: underestimates a distance")


PHOTO_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs", "photo.yaml")


def capture_overrides(tmp, *data):
    """configs/photo.yaml's overrides at full width for CAPTURE_STEPS
    steps with density control from step 10, plus the `data` ones that
    name the capture."""
    return [f"exp_root_dir={tmp}/outputs",
            f"system.capacity={TRAIN_CAPACITY}", "system.sh_degree=3",
            f"system.init_points={N_AVATAR}", "system.densify_from_iter=10",
            "system.densification_interval=10",
            f"system.densify_grad_threshold={TRAIN_GRAD_THRESHOLD:.1e}",
            f"trainer.max_steps={CAPTURE_STEPS}", "trainer.log_every=1",
            *data]


def capture_cli(dev, label, overrides, n_test):
    """`apps.launch.main --train` on configs/photo.yaml with `overrides`
    (`capture_overrides`): checks the launches, the loss and `last.ply`.
    Returns (launch counts, trial dir)."""
    from humangaussian_torch import kernels
    from humangaussian_torch.apps import launch
    from humangaussian_torch.io.ply import load_ply

    argv = ["--config", PHOTO_YAML, "--train", "--device", dev.type,
            *overrides]
    kernels.reset_launch_counts()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        trial = launch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    counts = {k: counts[k] for k in ("rasterize_fwd", "rasterize_bwd",
                                     "rasterize_bwd_rows")}
    steps = re.findall(r"photo step (\d+): loss=([0-9.eE+-]+) alive=(\d+)",
                       log.getvalue())
    losses = [float(x[1]) for x in steps]
    alive = [int(x[2]) for x in steps]
    psnr_line = re.search(r"photo eval: psnr=([0-9.]+) ssim=([0-9.]+)",
                          log.getvalue())
    print(f"  {label}: {len(steps)} steps in {wall:.1f} s (the capture's "
          f"load and the test views included), launches {counts}, loss "
          f"first 5 {statistics.mean(losses[:5]):.5f} last 5 "
          f"{statistics.mean(losses[-5:]):.5f}, alive {alive[0]} -> "
          f"{alive[-1]}, {n_test} test views: PSNR "
          f"{psnr_line.group(1) if psnr_line else '?'}")
    check(len(steps) == CAPTURE_STEPS, f"{label}: {len(steps)} steps logged")
    check(counts == {"rasterize_fwd": CAPTURE_STEPS + n_test,
                     "rasterize_bwd": CAPTURE_STEPS,
                     "rasterize_bwd_rows": CAPTURE_STEPS},
          f"{label}: launches {counts}")
    check(statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
          f"{label}: the loss did not fall")
    check(psnr_line is not None, f"{label}: no test PSNR printed")
    trained = load_ply(os.path.join(trial, "save", "last.ply"), device=dev)
    check(trained.num_alive > 0 and all(
        bool(torch.isfinite(v[trained.alive]).all())
        for v in trained.params().values()), f"{label}: last.ply non-finite")
    print(f"  {label}: last.ply {trained.num_alive} Gaussians")
    return counts, trial


def trainer_first_view(dev, label, overrides, bg, seed):
    """The photo trainer as `apps.launch.build_system` builds it for the
    capture: K1 and K2 against their plain versions at its first training
    view (the random initial cloud keeps every tile busy), then ms per
    `train_step` there. Returns (K1 error, K2 errors)."""
    from humangaussian_torch.apps import launch
    from humangaussian_torch.config import load_config
    from humangaussian_torch.ops.rasterize_tiled import (
        composite,
        composite_inputs,
        composite_plain,
    )

    _, trainer, dataset, pts, colors = launch.build_system(
        load_config(PHOTO_YAML, overrides), dev)
    state = trainer.init_state(0, pts, colors)
    posed = dataset.train[0]
    sc, rcfg = state.scene, trainer.raster_cfg
    _, pairs, kargs, tiles = composite_inputs(
        sc.means, sc.scales, sc.quats, sc.features, sc.opacities, sc.alive,
        [trainer.camera_for(posed)], sc.max_sh_degree, rcfg,
        tile_capacity=trainer.cfg.tile_capacity)
    got = composite(*kargs, bg, *tiles, rcfg)
    torch.cuda.synchronize()
    plain = composite_plain(*kargs, bg, *tiles, rcfg)
    busy = pairs.counts[pairs.counts > 0]
    h, w = posed.image.shape[:2]
    print(f"  {label} first training view {w}x{h}: pairs="
          f"{int(pairs.gids.numel())} on {busy.numel()} of "
          f"{tiles[0] * tiles[1]} tiles (max {int(busy.max())})")
    k1_err = compare(f"{label} first training view", got, plain)
    k2_errs, _, _, _, _ = k2_vs_plain(
        f"{label} first training view", kargs,
        routing_of(pairs), bg, tiles, rcfg, got, plain,
        seed=seed)
    del got, plain

    def step():
        nonlocal state
        state, _ = trainer.train_step(state, posed)

    print(f"  {label}: {cuda_ms(step, reps=10):.3f} ms per train_step at "
          f"{w}x{h} (first view, {N_AVATAR} Gaussians, SH 3)")
    return k1_err, k2_errs


def photo_data_phases(dev, tmp, assets) -> dict:
    """Phases 19 to 22 (`--only photo-data`): the on-device KNN, training
    from a multiview capture and from a CO3D sequence through
    `apps.launch`, and LPIPS. Returns the K1 / K2 launches of the two
    training runs and their largest errors against the plain versions."""
    from humangaussian_torch.core.camera import camera_from_c2w
    from humangaussian_torch.data.cameras import (
        RandomCameraConfig,
        eval_camera_batch,
    )
    from humangaussian_torch.io.ply import load_ply
    from humangaussian_torch.ops.projection import RasterizeConfig
    from humangaussian_torch.ops.rasterize_tiled import (
        composite,
        composite_inputs,
        composite_plain,
    )

    avatar = load_ply(assets[1], device=dev)
    knn_phase(dev, avatar)
    orbit = eval_camera_batch(RandomCameraConfig(), "test", device=dev)
    black = torch.zeros(3, device=dev)

    # -- phase 20: K1 / K2 at a 16:9 view, then the multiview capture -----
    h, w = CAPTURE_HW
    print(f"phase 20: K1 and K2 vs plain at {w}x{h}, then apps.launch "
          f"(photo-3dgs-system, data.type=multiview) on a {w}x{h} capture")
    cfg = RasterizeConfig()
    c2w, fovy = orbit_views(orbit, 1, seed=12)
    _, pairs, kargs, tiles = composite_inputs(
        avatar.means, avatar.scales, avatar.quats, avatar.features,
        avatar.opacities, avatar.alive,
        [camera_from_c2w(c2w[0], fovy, h, w)], avatar.max_sh_degree, cfg)
    got = composite(*kargs, black, *tiles, cfg)
    torch.cuda.synchronize()
    plain = composite_plain(*kargs, black, *tiles, cfg)
    busy = pairs.counts[pairs.counts > 0]
    print(f"  {w}x{h} view: {tiles[0]} x {tiles[1]} tiles, pairs="
          f"{int(pairs.gids.numel())} on {busy.numel()} busy tiles (max "
          f"{int(busy.max())}), alpha>0.5 pixels "
          f"{int((got['alpha'] > 0.5).sum())}")
    check(float(got["alpha"].max()) > 0.9, f"avatar not in the {w}x{h} view")
    k1_err = compare(f"{w}x{h} view", got, plain)
    k2_err, _, _, _, _ = k2_vs_plain(
        f"{w}x{h} view", kargs, routing_of(pairs), black,
        tiles, cfg, got, plain, seed=13)
    del got, plain

    t0 = time.perf_counter()
    mv_root = write_multiview_capture(os.path.join(tmp, "multiview"), avatar,
                                      orbit, black)
    print(f"  capture: {TRAIN_VIEWS + TEST_VIEWS} frames "
          f"({time.perf_counter() - t0:.1f} s)")
    mv_overrides = capture_overrides(
        tmp, "data.type=multiview", f"data.dataroot={mv_root}",
        "data.train_downsample_resolution=1")
    errs = trainer_first_view(dev, "multiview", mv_overrides, black, 14)
    k1_err = max(k1_err, errs[0])
    k2_err = tuple(max(a, b) for a, b in zip(k2_err, errs[1]))
    mv_counts, mv_trial = capture_cli(dev, "multiview", mv_overrides,
                                      TEST_VIEWS)

    # -- phase 21: the CO3D sequence ---------------------------------------
    ch, cw = CO3D_HW
    print(f"phase 21: apps.launch (data.type=co3d, box_crop) on a {cw}x{ch} "
          f"CO3D sequence at {CO3D_SIZE}^2")
    t0 = time.perf_counter()
    seq = write_co3d_sequence(os.path.join(tmp, "co3d"), avatar, orbit,
                              black)
    print(f"  sequence: {TRAIN_VIEWS + TEST_VIEWS} frames "
          f"({time.perf_counter() - t0:.1f} s)")
    co3d_overrides = capture_overrides(
        tmp, "data.type=co3d", f"data.dataroot={seq}",
        f"data.height={CO3D_SIZE}", f"data.width={CO3D_SIZE}",
        "data.box_crop=true")
    errs = trainer_first_view(dev, "co3d", co3d_overrides, black, 15)
    k1_err = max(k1_err, errs[0])
    k2_err = tuple(max(a, b) for a, b in zip(k2_err, errs[1]))
    co3d_counts, _ = capture_cli(dev, "co3d", co3d_overrides, TEST_VIEWS)

    lpips_phase(dev, mv_root, mv_trial)
    return {"counts": {k: mv_counts[k] + co3d_counts[k] for k in mv_counts},
            "k1_err": k1_err, "k2_err": k2_err[0]}


def lpips_phase(dev, mv_root, trial):
    """Phase 22: LPIPS with seeded VGG16 and lin weights (loaded through
    `load_lpips_params` from torchvision-named state dicts) between the
    multiview capture's test views and the trained scene's renders."""
    from humangaussian_torch.core.camera import camera_from_c2w
    from humangaussian_torch.data.multiview import (
        MultiviewConfig,
        MultiviewDataModule,
    )
    from humangaussian_torch.io.ply import load_ply
    from humangaussian_torch.perceptual import (
        LPIPS,
        VGG_CONV_IDS,
        VGG_STAGES,
        load_lpips_params,
    )
    from humangaussian_torch.render import render

    h, w = CAPTURE_HW
    print(f"phase 22: LPIPS (seeded VGG16) on the capture's {TEST_VIEWS} "
          f"test views at {w}x{h}")
    torch.manual_seed(0)
    seeded = LPIPS()
    vgg_sd = seeded.vgg.state_dict()  # torchvision's `features.*` names
    g = torch.Generator().manual_seed(1)
    lin_sd = {f"lin{i}.model.1.weight": torch.rand((1, ch, 1, 1),
                                                    generator=g)
              for i, (ch, _) in enumerate(VGG_STAGES)}
    check(len(vgg_sd) == 2 * len(VGG_CONV_IDS), "VGG16 state dict size")
    model = LPIPS()
    model.load_state_dict(load_lpips_params(vgg_sd, lin_sd))
    model = model.eval().to(dev)

    data = MultiviewDataModule(MultiviewConfig(
        dataroot=mv_root, train_downsample_resolution=1)).as_photo_dataset()
    scene = load_ply(os.path.join(trial, "save", "last.ply"), device=dev)
    pairs = []
    with torch.no_grad():
        for p in data.test:
            cam = camera_from_c2w(torch.from_numpy(p.c2w).to(dev), p.fovy,
                                  *p.image.shape[:2])
            x = torch.from_numpy(p.image).to(dev).permute(2, 0, 1)[None]
            y = render(scene, cam, torch.zeros(3, device=dev))["image"]
            pairs.append((x, y.clamp(0, 1).permute(2, 0, 1)[None]))
        d = [float(model(x, y)) for x, y in pairs]
        x, y = pairs[0]
        dxx, dyx = float(model(x, x)), float(model(y, x))
        ms = cuda_ms(lambda: model(x, y), reps=5)
        cpu_model = LPIPS()
        cpu_model.load_state_dict(model.state_dict())
        d_cpu = float(cpu_model.eval()(x.cpu(), y.cpu()))
    rel = abs(d[0] - d_cpu) / max(abs(d_cpu), 1e-30)
    print(f"  d(test view, render) = {', '.join(f'{v:.6f}' for v in d)}; "
          f"d(x, x) = {dxx:.3e}, |d(x, y) - d(y, x)| = {abs(d[0] - dyx):.3e}, "
          f"card vs CPU relative {rel:.3e}; {ms:.3f} ms per pair")
    check(all(math.isfinite(v) and v > 0 for v in d), "LPIPS not positive")
    check(abs(dxx) <= 1e-6 * d[0], f"LPIPS d(x, x) = {dxx}")
    check(abs(d[0] - dyx) <= 1e-6 * d[0], "LPIPS is not symmetric")
    check(rel <= LPIPS_REL_TOL, f"LPIPS card vs CPU relative {rel}")


def tools_phases(dev, tmp, assets) -> int:
    """Phases 23 and 24 (`--only tools`): mesh extraction from the avatar
    PLY and the viewer CLI's server driven over HTTP. Returns K1's
    launches over the viewer's "gs" frames."""
    mesh_phase(dev, tmp, assets)
    return viewer_phase(dev, assets)


def mesh_phase(dev, tmp, assets):
    """Phase 23: `extract_mesh` on the avatar PLY at MESH_RESOLUTION."""
    from humangaussian_torch.io.ply import load_ply
    from humangaussian_torch.mesh import (
        block_counts,
        extract_density_field,
        extract_mesh,
        save_obj,
    )

    print(f"phase 23: extract_mesh on the {N_AVATAR}-Gaussian avatar at "
          f"{MESH_RESOLUTION}^3")
    avatar = load_ply(assets[1], device=dev)
    t0 = time.perf_counter()
    field, _, _ = extract_density_field(avatar, MESH_RESOLUTION)
    field_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    verts, tris = extract_mesh(avatar, resolution=MESH_RESOLUTION)
    mesh_s = time.perf_counter() - t0
    counts = block_counts(avatar)
    dropped = int(np.maximum(counts - 8192, 0).sum())
    means = avatar.means[avatar.alive].cpu().numpy()
    lo, hi = means.min(0), means.max(0)
    margin = 3 * float(avatar.scales[avatar.alive].max()) + 2 * float(
        (hi - lo).max()) / (MESH_RESOLUTION - 1)
    print(f"  field {field_s:.2f} s (max {float(field.max()):.3f}, "
          f"{int((field > 1.0).sum())} voxels above the 1.0 iso level), "
          f"marching tets {mesh_s - field_s:.2f} s (extract_mesh {mesh_s:.2f} "
          f"s); {len(verts)} vertices, {len(tris)} triangles; blocks: "
          f"{int((counts > 0).sum())} busy, largest {int(counts.max())}, "
          f"{dropped} Gaussian-block pairs dropped past block_capacity 8192")
    check(bool(np.isfinite(field).all()), "density field not finite")
    check(len(verts) > 0 and len(tris) > 0, "the mesh is empty")
    check(bool(np.all(verts >= lo - margin) and np.all(verts <= hi + margin)),
          "the mesh leaves the scene's box")
    check(int(tris.min()) >= 0 and int(tris.max()) < len(verts),
          "triangle indices out of range")
    path = save_obj(os.path.join(tmp, "mesh", "avatar.obj"), verts, tris)
    with open(path) as f:
        lines = f.read().splitlines()
    vs = np.array([[float(t) for t in ln.split()[1:]] for ln in lines
                   if ln.startswith("v ")], np.float32)
    n_f = sum(ln.startswith("f ") for ln in lines)
    check(vs.shape == verts.shape and n_f == len(tris)
          and np.allclose(vs, verts, atol=1e-6), "save_obj did not read back")
    print(f"  {os.path.basename(path)}: {os.path.getsize(path)} bytes, read "
          f"back")


def viewer_phase(dev, assets) -> int:
    """Phase 24: the viewer CLI's server (`build_server`, the stand-in's
    animator) on port 0, driven over HTTP at VIEWER_SIZE^2."""
    import urllib.request

    from PIL import Image

    from humangaussian_torch import kernels
    from humangaussian_torch.apps import viewer
    from humangaussian_torch.ops.projection import RasterizeConfig
    from humangaussian_torch.ops.rasterize_tiled import (
        composite_inputs,
        composite_plain,
    )

    print(f"phase 24: the viewer over HTTP at {VIEWER_SIZE}^2 (gs, mesh, "
          f"skel), with the SMPL-X stand-in's animator")
    smplx_path, ply = assets[0], assets[1]
    server = viewer.build_server([
        "--ply", ply, "--smplx_path", smplx_path, "--port", "0", "--size",
        str(VIEWER_SIZE), "--device", dev.type]).start()
    base = f"http://127.0.0.1:{server.port}"
    view = "azimuth=30&elevation=15&distance=2.0"

    def get(path):
        return urllib.request.urlopen(base + path, timeout=600).read()

    def frame(mode):
        png = get(f"/render?{view}&mode={mode}")
        img = Image.open(io.BytesIO(png))
        check(img.size == (VIEWER_SIZE, VIEWER_SIZE) and img.mode == "RGB",
              f"viewer {mode} frame {img.size} {img.mode}")
        return png, np.asarray(img)

    try:
        check(b"viewer" in get("/"), "viewer page")
        info = json.loads(get("/info"))
        ms, frames = {}, {}
        kernels.reset_launch_counts()
        for mode in ("gs", "mesh", "skel"):
            frames[mode] = frame(mode)  # warm-up
            t0 = time.perf_counter()
            for _ in range(VIEWER_FRAMES):
                frame(mode)
            ms[mode] = (time.perf_counter() - t0) * 1e3 / VIEWER_FRAMES
        req = urllib.request.Request(
            base + "/pose", method="POST", data=json.dumps(
                {"joint": 15, "values": [0.3, -0.5, 0.8],
                 "global_orient": [0.2, 0.0, 0.9]}).encode())
        state = json.loads(urllib.request.urlopen(req, timeout=60).read())
        posed = frame("gs")
        torch.cuda.synchronize()
        launches = kernels.launch_counts()["rasterize_fwd"]
        joints = json.loads(get(f"/joints?{view}"))
    finally:
        server.stop()
    gs_frames = 2 + VIEWER_FRAMES
    print(f"  {info['n_gaussians']} Gaussians, {server.animator.n_gaussians} "
          f"bound; ms per frame over HTTP (render, PNG encode, transfer): "
          + ", ".join(f"{m} {v:.3f}" for m, v in ms.items())
          + f"; K1 launches {launches} for {gs_frames} gs frames")
    check(launches == gs_frames, f"viewer K1 launches {launches}")
    check(state["posable"], "the viewer is not posable")
    check(posed[0] != frames["gs"][0], "POST /pose did not change the frame")
    check(len(set(p for p, _ in frames.values())) == 3,
          "two display modes drew the same frame")
    check(all(int(a.max()) > 0 for _, a in frames.values()),
          "a display mode drew an empty frame")
    xy = np.asarray(joints["xy"], np.float64)
    check(joints["posable"] and xy.shape == (22, 2)
          and bool(np.isfinite(xy).all()), "/joints")

    # one "gs" frame, taken before the PNG encode, against plain compositing
    img = server.render(30.0, 15.0, 2.0, mode="gs")
    with torch.no_grad():
        scene = server.animator.frame_scene(server._current_pose())
        cam, _ = server._camera(30.0, 15.0, 2.0)
        cfg = RasterizeConfig()
        _, _, kargs, tiles = composite_inputs(
            scene.means, scene.scales, scene.quats, scene.features,
            scene.opacities, scene.alive, [cam], server.sh_degree, cfg)
        plain = composite_plain(*kargs, torch.zeros(3, device=dev), *tiles,
                                cfg)
    compare("viewer gs frame", {"image": torch.from_numpy(img)[None]},
            {"image": plain["image"].cpu()}, keys=("image",))
    return launches


# phases 25-26 (`--only nerf`): the NeRF stack
DF_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "configs", "dreamfusion.yaml")
# phase 25b: the JAX package's defaults for the field over the shipped
# config's cut-down one (DreamFusionConfig(): a hash grid of 16 levels x
# 2^19 x 2 features from base 16, 64-neuron MLPs with one hidden layer, 96
# samples a ray, the diffuse material and the neural environment map), and
# the SD 2.1-base prior (arch sd2)
DF_FULL_OVERRIDES = (
    "system.guidance.arch=sd2",
    "system.material=diffuse-with-point-light-material",
    "system.background=neural-environment-map-background",
    "system.geometry.n_neurons=64",
    "system.geometry.n_hidden_layers=1",
    "system.geometry.hash_cfg.n_levels=16",
    "system.geometry.hash_cfg.log2_hashmap_size=19",
    "system.geometry.hash_cfg.base_resolution=16",
    "system.renderer.num_samples_per_ray=96",
)
DF_TABLE_SHAPE = (16, 1 << 19, 2)  # the hash table those overrides give
DF_STEP_REPS = 10  # timed full-width steps, after 2 warm-ups
DF_CLI_STEPS = 5  # full-width steps through apps.launch.main
NEUS_HW = 64
NEUS_IMPORTANCE = 64  # the NeRF renderer's importance samples in phase 26
# the exporter's default threshold of 10 is the blob's peak density
# (softplus(10) at the centre), so a young field's isosurface there is
# empty; 5 is the JAX suite's
EXPORT_THRESHOLD = 5.0
# card against CPU: of each output's max |value| (tests/test_torch_nerf.py)
RENDER_TOL = {"comp_rgb": 1e-5, "comp_rgb_fg": 1e-5, "opacity": 1e-5,
              "weights": 1e-5, "depth": 1e-4, "sdf": 1e-5}
# the importance pass's per-sample weights: a fine depth moves with the
# coarse weights' rounding, and the merged depths' differences (dt) carry
# it into each weight, relative to a dt as small as the two samples are
# close; the composited outputs stay at RENDER_TOL
IMPORTANCE_WEIGHTS_TOL = 1e-4


def write_sd2_files(dev, tmp) -> list:
    """Seeded SD2_SINGLE_CONFIG `unet/` and VAEConfig() weight files in
    diffusers layout (bfloat16) and a prompt cache filled by
    `dummy_encode_fn(77, 1024)` for configs/dreamfusion.yaml's prompt;
    returns the overrides that point the launcher at them."""
    from humangaussian_torch.config import load_config
    from humangaussian_torch.guidance.prompt import (
        PromptProcessor,
        PromptProcessorConfig,
        dummy_encode_fn,
    )
    from humangaussian_torch.guidance.unet import SD2_SINGLE_CONFIG, SingleUNet
    from humangaussian_torch.guidance.vae import AutoencoderKL, VAEConfig

    t0 = time.perf_counter()
    model_key = os.path.join(tmp, "sd2")
    vae_key = os.path.join(tmp, "sd2_vae")
    os.makedirs(os.path.join(model_key, "unet"))
    os.makedirs(vae_key)
    torch.save(seeded_state_dict(lambda: SingleUNet(SD2_SINGLE_CONFIG), 25,
                                 dev),
               os.path.join(model_key, "unet", "diffusion_pytorch_model.bin"))
    torch.save(seeded_state_dict(lambda: AutoencoderKL(VAEConfig()), 26, dev),
               os.path.join(vae_key, "diffusion_pytorch_model.bin"))
    cache = os.path.join(tmp, "df_text_embeddings")
    overrides = [f"system.guidance.model_key={model_key}",
                 f"system.guidance.vae_key={vae_key}",
                 "system.prompt_processor.pretrained_model_name_or_path="
                 + model_key,
                 f"system.prompt_processor.cache_dir={cache}"]
    pp = load_config(DF_YAML, overrides)["system"]["prompt_processor"]
    PromptProcessor(
        PromptProcessorConfig(
            prompt=pp["prompt"], model_path=model_key, cache_dir=cache),
        dummy_encode_fn(77, 1024), device=dev)()
    print(f"  SD2 unet/ and VAE files and the prompt cache written in "
          f"{time.perf_counter() - t0:.1f} s")
    return overrides


def sd_step_launches(guidance, steps: int = 1) -> dict:
    """The launches of `steps` SD-guidance steps through the differentiated
    encode, from the module trees: one UNet forward and two encoder passes
    (the encode and its recomputation under checkpoint) for K3 + K3a, one
    encoder backward for K5 / K5a, K4 at every gated UNet site, the conv
    bias kernel at every convolution of the two encodes."""
    enc = norms_in(guidance.vae.encoder)
    fwd = norms_in(guidance.unet) + 2 * enc
    return launches(
        groupnorm_fwd=steps * fwd,
        groupnorm_bwd_stats=steps * enc, groupnorm_bwd_dx=steps * enc,
        attention_fwd=steps * flash_sites(guidance.unet,
                                          guidance.cfg.latent_size),
        conv_bias_add=steps * 2 * encode_convs(guidance.vae),
        **vae_attention_launches(guidance.vae, guidance.cfg.latent_size ** 2,
                                 2 * steps, steps))


def run_dreamfusion_cli(args) -> tuple:
    """`apps.launch.main(args)` with its output captured: (trial dir, the
    logged losses, host seconds of each train_step (synchronized), wall
    seconds)."""
    from humangaussian_torch.apps import launch
    from humangaussian_torch.nerf.system import DreamFusionSystem

    own = DreamFusionSystem.train_step
    step_s = []

    def timed(self, *a, **k):
        t = time.perf_counter()
        out = own(self, *a, **k)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    DreamFusionSystem.train_step = timed
    log = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            trial = launch.main(args)
        torch.cuda.synchronize()
    finally:
        DreamFusionSystem.train_step = own
    losses = [float(x) for x in re.findall(r"loss=(\S+)", log.getvalue())]
    return trial, losses, step_s, time.perf_counter() - t0


def check_orbit(trial, size):
    from PIL import Image

    path = os.path.join(trial, "save", "orbit.png")
    check(os.path.exists(path), "save/orbit.png missing")
    img = np.asarray(Image.open(path))
    check(img.shape == (size, 8 * size, 3), f"orbit.png is {img.shape}")
    return img


def profile_by_op(label, fn, top=6):
    """fn under torch.profiler: prints wall, device busy and idle share, the
    top kernels and the top launching operators; returns the device busy
    us (0 when the profiler saw no device kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, by_op = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
        elif e.device_type == DeviceType.CPU:
            for k in e.kernels:
                by_op[e.name] = by_op.get(e.name, 0.0) + k.duration
    if not by_name:
        print(f"  {label}: device time not measured (the profiler saw no "
              f"device kernels)")
        return 0.0
    busy_us = sum(by_name.values())
    print(f"  {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share "
          f"{max(0.0, 1 - busy_us / wall_us):.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}%  "
              f"{name[:90]}")
    print(f"  {label}, by launching operator:")
    for op, us in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}%  {op[:90]}")
    return busy_us


def staged_df_step(system, state) -> tuple:
    """One step timed by CUDA events in stages: the cameras (with the
    timesteps and jitter), the render, the encode, UNet + CFG (the
    system's and the guidance's methods wrapped on the instances, the
    encode's recomputation in the backward left out), the rest of the
    forward, the backward, Adam. Returns (ms by stage, state)."""
    g = system.guidance
    marks, forward = {}, [True]

    def wrap(obj, name, label):
        fn = getattr(obj, name)

        def wrapped(*a, **k):
            if not forward[0]:
                return fn(*a, **k)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            marks.setdefault(label, []).append((start, end))
            return out

        setattr(obj, name, wrapped)

    wrap(system, "render_batch", "render")
    wrap(g, "encode_images", "encode")
    wrap(g, "compute_grad_sds", "UNet + CFG")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    try:
        ev[0].record()
        state.optimizer.zero_grad(set_to_none=True)
        inputs = system.sample_step_inputs(state)
        ev[1].record()
        loss, _ = system.loss(inputs, state.generator)
        ev[2].record()
        forward[0] = False
        grads = torch.autograd.grad(loss, list(system.params.values()),
                                    materialize_grads=True)
        ev[3].record()
        system.apply_grads(state, dict(zip(system.params, grads)))
        ev[4].record()
        ev[4].synchronize()
    finally:
        del system.render_batch, g.encode_images, g.compute_grad_sds
    ms = {"cameras": ev[0].elapsed_time(ev[1])}
    for label, spans in marks.items():
        ms[label] = sum(a.elapsed_time(b) for a, b in spans)
    ms["rest of the forward"] = ev[1].elapsed_time(ev[2]) - sum(
        ms[k] for k in ("render", "encode", "UNet + CFG"))
    ms["backward"] = ev[2].elapsed_time(ev[3])
    ms["Adam"] = ev[3].elapsed_time(ev[4])
    ms["total"] = ev[0].elapsed_time(ev[4])
    return ms, state._replace(step=state.step + 1)


def renders_agree(label, got: dict, want: dict, tol=None) -> float:
    """Card outputs against the CPU's at `tol` (RENDER_TOL) of each
    output's max; prints each output's error and returns the largest as a
    share of its limit."""
    tol = tol or RENDER_TOL
    worst, errs = 0.0, []
    for k, w in want.items():
        if k not in tol:
            continue
        w = w.double()
        err = float((got[k].double().cpu() - w).abs().max())
        limit = tol[k] * float(w.abs().max())
        errs.append(f"{k} {err:.3e}")
        check(err <= limit, f"{label} {k}: card vs CPU {err:.3e} > "
              f"{limit:.3e}")
        worst = max(worst, err / max(limit, 1e-30))
    print(f"  {label}: card vs CPU max abs err " + ", ".join(errs))
    return worst


def hash_grid_share(system, state, busy_us):
    """The hash grid's gather (`index_select` of the step's 8 corners x 16
    levels per sample) and its backward's scatter-add (`index_add_` into a
    zeroed table) timed alone by CUDA events on one training render's
    samples, and their share of the profiled step's device time."""
    enc = system.renderer.geometry.encoding
    seen = []
    hook = enc.register_forward_hook(
        lambda m, args, out: seen.append(args[0].detach()))
    try:
        with torch.no_grad():
            system.render_batch(system.sample_step_inputs(state))
    finally:
        hook.remove()
    with torch.no_grad():
        rows, _ = enc.corners(seen[0])
        flat = enc.table.detach().reshape(-1, enc.table.shape[-1])
        idx = rows.reshape(-1)
        grad = torch.randn((idx.numel(), flat.shape[1]), device=flat.device)
        gather_ms = cuda_ms(lambda: torch.index_select(flat, 0, idx), 10)
        scatter_ms = cuda_ms(
            lambda: torch.zeros_like(flat).index_add_(0, idx, grad), 10)
    share = (f" = {100 * gather_ms * 1e3 / busy_us:.1f}% / "
             f"{100 * scatter_ms * 1e3 / busy_us:.1f}% of the profiled "
             f"step's device time" if busy_us else "")
    print(f"  hash grid at one step's {seen[0].numel() // 3} samples "
          f"({idx.numel()} corner rows): gather {gather_ms:.3f} ms, "
          f"scatter-add with its zero fill {scatter_ms:.3f} ms" + share)


def y_up_view(dev, azimuth_deg=0.0):
    """The orbit's camera at `azimuth_deg`: y up, radius 2, height 0.3."""
    from humangaussian_torch.core.camera import look_at_c2w

    a = math.radians(azimuth_deg)
    eye = torch.tensor([2.0 * math.sin(a), 0.3, 2.0 * math.cos(a)],
                       device=dev)
    return look_at_c2w(eye, torch.zeros(3, device=dev),
                       torch.tensor([0.0, 1.0, 0.0], device=dev))


def dreamfusion_phase(dev, tmp) -> tuple:
    """Phase 25: the DreamFusion system through apps.launch, (a) as
    shipped, (b) at full width. Returns (the launches of one full-width
    train_step, the trained system)."""
    import copy

    from humangaussian_torch import kernels
    from humangaussian_torch.apps import launch
    from humangaussian_torch.config import load_config
    from humangaussian_torch.nerf.renderer import NerfVolumeRenderer

    # -- (a) configs/dreamfusion.yaml as shipped --------------------------
    runs = os.path.join(tmp, "df_runs")
    tiny_over = [f"exp_root_dir={runs}",
                 f"system.prompt_processor.cache_dir={tmp}/df_tiny_cache"]
    cfg = load_config(DF_YAML, tiny_over)
    steps = int(cfg["trainer"]["max_steps"])
    every = int(cfg["trainer"]["log_every"])
    eval_h = int(cfg["data"]["eval_height"])
    print(f"phase 25a: apps.launch --train on configs/dreamfusion.yaml as "
          f"shipped (arch {cfg['system']['guidance']['arch']}, {steps} "
          f"steps)")
    kernels.reset_launch_counts()
    trial, losses, step_s, wall = run_dreamfusion_cli(
        ["--config", DF_YAML, "--train", "--device", dev.type, *tiny_over])
    counts = kernels.launch_counts()
    check(len(losses) == steps // every
          and all(math.isfinite(x) for x in losses),
          f"logged losses {losses}")
    check_orbit(trial, eval_h)
    tiny = launch.build_system(cfg, dev)
    want = sd_step_launches(tiny.guidance, steps)
    del tiny
    print(f"  losses {losses[0]:.4f} (step {every}) -> {losses[-1]:.4f} "
          f"(step {steps}); {1e3 * statistics.median(step_s):.3f} ms a step "
          f"(median, host clock with a sync), wall {wall:.1f} s with the "
          f"build and the orbit; launches {counts}")
    check(counts == want, f"shipped DreamFusion launches {counts}, want "
          f"{want}")
    check(want["groupnorm_fwd"] > 0 and want["groupnorm_bwd_dx"] > 0
          and want["attention_fwd"] == 0, f"tiny prior launches {want}")

    # -- (b) full width -----------------------------------------------------
    print("phase 25b: DreamFusionSystem at full width (SD2_SINGLE_CONFIG "
          "bf16, VAEConfig() at 512^2, 16 x 2^19 x 2 hash grid, 96 samples, "
          "batch 2 at 64^2)")
    overrides = write_sd2_files(dev, tmp) + list(DF_FULL_OVERRIDES) + [
        f"exp_root_dir={runs}"]
    cfg = load_config(DF_YAML, overrides)
    t0 = time.perf_counter()
    system = launch.build_system(cfg, dev)
    torch.cuda.synchronize()
    g = system.guidance
    geo = system.renderer.geometry
    n_unet = sum(p.numel() for p in g.unet.parameters())
    n_field = sum(p.numel() for p in system.params.values())
    print(f"  build_system {time.perf_counter() - t0:.1f} s: SingleUNet "
          f"{n_unet} parameters ({g.unet.dtype}), field {n_field} "
          f"parameters (hash table {tuple(geo.encoding.table.shape)}), "
          f"{system.cfg.renderer.num_samples_per_ray} samples a ray, batch "
          f"{system.camera_cfg.batch_size} at {system.camera_cfg.height}^2")
    check(tuple(geo.encoding.table.shape) == DF_TABLE_SHAPE
          and system.cfg.renderer.num_samples_per_ray == 96
          and g.unet.dtype == torch.bfloat16
          and system.prompt_embeddings.text_vd.shape == (4, 77, 1024),
          "full-width configuration")
    want = sd_step_launches(g)

    # one checked step
    state = system.init_state(0)
    before = {k: v.detach().clone() for k, v in system.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    state, metrics = system.train_step(state)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = float(metrics["loss"])
    check(math.isfinite(loss), f"loss {loss}")
    for k, p in system.params.items():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              f"gradient of {k} not finite")
    for prefix in ("geometry.encoding.table", "geometry.density_network",
                   "geometry.feature_network", "background.mlp"):
        check(any(not torch.equal(v, before[k])
                  for k, v in system.params.items() if k.startswith(prefix)),
              f"Adam did not move {prefix}")
    print(f"  checked step: loss {loss:.6g} (sds "
          f"{float(metrics['loss_sds']):.6g}, sparsity "
          f"{float(metrics['loss_sparsity']):.6g}), peak {peak:.2f} GiB; "
          f"launches {counts}")
    check(counts == want, f"DreamFusion step launches {counts}, want {want}")

    # ms per train_step
    for _ in range(2):
        state, _ = system.train_step(state)
    times = []
    for _ in range(DF_STEP_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = system.train_step(state)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    check(math.isfinite(float(metrics["loss"])), "loss after the timed steps")
    print(f"  train_step {statistics.median(times):.3f} ms median over "
          f"{DF_STEP_REPS} ({min(times):.3f}-{max(times):.3f}), CUDA events")
    stages, state = staged_df_step(system, state)
    print("  staged: " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                   stages.items()))
    busy_us = profile_by_op("profiled train_step",
                            lambda: system.train_step(state))
    hash_grid_share(system, state, busy_us)

    # one view of the trained field on the card and on the CPU
    h = system.camera_cfg.height
    c2w = y_up_view(dev)
    got = system.render_eval(state, c2w, 0.8, h, h)
    field = copy.deepcopy(system.renderer.field).to("cpu")
    cpu = NerfVolumeRenderer(field["geometry"], field["material"],
                             field["background"], system.cfg.renderer)
    with torch.no_grad():
        want_view = cpu.render_image(c2w.cpu(), 0.8, h, h)
    worst = renders_agree("render_eval", got, want_view)
    view_ms = cuda_ms(lambda: system.render_eval(state, c2w, 0.8, h, h), 5)
    print(f"  render_eval at {h}^2: card vs CPU within {worst:.3f} of the "
          f"limits, {view_ms:.3f} ms a view (opacity max "
          f"{float(got['opacity'].max()):.4f})")
    del field, cpu, want_view

    # the CLI at this width
    kernels.reset_launch_counts()
    trial, losses, step_s, wall = run_dreamfusion_cli(
        ["--config", DF_YAML, "--train", "--device", dev.type, *overrides,
         f"trainer.max_steps={DF_CLI_STEPS}", "trainer.log_every=1"])
    check(len(losses) == DF_CLI_STEPS
          and all(math.isfinite(x) for x in losses), f"CLI losses {losses}")
    check_orbit(trial, int(cfg["data"]["eval_height"]))
    check(kernels.launch_counts() == sd_step_launches(g, DF_CLI_STEPS),
          f"CLI launches {kernels.launch_counts()}")
    print(f"  apps.launch --train, {DF_CLI_STEPS} steps: "
          f"{statistics.median(step_s[1:]):.3f} s a step (median after the "
          f"first, host clock with a sync), first {step_s[0]:.3f} s, wall "
          f"{wall:.1f} s with the build and the orbit; orbit.png written")
    return counts, system


def neus_export_phase(dev, tmp, system):
    """Phase 26: the NeuS renderer at full width and the NeRF renderer's
    importance pass, card against CPU; the exporter on phase 25's field."""
    import copy

    from humangaussian_torch.nerf.background import (
        NeuralEnvironmentMapBackground,
    )
    from humangaussian_torch.nerf.exporter import export_implicit_volume
    from humangaussian_torch.nerf.material import NeuralRadianceMaterial
    from humangaussian_torch.nerf.renderer import (
        NerfVolumeRenderer,
        RendererConfig,
    )
    from humangaussian_torch.nerf.sdf import (
        ImplicitSDF,
        ImplicitSDFConfig,
        NeusVolumeRenderer,
    )

    print(f"phase 26: NeusVolumeRenderer and the importance pass at "
          f"{NEUS_HW}^2, card vs CPU; export_implicit_volume")
    hw = NEUS_HW
    s = system.cfg.renderer.num_samples_per_ray
    gen = torch.Generator().manual_seed(26)
    c2w = y_up_view(dev, 30.0)
    jitter = torch.rand((hw * hw, s), generator=gen)

    def on(device, modules):
        return [copy.deepcopy(m).to(device) for m in modules]

    neus_mods = [ImplicitSDF(ImplicitSDFConfig(), "cpu", gen),
                 NeuralRadianceMaterial(3, device="cpu", generator=gen),
                 NeuralEnvironmentMapBackground(device="cpu", generator=gen)]
    rcfg = RendererConfig(num_samples_per_ray=s)
    out = {}
    for device in (dev, torch.device("cpu")):
        r = NeusVolumeRenderer(*on(device, neus_mods), rcfg, device=device)
        with torch.no_grad():
            out[device.type] = r.render_image(
                c2w.to(device), 0.8, hw, hw, jitter.to(device),
                cos_anneal_ratio=0.5)
        if device == dev:
            neus_ms = cuda_ms(lambda: r.render_image(
                c2w, 0.8, hw, hw, jitter.to(dev), cos_anneal_ratio=0.5), 5)
    worst = renders_agree("NeuS", out[dev.type], out["cpu"])
    op = out[dev.type]["opacity"]
    check(float(op[hw // 2, hw // 2, 0]) > 0.5, "NeuS misses the sphere")
    print(f"  NeuS (full-width ImplicitSDF, NeuralRadianceMaterial, {s} "
          f"samples): card vs CPU within {worst:.3f} of the limits, "
          f"{neus_ms:.3f} ms a view")

    fine = torch.rand((hw * hw, NEUS_IMPORTANCE), generator=gen)
    icfg = dataclasses.replace(system.cfg.renderer,
                               num_importance_samples=NEUS_IMPORTANCE)
    field = system.renderer.field
    for device in (dev, torch.device("cpu")):
        mods = ([field["geometry"], field["material"], field["background"]]
                if device == dev else on(device, field.values()))
        r = NerfVolumeRenderer(*mods, icfg)
        with torch.no_grad():
            out[device.type] = r.render_image(
                c2w.to(device), 0.8, hw, hw, jitter.to(device),
                fine.to(device))
        if device == dev:
            imp_ms = cuda_ms(lambda: r.render_image(
                c2w, 0.8, hw, hw, jitter.to(dev), fine.to(dev)), 5)
    worst = renders_agree("importance", out[dev.type], out["cpu"],
                          dict(RENDER_TOL, weights=IMPORTANCE_WEIGHTS_TOL))
    print(f"  NeRF renderer with {s} + {NEUS_IMPORTANCE} importance samples "
          f"on phase 25's field: card vs CPU within {worst:.3f} of the "
          f"limits, {imp_ms:.3f} ms a view")

    save = os.path.join(tmp, "df_export")
    t0 = time.perf_counter()
    obj = export_implicit_volume(save, system.renderer.geometry,
                                 system.renderer.material,
                                 threshold=EXPORT_THRESHOLD)
    export_s = time.perf_counter() - t0
    for name in ("model.obj", "model.mtl", "texture_kd.png"):
        check(os.path.exists(os.path.join(save, name)), f"{name} missing")
    with open(obj) as f:
        lines = f.read().splitlines()
    verts = np.array([[float(x) for x in ln.split()[1:]] for ln in lines
                      if ln.startswith("v ")])
    n_faces = sum(ln.startswith("f ") for ln in lines)
    check(len(verts) > 0 and n_faces > 0, "the exported mesh is empty")
    check(bool(np.isfinite(verts).all()) and float(np.abs(verts).max())
          <= 1.0, "the exported mesh leaves the box")
    from PIL import Image

    tex = Image.open(os.path.join(save, "texture_kd.png"))
    check(tex.size == (512, 512), f"texture {tex.size}")
    print(f"  export_implicit_volume (resolution 64, texture 512, threshold "
          f"{EXPORT_THRESHOLD}): {len(verts)} vertices, {n_faces} faces, "
          f"{export_s:.2f} s")


# ---- slice 11: ControlNet SDS, explicit geometry, the GAN renderer, DP ----

CN_TEXT = (77, 768)  # the SD 1.5 text encoder's stand-in width
CN_REPS = 3  # timed ControlNet calls with their backward, after a warm-up
CN_NORMS = 61 + 27 + 22  # UNet forward, ControlNet forward, VAE encode
EXPLICIT_HW = 256  # the tetrahedral grid's NVDiffRasterizer view
MESH_HW = 512  # CustomMesh on the SMPL-X stand-in
PATCH_HW, PATCH_SIZE, PATCH_DOWNSAMPLE = 256, 32, 4
GAN_HW = 256  # the GAN renderer's output; the NeRF renders GAN_HW / 4
VIEW_REPS = 5  # timed views / renders, after a warm-up
# card against CPU for the mesh rasterizer: the winning face may flip on
# a few pixels where two faces' depths tie within rounding (FMA contraction
# on the card); the rest within RENDER_TOL
MESH_MISMATCH_FRACTION = 1e-3
DP_LOSS_RTOL, DP_MEANS_TOL = 2e-4, 1e-5  # tests/test_torch_dist.py's
DP_REPS = 3  # timed steps of each kind, in turns, after a warm-up of each


def full_width_field(dev, n_features=3, seed=27):
    """Phase 25's full-width field (DF_FULL_OVERRIDES: a 16 x 2^19 x 2 hash
    grid from base 16, 64-neuron MLPs, 96 samples a ray, the diffuse
    material and the neural environment map) as a NeRF renderer; with
    `n_features` > 3, the hybrid rgb-latent material and a solid
    background of that width instead (the GAN renderer's base)."""
    from humangaussian_torch.nerf import background, geometry, material
    from humangaussian_torch.nerf.encoding import HashGridConfig
    from humangaussian_torch.nerf.renderer import (
        NerfVolumeRenderer,
        RendererConfig,
    )

    gen = torch.Generator().manual_seed(seed)
    geo = geometry.ImplicitVolume(geometry.ImplicitVolumeConfig(
        hash_cfg=HashGridConfig(n_levels=16, log2_hashmap_size=19,
                                base_resolution=16),
        n_neurons=64, n_hidden_layers=1, n_feature_dims=n_features), dev, gen)
    if n_features == 3:
        mat = material.DiffuseWithPointLightMaterial()
        bg = background.NeuralEnvironmentMapBackground(device=dev,
                                                       generator=gen)
    else:
        mat = material.HybridRGBLatentMaterial()
        bg = background.SolidColorBackground((1.0,) * n_features, device=dev)
    return NerfVolumeRenderer(geo, mat, bg,
                              RendererConfig(num_samples_per_ray=96))


def write_controlnet_files(dev, tmp) -> tuple:
    """Seeded bfloat16 SD 1.5 `unet/` (UNet2D(SD15_CONFIG)) and
    ControlNetModel files in diffusers layout, read back through the
    launcher's `load_state_dict_file` into fresh modules on the card."""
    from humangaussian_torch.apps.launch import load_state_dict_file
    from humangaussian_torch.guidance.controlnet import (
        SD15_CONFIG,
        ControlNet,
        UNet2D,
    )

    t0 = time.perf_counter()
    paths = {}
    for name, fn, seed in (("unet", lambda: UNet2D(SD15_CONFIG), 27),
                           ("controlnet", lambda: ControlNet(SD15_CONFIG),
                            28)):
        d = os.path.join(tmp, "sd15", name)
        os.makedirs(d)
        paths[name] = os.path.join(d, "diffusion_pytorch_model.bin")
        sd = seeded_state_dict(fn, seed, dev)
        if name == "controlnet":  # move the zero taps off zero
            g = torch.Generator().manual_seed(seed)
            sd = {k: (v.float() + 0.01 * torch.randn(v.shape, generator=g)
                      ).to(torch.bfloat16)
                  if k.startswith(("controlnet_down", "controlnet_mid",
                                   "controlnet_cond_embedding.conv_out"))
                  else v for k, v in sd.items()}
        torch.save(sd, paths[name])
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.device(dev):
        unet, net = UNet2D(SD15_CONFIG), ControlNet(SD15_CONFIG)
    unet.load_state_dict(load_state_dict_file(paths["unet"]))
    net.load_state_dict(load_state_dict_file(paths["controlnet"]))
    unet.to(memory_format=torch.channels_last)
    net.to(memory_format=torch.channels_last)
    torch.cuda.synchronize()
    print(f"  SD 1.5 unet/ and ControlNetModel files written in {write_s:.1f}"
          f" s, loaded in {time.perf_counter() - t0:.1f} s")
    return unet, net


def controlnet_phase(dev, tmp, system, smplx_path) -> dict:
    """Phase 27: ControlNetGuidance (SD 1.5 UNet and ControlNet from seeded
    files, phase 11's VAEConfig() VAE) on the avatar's 8 views at SIZE^2
    from phase 11's system, conditioned on their openpose skeletons (the
    stand-in's openpose-style skeleton, as the launcher builds it without
    texture_structure_joint), differentiated to the render. Returns the
    launches of one call."""
    from humangaussian_torch import kernels
    from humangaussian_torch.guidance.controlnet import ControlNetGuidance
    from humangaussian_torch.guidance.prompt import dummy_encode_fn
    from humangaussian_torch.guidance.schedule import sd_eps_schedule
    from humangaussian_torch.smplx.model import load_smplx_npz
    from humangaussian_torch.smplx.pose_image import draw_openpose_pose
    from humangaussian_torch.smplx.skeleton import Skeleton

    print("phase 27: ControlNetGuidance (SD 1.5 + ControlNet, bf16) on the "
          f"avatar's {system.camera_cfg.batch_size} views at "
          f"{system.camera_cfg.height}^2 with openpose skeletons")
    unet, net = write_controlnet_files(dev, tmp)
    vae = system.guidance.vae
    g = ControlNetGuidance(unet, net, vae, sd_eps_schedule(device=dev))
    n_unet = sum(p.numel() for p in unet.parameters())
    n_net = sum(p.numel() for p in net.parameters())
    norms = (norms_in(unet), norms_in(net), norms_in(vae.encoder))
    check(sum(norms) == CN_NORMS, f"norms {norms}, want 61 + 27 + 22")
    want = launches(rasterize_fwd=1, rasterize_bwd=1, rasterize_bwd_rows=1,
                    groupnorm_fwd=sum(norms),
                    groupnorm_bwd_stats=norms[2], groupnorm_bwd_dx=norms[2],
                    conv_bias_add=encode_convs(vae),
                    **vae_attention_launches(
                        vae, (g.image_size // 8) ** 2, 1, 1,
                        system.camera_cfg.batch_size))
    state = system.init_state(0)
    inputs = system.sample_step_inputs(state)
    cams = inputs.cameras
    b = cams.c2w.shape[0]
    skel = Skeleton(style="openpose", apose=True).load_smplx(
        load_smplx_npz(smplx_path)).scale(-10)
    pose, _ = draw_openpose_pose(
        torch.tensor(skel.points3d, dtype=torch.float32, device=dev),
        cams.mvp_mtx, 512, 512, cams.azimuth.abs() > 120.0)
    enc = dummy_encode_fn(*CN_TEXT)
    text = torch.from_numpy(np.concatenate(
        [enc([PROMPT])] * b + [enc([""])] * b)).to(dev)
    t = torch.randint(20, 981, (b,), generator=state.generator, device=dev)

    def call():
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in state.scene.params().items()}
        out = system.render_batch(state.scene.replace_params(leaves), cams,
                                  system.camera_cfg.height,
                                  system.camera_cfg.width)
        res = g(pose, out["image"], text, t, state.generator)
        res["loss_sds"].backward()
        return res, leaves

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res, leaves = call()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = float(res["loss_sds"].detach())
    check(math.isfinite(loss) and bool(torch.isfinite(res["grad"]).all()),
          f"ControlNet loss {loss}")
    for k, v in leaves.items():
        check(v.grad is not None and bool(torch.isfinite(v.grad).all()),
              f"ControlNet: d loss / d {k} not finite")
    check(float(leaves["means"].grad.abs().max()) > 0,
          "ControlNet: no gradient reached the render")
    check(counts == want, f"ControlNet launches {counts}, want {want}")
    times = []
    for i in range(CN_REPS + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    print(f"  UNet2D {n_unet} parameters, ControlNet {n_net}; norms "
          f"{' + '.join(map(str, norms))}; loss {loss:.6g}, grad norm "
          f"{float(res['grad_norm']):.6g}, d loss / d means max "
          f"{float(leaves['means'].grad.abs().max()):.3e}; render + call + "
          f"backward {statistics.median(times):.3f} ms median over "
          f"{CN_REPS} ({min(times):.3f}-{max(times):.3f}), CUDA events; "
          f"peak {peak:.2f} GiB; launches {counts}")
    del g, unet, net, res, leaves
    torch.cuda.empty_cache()
    return counts


def mesh_views_agree(label, got, want):
    """The mesh rasterizer's outputs on the card against the CPU's: the
    winning face equal on all but MESH_MISMATCH_FRACTION of the pixels,
    and there the outputs within RENDER_TOL of their max |value|."""
    same = got["face"].cpu() == want["face"]
    frac = 1.0 - float(same.float().mean())
    check(frac <= MESH_MISMATCH_FRACTION,
          f"{label}: the winning face differs on {frac:.2e} of the pixels")
    worst = 0.0
    for k in ("comp_rgb", "opacity", "depth", "comp_normal"):
        g, w = got[k].detach().cpu()[same], want[k].detach()[same]
        tol = RENDER_TOL.get(k, 1e-5) * max(float(w.abs().max()), 1e-6)
        err = float((g - w).abs().max()) if g.numel() else 0.0
        check(err <= tol, f"{label}: {k} off by {err:.3e} (limit {tol:.3e})")
        worst = max(worst, err / tol)
    print(f"  {label}: card vs CPU, winning face differs on {frac:.2e} of "
          f"the pixels, elsewhere within {worst:.3f} of the limits")
    return worst


def rasterize_faces(renderer, mvp):
    """A render with the winning face index beside it (from the same
    rasterization the renderer runs)."""
    from humangaussian_torch.nerf import explicit

    seen = {}
    own = explicit.rasterize_mesh

    def spy(*a, **k):
        seen["out"] = own(*a, **k)
        return seen["out"]

    explicit.rasterize_mesh = spy
    try:
        out = renderer.render(mvp)
    finally:
        explicit.rasterize_mesh = own
    out["face"] = seen["out"]["face"]
    return out


def explicit_phase(dev, assets, df_system=None):
    """Phase 28: TetrahedraSDFGrid (defaults, resolution 32) through
    NVDiffRasterizer at EXPLICIT_HW^2 forward and backward, card against
    CPU; CustomMesh on the SMPL-X stand-in at MESH_HW^2; PatchRenderer over
    phase 25's full-width field (or one built at its configuration)."""
    import copy

    from humangaussian_torch import kernels
    from humangaussian_torch.core.camera import camera_from_c2w
    from humangaussian_torch.nerf import background, explicit, material

    print(f"phase 28: TetrahedraSDFGrid + NVDiffRasterizer at "
          f"{EXPLICIT_HW}^2, CustomMesh at {MESH_HW}^2, PatchRenderer")
    kernels.reset_launch_counts()
    gen = torch.Generator().manual_seed(28)
    geo = explicit.TetrahedraSDFGrid(explicit.TetSDFGridConfig(), dev, gen)
    with torch.no_grad():  # a deformed, bumpy sphere
        geo.deformation.normal_(0.0, 0.3, generator=torch.Generator(
            device=dev).manual_seed(28))
    r = explicit.NVDiffRasterizer(
        geo, material.DiffuseWithPointLightMaterial(),
        background.SolidColorBackground((0.2, 0.3, 0.4), device=dev),
        EXPLICIT_HW, EXPLICIT_HW)
    c2w = y_up_view(dev, 30.0)
    cam = camera_from_c2w(c2w, torch.tensor(0.8, device=dev), EXPLICIT_HW,
                          EXPLICIT_HW)
    mvp = cam.full_proj
    cot = torch.randn((EXPLICIT_HW, EXPLICIT_HW, 3), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    tris, mask = geo.isosurface()
    out = rasterize_faces(r, mvp)
    (out["comp_rgb"] * cot).sum().backward()
    for name in ("sdf", "deformation"):
        grad = getattr(geo, name).grad
        check(grad is not None and bool(torch.isfinite(grad).all())
              and float(grad.abs().max()) > 0,
              f"tetrahedra grid: d loss / d {name} not finite or zero")
    live = int(mask.sum())
    cover = float(out["opacity"].mean())
    check(live > 0 and 0.0 < cover < 1.0, f"{live} triangles, cover {cover}")
    cpu_geo = copy.deepcopy(geo).to("cpu")
    cpu_r = explicit.NVDiffRasterizer(
        cpu_geo, material.DiffuseWithPointLightMaterial(),
        background.SolidColorBackground((0.2, 0.3, 0.4), device="cpu"),
        EXPLICIT_HW, EXPLICIT_HW)
    with torch.no_grad():
        want = rasterize_faces(cpu_r, mvp.cpu())
    mesh_views_agree("tetrahedra grid view", out, want)

    def fwd():
        with torch.no_grad():
            r.render(mvp)

    def fwd_bwd():
        geo.zero_grad(set_to_none=True)
        (r.render(mvp)["comp_rgb"] * cot).sum().backward()

    view_ms = cuda_ms(fwd, VIEW_REPS)
    grad_ms = cuda_ms(fwd_bwd, VIEW_REPS)
    print(f"  tetrahedra grid (resolution 32: {tris.shape[0]} triangle "
          f"slots, {live} live), {cover:.3f} of the view covered; "
          f"{view_ms:.3f} ms a view, {grad_ms:.3f} ms with the backward")
    del geo, r, cpu_geo, cpu_r, out, want

    # CustomMesh on the stand-in's template mesh, centred and scaled into
    # the unit box
    d = np.load(assets[0])
    verts = d["v_template"].astype(np.float32)
    verts = (verts - verts.mean(0)) / np.abs(verts - verts.mean(0)).max() \
        * 0.9
    mesh = explicit.CustomMesh(verts, d["f"].astype(np.int64),
                               explicit.CustomMeshConfig(), dev, gen)
    mr = explicit.NVDiffRasterizer(
        mesh, material.DiffuseWithPointLightMaterial(),
        background.SolidColorBackground((0.0, 0.0, 0.0), device=dev),
        MESH_HW, MESH_HW)
    mvp = camera_from_c2w(y_up_view(dev), torch.tensor(0.8, device=dev),
                          MESH_HW, MESH_HW).full_proj
    with torch.no_grad():
        out = mr.render(mvp, camera_position=y_up_view(dev)[:3, 3],
                        light_positions=torch.tensor([1.0, 2.0, 3.0],
                                                     device=dev))
    cover = float(out["opacity"].mean())
    check(bool(torch.isfinite(out["comp_rgb"]).all()) and 0.0 < cover < 1.0,
          f"CustomMesh view: cover {cover}")
    mesh_ms = cuda_ms(lambda: mr.render(mvp), VIEW_REPS)
    print(f"  CustomMesh ({verts.shape[0]} vertices, {d['f'].shape[0]} "
          f"faces) at {MESH_HW}^2: {cover:.3f} covered, {mesh_ms:.3f} ms a "
          f"view (no grad)")
    del mesh, mr

    # PatchRenderer over the full-width field
    base = (df_system.renderer if df_system is not None
            else full_width_field(dev))
    pr = explicit.PatchRenderer(base, PATCH_SIZE, PATCH_DOWNSAMPLE)
    c2w = y_up_view(dev, 15.0)
    with torch.no_grad():
        out = pr.render_image(c2w, 0.8, PATCH_HW, PATCH_HW,
                              generator=torch.Generator(device=dev)
                              .manual_seed(28))
        y0, x0 = out["patch_origin"]
        check(out["global"]["comp_rgb"].shape == (
            PATCH_HW // PATCH_DOWNSAMPLE, PATCH_HW // PATCH_DOWNSAMPLE, 3)
            and out["patch"]["comp_rgb"].shape == (PATCH_SIZE, PATCH_SIZE, 3)
            and all(bool(torch.isfinite(v).all()) for part in
                    ("global", "patch") for v in out[part].values()),
            "PatchRenderer outputs")
        fixed = pr.render_image(c2w, 0.8, PATCH_HW, PATCH_HW,
                                patch_origin=(y0, x0))
        field = copy.deepcopy(base.field).to("cpu")
        from humangaussian_torch.nerf.renderer import NerfVolumeRenderer

        cpu = explicit.PatchRenderer(NerfVolumeRenderer(
            field["geometry"], field["material"], field["background"],
            base.cfg), PATCH_SIZE, PATCH_DOWNSAMPLE)
        want = cpu.render_image(c2w.cpu(), 0.8, PATCH_HW, PATCH_HW,
                                patch_origin=(y0, x0))
    # the patch is a window of the image whose scale the global view
    # gives: each output's limit is RENDER_TOL of the larger of the two
    # parts' max |value|
    worst = 0.0
    for part in ("global", "patch"):
        tol = {k: RENDER_TOL[k] * max(
            float(want["global"][k].abs().max()),
            float(want["patch"][k].abs().max()))
            / max(float(want[part][k].abs().max()), 1e-30)
            for k in RENDER_TOL if k in want[part]}
        worst = max(worst, renders_agree(f"patch renderer {part}",
                                         fixed[part], want[part], tol))
    patch_ms = cuda_ms(lambda: pr.render_image(
        c2w, 0.8, PATCH_HW, PATCH_HW, generator=torch.Generator(
            device=dev).manual_seed(28)), VIEW_REPS)
    print(f"  PatchRenderer ({'phase 25' if df_system else 'a fresh'} "
          f"full-width field, {PATCH_HW}^2, patch {PATCH_SIZE} at "
          f"({y0}, {x0}), global 1/{PATCH_DOWNSAMPLE}): card vs CPU within "
          f"{worst:.3f} of the limits, {patch_ms:.3f} ms a render (no grad)")
    counts = kernels.launch_counts()
    check(set(counts.values()) == {0}, f"explicit phase launched {counts}")


def gan_norm_launches(r, level: int) -> dict:
    """The launches of one GAN render at `level` with the generator and
    discriminator losses and their backwards, from the module trees: every
    norm of the generator and the global encoder (and at level 2 the local
    encoder) once, the discriminator's three times (the fake for the
    generator loss, the real and the fake for its own), forward and
    backward alike."""
    n = (norms_in(r.generator) + norms_in(r.global_encoder)
         + 3 * norms_in(r.discriminator)
         + (norms_in(r.local_encoder) if level == 2 else 0))
    return launches(groupnorm_fwd=n, groupnorm_bwd_stats=n,
                    groupnorm_bwd_dx=n)


def gan_phase(dev):
    """Phase 29: GANVolumeRenderer(GANRendererConfig()) over the full-width
    field of phase 25's configuration with the hybrid rgb-latent material
    (3 + 2 x 4 features), GAN_HW / 4 -> GAN_HW: each generator level with
    the generator and discriminator losses differentiated."""
    from humangaussian_torch import kernels
    from humangaussian_torch.nerf.gan import (
        GANRendererConfig,
        GANVolumeRenderer,
        discriminator_loss,
        generator_loss,
    )

    print(f"phase 29: GANVolumeRenderer {GAN_HW // 4}^2 -> {GAN_HW}^2 over "
          "the full-width field (hybrid-rgb-latent-material)")
    cfg = GANRendererConfig()
    base = full_width_field(dev, 3 + 2 * cfg.z_channels, seed=29)
    torch.manual_seed(29)
    r = GANVolumeRenderer(base, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(29)
    gt = torch.rand((GAN_HW, GAN_HW, 3), generator=gen, device=dev)
    c2w = y_up_view(dev, 45.0)
    params = list(r.nets.parameters()) + list(base.field.parameters())
    for level in (0, 1, 2):
        for p in params:
            p.grad = None
        kernels.reset_launch_counts()
        out = r.render_image(c2w, 0.8, GAN_HW, GAN_HW, generator=gen,
                             gt_rgb=gt, multi_level_guidance=True,
                             level=level)
        fake = out["comp_gan_rgb"][None]
        g_loss = generator_loss(r.discriminator, fake)
        g_loss.backward()
        d_loss = discriminator_loss(r.discriminator, gt[None], fake)
        d_loss.backward()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check(out["generator_level"] == level
              and tuple(out["comp_gan_rgb"].shape) == (GAN_HW, GAN_HW, 3)
              and all(bool(torch.isfinite(out[k]).all()) for k in
                      ("comp_gan_rgb", "comp_rgb", "comp_lr_rgb",
                       "posterior_kl"))
              and math.isfinite(float(g_loss.detach()))
              and math.isfinite(float(d_loss.detach())),
              f"GAN level {level} outputs")
        for name, net in (("generator", r.generator),
                          ("discriminator", r.discriminator),
                          ("base field", base.field)):
            grads = [p.grad for p in net.parameters() if p.grad is not None]
            check(grads and all(bool(torch.isfinite(x).all())
                                for x in grads)
                  and max(float(x.abs().max()) for x in grads) > 0,
                  f"GAN level {level}: {name} gradients")
        want = gan_norm_launches(r, level)
        check(counts == want, f"GAN level {level} launches {counts}, want "
              f"{want}")
        print(f"  level {level}: generator loss {float(g_loss.detach()):.6g}, "
              f"discriminator loss {float(d_loss.detach()):.6g}, posterior KL "
              f"{float(out['posterior_kl'].detach()):.6g}; launches "
              f"{counts}")

    def render():
        with torch.no_grad():
            r.render_image(c2w, 0.8, GAN_HW, GAN_HW)

    ms = cuda_ms(render, VIEW_REPS)
    print(f"  {norms_in(r.nets)} GroupNorms in the four networks; "
          f"{ms:.3f} ms a render (mode path, no grad)")
    del r, base


def clone_state(state):
    """A deep copy of a TrainState (the step updates parameters and
    moments in place), the generator's state included."""
    def c(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, dict):
            return {k: c(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[c(v) for v in x])
        return x

    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    return c(state._replace(generator=None))._replace(generator=gen)


@contextlib.contextmanager
def deterministic_step():
    """Inside, torch's deterministic algorithms are on, strict (cuDNN's
    deterministic convolutions, `index_add_` sorted, cuBLAS only with a
    fixed workspace): an op without a deterministic implementation
    raises. The context yields the caught warnings. No wrapper is swapped:
    every kernel of the port stays on the path (each adds in a fixed
    order). Only phase 30's comparison uses it."""
    was = torch.are_deterministic_algorithms_enabled()
    was_warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(was, warn_only=was_warn_only)


def nondeterministic_ops(caught) -> list:
    """What torch's warnings about determinism name: the op of a "does not
    have a deterministic implementation" warning, "cuBLAS" for the warning
    that cuBLAS's workspace is not fixed (CUBLAS_WORKSPACE_CONFIG), any
    other warning that mentions determinism whole."""
    ops = set()
    for w in caught:
        msg = str(w.message)
        if "deterministic" not in msg.lower():
            continue
        if "does not have a deterministic" in msg:
            ops.add(msg.split(" does not have")[0])
        elif "cublas" in msg.lower():
            ops.add("cuBLAS")
        else:
            ops.add(msg)
    return sorted(ops)


def step_diffs(a, b) -> tuple:
    """(relative loss difference, max |means difference|, max_radii2d
    equal, generator states equal) of two (state, metrics) step results."""
    (sa, ma), (sb, mb) = a, b
    la, lb = float(ma["loss"]), float(mb["loss"])
    return (abs(la - lb) / abs(lb),
            float((sa.scene.means - sb.scene.means).abs().max()),
            torch.equal(sa.densify.max_radii2d, sb.densify.max_radii2d),
            torch.equal(sa.generator.get_state(), sb.generator.get_state()))


def dist_phase(dev, system) -> dict:
    """Phase 30: `multihost_init` (NCCL, world size 1, torchrun's
    variables set here) and `make_dp_train_step` on phase 11's system
    against `train_step` from copies of one state, every kernel on the
    path: in `deterministic_step` (strict: no op may lack a deterministic
    implementation, and none may warn about determinism) `train_step` must
    repeat itself bit for bit and the DP step is held to
    tests/test_torch_dist.py's limits; with
    torch's deterministic algorithms off, and with cuDNN's deterministic
    convolutions alone, what still differs from run to run is printed.
    Returns the launches of one DP step."""
    import socket

    import torch.distributed as dist

    from humangaussian_torch import kernels
    from humangaussian_torch.dist.parallel import (
        make_dp_train_step,
        multihost_init,
    )

    print("phase 30: make_dp_train_step over NCCL at world size 1 on phase "
          "11's system")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)),
                 ("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        os.environ.setdefault(k, v)
    try:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        check(multihost_init() and dist.get_backend() == backend
              and dist.get_world_size() == 1, f"{backend} process group")
        dp_step = make_dp_train_step(system)
        state0 = system.init_state(0)

        want = dual_branch_step_launches(system.guidance)
        # every kernel on the path, torch's deterministic algorithms on,
        # strict: an op without a deterministic implementation raises
        with deterministic_step() as caught:
            ref = system.train_step(clone_state(state0))
            again = system.train_step(clone_state(state0))
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            dp = dp_step(clone_state(state0))
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        warned = nondeterministic_ops(caught)
        check(counts == want, f"DP step launches {counts}, want {want}")
        check(all(math.isfinite(float(v)) for v in dp[1].values()),
              "DP metrics not finite")
        d_dp, d_again = step_diffs(dp, ref), step_diffs(again, ref)
        print(f"  on the kernels, torch's deterministic algorithms on "
              f"(strict): train_step against itself: loss relative "
              f"{d_again[0]:.3e}, means within {d_again[1]:.3e}; DP step "
              f"against train_step: loss {float(dp[1]['loss']):.9g} vs "
              f"{float(ref[1]['loss']):.9g} (relative {d_dp[0]:.3e}), means "
              f"within {d_dp[1]:.3e}; warned about determinism: "
              f"{warned or 'none'}; launches {counts}")
        check(not warned, f"ops warned about determinism: {warned}")
        check(d_again[0] == 0.0 and d_again[1] == 0.0 and d_again[2]
              and d_again[3], "train_step does not repeat itself bit for bit "
              "on the kernels")
        check(d_dp[0] <= DP_LOSS_RTOL, f"DP loss off by {d_dp[0]:.3e}")
        check(d_dp[1] <= DP_MEANS_TOL, f"DP means off by {d_dp[1]:.3e}")
        check(d_dp[2] and d_dp[3], "DP max_radii2d or generator state")

        # what still differs without the flag: all of it off, then cuDNN's
        # deterministic convolutions alone
        off = step_diffs(system.train_step(clone_state(state0)),
                         system.train_step(clone_state(state0)))
        was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            cudnn = step_diffs(system.train_step(clone_state(state0)),
                               system.train_step(clone_state(state0)))
        finally:
            torch.backends.cudnn.deterministic = was
        print(f"  torch's deterministic algorithms off: train_step against "
              f"itself: loss relative {off[0]:.3e}, means within "
              f"{off[1]:.3e}; with cuDNN's deterministic convolutions alone: "
              f"loss relative {cudnn[0]:.3e}, means within {cudnn[1]:.3e}")

        times = {"dp": [], "ref": []}
        st = {"dp": clone_state(state0), "ref": clone_state(state0)}
        fns = {"dp": dp_step, "ref": system.train_step}
        for kind in ("dp", "ref"):
            st[kind], _ = fns[kind](st[kind])
        for kind in ("ref", "dp") * DP_REPS:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            st[kind], _ = fns[kind](st[kind])
            end.record()
            end.synchronize()
            times[kind].append(start.elapsed_time(end))
        print(f"  ms per step (median of {DP_REPS}, in turns, CUDA events): "
              f"DP {statistics.median(times['dp']):.3f} "
              f"({min(times['dp']):.3f}-{max(times['dp']):.3f}), train_step "
              f"{statistics.median(times['ref']):.3f} "
              f"({min(times['ref']):.3f}-{max(times['ref']):.3f})")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return counts

if __name__ == "__main__":
    sys.exit(main())
