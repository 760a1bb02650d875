"""CLI: animate a trained avatar with an AMASS motion and write a video.

Port of humangaussian_tpu/apps/animate.py, same flags plus `--device`
(default cuda). Loads the avatar PLY with the animation axis shim, binds
it to the SMPL-X mesh once, re-poses it per motion frame and renders each
frame with the tiled rasterizer (one compositing launch per frame) from a
fixed or orbiting camera.

  python -m humangaussian_torch.apps.animate --ply last.ply \\
      --motion motion.npz --smplx_path SMPLX_NEUTRAL.npz --out anim.mp4
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from humangaussian_torch.utils.profiling import trace_annotation


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ply", required=True)
    parser.add_argument("--motion", required=True, help="AMASS npz")
    parser.add_argument("--smplx_path", required=True)
    parser.add_argument("--gender", default="neutral")
    parser.add_argument("--out", default="animation.mp4")
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--radius", type=float, default=2.0)
    parser.add_argument("--rotate", action="store_true")
    parser.add_argument("--max_frames", type=int, default=0)
    parser.add_argument("--fps", type=int, default=30)
    parser.add_argument("--device", default="cuda")
    return parser


def frame_camera(i: int, n: int, size: int, radius: float, rotate: bool,
                 device):
    """The CLI's camera for frame i of n: looking at the origin from
    `radius`, orbiting once over the motion when `rotate`."""
    from humangaussian_torch.core.camera import camera_from_c2w, look_at_c2w

    angle = 2 * math.pi * i / n if rotate else 0.0
    f32 = dict(dtype=torch.float32, device=device)
    # each host value's copy to the card waits for the stream
    with trace_annotation("hg.read.frame_camera"):
        eye = torch.tensor(
            [radius * math.sin(angle), 0.3, radius * math.cos(angle)], **f32
        )
    with trace_annotation("hg.read.frame_camera"):
        up = torch.tensor([0.0, 1.0, 0.0], **f32)
    c2w = look_at_c2w(eye, torch.zeros(3, **f32), up)
    return camera_from_c2w(c2w, 0.9, size, size)


def render_motion_frame(animator, body_pose, i: int, n: int, args,
                        background) -> np.ndarray:
    """Frame i of n: re-pose to `body_pose` [21,3], render, copy to host
    as an [H,W,3] float array."""
    from humangaussian_torch.smplx.lbs import SMPLXPose

    with trace_annotation("hg.frame"):
        dev = background.device
        cam = frame_camera(i, n, args.size, args.radius, args.rotate, dev)
        with trace_annotation("hg.read.frame_pose"):
            body_pose = torch.from_numpy(body_pose).to(dev)
        out = animator.render_frame(SMPLXPose.rest(body_pose=body_pose), cam,
                                    background)
        with trace_annotation("hg.read.frame"):
            return out["image"].cpu().numpy()


def main(argv=None):
    """Run the CLI; returns (path written, list of [H,W,3] frames)."""
    from humangaussian_torch import resolve_device
    from humangaussian_torch.animation import (
        AvatarAnimator,
        load_amass_body_poses,
    )
    from humangaussian_torch.convert import smplx_from_numpy
    from humangaussian_torch.io.ply import load_ply
    from humangaussian_torch.smplx.model import load_smplx_npz
    from humangaussian_torch.utils.saving import save_video

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    scene = load_ply(args.ply, animation_convention=True, device=dev)
    model = smplx_from_numpy(load_smplx_npz(args.smplx_path,
                                            gender=args.gender), dev)
    animator = AvatarAnimator(scene, model)
    print(f"bound {animator.n_gaussians} gaussians to the SMPL-X mesh")

    body_poses = load_amass_body_poses(args.motion)
    if args.max_frames:
        body_poses = body_poses[: args.max_frames]

    bg = torch.ones((3,), dtype=torch.float32, device=dev)
    frames = []
    n = len(body_poses)
    for i, bp in enumerate(body_poses):
        frames.append(render_motion_frame(animator, bp, i, n, args, bg))
        if (i + 1) % 10 == 0:
            print(f"frame {i + 1}/{n}")

    path = save_video(args.out, frames, fps=args.fps)
    print(f"wrote {path}")
    return path, frames


if __name__ == "__main__":
    main()
