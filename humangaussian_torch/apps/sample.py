"""CLI: text -> (image, depth) sampling with the dual-branch prior.

Port of humangaussian_tpu/apps/sample.py, same flags plus `--device`
(default cuda). Builds the avatar system from the config (the prior, the
prompt embeddings and the skeleton), draws the skeleton from the test
orbit's single view, denoises the rgb and depth latents jointly over
`--steps` DDIM steps conditioned on it (`DualBranchGuidance.sample_joint`,
the CFG pair in one UNet batch) and writes the image, the depth and the
pose image side by side.

  python -m humangaussian_torch.apps.sample --config configs/avatar.yaml \\
      --prompt "A man in a suit" --azimuth 0 --out sample.png
"""
from __future__ import annotations

import argparse

import torch


def main(argv=None) -> str:
    """Run the CLI; returns the written path."""
    from humangaussian_torch import resolve_device
    from humangaussian_torch.apps.launch import build_system
    from humangaussian_torch.config import load_config
    from humangaussian_torch.data.cameras import (
        RandomCameraConfig,
        eval_camera_batch,
    )
    from humangaussian_torch.utils.saving import save_image_grid

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--prompt", required=True)
    parser.add_argument("--azimuth", type=float, default=0.0)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="sample.png")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = load_config(
        args.config,
        args.overrides + [f"system.prompt_processor.prompt={args.prompt}"])
    system = build_system(cfg, dev)

    cams = eval_camera_batch(RandomCameraConfig(n_test_views=1), "test", dev)
    pose = system.pose_images(cams)
    text2 = system.prompt_embeddings.get_text_embeddings(
        torch.zeros(1, device=dev),
        torch.full((1,), args.azimuth, device=dev))[:2]  # [cond | neg]
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    images, depths = system.guidance.sample_joint(pose, text2, generator,
                                                  num_steps=args.steps)
    save_image_grid(args.out, [x[0].cpu().numpy()
                               for x in (images, depths, pose)])
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
