"""CLI launcher: train from a YAML config plus dotlist overrides.

Port of humangaussian_tpu/apps/launch.py: `--config`, `--train`, the
`key.sub=value` overrides, plus `--device` (default cuda; raises when
there is none):

  python -m humangaussian_torch.apps.launch --config configs/photo.yaml \\
      --train data.dataroot=/path/to/scene

Ported so far: `system.type: photo-3dgs-system`, the photometric 3DGS
trainer (train/photo.py) on a Blender-layout or COLMAP dataset; it writes
`save/last.ply` under the trial directory. The text-to-avatar system and
the dreamfusion system are not ported yet and raise NotImplementedError.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil

import numpy as np


def _take(dc_cls, src: dict):
    fields = {f.name for f in dataclasses.fields(dc_cls)}
    return dc_cls(**{k: v for k, v in src.items() if k in fields})


def build_system(cfg: dict, device="cuda"):
    stype = cfg.get("system", {}).get("type", "gaussiandreamer-system")
    if stype == "photo-3dgs-system":
        return _build_photo_trainer(cfg, device)
    if stype == "gaussiandreamer-system":
        raise NotImplementedError(
            "gaussiandreamer-system is not ported yet (ROADMAP.md queue 1: "
            "guidance, items 7-10, and train/system, item 14)")
    if stype == "dreamfusion-system":
        raise NotImplementedError(
            "dreamfusion-system is not ported yet (ROADMAP.md queue 1 item "
            "21, the NeRF stack)")
    raise ValueError(
        f"unknown system.type {stype!r}; expected gaussiandreamer-"
        "system, dreamfusion-system or photo-3dgs-system"
    )


def _build_photo_trainer(cfg: dict, device="cuda"):
    """system.type: photo-3dgs-system — the photometric 3DGS trainer fed by
    a posed-image dataset: data.type blender or colmap (multiview and co3d
    are not ported yet)."""
    from humangaussian_torch.train.photo import (
        PhotoTrainConfig,
        PhotoTrainer,
    )

    sys_cfg = cfg.get("system", {})
    data_cfg = dict(cfg.get("data", {}))
    dtype_ = data_cfg.pop("type", "blender")
    if dtype_ == "blender":
        from humangaussian_torch.data.photo import load_blender

        dataset = load_blender(
            data_cfg["dataroot"],
            white_background=bool(sys_cfg.get("white_background", False)),
        )
    elif dtype_ == "colmap":
        from humangaussian_torch.data.photo import load_colmap

        dataset = load_colmap(data_cfg["dataroot"])
    elif dtype_ in ("multiview", "co3d"):
        raise ValueError(
            f"data.type {dtype_!r} is not ported yet (ROADMAP.md queue 1 "
            "item 20); use blender or colmap")
    else:
        raise ValueError(
            f"unknown data.type {dtype_!r} for photo-3dgs-system; expected "
            "blender, colmap, multiview or co3d"
        )

    trainer = PhotoTrainer(_take(PhotoTrainConfig, sys_cfg), dataset.extent,
                           device=device)
    if dataset.points is not None and len(dataset.points):
        pts = np.asarray(dataset.points, np.float32)
        colors = (
            np.asarray(dataset.point_colors, np.float32)
            if dataset.point_colors is not None
            else np.full_like(pts, 0.5)
        )
    else:
        # no sparse points (blender): random points in a cube, like
        # upstream's dataset_readers fallback
        rs = np.random.RandomState(0)
        n0 = int(sys_cfg.get("init_points", 10_000))
        pts = (rs.rand(n0, 3).astype(np.float32) * 2 - 1) * (
            dataset.extent * 0.5
        )
        colors = rs.rand(n0, 3).astype(np.float32)
    return ("photo", trainer, dataset, pts, colors)


def _run_photo(bundle, cfg, dirs):
    from humangaussian_torch.io.ply import save_ply
    from humangaussian_torch.train.photo import train_photo

    _tag, trainer, dataset, pts, colors = bundle
    seed = int(cfg.get("seed", 0))
    trainer_cfg = cfg.get("trainer", {})
    state = trainer.init_state(seed, pts, colors)
    iters = int(trainer_cfg.get("max_steps", trainer.cfg.iterations))
    state = train_photo(trainer, state, dataset, iterations=iters,
                        rng=np.random.default_rng(seed),
                        log_every=int(trainer_cfg.get("log_every", 100)))
    if dataset.test:
        metrics = trainer.evaluate(state.scene, dataset.test)
        print(f"photo eval: psnr={metrics['psnr']:.2f} "
              f"ssim={metrics['ssim']:.3f}")
    save_ply(state.scene, os.path.join(dirs["save"], "last.ply"))
    return state


def main(argv=None):
    """Run the CLI; returns the trial directory."""
    from humangaussian_torch import resolve_device
    from humangaussian_torch.config import ExperimentConfig, load_config

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = load_config(args.config, args.overrides)
    exp = ExperimentConfig(
        name=cfg.get("name", "default"),
        tag=str(cfg.get("tag", "")),
        exp_root_dir=cfg.get("exp_root_dir", "outputs"),
        seed=int(cfg.get("seed", 0)),
    )
    dirs = exp.make_dirs()
    shutil.copy(args.config, os.path.join(dirs["configs"], "raw.yaml"))

    system = build_system(cfg, dev)
    if args.train:
        _run_photo(system, cfg, dirs)
    return dirs["trial"]


if __name__ == "__main__":
    main()
