"""CLI launcher: train from a YAML config plus dotlist overrides.

Port of humangaussian_tpu/apps/launch.py: `--config`, `--train`, `--test`,
`--resume <ckpt dir>`, the `key.sub=value` overrides, plus `--device`
(default cuda; raises when there is none):

  python -m humangaussian_torch.apps.launch --config configs/avatar.yaml \\
      --train system.prompt_processor.prompt="a man in a suit"

`system.type: gaussiandreamer-system` (the shipped text-to-avatar path)
builds the SMPL-X skeleton from `system.smplx_path`, the prompt embeddings
(the processor's md5 cache, else a host CLIP or, for DeepFloyd, T5 encoder
from `system.prompt_processor.pretrained_model_name_or_path`), the prior
from diffusers-layout weight files (`build_guidance` for the dual-branch
prior; `build_deep_floyd` for `system.guidance.type: deep-floyd`, the
IF-I-XL UNet of `model_key/unet/`) and the camera, trainer, optimizer and
rasterizer configurations; `main` then runs
`init_state` with the seed, `--resume`, `train/loop.run_training` and
`finalize` (orbit video, `last.ply`, `ckpts/last`) and prints `artifacts in
<save dir>`. The TensorBoard logger is built only when an event writer
imports (the line printed otherwise says so), the CSV logger always, wandb
with `trainer.wandb`. `system.type: photo-3dgs-system` is the photometric
3DGS trainer (train/photo.py) on `data.type` blender, colmap, multiview
or co3d:

  python -m humangaussian_torch.apps.launch --config configs/photo.yaml \\
      --train data.type=multiview data.dataroot=/path/to/capture

Not ported yet, and raising NotImplementedError: `dreamfusion-system`
(ROADMAP item 21).

Both priors are built on the meta device and materialized on the card
(the IF-I-XL UNet is 6.8B parameters); a `.bin` weight file is read
through `torch.load(mmap=True)`, so the host holds no second copy.
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
        return _build_avatar_system(cfg, device)
    if stype == "dreamfusion-system":
        raise NotImplementedError(
            "dreamfusion-system is not ported yet (ROADMAP.md queue 1 item "
            "21, the NeRF stack)")
    raise ValueError(
        f"unknown system.type {stype!r}; expected gaussiandreamer-"
        "system, dreamfusion-system or photo-3dgs-system"
    )


def _build_avatar_system(cfg: dict, device="cuda"):
    """system.type: gaussiandreamer-system with the dual-branch prior."""
    from humangaussian_torch import resolve_device
    from humangaussian_torch.data.cameras import RandomCameraConfig
    from humangaussian_torch.guidance.prompt import (
        PromptProcessor,
        PromptProcessorConfig,
    )
    from humangaussian_torch.ops.projection import RasterizeConfig
    from humangaussian_torch.smplx.model import load_smplx_npz
    from humangaussian_torch.smplx.skeleton import Skeleton
    from humangaussian_torch.train.optim import GaussianOptimConfig
    from humangaussian_torch.train.system import (
        GaussianDreamerConfig,
        GaussianDreamerSystem,
    )

    dev = resolve_device(device)
    sys_cfg = cfg.get("system", {})
    gtype = sys_cfg.get("guidance", {}).get("type", "dual-branch")

    model = load_smplx_npz(sys_cfg["smplx_path"],
                           gender=sys_cfg.get("gender", "neutral"))
    skel = Skeleton(
        style="humansd" if sys_cfg.get("texture_structure_joint", True)
        else "openpose",
        apose=sys_cfg.get("apose", True),
    ).load_smplx(model).scale(-10)

    pp_raw = dict(sys_cfg.get("prompt_processor", {}))
    pp_raw.setdefault("model_path",
                      pp_raw.pop("pretrained_model_name_or_path", ""))
    # DeepFloyd conditions on T5 embeddings; an explicit encoder_type wins
    pp_raw.setdefault("encoder_type",
                      "t5" if gtype == "deep-floyd" else "clip")
    embeddings = PromptProcessor(_take(PromptProcessorConfig, pp_raw),
                                 device=dev)()
    if gtype == "deep-floyd":
        guidance = build_deep_floyd(cfg, dev, embeddings)
    else:
        guidance = build_guidance(cfg, dev)
    return GaussianDreamerSystem(
        _take(GaussianDreamerConfig, sys_cfg), skel, guidance, embeddings,
        camera_cfg=_take(RandomCameraConfig, cfg.get("data", {})),
        optim_cfg=_take(GaussianOptimConfig, sys_cfg.get("optimizer", {})),
        raster_cfg=_take(RasterizeConfig, sys_cfg.get("rasterizer", {})),
        device=dev,
    )


def _find_weights(root: str, subfolder: str) -> str:
    """The diffusers weight file under root[/subfolder], or root itself
    when it is a file."""
    base = os.path.join(root, subfolder) if subfolder else root
    for name in (
        "diffusion_pytorch_model.safetensors",
        "diffusion_pytorch_model.bin",
        "model.safetensors",
        "pytorch_model.bin",
    ):
        cand = os.path.join(base, name)
        if os.path.exists(cand):
            return cand
    if os.path.isfile(base):
        return base
    raise FileNotFoundError(f"no weight file under {base!r}")


def load_state_dict_file(path: str) -> dict:
    """A diffusers weight file as a dict of CPU tensors: `.safetensors`
    through the `safetensors` package (an ImportError names it when it is
    missing), anything else through `torch.load(weights_only=True,
    mmap=True)`: the tensors stay in the file's pages until they are
    copied."""
    import torch

    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as exc:
            raise ImportError(
                f"{path} needs the `safetensors` package, which is not "
                "installed; convert the file to a .bin state dict") from exc
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def _load_into(module, path: str, dtype, bf16_weights: bool, dev,
               upgrade=None):
    """Materialize a meta-device module on `dev` from a weight file: a
    tensor the file lacks raises KeyError naming it, one the module lacks
    prints a warning; then the weights are cast (`cast_weights`) and the
    module is put in the channels_last memory format its activations use."""
    import torch

    from humangaussian_torch.guidance.unet import cast_weights

    module.to_empty(device=dev)
    state = load_state_dict_file(path)
    if upgrade is not None:
        state = upgrade(state)
    missing, unexpected = module.load_state_dict(state, strict=False)
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} of the model's "
                       f"tensors, e.g. {missing[:3]}")
    if unexpected:
        print(f"warning: {len(unexpected)} unmatched keys in {path}, "
              f"e.g. {unexpected[:3]}")
    del state
    cast_weights(module, dtype, round_to_bf16=bf16_weights)
    return module.to(memory_format=torch.channels_last)


def build_deep_floyd(cfg: dict, device="cuda", embeddings=None):
    """The DeepFloyd IF guidance of `system.guidance` (type deep-floyd)
    behind the system's guidance call, on `device`.

    `arch` is `if-xl` (or `sd2-base`, the shared default: IF_I_XL_CONFIG)
    or `tiny` (TINY_IF_CONFIG, 16^2 pixels unless the config says
    otherwise); `model_key` holds `unet/` in diffusers layout;
    `half_precision_weights` (the default) rounds every floating weight
    through bfloat16, as `build_guidance` does. `embeddings` rides into
    the adapter for `use_perp_neg`."""
    import torch

    from humangaussian_torch import resolve_device
    from humangaussian_torch.guidance.deep_floyd import (
        IF_I_XL_CONFIG,
        TINY_IF_CONFIG,
        DeepFloydConfig,
        DeepFloydGuidance,
        DeepFloydSystemGuidance,
    )
    from humangaussian_torch.guidance.schedule import if_schedule
    from humangaussian_torch.guidance.unet import SingleUNet

    dev = resolve_device(device)
    g_raw = dict(cfg.get("system", {}).get("guidance", {}))
    arch = g_raw.get("arch", "sd2-base")
    if arch == "tiny":
        unet_cfg = TINY_IF_CONFIG
        g_raw.setdefault("image_size", 16)
    elif arch in ("sd2-base", "if-xl"):
        unet_cfg = IF_I_XL_CONFIG
    else:
        raise ValueError(f"unknown deep-floyd arch {arch!r}; expected "
                         "'if-xl', 'sd2-base' or 'tiny'")
    with torch.device("meta"):
        unet = SingleUNet(unet_cfg)
    _load_into(unet, _find_weights(g_raw["model_key"], "unet"),
               unet_cfg.dtype,
               bool(g_raw.get("half_precision_weights", True)), dev)
    return DeepFloydSystemGuidance(
        DeepFloydGuidance(unet, if_schedule(device=dev),
                          _take(DeepFloydConfig, g_raw)),
        embeddings=embeddings)


def build_guidance(cfg: dict, device="cuda"):
    """The dual-branch prior of `system.guidance`, on `device`.

    `arch` is `sd2-base` (SD2_BASE_CONFIG, VAEConfig()) or `tiny` (the test
    widths, 16^2 images and 8^2 latents unless the config says otherwise);
    `system.guidance.unet.*` overrides architecture fields; `model_key`
    holds `unet_ema/` and `vae_key` the VAE, both in diffusers layout.
    The prior computes in its configuration's dtype (bfloat16 for sd2-base,
    float32 for tiny) whatever `half_precision_weights` says; with the flag
    (the default) every floating weight, the GroupNorm parameters
    included, is first rounded through bfloat16, as the reference stores
    its weights in bfloat16 and casts them to the compute dtype."""
    import torch

    from humangaussian_torch import resolve_device
    from humangaussian_torch.guidance.dual_branch import (
        DualBranchGuidance,
        GuidanceConfig,
    )
    from humangaussian_torch.guidance.schedule import DiffusionSchedule
    from humangaussian_torch.guidance.unet import (
        SD2_BASE_CONFIG,
        TINY_TEST_CONFIG,
        DualBranchUNet,
    )
    from humangaussian_torch.guidance.vae import (
        AutoencoderKL,
        VAEConfig,
        tiny_vae_config,
        upgrade_vae_state_dict,
    )

    dev = resolve_device(device)
    g_raw = dict(cfg.get("system", {}).get("guidance", {}))
    gtype = g_raw.get("type", "dual-branch")
    if gtype != "dual-branch":
        raise ValueError(
            f"unknown system.guidance.type {gtype!r}; the port has "
            "'dual-branch'")
    arch = g_raw.get("arch", "sd2-base")
    if arch == "tiny":
        unet_cfg, vae_cfg = TINY_TEST_CONFIG, tiny_vae_config()
        g_raw.setdefault("latent_size", 8)
        g_raw.setdefault("image_size", 16)
    elif arch == "sd2-base":
        unet_cfg, vae_cfg = SD2_BASE_CONFIG, VAEConfig()
    else:
        raise ValueError(
            f"unknown system.guidance.arch {arch!r}; expected 'sd2-base' or "
            "'tiny'")
    overrides = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in (g_raw.get("unet") or {}).items()}
    if overrides:
        unet_cfg = dataclasses.replace(unet_cfg, **overrides)
    if unet_cfg.branch_num != 1:
        raise ValueError(
            "system.guidance.unet.branch_num must be 1 on the training "
            "path: the dual-branch guidance supplies one depth branch")

    bf16_weights = bool(g_raw.get("half_precision_weights", True))
    # build on the meta device, then materialize straight on `dev`: the
    # full-width UNet is 899.7M parameters
    with torch.device("meta"):
        unet = DualBranchUNet(unet_cfg)
        vae = AutoencoderKL(vae_cfg)
    _load_into(unet, _find_weights(g_raw["model_key"], "unet_ema"),
               unet_cfg.dtype, bf16_weights, dev)
    _load_into(vae, _find_weights(g_raw["vae_key"], ""), vae_cfg.dtype,
               bf16_weights, dev, upgrade=upgrade_vae_state_dict)
    return DualBranchGuidance(
        unet, vae, DiffusionSchedule.create(device=dev),
        _take(GuidanceConfig, g_raw))


def _build_photo_trainer(cfg: dict, device="cuda"):
    """system.type: photo-3dgs-system — the photometric 3DGS trainer fed by
    a posed-image dataset: data.type blender, colmap, multiview (an
    instant-ngp `transforms.json` capture) or co3d (one CO3D-v2 sequence;
    `data.dataroot` is its `root_dir`), the last two through their
    datamodules' `as_photo_dataset`."""
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
    elif dtype_ == "multiview":
        from humangaussian_torch.data.multiview import (
            MultiviewConfig,
            MultiviewDataModule,
        )

        dataset = MultiviewDataModule(
            _take(MultiviewConfig, data_cfg)).as_photo_dataset()
    elif dtype_ == "co3d":
        from humangaussian_torch.data.co3d import Co3dConfig, Co3dDataModule

        data_cfg.setdefault("root_dir", data_cfg.pop("dataroot", ""))
        dataset = Co3dDataModule(
            _take(Co3dConfig, data_cfg)).as_photo_dataset()
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


def _run_avatar(system, cfg, dirs, exp, args):
    from humangaussian_torch.train.checkpoint import restore_checkpoint
    from humangaussian_torch.train.loop import finalize, run_training
    from humangaussian_torch.utils.loggers import (
        CSVLogger,
        MultiLogger,
        TensorBoardLogger,
        WandbLogger,
    )

    state = system.init_state(seed=exp.seed)
    if args.resume:
        state = restore_checkpoint(args.resume, state)
        print(f"resumed from {args.resume} at step {state.step}")
    trainer_cfg = cfg.get("trainer", {})
    if args.train:
        loggers = [CSVLogger(os.path.join(dirs["trial"], "csv_logs",
                                          "metrics.csv"))]
        try:
            loggers.append(TensorBoardLogger(os.path.join(dirs["trial"],
                                                          "tb_logs")))
        except ImportError as exc:
            print(f"TensorBoard logger left out: no event writer ({exc})")
        if trainer_cfg.get("wandb", False):
            loggers.append(WandbLogger(
                project=trainer_cfg.get("wandb_project", "humangaussian"),
                name=exp.tag or exp.name, config=dict(cfg)))
        state, _hist = run_training(
            system, state,
            max_steps=int(trainer_cfg.get("max_steps", 3600)),
            val_interval=int(trainer_cfg.get("val_check_interval", 100)),
            save_dir=dirs["save"],
            log_every=int(trainer_cfg.get("log_every", 10)),
            logger=MultiLogger(loggers),
            progress_path=os.path.join(dirs["trial"], "progress"),
        )
    if args.test or args.train:
        finalize(system, state, dirs["save"])
        print(f"artifacts in {dirs['save']}")
    return state


def main(argv=None):
    """Run the CLI; returns the trial directory."""
    from humangaussian_torch import resolve_device
    from humangaussian_torch.config import ExperimentConfig, load_config

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--resume", default=None, help="checkpoint dir")
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
    if isinstance(system, tuple):  # the photo-3DGS trainer's bundle
        if args.train:
            _run_photo(system, cfg, dirs)
        return dirs["trial"]
    _run_avatar(system, cfg, dirs, exp, args)
    return dirs["trial"]


if __name__ == "__main__":
    main()
