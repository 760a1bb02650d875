"""Host training loop of the avatar trainer: steps, density control,
validation renders, logging and the final artifacts.

Port of humangaussian_tpu/train/loop.py. `run_training` drives
`system.train_step` to `max_steps`, runs the density-control pass the host
step calls for (`system.maybe_densify`, decided without a device read),
logs every `log_every` steps and after each density-control pass (the
metrics are read from the device only then, in one copy), renders the
validation orbit every `val_interval` steps (`it{N}-val.png`), writes the
guidance strip every `guidance_eval_interval` steps (`it{N}-guidance.png`:
the render, the pose image, the 1-step and the denoised image, the 1-step
and the denoised depth of the first camera, each resized to the prior's
image size) and writes `metrics.csv`. Each pass of the loop is an
`hg.step` span (utils/profiling.py).
`finalize` writes the 120-view orbit video (`orbit.mp4`, or the `.gif`
that `save_video` falls back to), `last.ply` and the checkpoint
`ckpts/last`.

The port's binning caps each tile at `state.tile_cap` pairs and drops the
deepest ones (`overflow`), so the JAX loop's tile-capacity ladder stays: a
logged step that drops any pair warns, and more than
`OVERFLOW_GROW_THRESHOLD` dropped pairs on `OVERFLOW_PATIENCE` logged
checks in a row grow the cap 1.5x (rounded up to 128) up to
`TILE_CAP_MAX`. The cap and the streak of logged checks over the
threshold live in the `TrainState`, so the checkpoint keeps them, a
resumed run does not climb the ladder again, and a caller that runs one
step a call climbs it as one long call does. Not ported, because
dynamic binning leaves them nothing to do: `active_rank_bucket` (the
candidate domain is sized by the live scene) and the `class_fracs` ladder
(there is no class chain, so `overflow_spill` is 0), with their arguments;
nor the opt-in `overflow_limit` abort, which the ladder replaces. The
JAX `run_training` also calls `finalize`,
and its launcher calls it again; here the launcher's call is the only one.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from humangaussian_torch.io.ply import save_ply
from humangaussian_torch.train.checkpoint import save_checkpoint
from humangaussian_torch.utils.profiling import trace_annotation
from humangaussian_torch.utils.saving import (
    save_image_grid,
    save_metrics_csv,
    save_video,
)


def snapshot_code(save_dir: str) -> str | None:
    """Copy the git-tracked sources into `save_dir/code`; None outside a
    git checkout."""
    import shutil
    import subprocess

    try:
        root = subprocess.check_output(
            ["git", "rev-parse", "--show-toplevel"], text=True,
            stderr=subprocess.DEVNULL).strip()
        files = subprocess.check_output(
            ["git", "ls-files"], cwd=root, text=True).splitlines()
    except (OSError, subprocess.CalledProcessError):
        return None
    dst_root = os.path.join(save_dir, "code")
    for rel in files:
        src = os.path.join(root, rel)
        if not os.path.isfile(src):
            continue
        dst = os.path.join(dst_root, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copy2(src, dst)
    return dst_root


OVERFLOW_GROW_THRESHOLD = 50_000  # dropped pairs in a logged step
OVERFLOW_PATIENCE = 3  # logged checks in a row over the threshold
TILE_CAP_MAX = 65536  # K1 and K2 walk segments of any length


def grown_tile_cap(tile_cap: int) -> int:
    """The ladder's next rung: 1.5x, rounded up to 128, at most
    `TILE_CAP_MAX`."""
    return min(-(-int(tile_cap * 1.5) // 128) * 128, TILE_CAP_MAX)


def _read(tensors: dict, site: str) -> dict:
    """The dict's scalar device tensors as Python floats, copied to the
    host in one read (an `hg.read.<site>` span)."""
    with trace_annotation(f"hg.read.{site}"):
        values = torch.stack([torch.as_tensor(v, dtype=torch.float64)
                              for v in tensors.values()]).tolist()
    return dict(zip(tensors, values))


def run_training(
    system,
    state,
    max_steps: int | None = None,
    val_interval: int = 100,
    save_dir: str | None = None,
    log_every: int = 10,
    log_fn=print,
    guidance_eval_interval: int = 0,
    logger=None,  # utils.loggers.MultiLogger
    progress_path: str | None = None,  # percentage file for external UIs
):
    """Train from `state.step` to `max_steps`. Returns (state, history)."""
    max_steps = max_steps or system.cfg.max_steps
    history: list[dict] = []
    t_last = time.time()
    steps_since_log = 0

    for _ in range(state.step, max_steps):
        with trace_annotation("hg.step"):
            state, metrics = system.train_step(state)
            state, dens_info = system.maybe_densify(state)
            step = state.step
            steps_since_log += 1

            if progress_path:
                with open(progress_path, "w") as pf:
                    pf.write(f"{step / max_steps * 100:.1f}")

            if step % log_every == 0 or dens_info is not None:
                row = _read(metrics, "log")
                row["step"] = step
                now = time.time()
                row["steps_per_s"] = steps_since_log / max(now - t_last, 1e-9)
                t_last, steps_since_log = now, 0
                if dens_info is not None:
                    dens = {k: int(v) for k, v in
                            _read(dens_info._asdict(), "densify_info").items()}
                    row.update((k, v) for k, v in dens.items()
                               if k != "n_alive")
                ovf = int(row.get("overflow", 0))
                if ovf:
                    log_fn(f"WARNING step {step}: rasterizer dropped {ovf} "
                           f"(tile, gaussian) pairs at tile_capacity "
                           f"{state.tile_cap}")
                streak = (state.ovf_streak + 1
                          if ovf > OVERFLOW_GROW_THRESHOLD else 0)
                if (streak >= OVERFLOW_PATIENCE
                        and state.tile_cap < TILE_CAP_MAX):
                    new_cap = grown_tile_cap(state.tile_cap)
                    log_fn(f"step {step}: overflow persisted {streak} "
                           f"checks ({ovf} pairs); tile_capacity "
                           f"{state.tile_cap} -> {new_cap}")
                    state = state._replace(tile_cap=new_cap, ovf_streak=0)
                elif streak != state.ovf_streak:
                    state = state._replace(ovf_streak=streak)
                history.append(row)
                if logger is not None:
                    logger.log_scalars(step, row)
                log_fn(
                    f"step {step}: loss={row['loss']:.4f} "
                    f"alive={int(row['n_alive'])} "
                    f"{row['steps_per_s']:.2f} it/s"
                    + (f" densify={dens}" if dens_info is not None else "")
                )

            if save_dir and val_interval and step % val_interval == 0:
                out, _cams = system.render_eval(state.scene, "val")
                images = out["image"].cpu().numpy()
                save_image_grid(os.path.join(save_dir, f"it{step}-val.png"),
                                images)
                if logger is not None:
                    logger.log_image(step, "val/render", images[0])
            if (save_dir and guidance_eval_interval
                    and step % guidance_eval_interval == 0):
                save_guidance_strip(
                    os.path.join(save_dir, f"it{step}-guidance.png"),
                    system.guidance_eval_snapshot(state))

    if save_dir:
        save_metrics_csv(os.path.join(save_dir, "metrics.csv"), history)
    if logger is not None:
        logger.close()
    return state, history


GUIDANCE_STRIP = ("render", "pose", "imgs_1step", "imgs_final",
                  "depths_1step", "depths_final")


def save_guidance_strip(path: str, strips: dict) -> str:
    """The first camera's panels of a `guidance_eval_snapshot`, side by
    side, each resized (anti-aliased bilinear) to the denoised image's
    size."""
    from humangaussian_torch.guidance.dual_branch import resize_bilinear

    size = strips["imgs_final"].shape[1]
    row = [resize_bilinear(strips[k][:1], size)[0].cpu().numpy()
           for k in GUIDANCE_STRIP if k in strips]
    return save_image_grid(path, [np.concatenate(row, axis=1)])


def finalize(system, state, save_dir: str) -> str:
    """The test orbit video, `last.ply` and `ckpts/last` under `save_dir`."""
    out, _cams = system.render_eval(state.scene, "test")
    save_video(os.path.join(save_dir, "orbit.mp4"),
               out["image"].cpu().numpy(), fps=30)
    save_ply(state.scene, os.path.join(save_dir, "last.ply"))
    save_checkpoint(os.path.join(save_dir, "ckpts", "last"), state)
    return save_dir
