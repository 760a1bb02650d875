"""Checkpoint and resume of the avatar trainer's whole state.

Port of humangaussian_tpu/train/checkpoint.py. The JAX package writes one
orbax pytree; here `torch.save` writes one file, `state.pt`, under the
checkpoint directory: the padded scene, the Adam moments and count, the
densify statistics, the host step, the generator's state
(`torch.Generator.get_state`), the per-tile pair cap that the loop's
ladder reached and its overflow streak, so a run resumes bit for bit.
PLY export (io/ply.py) stays the interop artifact. There is no compatibility with
the JAX package's orbax checkpoints.
"""
from __future__ import annotations

import os

import torch

from humangaussian_torch.densify import DensifyState
from humangaussian_torch.train.optim import AdamState

STATE_FILE = "state.pt"


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(path: str, state) -> str:
    """Write a `train.system.TrainState` under the directory `path`."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    torch.save({
        "scene": _cpu(state.scene._asdict()),
        "adam": {"mu": _cpu(state.adam.mu), "nu": _cpu(state.adam.nu),
                 "count": int(state.adam.count)},
        "densify": _cpu(state.densify._asdict()),
        "step": int(state.step),
        "generator": state.generator.get_state(),
        "tile_cap": int(state.tile_cap),
        "ovf_streak": int(state.ovf_streak),
    }, os.path.join(path, STATE_FILE))
    return path


def restore_checkpoint(path: str, template):
    """The TrainState saved under `path`, on the device of `template` (a
    freshly built TrainState, whose generator is reseeded from the file)."""
    dev = template.scene.device
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)

    def put(tree, like):
        if isinstance(like, torch.Tensor):
            return tree.to(dev, like.dtype)
        return {k: put(tree[k], like[k]) for k in like}

    template.generator.set_state(saved["generator"])
    return template._replace(
        scene=type(template.scene)(**put(saved["scene"],
                                         template.scene._asdict())),
        adam=AdamState(mu=put(saved["adam"]["mu"], template.adam.mu),
                       nu=put(saved["adam"]["nu"], template.adam.nu),
                       count=int(saved["adam"]["count"])),
        densify=DensifyState(**put(saved["densify"],
                                   template.densify._asdict())),
        step=int(saved["step"]),
        tile_cap=int(saved["tile_cap"]),
        ovf_streak=int(saved.get("ovf_streak", 0)),
    )
