"""Carry state from numpy (or the JAX package's containers) into the port.

`scene_from_numpy` turns the fields of a JAX `GaussianScene` (means,
log_scales, quats, sh_dc, sh_rest, opacity_logits, alive), given as a
mapping or a NamedTuple of array-likes, into the port's GaussianScene;
`smplx_from_numpy` does the same for an `SMPLXModel`, and
`adam_state_from_numpy`, `densify_state_from_numpy` and
`photo_state_from_numpy` for the training state (JAX `AdamState`,
`DensifyState`, `PhotoTrainState` given as numpy leaves). The parity tests
use them so that the two packages compute on identical state. Nothing
here imports JAX: arrays are read through `numpy.asarray`.
"""
from __future__ import annotations

import numpy as np
import torch

from humangaussian_torch import resolve_device
from humangaussian_torch.core.scene import GaussianScene
from humangaussian_torch.densify import DensifyState
from humangaussian_torch.smplx.model import SMPLXModel
from humangaussian_torch.train.optim import AdamState
from humangaussian_torch.train.photo import PhotoTrainState


def _fields(d) -> dict:
    return dict(d._asdict()) if hasattr(d, "_asdict") else dict(d)


def scene_from_numpy(d, device="cuda") -> GaussianScene:
    dev = resolve_device(device)
    f = _fields(d)

    def t(name, dtype=torch.float32):
        return torch.from_numpy(np.array(f[name])).to(dev, dtype)

    return GaussianScene(
        means=t("means"),
        log_scales=t("log_scales"),
        quats=t("quats"),
        sh_dc=t("sh_dc"),
        sh_rest=t("sh_rest"),
        opacity_logits=t("opacity_logits"),
        alive=t("alive", torch.bool),
    )


def smplx_from_numpy(d, device="cuda") -> SMPLXModel:
    """SMPLXModel with tensor fields on `device` (`parents` stays numpy:
    the kinematic loop indexes with it)."""
    dev = resolve_device(device)
    f = _fields(d)

    def t(name, dtype=torch.float32):
        return torch.from_numpy(np.array(f[name])).to(dev, dtype)

    return SMPLXModel(
        v_template=t("v_template"),
        shapedirs=t("shapedirs"),
        exprdirs=t("exprdirs"),
        posedirs=t("posedirs"),
        j_regressor=t("j_regressor"),
        lbs_weights=t("lbs_weights"),
        parents=np.asarray(f["parents"], np.int32),
        faces=t("faces", torch.int64),
        landmark_vertex_ids=t("landmark_vertex_ids", torch.int64),
        hands_mean=t("hands_mean"),
    )


def _f32(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(dev)


def adam_state_from_numpy(d, device="cuda") -> AdamState:
    """AdamState from {mu: {name: array}, nu: {...}, count}."""
    dev = resolve_device(device)
    f = _fields(d)
    return AdamState(
        mu={k: _f32(v, dev) for k, v in f["mu"].items()},
        nu={k: _f32(v, dev) for k, v in f["nu"].items()},
        count=int(f["count"]),
    )


def densify_state_from_numpy(d, device="cuda") -> DensifyState:
    dev = resolve_device(device)
    f = _fields(d)
    return DensifyState(
        grad_accum=_f32(f["grad_accum"], dev),
        denom=_f32(f["denom"], dev),
        max_radii2d=_f32(f["max_radii2d"], dev),
    )


def photo_state_from_numpy(d, device="cuda", seed: int = 0) -> PhotoTrainState:
    """PhotoTrainState from the JAX state's numpy leaves {scene, adam,
    densify, step, active_sh_degree}. The JAX PRNG key has no torch
    counterpart: the split-noise generator is seeded with `seed`."""
    dev = resolve_device(device)
    f = _fields(d)
    return PhotoTrainState(
        scene=scene_from_numpy(f["scene"], dev),
        adam=adam_state_from_numpy(f["adam"], dev),
        densify=densify_state_from_numpy(f["densify"], dev),
        step=int(f["step"]),
        generator=torch.Generator(device=dev).manual_seed(seed),
        active_sh_degree=int(f["active_sh_degree"]),
    )
