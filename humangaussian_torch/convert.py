"""Carry state from numpy (or the JAX package's containers) into the port.

`scene_from_numpy` turns the fields of a JAX `GaussianScene` (means,
log_scales, quats, sh_dc, sh_rest, opacity_logits, alive), given as a
mapping or a NamedTuple of array-likes, into the port's GaussianScene;
`smplx_from_numpy` does the same for an `SMPLXModel`. The parity tests use
both so that the two packages compute on identical state. Nothing here
imports JAX: arrays are read through `numpy.asarray`.
"""
from __future__ import annotations

import numpy as np
import torch

from humangaussian_torch import resolve_device
from humangaussian_torch.core.scene import GaussianScene
from humangaussian_torch.smplx.model import SMPLXModel


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
