"""Bytes the fused GroupNorm forward must move in a training step, from
the configuration's shapes: each call reads its activation once and writes
its output once, in the prior's dtype. The calls and their shapes come
from the plain reference's UNet and VAE encoder run on the meta device:
the UNet once on 3B latents; the encoder on B images five times (three
encodes, two of them run again by the backward's recomputation, since the
kernel does that work too)."""
from __future__ import annotations

import dataclasses
import functools
import json
import math

import torch

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
ENCODE_PASSES = 5  # 3 encodes + 2 recomputed in the backward


def _norm_shapes(module, run) -> list:
    from portbench.reference.common import GroupNormAct

    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, a, o: shapes.append(tuple(a[0].shape)))
        for m in module.modules() if isinstance(m, GroupNormAct)]
    run()
    for h in hooks:
        h.remove()
    return shapes


@functools.lru_cache(maxsize=8)
def _step_calls(conf_json: str) -> tuple:
    from portbench.reference.avatar import take
    from portbench.reference.unet import DualBranchUNet, UNetConfig
    from portbench.reference.vae import AutoencoderKL, VAEConfig

    conf = json.loads(conf_json)
    ucfg = dataclasses.replace(take(UNetConfig, conf["unet"]),
                               dtype=torch.float32)
    vcfg = dataclasses.replace(take(VAEConfig, conf["vae"]),
                               dtype=torch.float32)
    b = conf["data"]["batch_size"]
    size = conf["system"]["guidance"]["image_size"]
    lat = size // 2 ** (len(vcfg.block_out_channels) - 1)
    p = conf["prompt"]
    with torch.device("meta"):
        unet, vae = DualBranchUNet(ucfg), AutoencoderKL(vcfg)
        x = torch.zeros(3 * b, lat, lat, ucfg.in_channels)
        u = _norm_shapes(unet, lambda: unet(
            x, x, torch.zeros(3 * b, dtype=torch.int64),
            torch.zeros(3 * b, p["seq"], p["dim"]), torch.zeros(3 * b, 6)))
        v = _norm_shapes(vae, lambda: vae.encode(
            torch.zeros(b, size, size, vcfg.in_channels)))
    return tuple(u), tuple(v) * ENCODE_PASSES


def step_calls(conf: dict) -> list:
    """[(N, C, H, W)] of every GroupNorm forward call of one step."""
    u, v = _step_calls(json.dumps(conf, sort_keys=True))
    return list(u) + list(v)


def fwd_bytes(conf: dict) -> int:
    """x read once and y written once over the step's calls."""
    u, v = _step_calls(json.dumps(conf, sort_keys=True))
    bu = DTYPE_BYTES[conf["unet"]["dtype"]]
    bv = DTYPE_BYTES[conf["vae"]["dtype"]]
    return (sum(2 * math.prod(s) * bu for s in u)
            + sum(2 * math.prod(s) * bv for s in v))
