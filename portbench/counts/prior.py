"""The guidance's model FLOPs a training step, from the configuration's
shapes: the plain reference's UNet and VAE encoder built on the meta
device and run once under `torch.utils.flop_counter.FlopCounterMode`,
which counts the matrix products of convolutions, linear layers and the
attention's QK^T and PV (2 FLOPs a multiply-add) and nothing else: no
elementwise op, no GroupNorm, no rasterizer."""
from __future__ import annotations

import dataclasses
import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode


def _cfgs(conf: dict):
    from portbench.reference.avatar import take
    from portbench.reference.unet import UNetConfig
    from portbench.reference.vae import VAEConfig

    return (dataclasses.replace(take(UNetConfig, conf["unet"]),
                                dtype=torch.float32),
            dataclasses.replace(take(VAEConfig, conf["vae"]),
                                dtype=torch.float32))


@functools.lru_cache(maxsize=8)
def _unet_flops(conf_json: str, batch: int) -> int:
    from portbench.reference.unet import DualBranchUNet

    conf = json.loads(conf_json)
    ucfg, _ = _cfgs(conf)
    g = conf["system"]["guidance"]
    lat = g["image_size"] // 2 ** (len(conf["vae"]["block_out_channels"]) - 1)
    p = conf["prompt"]
    with torch.device("meta"):
        unet = DualBranchUNet(ucfg)
        x = torch.zeros(batch, lat, lat, ucfg.in_channels)
        with FlopCounterMode(display=False) as fc:
            unet(x, x, torch.zeros(batch, dtype=torch.int64),
                 torch.zeros(batch, p["seq"], p["dim"]),
                 torch.zeros(batch, 6))
    return fc.get_total_flops()


@functools.lru_cache(maxsize=8)
def _encode_flops(conf_json: str, batch: int) -> int:
    from portbench.reference.vae import AutoencoderKL

    conf = json.loads(conf_json)
    _, vcfg = _cfgs(conf)
    size = conf["system"]["guidance"]["image_size"]
    with torch.device("meta"):
        vae = AutoencoderKL(vcfg)
        with FlopCounterMode(display=False) as fc:
            vae.encode(torch.zeros(batch, size, size, vcfg.in_channels))
    return fc.get_total_flops()


def unet_flops(conf: dict, batch: int) -> int:
    """The UNet's forward on `batch` noisy latents."""
    return _unet_flops(json.dumps(conf, sort_keys=True), batch)


def encode_flops(conf: dict, batch: int) -> int:
    """The VAE encoder's forward on `batch` images at the prior's size."""
    return _encode_flops(json.dumps(conf, sort_keys=True), batch)


def step_flops(conf: dict) -> int:
    """Model FLOPs of one ANPG step of a batch B: the UNet on 3B latents
    ([cond | neg | null]), three encodes of B images (render, depth, pose)
    and the input gradient of the two differentiated encodes, counted as
    their forward's FLOPs. The encodes' recomputation in the backward is
    not model work and is not counted."""
    b = conf["data"]["batch_size"]
    return unet_flops(conf, 3 * b) + encode_flops(conf, b) * (3 + 2)
