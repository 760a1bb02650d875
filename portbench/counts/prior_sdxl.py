"""The SDXL guidance's model FLOPs a training step, from the
configuration's shapes, counted as `counts/prior.py` counts them for the
dual-branch prior: the plain reference's SDXL UNet and VAE encoder built
on the meta device and run once under `torch.utils.flop_counter.
FlopCounterMode`, which counts the matrix products of convolutions,
linear layers and the attention's QK^T and PV (2 FLOPs a multiply-add)
and nothing else."""
from __future__ import annotations

import dataclasses
import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode


def latent_size(conf: dict) -> int:
    return (conf["system"]["guidance"]["image_size"]
            // 2 ** (len(conf["vae"]["block_out_channels"]) - 1))


def meta_unet(conf: dict):
    """The plain reference's SDXL UNet on the meta device, in float32."""
    from portbench.reference.avatar import take
    from portbench.reference.unet_sdxl import SDXLUNet, SDXLUNetConfig

    with torch.device("meta"):
        return SDXLUNet(dataclasses.replace(
            take(SDXLUNetConfig, conf["unet"]), dtype=torch.float32))


def unet_inputs(conf: dict, batch: int) -> tuple:
    """Meta inputs of one UNet pass on `batch` latents."""
    lat = latent_size(conf)
    u, p = conf["unet"], conf["prompt"]
    with torch.device("meta"):
        return (torch.zeros(batch, lat, lat, u["in_channels"]),
                torch.zeros(batch, dtype=torch.int64),
                torch.zeros(batch, p["seq"], p["dim"]),
                torch.zeros(batch, p["pooled_dim"]),
                torch.zeros(batch, u["num_time_ids"]))


@functools.lru_cache(maxsize=8)
def _unet_flops(conf_json: str, batch: int) -> int:
    conf = json.loads(conf_json)
    unet = meta_unet(conf)
    with FlopCounterMode(display=False) as fc:
        unet(*unet_inputs(conf, batch))
    return fc.get_total_flops()


@functools.lru_cache(maxsize=8)
def _encode_flops(conf_json: str, batch: int) -> int:
    from portbench.reference.avatar import take
    from portbench.reference.vae import AutoencoderKL, VAEConfig

    conf = json.loads(conf_json)
    vcfg = dataclasses.replace(take(VAEConfig, conf["vae"]),
                               dtype=torch.float32)
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
    ([cond | neg | null]), one encode of B renders and its input gradient,
    counted as the forward's FLOPs. The encode's recomputation in the
    backward is not model work and is not counted."""
    b = conf["data"]["batch_size"]
    return unet_flops(conf, 3 * b) + encode_flops(conf, b) * 2
