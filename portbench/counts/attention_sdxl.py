"""The QK^T and PV FLOPs of the SDXL UNet's self-attention sites that run
kernel K4 in a training step, from the configuration's shapes: the plain
reference's UNet run once on the meta device on the step's 3B latents,
each self-attention call (`attn1`) on a token count that is a multiple of
128 (the program's gate for K4) recorded as (batch, tokens, heads, head
width). Each site costs 2 products x 2 FLOPs a multiply-add x B H S^2 D."""
from __future__ import annotations

import functools
import json


@functools.lru_cache(maxsize=8)
def _sites(conf_json: str) -> tuple:
    from portbench.counts import prior_sdxl
    from portbench.reference.unet import BasicTransformerBlock

    conf = json.loads(conf_json)
    b = 3 * conf["data"]["batch_size"]
    unet = prior_sdxl.meta_unet(conf)
    sites = []

    def hook(mod, args, _out):
        bb, n, inner = args[0].shape
        if n % 128 == 0:
            sites.append((bb, n, mod.heads, inner // mod.heads))

    hooks = [m.attn1.register_forward_hook(hook) for m in unet.modules()
             if isinstance(m, BasicTransformerBlock)]
    unet(*prior_sdxl.unet_inputs(conf, b))
    for h in hooks:
        h.remove()
    return tuple(sites)


def sites(conf: dict) -> list:
    """[(B, S, H, D)] of the step's K4 calls."""
    return list(_sites(json.dumps(conf, sort_keys=True)))


def step_flops(conf: dict) -> int:
    return sum(4 * b * h * s * s * d for b, s, h, d in sites(conf))
