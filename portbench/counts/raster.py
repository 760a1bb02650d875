"""Work of the compositing kernels K1 (forward) and K2 + K2b (backward),
from a scene and its cameras: the data-dependent part (visible Gaussians,
pairs, contributions) from the benchmark's own plain projection, binning
and compositing of the same scene and cameras, never from the program's
buffers or counters.

Bytes count each input read once and each output written once:
- K1 reads each visible Gaussian's feature row (10 float32) and each
  pair's Gaussian index (int32) and writes, per pixel, colour (3), depth,
  alpha, final transmittance and the last contributor's index (4 bytes
  each);
- K2 + K2b read the feature rows, the pair indices, the gradients of
  colour, depth and alpha and the forward's final transmittance and last
  contributor per pixel, and write each visible Gaussian's feature-row
  gradient (10 float32).
Operations count the arithmetic a pair-pixel contribution needs (the work
every implementation does, whatever it skips): FWD_FLOPS in the forward,
BWD_FLOPS in the backward, against the card's float32 peak.
"""
from __future__ import annotations

import torch

FEATURE_BYTES = 10 * 4
PAIR_BYTES = 4
FWD_PIXEL_BYTES = 7 * 4  # rgb, depth, alpha, final T, last index
BWD_PIXEL_BYTES = 7 * 4  # d rgb, d depth, d alpha, final T, last index
# forward: dx, dy (2), the conic's quadratic form (7), exp (1), opacity
# product and clamp (2), transmittance product (2), weight (1), colour and
# depth accumulation (4 multiply-adds: 8)
FWD_FLOPS = 23
# backward: the forward's alpha again (12), the transmittance walked back
# (2), the accumulated colour and depth behind the pair (8), d alpha
# (8), d opacity (2), d power (2), d conic (6), d mean (6), d colour and
# depth (8)
BWD_FLOPS = 54


def work(params: dict, alive, cams, tile_capacity: int, cfg, background,
         backward: bool) -> dict:
    """{fwd_bytes, fwd_flops, bwd_bytes, bwd_flops, pairs, contribs,
    visible} of rendering `cams` (a list of cameras of one size)."""
    from portbench.reference.composite import render

    feats = torch.cat([params["sh_dc"][:, None, :], params["sh_rest"]], 1)
    sh_degree = int(round((1 + params["sh_rest"].shape[1]) ** 0.5)) - 1
    with torch.no_grad():
        out = render(params["means"], torch.exp(params["log_scales"]),
                     params["quats"], feats,
                     torch.sigmoid(params["opacity_logits"]).reshape(-1),
                     alive, cams, background, sh_degree, cfg, tile_capacity)
    pixels = sum(c.height * c.width for c in cams)
    vis, pairs, contribs = out["n_visible"], out["pairs"], int(
        out["contribs"])
    res = {"pairs": pairs, "contribs": contribs, "visible": vis,
           "fwd_bytes": vis * FEATURE_BYTES + pairs * PAIR_BYTES
           + pixels * FWD_PIXEL_BYTES,
           "fwd_flops": contribs * FWD_FLOPS, "bwd_bytes": 0, "bwd_flops": 0}
    if backward:
        res["bwd_bytes"] = (2 * vis * FEATURE_BYTES + pairs * PAIR_BYTES
                            + pixels * BWD_PIXEL_BYTES)
        res["bwd_flops"] = contribs * BWD_FLOPS
    return res


def least_seconds(w: dict, hbm: float, flops: float) -> float:
    """The forward's and the backward's least time, each the larger of its
    bytes over the memory bandwidth and its operations over the peak."""
    return (max(w["fwd_bytes"] / hbm, w["fwd_flops"] / flops)
            + max(w["bwd_bytes"] / hbm, w["bwd_flops"] / flops))
