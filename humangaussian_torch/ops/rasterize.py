"""Rasterizer entry point: the tiled production path or the oracle.

Port of humangaussian_tpu/ops/rasterize.py.
"""
from humangaussian_torch.ops.rasterize_ref import rasterize_reference
from humangaussian_torch.ops.rasterize_tiled import rasterize_tiled


def rasterize(*args, impl: str = "tiled", **kwargs):
    """impl: "tiled" (binning + the compositing kernel) or "reference"
    (the brute-force oracle)."""
    if impl == "tiled":
        return rasterize_tiled(*args, **kwargs)
    if impl == "reference":
        return rasterize_reference(*args, **kwargs)
    raise ValueError(f"unknown rasterizer impl {impl!r}")
