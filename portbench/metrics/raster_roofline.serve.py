"""% of its roofline for K1 on the traced frames: the forward's least time
(counts/raster.py: bytes over 3.35 TB/s or operations over the float32
peak, whichever is larger, from the benchmark's own projection and
binning of the frames' re-posed scenes and cameras) over K1's device
time."""
from portbench.peaks import FP32_FLOPS, HBM_BYTES_PER_S

KERNEL = "rasterize_fwd_kernel"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    dev_s = tr.op_device_s(KERNEL)
    inputs = ctx.cell.raster_inputs()
    if dev_s <= 0 or not inputs:
        return None
    raster = ctx.counts("raster")
    least = 0.0
    for params, alive, cams, _h, _w, cap, cfg, bg, backward in inputs:
        w = raster.work(params, alive, cams, cap, cfg, bg, backward)
        least += raster.least_seconds(w, HBM_BYTES_PER_S, FP32_FLOPS)
    return 100.0 * least / dev_s
