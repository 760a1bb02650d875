"""% of their roofline for K1, K2 and K2b on the traced steps' renders:
the least time of the forward and the backward (counts/raster.py: bytes
over 3.35 TB/s or operations over the float32 peak, whichever is larger,
from the benchmark's own projection and binning of the same scenes and
cameras) over the three kernels' device time."""
from portbench.peaks import FP32_FLOPS, HBM_BYTES_PER_S

KERNELS = ("rasterize_fwd_kernel", "rasterize_bwd_kernel",
           "rasterize_bwd_rows_kernel")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    dev_s = sum(tr.op_device_s(k) for k in KERNELS)
    inputs = ctx.cell.raster_inputs()
    if dev_s <= 0 or not inputs:
        return None
    raster = ctx.counts("raster")
    least = 0.0
    for params, alive, cams, _h, _w, cap, cfg, bg, backward in inputs:
        w = raster.work(params, alive, cams, cap, cfg, bg, backward)
        least += raster.least_seconds(w, HBM_BYTES_PER_S, FP32_FLOPS)
    return 100.0 * least / dev_s
