"""% of its roofline for kernel K4 (the self-attention forward,
csrc/attention_fwd.cu) in the SDXL cell: the QK^T and PV FLOPs of the
step's 70 self-attention sites (counts/attention_sdxl.py: 10 at (240,
4096, 64), 60 at (480, 1024, 64) as (batch x heads, tokens, head width))
over 989 TFLOP/s, against K4's device time a step. None when the trace
holds no K4 launch."""
from portbench.peaks import BF16_FLOPS

KERNEL = "attention_fwd_kernel"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    dev_s = tr.op_device_s(KERNEL) / ctx.traced_units
    if dev_s <= 0:
        return None
    least = ctx.counts("attention_sdxl").step_flops(ctx.conf) / BF16_FLOPS
    return 100.0 * least / dev_s
