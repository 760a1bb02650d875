"""% of its roofline for the fused GroupNorm forward kernel: the step's
GroupNorm-forward bytes (counts/groupnorm.py: x read and y written once
per call, from the configuration's shapes) over 3.35 TB/s, against the
kernel's device time a step."""
from portbench.peaks import HBM_BYTES_PER_S

KERNEL = "groupnorm_fwd_kernel"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    dev_s = tr.op_device_s(KERNEL) / ctx.traced_units
    if dev_s <= 0:
        return None
    least = ctx.counts("groupnorm").fwd_bytes(ctx.conf) / HBM_BYTES_PER_S
    return 100.0 * least / dev_s
