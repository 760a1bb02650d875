"""ms, the 95th percentile of every frame's latency in the window, from
the client's request to the frame's array on the host (nearest rank)."""
import math


def read(ctx):
    lat = sorted(ctx.latencies_s)
    if not lat:
        return None
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)] * 1e3
