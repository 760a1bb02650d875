"""What the program's own `hg.*` spans (humangaussian_torch/utils/
profiling.py) say in a traced window: the device's idle time split by the
layer span the host was in, the device time launched inside a span, and
the count of blocking host reads (`hg.read.*` spans).

The idle split: the window's idle time (no device operation running) is
cut by each layer span's host intervals in turn (`layers`' order); each
layer gets the idle time inside its intervals, and what no layer span
covers is the rest. The layers plus the rest sum to the window's idle
time, whatever the spans. Every reader returns None when the trace holds
no `unit_span` (a program without the spans)."""
from __future__ import annotations

import bisect

TRAIN_UNIT = "hg.step"
TRAIN_LAYERS = ("hg.inputs", "hg.render", "hg.guidance", "hg.backward",
                "hg.optim")
SERVE_UNIT = "hg.frame"
SERVE_LAYERS = ("hg.repose", "hg.render")
READ = "hg.read."


def merged(ivs) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_intervals(tr) -> list:
    """The window's intervals (us) in which no device operation ran."""
    lo, hi = tr.window
    gaps, end = [], lo
    for s, e, _, _ in tr.ops:  # sorted by start
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if hi > end:
        gaps.append((end, hi))
    return [g for g in gaps if g[1] > g[0]]


def cut(gaps, ivs):
    """(the parts of `gaps` outside `ivs`, the length inside them); both
    sorted and disjoint."""
    rest, inside, j = [], 0.0, 0
    for s, e in gaps:
        while j < len(ivs) and ivs[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(ivs) and ivs[k][0] < e:
            a, b = max(ivs[k][0], cur), min(ivs[k][1], e)
            if a > cur:
                rest.append((cur, a))
            if b > a:
                inside += b - a
                cur = b
            k += 1
        if e > cur:
            rest.append((cur, e))
    return rest, inside


def idle_split(tr, layers) -> dict:
    """Idle seconds of the window by layer span, and under None the rest."""
    gaps, out = idle_intervals(tr), {}
    for name in layers:
        gaps, inside = cut(gaps, merged(tr.spans.get(name, [])))
        out[name] = inside / 1e6
    out[None] = sum(e - s for s, e in gaps) / 1e6
    return out


def idle_ms(ctx, unit_span: str, layers, layer):
    """Idle ms a unit inside `layer`'s spans (None: the rest)."""
    tr = ctx.trace
    if tr is None or unit_span not in tr.spans or not ctx.traced_units:
        return None
    return idle_split(tr, layers)[layer] / ctx.traced_units * 1e3


def launched_ms(ctx, span: str):
    """Device ms a unit of the operations launched inside `span`, on any
    thread (the spans of one name merged first)."""
    tr = ctx.trace
    if tr is None or span not in tr.spans or not ctx.traced_units:
        return None
    ivs = merged(tr.spans[span])
    starts = [s for s, _ in ivs]
    total = 0.0
    for s, e, _, launch in tr.ops:
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch <= ivs[i][1]:
            total += e - s
    return total / 1e3 / ctx.traced_units


def reads(ctx, unit_span: str):
    """`hg.read.*` spans a unit: the blocking host reads."""
    tr = ctx.trace
    if tr is None or unit_span not in tr.spans or not ctx.traced_units:
        return None
    n = sum(len(v) for k, v in tr.spans.items() if k.startswith(READ))
    return n / ctx.traced_units
