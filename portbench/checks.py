"""The comparisons that decide `correct`: numbers of the program's run
against the plain reference's, each with its limit."""
from __future__ import annotations

import dataclasses
import statistics

import torch

NEGLIGIBLE = 1e-3  # a leaf whose reference gradient is under this share of
# the median leaf's is left out: it moves under Adam by round-off alone


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN fails


def leaf_norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tree.items()}


def counted_leaves(ref_grads: dict) -> list:
    """The leaves compared: those whose reference gradient norm is at least
    NEGLIGIBLE of the median leaf's."""
    norms = leaf_norms(ref_grads)
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= NEGLIGIBLE * med and v > 0]


def worst_norm_gap(got: dict, want: dict, leaves: list) -> tuple:
    """(gap, leaf): the largest |‖got‖ - ‖want‖| over `leaves`, against the
    larger of ‖want‖ of that leaf and of the median leaf."""
    g, w = leaf_norms(got), leaf_norms(want)
    med = statistics.median(w[k] for k in leaves)
    gaps = {k: abs(g[k] - w[k]) / max(w[k], med) for k in leaves}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def worst_rel_diff(got: dict, want: dict, leaves: list) -> tuple:
    """(diff, leaf): the largest ‖got - want‖ / max(‖want‖, median leaf's
    ‖want‖) over `leaves`."""
    w = leaf_norms(want)
    med = statistics.median(w[k] for k in leaves)
    d = {k: float(torch.linalg.vector_norm((got[k] - want[k]).double()))
         / max(w[k], med) for k in leaves}
    worst = max(d, key=d.get)
    return d[worst], worst


def report(checks: list, file) -> None:
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=file)
