"""The readings of `sdxl_body`'s comparison under the half-batch fault:
the training step's loss and gradients from the first half of the camera
batch (portbench/faults.py's `half_batch`), with SDXL's pooled text rows
halved as that fault halves the token rows (it does not know of them).
One line a seed, as `portbench/run.py --calibrate` prints them:

    python3 scripts/sdxl_half_batch.py 1,2,3
"""
from __future__ import annotations

import contextlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@contextlib.contextmanager
def pooled_rows_halved():
    """Inside, `batch_loss` halves the pooled rows to the token rows' batch
    when they differ; the half-batch fault, planted inside, wraps it."""
    import humangaussian_torch.train.system as system

    own = system.GaussianDreamerSystem.batch_loss

    def halved(self, params, offset, template, inputs, step, *a, **k):
        b = inputs.t.shape[0]
        if inputs.pooled is not None and inputs.pooled.shape[0] != 3 * b:
            rows = inputs.pooled.reshape(3, -1, inputs.pooled.shape[-1])
            inputs = inputs._replace(pooled=rows[:, :b].reshape(3 * b, -1))
        return own(self, params, offset, template, inputs, step, *a, **k)

    system.GaussianDreamerSystem.batch_loss = halved
    try:
        yield
    finally:
        system.GaussianDreamerSystem.batch_loss = own


def main(argv=None) -> int:
    from portbench.calibrate import calibrate

    args = sys.argv[1:] if argv is None else argv
    seeds = [int(s) for s in args[0].split(",")]
    with pooled_rows_halved():
        return calibrate("sdxl_body", seeds, 0.0, control=False,
                         fault="half_batch")


if __name__ == "__main__":
    sys.exit(main())
