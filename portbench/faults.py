"""Faults planted in the program's timed path, for the tests and for the
readings that set the limits (`run.py --calibrate ... --fault NAME`): each
must make `correct` come out false.

- `state_unchanged`: the training step's Adam update does nothing;
- `half_batch`: the training step's loss and gradients come from the
  first half of the camera batch, the mean taken over it;
- `answer_altered`: each served frame has one pixel changed by 0.5 where
  it is produced.
"""
from __future__ import annotations

import contextlib

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


@contextlib.contextmanager
def planted(name: str):
    import humangaussian_torch.apps.animate as animate
    import humangaussian_torch.train.system as system

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; expected one of {FAULTS}")
    undo = []

    def patch(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "state_unchanged":
        patch(system, "adam_step",
              lambda params, grads, state, lrs, cfg: (params, state))
    elif name == "half_batch":
        own = system.GaussianDreamerSystem.batch_loss

        def half(self, params, offset, template, inputs, step, *a, **k):
            b = inputs.t.shape[0] // 2
            text = inputs.text.reshape(3, -1, *inputs.text.shape[1:])
            cams = inputs.cameras._replace(**{
                f: getattr(inputs.cameras, f)[:b]
                for f in ("c2w", "mvp_mtx", "camera_positions",
                          "light_positions", "elevation", "azimuth",
                          "camera_distances", "fovy")})
            return own(self, params, offset, template, inputs._replace(
                cameras=cams, pose=inputs.pose[:b], t=inputs.t[:b],
                text=text[:, :b].reshape(-1, *text.shape[2:])), step,
                *a, **k)

        patch(system.GaussianDreamerSystem, "batch_loss", half)
    else:
        own = animate.render_motion_frame

        def altered(*a, **k):
            img = own(*a, **k).copy()
            img[0, 0] += 0.5
            return img

        patch(animate, "render_motion_frame", altered)
    try:
        yield
    finally:
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)
