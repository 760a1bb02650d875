"""hg_avatar_anim: the zero-shot animation of a trained avatar, as
`apps/animate.py` serves it.

Set-up makes the avatar from the seed on the card (`inputs.avatar`), gives
it to the program's `AvatarAnimator` with the SMPL-X stand-in (the
one-time binding on the host) and renders `warm_frames` frames. A unit of
the window is one frame of one client in a closed loop:
`apps.animate.render_motion_frame` (re-pose by LBS through the binding,
the tiled render at `size`^2 from an orbiting camera, the copy of the
[H, W, 3] image to the host), asked for when the previous frame's array is
on the host. Frame i takes the synthetic walk cycle's pose i mod
`frames_per_orbit` and the orbit's camera i mod `frames_per_orbit`.

The comparison: `check_frames` frames of the window, drawn from the seed
(reservoir sampling, so every frame of the window is as likely), each
against the plain reference's re-pose and render of the same pose and
camera from its own binding; the re-posed positions of those frames,
re-posed by the program after the window, against the reference's; and
the number of Gaussians bound, which must be equal for the re-posed
positions to be compared.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time
import types

import numpy as np
import torch

from portbench import inputs
from portbench.checks import Check

# Limits, each set between the sound runs' highest reading and the
# control's lowest (PERF.md, "Limits").
LIMITS = {
    "repose_max_abs": 1e-5,  # sound 0, bfloat16 control 0.0164+
    "image_mean_abs": 1e-5,  # sound 4.7e-9 to 5.3e-9, control 3.2e-3+
    "image_max_abs": 0.02,  # sound 1.4e-6 to 4.9e-5, control 0.59+
}


def frame_camera(i: int, n: int, size: int, radius: float, rotate: bool,
                 device):
    """The CLI's camera for frame i of n (a copy of
    `apps.animate.frame_camera` on the reference's camera code)."""
    from portbench.reference.camera import camera_from_c2w, look_at_c2w

    angle = 2 * math.pi * i / n if rotate else 0.0
    f32 = dict(dtype=torch.float32, device=device)
    eye = torch.tensor([radius * math.sin(angle), 0.3,
                        radius * math.cos(angle)], **f32)
    c2w = look_at_c2w(eye, torch.zeros(3, **f32),
                      torch.tensor([0.0, 1.0, 0.0], **f32))
    return camera_from_c2w(c2w, 0.9, size, size)


class AnimCell:
    unit = "frame"

    def __init__(self, seed: int, device, conf: dict, traffic: dict,
                 control: bool = False):
        self.seed = int(seed) & inputs.SEED_MASK
        self.dev = torch.device(device)
        self.conf, self.traffic = conf, traffic
        self.n = traffic["frames_per_orbit"]
        self.model = inputs.standin_model()
        self.avatar = inputs.avatar(self.model, conf["n_gaussians"],
                                    self.seed, self.dev)
        self.motion = inputs.walk_cycle(self.seed, self.n, traffic["fps"],
                                        traffic["walk_period_s"])
        self.bg = torch.tensor(conf["background"], dtype=torch.float32,
                               device=self.dev)
        self.args = types.SimpleNamespace(
            size=conf["size"], radius=conf["radius"], rotate=conf["rotate"])
        self.rng = np.random.default_rng(self.seed)
        self.sample = []  # (window frame, pose and camera index, image)
        self.sampling = self.capturing = False
        self.captured = []
        self.i = 0
        self.failed = 0
        self.animator = None
        self.control = control
        if control:
            self.sample = [(j, int(k), None) for j, k in enumerate(
                self.rng.choice(self.n, traffic["check_frames"],
                                replace=False))]
            return
        if self.dev.type == "cuda":
            from humangaussian_torch import kernels

            kernels.build_all()
        from humangaussian_torch.animation import AvatarAnimator
        from humangaussian_torch.convert import smplx_from_numpy
        from humangaussian_torch.core.scene import GaussianScene
        from humangaussian_torch.smplx.model import SMPLXModel

        scene = GaussianScene(**self.avatar, alive=torch.ones(
            conf["n_gaussians"], dtype=torch.bool, device=self.dev))
        self.animator = AvatarAnimator(
            scene, smplx_from_numpy(SMPLXModel(**self.model._asdict()),
                                    self.dev),
            scale_delta=conf["scale_delta"], max_err=conf["bind_max_err"])
        for _ in range(traffic["warm_frames"]):
            self.run_unit()
        self.i = 0

    # ---- the window ------------------------------------------------------------
    def run_unit(self):
        from humangaussian_torch.apps.animate import render_motion_frame

        k = self.i % self.n
        t0 = time.perf_counter()
        img = render_motion_frame(self.animator, self.motion[k], k, self.n,
                                  self.args, self.bg)
        lat = time.perf_counter() - t0
        if self.sampling:
            self._offer(self.i, k, img)
        self.i += 1
        return lat

    def _offer(self, i, k, img):
        """Reservoir sampling of `check_frames` frames of the window."""
        m = self.traffic["check_frames"]
        if len(self.sample) < m:
            self.sample.append((i, k, img))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < m:
                self.sample[j] = (i, k, img)

    def synchronize(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def begin_window(self):
        self.i = 0
        self.sampling = True

    def end_window(self):
        self.sampling = False

    def begin_traced(self):
        self.captured = []
        self.capturing = True

    def end_traced(self):
        self.capturing = False

    @contextlib.contextmanager
    def spans(self):
        """Spans around `render_frame` (re-pose and render) and
        `frame_scene` (the re-pose); each frame's re-posed scene and camera
        are kept for the counts."""
        from portbench.trace import wrap

        animator = self.animator

        def keep_camera(args, kwargs):
            if self.capturing:
                self.captured.append([args[1], None])

        def keep_scene(scene):
            if self.capturing and self.captured:
                self.captured[-1][1] = scene

        undo = [wrap(animator, "render_frame", "portbench.render_frame",
                     keep_camera),
                wrap(animator, "frame_scene", "portbench.frame_scene",
                     on_result=keep_scene)]
        try:
            yield
        finally:
            for u in undo:
                u()

    def raster_inputs(self):
        """(params, alive, [camera], height, width, tile cap, raster config,
        background, differentiated) of each traced frame: the program's
        re-posed scene of that frame's pose, and its camera."""
        from portbench.reference.avatar import take
        from portbench.reference.projection import RasterizeConfig

        rcfg = take(RasterizeConfig, self.conf["rasterizer"])
        out = []
        size = self.conf["size"]
        for cam, scene in self.captured:
            params = {"means": scene.means, "log_scales": scene.log_scales,
                      "quats": scene.quats, "sh_dc": scene.sh_dc,
                      "sh_rest": scene.sh_rest,
                      "opacity_logits": scene.opacity_logits}
            out.append((params, scene.alive, [cam], size, size,
                        self.conf["tile_capacity"], rcfg, self.bg, False))
        return out

    def launch_note(self) -> str:
        from humangaussian_torch import kernels

        return f"program launches since start: {kernels.launch_counts()}"

    # ---- the comparison ------------------------------------------------------------
    def reference_frames(self, dtype=torch.float32):
        """The plain reference's (bound count, [re-posed means], [images])
        of the sampled frames; `dtype` bfloat16 is the control."""
        from portbench.reference.avatar import take
        from portbench.reference.body import bind, model_tensors, reposed_means
        from portbench.reference.composite import render
        from portbench.reference.projection import RasterizeConfig

        conf, av = self.conf, self.avatar
        b = bind(self.model, av["means"].cpu().numpy(), self.dev,
                 conf["scale_delta"], conf["bind_max_err"])
        keep = torch.from_numpy(b.keep).to(self.dev)
        tm = model_tensors(self.model, self.dev)
        rcfg = take(RasterizeConfig, conf["rasterizer"])
        m = int(b.keep.sum())
        alive = torch.ones(m, dtype=torch.bool, device=self.dev)
        scales = torch.exp(av["log_scales"][keep])
        feats = torch.cat([av["sh_dc"][keep][:, None], av["sh_rest"][keep]],
                          dim=1)
        opa = torch.sigmoid(av["opacity_logits"][keep])[:, 0]
        means_all, images = [], []
        with torch.no_grad():
            for _, k, _ in self.sample:
                pose = torch.from_numpy(self.motion[k]).to(self.dev)
                means = reposed_means(tm, b, pose, dtype).float()
                cam = frame_camera(k, self.n, conf["size"], conf["radius"],
                                   conf["rotate"], self.dev)
                out = render(means, scales, av["quats"][keep], feats, opa,
                             alive, [cam], self.bg, conf["sh_degree"], rcfg,
                             conf["tile_capacity"], feature_dtype=dtype)
                means_all.append(means)
                images.append(out["image"][0].cpu())
        return m, means_all, images

    def check(self) -> list:
        if self.control:
            n_prog, prog_means, prog_images = self.reference_frames(
                torch.bfloat16)
        else:
            from humangaussian_torch.smplx.lbs import SMPLXPose

            anim = self.animator
            n_prog = anim.n_gaussians
            with torch.no_grad():
                prog_means = [anim.frame_scene(SMPLXPose.rest(
                    body_pose=torch.from_numpy(self.motion[k]).to(self.dev)))
                    .means[:n_prog].clone() for _, k, _ in self.sample]
            prog_images = [torch.from_numpy(np.asarray(img))
                           for _, _, img in self.sample]
            self.animator = None
            gc.collect()
            if self.dev.type == "cuda":
                torch.cuda.empty_cache()
        n_ref, ref_means, ref_images = self.reference_frames()
        rep = (max(float((a - b).abs().max())
                   for a, b in zip(prog_means, ref_means))
               if n_prog == n_ref else float("inf"))
        diffs = [(a.float() - b).abs() for a, b in zip(prog_images,
                                                         ref_images)]
        mean_abs = [float(d.mean()) for d in diffs]
        max_abs = [float(d.max()) for d in diffs]
        checks = [
            Check("repose_max_abs", rep, LIMITS["repose_max_abs"]),
            Check("image_mean_abs", max(mean_abs), LIMITS["image_mean_abs"]),
            Check("image_max_abs", max(max_abs), LIMITS["image_max_abs"]),
        ]
        self.failed = sum(a > LIMITS["image_mean_abs"]
                          or b > LIMITS["image_max_abs"]
                          for a, b in zip(mean_abs, max_abs))
        return checks


def build(seed, device, conf, traffic, control=False):
    return AnimCell(seed, device, conf, traffic, control)
