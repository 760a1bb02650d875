"""hg_avatar_sd2: HumanGaussian's avatar trainer at full width, as
configs/avatar.yaml ships it, built in memory from the seed.

The program's objects are those `apps.launch._build_avatar_system` and
`build_guidance` build (the launcher reads weights only from files):
`DualBranchUNet` and `AutoencoderKL` built on the meta device, filled on
the card from the benchmark's seeded bfloat16 weights, cast by
`cast_weights` with the weights rounded through bfloat16 and put in the
channels_last format, `DualBranchGuidance`, the skeleton of the SMPL-X
stand-in, the seeded prompt embeddings and `GaussianDreamerSystem`.

A unit of the window is one pass of `train/loop.py::run_training`'s loop:
`train_step`, then `maybe_densify`, with the loop's metrics read every
`log_every` steps. Set-up runs the traffic's first `checked_steps` through
the same call, from `init_state(seed)`, and keeps what the comparison
needs: the parameters before and after them, the Adam first moment after
the first (the first gradient, times 1 - beta1) and each step's loss.
After the window the program is freed and the plain trainer
(`reference/avatar.py`) follows the same steps from the same seed.
"""
from __future__ import annotations

import contextlib
import gc

import torch

from portbench import inputs
from portbench.reference.avatar import take
from portbench.checks import (
    Check,
    counted_leaves,
    worst_norm_gap,
    worst_rel_diff,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# Limits, each set between the sound runs' highest reading and the
# control's lowest (PERF.md, "Limits").
LIMITS = {
    "loss_rel_gap": 0.15,  # sound 0.0123-0.0195, float8 control 0.727+
    "grad_norm_gap": 0.06,  # sound 0.0026-0.0159, control 0.146+
    "grad_rel_diff": 0.5,  # sound 0.128-0.166, control 0.993+
    "change_norm_gap": 0.05,  # sound 0.00028-0.0032, state unchanged 1
}


def _prior_cfgs(conf: dict, unet_cls_cfg, vae_cls_cfg):
    u = {k: v for k, v in conf["unet"].items() if k != "parameters"}
    u["dtype"] = DTYPES[u["dtype"]]
    v = dict(conf["vae"])
    v["dtype"] = DTYPES[v["dtype"]]
    return take(unet_cls_cfg, u), take(vae_cls_cfg, v)


def seeded_prior(conf: dict, seed: int, device):
    """The benchmark's bfloat16 weights for the UNet and the VAE, named
    by the plain reference's modules (the program's carry the same
    names)."""
    from portbench.reference.unet import DualBranchUNet, UNetConfig
    from portbench.reference.vae import AutoencoderKL, VAEConfig

    ucfg, vcfg = _prior_cfgs(conf, UNetConfig, VAEConfig)
    with torch.device("meta"):
        unet, vae = DualBranchUNet(ucfg), AutoencoderKL(vcfg)
    return (inputs.seeded_state_dict(unet, seed, device, salt=1),
            inputs.seeded_state_dict(vae, seed, device, salt=2))


def build_program(conf: dict, model, prompts, unet_sd, vae_sd, device,
                  init_points: int):
    """The program's `GaussianDreamerSystem`, as the launcher builds it."""
    from humangaussian_torch.data.cameras import RandomCameraConfig
    from humangaussian_torch.guidance.dual_branch import (
        DualBranchGuidance,
        GuidanceConfig,
    )
    from humangaussian_torch.guidance.prompt import PromptEmbeddings
    from humangaussian_torch.guidance.schedule import DiffusionSchedule
    from humangaussian_torch.guidance.unet import (
        DualBranchUNet,
        UNetConfig,
        cast_weights,
    )
    from humangaussian_torch.guidance.vae import AutoencoderKL, VAEConfig
    from humangaussian_torch.ops.projection import RasterizeConfig
    from humangaussian_torch.smplx.model import SMPLXModel
    from humangaussian_torch.smplx.skeleton import Skeleton
    from humangaussian_torch.train.optim import GaussianOptimConfig
    from humangaussian_torch.train.system import (
        GaussianDreamerConfig,
        GaussianDreamerSystem,
    )

    dev = torch.device(device)
    s = conf["system"]
    ucfg, vcfg = _prior_cfgs(conf, UNetConfig, VAEConfig)
    with torch.device("meta"):
        unet, vae = DualBranchUNet(ucfg), AutoencoderKL(vcfg)
    bf16 = bool(s["guidance"].get("half_precision_weights", True))
    for module, sd, dtype in ((unet, unet_sd, ucfg.dtype),
                              (vae, vae_sd, vcfg.dtype)):
        module.to_empty(device=dev)
        module.load_state_dict(sd)
        cast_weights(module, dtype, round_to_bf16=bf16)
        module.to(memory_format=torch.channels_last)
    guidance = DualBranchGuidance(unet, vae, DiffusionSchedule.create(
        device=dev), take(GuidanceConfig, s["guidance"]))
    skel = Skeleton(style="humansd" if s["texture_structure_joint"]
                    else "openpose", apose=s["apose"]).load_smplx(
        SMPLXModel(**model._asdict())).scale(-10)
    sys_cfg = dict(s, pts_num=init_points)
    return GaussianDreamerSystem(
        take(GaussianDreamerConfig, sys_cfg), skel, guidance,
        PromptEmbeddings(*prompts),
        camera_cfg=take(RandomCameraConfig, conf["data"]),
        optim_cfg=take(GaussianOptimConfig, s["optimizer"]),
        raster_cfg=take(RasterizeConfig, s["rasterizer"]), device=dev)


def _quiet(*_args, **_kwargs):
    pass


class AvatarTrainCell:
    unit = "step"

    def __init__(self, seed: int, device, conf: dict, traffic: dict,
                 control: bool = False):
        self.seed = int(seed) & inputs.SEED_MASK
        self.dev = torch.device(device)
        self.conf, self.traffic = conf, traffic
        self.model = inputs.standin_model()
        self.prompts = inputs.prompt_embeddings(self.seed, self.dev,
                                                **conf["prompt"])
        self.log_every = traffic["log_every"]
        self.captured = []
        self.capturing = False
        self.failed = 0
        if control:
            self._control_steps()
            return
        if self.dev.type == "cuda":
            from humangaussian_torch import kernels

            kernels.build_all()
        # the weights are made again from the seed for the reference, so
        # that the window holds only the program's copy
        self.system = build_program(
            conf, self.model, self.prompts,
            *seeded_prior(conf, self.seed, self.dev), self.dev,
            traffic["init_points"])
        state = self.system.init_state(self.seed)
        self.state = state._replace(step=traffic["start_step"])
        self._checked_steps()

    # ---- set-up --------------------------------------------------------------
    def _params(self):
        return {k: v.detach().clone()
                for k, v in self.state.scene.params().items()}

    def _checked_steps(self):
        """The first steps through the window's own call; what the
        comparison reads is kept."""
        self.p0 = self._params()
        self.losses = []
        for i in range(self.traffic["checked_steps"]):
            self.losses.append(self._loop(log_every=1)["loss"])
            if i == 0:
                b1 = self.system.optim_cfg.beta1
                self.g1 = {k: v.detach().clone() / (1.0 - b1)
                           for k, v in self.state.adam.mu.items()}
        self.p3 = self._params()
        for _ in range(self.traffic["warm_steps"]):
            self._loop(self.log_every)
        self.synchronize()

    def _control_steps(self):
        """The control in the program's place: the plain trainer with the
        prior in float8 (`common.set_precision`)."""
        from portbench.reference.avatar import ReferenceTrainer

        ref = ReferenceTrainer(self.conf, self.model, self.prompts,
                               *seeded_prior(self.conf, self.seed, self.dev),
                               self.seed, self.dev, precision="fp8",
                               init_points=self.traffic["init_points"],
                               start_step=self.traffic["start_step"])
        self.p0 = {k: v.clone() for k, v in ref.params.items()}
        self.losses = []
        for i in range(self.traffic["checked_steps"]):
            r = ref.step()
            self.losses.append(r["loss"])
            if i == 0:
                self.g1 = r["grads"]
        self.p3 = ref.params
        del ref
        self.system = self.state = None

    # ---- the window ------------------------------------------------------------
    def _loop(self, log_every):
        from humangaussian_torch.train.loop import run_training

        self.state, history = run_training(
            self.system, self.state, max_steps=self.state.step + 1,
            val_interval=0, save_dir=None, log_every=log_every,
            log_fn=_quiet)
        return history[-1] if history else None

    def run_unit(self):
        self._loop(self.log_every)
        return None

    def synchronize(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def begin_window(self):
        pass

    def end_window(self):
        pass

    def begin_traced(self):
        self.captured = []
        self.capturing = True

    def end_traced(self):
        self.capturing = False

    @contextlib.contextmanager
    def spans(self):
        """Spans around the step's layers: `loss_and_grads` (the forward
        and the backward), `render_batch` and the guidance's call; the
        render's scene and cameras of each step are kept for the counts."""
        from portbench.trace import CallSpan, wrap

        system = self.system

        def keep(args, kwargs):
            if self.capturing:
                scene, cameras = args[0], args[1]
                self.captured.append((
                    {k: v.detach().clone() for k, v in
                     scene.params().items()}, scene.alive.clone(), cameras,
                    args[2], args[3], kwargs.get("tile_cap")))

        undo = [wrap(system, "loss_and_grads", "portbench.loss_and_grads"),
                wrap(system, "render_batch", "portbench.render_batch", keep)]
        guidance = system.guidance
        system.guidance = CallSpan(guidance, "portbench.guidance")
        try:
            yield
        finally:
            system.guidance = guidance
            for u in undo:
                u()

    def raster_inputs(self):
        """(params, alive, Camera list, height, width, tile cap, raster
        config, background, differentiated) of each traced step's render."""
        from portbench.reference.camera import camera_from_c2w
        from portbench.reference.projection import RasterizeConfig

        rcfg = take(RasterizeConfig, self.conf["system"]["rasterizer"])
        out = []
        for params, alive, cams, h, w, cap in self.captured:
            cam = camera_from_c2w(cams.c2w, cams.fovy, h, w)
            out.append((params, alive, [cam[i] for i in range(len(cam))],
                        h, w, cap or self.conf["system"]["tile_capacity"],
                        rcfg, torch.zeros(3, device=self.dev), True))
        return out

    def launch_note(self) -> str:
        from humangaussian_torch import kernels

        return f"program launches since start: {kernels.launch_counts()}"

    # ---- the comparison ------------------------------------------------------------
    def check(self) -> list:
        from portbench.reference.avatar import ReferenceTrainer

        self.system = self.state = None
        self.captured = []
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = ReferenceTrainer(self.conf, self.model, self.prompts,
                               *seeded_prior(self.conf, self.seed, self.dev),
                               self.seed, self.dev, init_points=self.traffic["init_points"],
                               start_step=self.traffic["start_step"])
        p0 = {k: v.clone() for k, v in ref.params.items()}
        losses, g1 = [], None
        for i in range(self.traffic["checked_steps"]):
            r = ref.step()
            losses.append(r["loss"])
            if i == 0:
                g1 = r["grads"]
        d_ref = {k: ref.params[k] - p0[k] for k in p0}
        d_prog = {k: self.p3[k] - self.p0[k] for k in p0}
        leaves = counted_leaves(g1)
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(self.losses,
                                                           losses))
        gn, gn_leaf = worst_norm_gap(self.g1, g1, leaves)
        gd, gd_leaf = worst_rel_diff(self.g1, g1, leaves)
        cn, cn_leaf = worst_norm_gap(d_prog, d_ref, leaves)
        self.details = {"leaves": leaves, "worst": [gn_leaf, gd_leaf,
                                                    cn_leaf],
                        "losses": self.losses, "ref_losses": losses}
        checks = [Check("loss_rel_gap", loss_gap, LIMITS["loss_rel_gap"]),
                  Check("grad_norm_gap", gn, LIMITS["grad_norm_gap"]),
                  Check("grad_rel_diff", gd, LIMITS["grad_rel_diff"]),
                  Check("change_norm_gap", cn, LIMITS["change_norm_gap"])]
        self.failed = 0 if all(c.ok for c in checks) else len(self.losses)
        return checks


def build(seed, device, conf, traffic, control=False):
    return AvatarTrainCell(seed, device, conf, traffic, control)
