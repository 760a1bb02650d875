"""hg_avatar_sdxl: HumanGaussian's avatar trainer with Stable Diffusion XL
base 1.0 as its prior, as configs/avatar_sdxl.yaml ships it, built in
memory from the seed.

The program's objects are those `apps.launch._build_avatar_system` and
`build_sdxl_guidance` build (the launcher reads weights only from files):
`SingleUNet(SDXL_BASE_CONFIG)` and the sdxl-vae `AutoencoderKL` built on
the meta device, filled on the card from the benchmark's seeded bfloat16
weights, cast by `cast_weights` and put in the channels_last format,
`SDXLSystemGuidance`, the skeleton of the SMPL-X stand-in, the seeded
prompt embeddings (token rows and pooled rows) and
`GaussianDreamerSystem`.

The unit, the set-up and what the comparison keeps are those of
`hg_avatar_sd2` (whose cell this one extends): one pass of
`run_training`'s loop a unit, the traffic's first `checked_steps` run in
set-up from `init_state(seed)`. After the window the program is freed and
the plain trainer (`reference/avatar_sdxl.py`) follows the same steps.
The launch note adds the transformer blocks the program's UNet ran, from
forward hooks on its `BasicTransformerBlock`s (70 a UNet pass).
"""
from __future__ import annotations

import gc
import os

import torch

from portbench import harness, inputs
from portbench.checks import (
    Check,
    counted_leaves,
    worst_norm_gap,
    worst_rel_diff,
)
from portbench.reference.avatar import take

sd2 = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "hg_avatar_sd2.py"), "portbench_config_hg_avatar_sd2")

# Limits (PERF.md, "Limits"; sound: 9 seeds, control: the plain trainer
# with the prior in float8, 3 seeds; half batch: the step's loss and
# gradients from half the camera batch, scripts/sdxl_half_batch.py, 3
# seeds; H100). The loss and the gradients' difference separate the sound
# runs from both and take a limit between them; the per-pixel clip and
# Adam leave the gradients' norms and the parameters' change nearly as
# they are in the control, so those two take the SD2 cell's limits,
# between the sound readings and 1 (what a zero gradient and a state left
# unchanged read). The half batch fails the loss, the gradients' norm and
# their difference on every seed.
LIMITS = {
    # sound 0.00068-0.0036, control 0.082-0.175, half batch 0.176-0.434
    "loss_rel_gap": 0.03,
    # sound 0.0031-0.0141, control 0.019-0.062, half batch 0.074-0.257
    "grad_norm_gap": 0.06,
    # sound 0.083-0.109, control 0.749-0.910, half batch 1.004-1.012
    "grad_rel_diff": 0.3,
    # sound 0.00025-0.0033, half batch 0.0095-0.0254, state unchanged 1
    "change_norm_gap": 0.05,
}


def prompt_rows(seed: int, device, seq: int, dim: int, pooled_dim: int):
    """(token rows, pooled rows): the five fields of `inputs.
    prompt_embeddings` ([4, L, D] view-dependent cond and negative, [L, D]
    cond, negative and empty) and the same five as pooled rows ([4, P],
    [P]), float32 stand-ins for SDXL's two CLIP encoders."""
    p = torch.randn((11, pooled_dim), generator=inputs.generator(
        seed, device, 4), device=device)
    return (inputs.prompt_embeddings(seed, device, seq, dim),
            (p[0:4], p[4:8], p[8], p[9], p[10]))


def seeded_prior(conf: dict, seed: int, device):
    """The benchmark's bfloat16 weights for the UNet and the VAE, named by
    the plain reference's modules (the program's carry the same names)."""
    from portbench.reference.unet_sdxl import SDXLUNet, SDXLUNetConfig
    from portbench.reference.vae import AutoencoderKL, VAEConfig

    with torch.device("meta"):
        unet = SDXLUNet(take(SDXLUNetConfig, {
            k: v for k, v in conf["unet"].items() if k != "dtype"}))
        vae = AutoencoderKL(take(VAEConfig, {
            k: v for k, v in conf["vae"].items() if k != "dtype"}))
    return (inputs.seeded_state_dict(unet, seed, device, salt=1),
            inputs.seeded_state_dict(vae, seed, device, salt=2))


def build_program(conf: dict, model, prompts, pooled, unet_sd, vae_sd,
                  device, init_points: int):
    """The program's `GaussianDreamerSystem`, as the launcher builds it."""
    from humangaussian_torch.data.cameras import RandomCameraConfig
    from humangaussian_torch.guidance.prompt import PromptEmbeddings
    from humangaussian_torch.guidance.schedule import sd_eps_schedule
    from humangaussian_torch.guidance.stable_diffusion_xl import (
        SDXLGuidance,
        SDXLGuidanceConfig,
        SDXLSystemGuidance,
    )
    from humangaussian_torch.guidance.unet import (
        SingleUNet,
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
    ucfg, vcfg = sd2._prior_cfgs(conf, UNetConfig, VAEConfig)
    with torch.device("meta"):
        unet, vae = SingleUNet(ucfg), AutoencoderKL(vcfg)
    bf16 = bool(s["guidance"].get("half_precision_weights", True))
    for module, sd, dtype in ((unet, unet_sd, ucfg.dtype),
                              (vae, vae_sd, vcfg.dtype)):
        module.to_empty(device=dev)
        module.load_state_dict(sd)
        cast_weights(module, dtype, round_to_bf16=bf16)
        module.to(memory_format=torch.channels_last)
    guidance = SDXLSystemGuidance(SDXLGuidance(
        unet, vae, sd_eps_schedule(device=dev),
        take(SDXLGuidanceConfig, s["guidance"])))
    skel = Skeleton(style="humansd" if s["texture_structure_joint"]
                    else "openpose", apose=s["apose"]).load_smplx(
        SMPLXModel(**model._asdict())).scale(-10)
    return GaussianDreamerSystem(
        take(GaussianDreamerConfig, dict(s, pts_num=init_points)), skel,
        guidance, PromptEmbeddings(*prompts,
                                   pooled=PromptEmbeddings(*pooled)),
        camera_cfg=take(RandomCameraConfig, conf["data"]),
        optim_cfg=take(GaussianOptimConfig, s["optimizer"]),
        raster_cfg=take(RasterizeConfig, s["rasterizer"]), device=dev)


class SDXLTrainCell(sd2.AvatarTrainCell):
    def __init__(self, seed: int, device, conf: dict, traffic: dict,
                 control: bool = False):
        # a program without the SDXL guidance fails here, before any build
        import humangaussian_torch.guidance.stable_diffusion_xl  # noqa: F401

        self.seed = int(seed) & inputs.SEED_MASK
        self.dev = torch.device(device)
        self.conf, self.traffic = conf, traffic
        self.model = inputs.standin_model()
        self.prompts, self.pooled = prompt_rows(self.seed, self.dev,
                                                **conf["prompt"])
        self.log_every = traffic["log_every"]
        self.captured = []
        self.capturing = False
        self.failed = 0
        self.blocks_run = 0
        if control:
            self._control_steps()
            return
        if self.dev.type == "cuda":
            from humangaussian_torch import kernels

            kernels.build_all()
        self.system = build_program(
            conf, self.model, self.prompts, self.pooled,
            *seeded_prior(conf, self.seed, self.dev), self.dev,
            traffic["init_points"])
        self._count_blocks()
        self.state = self.system.init_state(self.seed)._replace(
            step=traffic["start_step"])
        self._checked_steps()

    def _count_blocks(self):
        from humangaussian_torch.guidance.unet import BasicTransformerBlock

        def hook(*_args):
            self.blocks_run += 1

        unet = self.system.guidance.xl.unet
        self.n_blocks = 0
        for m in unet.modules():
            if isinstance(m, BasicTransformerBlock):
                m.register_forward_hook(hook)
                self.n_blocks += 1

    def _reference(self, precision: str = "float32"):
        from portbench.reference.avatar_sdxl import SDXLReferenceTrainer

        return SDXLReferenceTrainer(
            self.conf, self.model, self.prompts, self.pooled,
            *seeded_prior(self.conf, self.seed, self.dev), self.seed,
            self.dev, precision=precision,
            init_points=self.traffic["init_points"],
            start_step=self.traffic["start_step"])

    def _reference_steps(self, ref):
        p0 = {k: v.clone() for k, v in ref.params.items()}
        losses, g1 = [], None
        for i in range(self.traffic["checked_steps"]):
            r = ref.step()
            losses.append(r["loss"])
            if i == 0:
                g1 = r["grads"]
        return p0, losses, g1, ref.params

    def _control_steps(self):
        """The control in the program's place: the plain trainer with the
        prior in float8 (`common.set_precision`)."""
        self.p0, self.losses, self.g1, self.p3 = self._reference_steps(
            self._reference("fp8"))
        self.system = self.state = None

    def launch_note(self) -> str:
        steps = self.traffic["checked_steps"] + self.traffic["warm_steps"]
        return (f"{super().launch_note()}; transformer blocks run "
                f"{self.blocks_run} (a UNet pass has {self.n_blocks}; "
                f"{steps} set-up steps before the window)")

    def check(self) -> list:
        self.system = self.state = None
        self.captured = []
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        p0, losses, g1, p3 = self._reference_steps(self._reference())
        d_ref = {k: p3[k] - p0[k] for k in p0}
        d_prog = {k: self.p3[k] - self.p0[k] for k in p0}
        leaves = counted_leaves(g1)
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(self.losses, losses))
        gn, gn_leaf = worst_norm_gap(self.g1, g1, leaves)
        gd, gd_leaf = worst_rel_diff(self.g1, g1, leaves)
        cn, cn_leaf = worst_norm_gap(d_prog, d_ref, leaves)
        self.details = {"leaves": leaves,
                        "worst": [gn_leaf, gd_leaf, cn_leaf],
                        "losses": self.losses, "ref_losses": losses}
        checks = [Check(name, value, LIMITS[name]) for name, value in (
            ("loss_rel_gap", loss_gap), ("grad_norm_gap", gn),
            ("grad_rel_diff", gd), ("change_norm_gap", cn))]
        self.failed = 0 if all(c.ok for c in checks) else len(self.losses)
        return checks


def build(seed, device, conf, traffic, control=False):
    return SDXLTrainCell(seed, device, conf, traffic, control)
