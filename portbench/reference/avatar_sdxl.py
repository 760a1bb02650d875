"""The plain avatar trainer against SDXL: HumanGaussian's SDS step with
Stable Diffusion XL base 1.0 as the prior, in float32, with no kernel.

It reuses `reference/avatar.py`'s trainer (the scene from the stand-in's
surface, the camera sampler, the plain render and its per-view backward,
Adam) and replaces the prior and the guidance step, as the program's
`SDXLSystemGuidance` is specified:

- draws, from one device generator in this order: 8 cameras, the
  timesteps' unit draws, the encode's normal draw, the gradient's;
- the render (1024^2) mapped to [-1, 1] and encoded by the sdxl-vae at its
  own size (no resize), the latent scaled by 0.13025;
- the UNet on [cond | neg | null] text rows and pooled rows of each view's
  direction, with the time ids (original H x W, crop 0 0, target H x W);
  the ANPG score s (e_text - e_null) + (t < 200 ? e_null : e_null -
  e_neg); w(t) = 1 - alpha_bar on the epsilon schedule (scaled-linear
  0.00085 -> 0.012, no zero-SNR rescale); the per-pixel norm clip; the
  C() clamp; the reparameterized loss and the sparsity loss.

Departures for room: the encode runs one image at a time, its gradient
carried back image by image; the UNet runs on blocks of `UNET_BLOCK`
samples. The pose image is not drawn: SDXL is a single-branch prior and
takes none.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench.reference.avatar import (
    ReferenceTrainer,
    c_schedule,
    direction_index,
    take,
)
from portbench.reference.body import (
    mean_3nn_sq_dist,
    sample_mesh_surface,
    skeleton_apose,
)
from portbench.reference.camera import camera_from_c2w
from portbench.reference.camera_sampler import (
    RandomCameraConfig,
    sample_camera_batch,
)
from portbench.reference.common import set_precision
from portbench.reference.optim import GaussianOptimConfig, adam_init, adam_step
from portbench.reference.projection import RasterizeConfig
from portbench.reference.scene import scene_from_points
from portbench.reference.schedule import DiffusionSchedule
from portbench.reference.unet_sdxl import SDXLUNet, SDXLUNetConfig
from portbench.reference.vae import AutoencoderKL, VAEConfig, sample_latent

UNET_BLOCK = 8  # samples a block of the float32 UNet


def build_prior(conf: dict, unet_sd: dict, vae_sd: dict, device,
                precision: str = "float32"):
    """(unet, vae) in float32 from the benchmark's state dicts; `precision`
    `fp8` is the control (common.set_precision)."""
    ucfg = dataclasses.replace(take(SDXLUNetConfig, conf["unet"]),
                               dtype=torch.float32)
    vcfg = dataclasses.replace(take(VAEConfig, conf["vae"]),
                               dtype=torch.float32)
    with torch.device("meta"):
        unet, vae = SDXLUNet(ucfg), AutoencoderKL(vcfg)
    for module, sd in ((unet, unet_sd), (vae, vae_sd)):
        module.to_empty(device=device)
        module.load_state_dict({k: v.float() for k, v in sd.items()})
        module.eval().requires_grad_(False)
        set_precision(module, precision)
    return unet, vae


class SDXLReferenceTrainer(ReferenceTrainer):
    """The plain trainer against SDXL from `seed`; `prompts` is the token
    rows' five fields and `pooled` the pooled rows' five fields."""

    def __init__(self, conf: dict, model, prompts, pooled, unet_sd: dict,
                 vae_sd: dict, seed: int, device, precision="float32",
                 init_points: int | None = None, start_step: int = 0):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        s = conf["system"]
        self.conf, self.dev = conf, torch.device(device)
        self.camera_cfg = take(RandomCameraConfig, conf["data"])
        self.optim_cfg = take(GaussianOptimConfig, s["optimizer"])
        self.raster_cfg = take(RasterizeConfig, s["rasterizer"])
        self.guidance_cfg = s["guidance"]
        self.unet, self.vae = build_prior(conf, unet_sd, vae_sd, device,
                                          precision)
        self.schedule = DiffusionSchedule.create(
            rescale_betas_zero_snr=False, prediction_type="epsilon",
            device=device)
        self.prompts, self.pooled = prompts, pooled
        verts, _kp = skeleton_apose(model)
        pts = sample_mesh_surface(verts, model.faces,
                                  init_points or s["pts_num"], seed)
        self.scene = scene_from_points(
            torch.from_numpy(pts).to(device),
            torch.full((pts.shape[0], 3), 0.5, device=device),
            capacity=s["capacity"], sh_degree=s["sh_degree"],
            mean_sq_dist=mean_3nn_sq_dist(pts))
        self.params = {k: v.clone() for k, v in self.scene.params().items()}
        self.adam = adam_init(self.params)
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.step_count = start_step
        self.background = torch.zeros(3, device=device)

    def _encode_xl(self, img, eps, grad_out=None):
        """Latents of [B, H, W, 3] images in [0, 1], one image at a time;
        with `grad_out` (the latents' gradient) the images' gradient."""
        scale = self.conf["vae"]["scaling_factor"]
        outs = []
        for i in range(img.shape[0]):
            x = img[i:i + 1].detach().requires_grad_(grad_out is not None)
            with torch.set_grad_enabled(grad_out is not None):
                mean, logvar = self.vae.encode(x * 2.0 - 1.0)
                lat = sample_latent(mean, logvar, eps=eps[i:i + 1]) * scale
                outs.append(lat if grad_out is None else torch.autograd.grad(
                    lat, x, grad_out[i:i + 1])[0])
        return torch.cat(outs)

    def _unet_xl(self, x, t, text, pooled):
        g = self.guidance_cfg
        o, ts = g["original_size"], g["target_size"]
        ids = torch.tensor([[o, o, 0, 0, ts, ts]], dtype=torch.float32,
                           device=self.dev)
        outs = []
        with torch.no_grad():
            for i in range(0, x.shape[0], UNET_BLOCK):
                n = x[i:i + UNET_BLOCK].shape[0]
                outs.append(self.unet(x[i:i + n], t[i:i + n],
                                      text[i:i + n], pooled[i:i + n],
                                      ids.expand(n, -1)))
        return torch.cat(outs)

    def sds_xl(self, rgb, text, pooled, t, draws, step):
        """(loss_sds, d loss / d rgb) of the SDXL ANPG guidance."""
        g = self.guidance_cfg
        if g["mode"] != "anpg":
            raise ValueError("the plain trainer follows the anpg mode")
        b = rgb.shape[0]
        latents = self._encode_xl(rgb, draws["rgb"])
        noisy = self.schedule.add_noise(latents, draws["noise"], t)
        pred = self._unet_xl(noisy.repeat(3, 1, 1, 1), t.repeat(3), text,
                             pooled)
        e_text, e_neg, e_null = pred.chunk(3, dim=0)
        mask = (t < g.get("anpg_boundary_t", 200)).float().reshape(
            b, 1, 1, 1)
        score = (g["guidance_scale"] * (e_text - e_null) + mask * e_null
                 + (1.0 - mask) * (e_null - e_neg))
        w = self.schedule.sds_weight(t, g["weighting_strategy"])
        grad = w.reshape(b, 1, 1, 1) * score
        if g["grad_clip_pixel"]:
            gn = torch.linalg.vector_norm(grad, dim=-1, keepdim=True) + 1e-8
            grad = gn.clamp_max(g["grad_clip_threshold"]) * grad / gn
        grad = torch.nan_to_num(grad)
        clip = c_schedule(self.conf["system"]["grad_clip"], step)
        grad = grad.clamp(-clip, clip)
        d = latents - (latents - grad)
        loss = 0.5 * (d ** 2).sum() / b
        return loss, self._encode_xl(rgb, draws["rgb"], grad_out=d / b)

    def step(self) -> dict:
        """One step; returns {loss, grads (a dict of leaves), pairs}."""
        s = self.conf["system"]
        st = self.step_count
        cc = self.camera_cfg
        b = cc.batch_size
        cams = sample_camera_batch(self.gen, st, cc, self.dev)
        u = torch.rand(b, generator=self.gen, device=self.dev,
                       dtype=torch.float32)
        idx = direction_index(cams.elevation, cams.azimuth)

        def rows(fields):
            vd, uncond_vd, _, _, null = fields
            return torch.cat([vd[idx], uncond_vd[idx],
                              null.expand(b, *null.shape)], dim=0)

        text, pooled = rows(self.prompts), rows(self.pooled)
        t = self._timesteps(u, st)
        down = 2 ** (len(self.conf["vae"]["block_out_channels"]) - 1)
        lat = self.guidance_cfg["image_size"] // down
        ch = self.conf["vae"]["latent_channels"]
        draws = {k: self._normal((b, lat, lat, ch)) for k in ("rgb", "noise")}

        cam = camera_from_c2w(cams.c2w, cams.fovy, cc.height, cc.width)
        views = [cam[i] for i in range(b)]
        with torch.no_grad():
            out = self._render(self.params, views, False)
        img = out["image"].requires_grad_(True)
        dep = out["depth"][..., None].requires_grad_(True)
        opacity = dep / (dep.max().detach() + 1e-5)
        loss_sds, g_rgb = self.sds_xl(img.detach(), text, pooled, t, draws,
                                      st)
        sparsity = torch.sqrt(opacity ** 2 + 0.01).mean()
        oc = opacity.clamp(1e-3, 1.0 - 1e-3)
        opaque = (-(oc * torch.log(oc) + (1 - oc) * torch.log(1 - oc))).mean()
        l_sds = c_schedule(s["lambda_sds"], st)
        l_sp = c_schedule(s["lambda_sparsity"], st)
        l_op = c_schedule(s["lambda_opaque"], st)
        surrogate = (l_sds * (img * g_rgb).sum() + l_sp * sparsity
                     + l_op * opaque)
        gi, gd = torch.autograd.grad(surrogate, [img, dep])
        loss = loss_sds * l_sds + sparsity.detach() * l_sp \
            + opaque.detach() * l_op

        grads = {k: torch.zeros_like(v) for k, v in self.params.items()}
        for i in range(b):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in self.params.items()}
            with torch.enable_grad():
                o = self._render(leaves, [views[i]], True)
                obj = ((o["image"][0] * gi[i]).sum()
                       + (o["depth"][0] * gd[i, ..., 0]).sum())
                gs = torch.autograd.grad(obj, list(leaves.values()),
                                         allow_unused=True)
            for k, gk in zip(leaves, gs):
                if gk is not None:
                    grads[k] += gk
        self.params, self.adam = adam_step(
            self.params, grads, self.adam, self.optim_cfg.group_lrs(st),
            self.optim_cfg)
        self.step_count += 1
        return {"loss": float(loss), "grads": grads, "pairs": out["pairs"]}
