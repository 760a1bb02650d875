"""The plain avatar trainer: HumanGaussian's text-to-avatar SDS step in
float32, written from the reference's recipe with frozen copies of the
modules it needs, and no kernel.

One step, as the program's `GaussianDreamerSystem.train_step` is
specified: draw 8 cameras, the timesteps' unit draws, the encodes' and
the noise's normal draws from one device generator in that order; draw
the skeleton's pose images; render the batch; encode the render, the
min-max normalized depth and the pose image (resized to 512^2) with the
VAE; score the noisy latents with the dual-branch UNet on [cond | neg |
null] text (ANPG); clip the gradient per pixel and by the C() schedule;
the reparameterized SDS loss plus the sparsity loss; the gradients of the
Gaussians' parameters; per-group Adam.

The two 1024^2 -> 512^2 encodes and the render are differentiated by
parts so that a float32 step fits: the latents' gradient is carried back
through each encode in chunks of images, and the images' gradient through
each view's render by itself (the render of a view does not depend on the
others).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
from portbench.reference.composite import render
from portbench.reference.optim import GaussianOptimConfig, adam_init, adam_step
from portbench.reference.pose_image import draw_humansd_pose
from portbench.reference.projection import RasterizeConfig
from portbench.reference.resize import resize_bilinear
from portbench.reference.scene import scene_from_points
from portbench.reference.schedule import DiffusionSchedule
from portbench.reference.unet import DualBranchUNet, UNetConfig
from portbench.reference.vae import AutoencoderKL, VAEConfig, sample_latent

RGB_MEAN, RGB_STD = 0.14654, 1.03744
WHOLE_MEAN, WHOLE_STD = -0.2481, 1.45647
DEPTH_MEAN, DEPTH_STD = 0.21360, 1.20629
VAE_SCALE = 0.18215
ENCODE_CHUNK = 2  # images a chunk of a float32 encode


def take(cls, src: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in src.items() if k in names})


def c_schedule(value, step) -> float:
    """A C()-style scalar (start_step, start, end, end_step) at `step`."""
    if isinstance(value, (int, float)):
        return float(value)
    s0, v0, v1, s1 = value
    t = min(max((float(step) - s0) / max(s1 - s0, 1e-8), 0.0), 1.0)
    return v0 + (v1 - v0) * t


def direction_index(elevation, azimuth):
    """0 side, 1 front, 2 back, 3 overhead (thresholds 45 / 45 / 60)."""
    az = (azimuth + 180.0) % 360.0 - 180.0
    idx = torch.zeros(elevation.shape, dtype=torch.int64,
                      device=elevation.device)
    idx = torch.where((az > -45.0) & (az < 45.0), 1, idx)
    idx = torch.where((az > 135.0) | (az < -135.0), 2, idx)
    return torch.where(elevation > 60.0, 3, idx)


def build_prior(conf: dict, unet_sd: dict, vae_sd: dict, device,
                precision: str = "float32"):
    """(unet, vae) in float32 from the benchmark's state dicts; `precision`
    `fp8` is the control (common.set_precision)."""
    ucfg = dataclasses.replace(take(UNetConfig, conf["unet"]),
                               dtype=torch.float32)
    vcfg = dataclasses.replace(take(VAEConfig, conf["vae"]),
                               dtype=torch.float32)
    with torch.device("meta"):
        unet, vae = DualBranchUNet(ucfg), AutoencoderKL(vcfg)
    for module, sd in ((unet, unet_sd), (vae, vae_sd)):
        module.to_empty(device=device)
        module.load_state_dict({k: v.float() for k, v in sd.items()})
        module.eval().requires_grad_(False)
        set_precision(module, precision)
    return unet, vae


class ReferenceTrainer:
    """The plain trainer from `seed`: the initial scene, Adam and the
    generator, then `step()` after step."""

    def __init__(self, conf: dict, model, prompts, unet_sd: dict,
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
        self.schedule = DiffusionSchedule.create(device=device)
        self.prompts = prompts
        verts, kp = skeleton_apose(model)
        self.pose_points = torch.tensor(kp, device=device)
        pts = sample_mesh_surface(verts, model.faces,
                                  init_points or s["pts_num"], seed)
        scene = scene_from_points(
            torch.from_numpy(pts).to(device),
            torch.full((pts.shape[0], 3), 0.5, device=device),
            capacity=s["capacity"], sh_degree=s["sh_degree"],
            mean_sq_dist=mean_3nn_sq_dist(pts))
        self.scene = scene
        self.params = {k: v.clone() for k, v in scene.params().items()}
        self.adam = adam_init(self.params)
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.step_count = start_step
        self.background = torch.zeros(3, device=device)

    # ---- draws -----------------------------------------------------------
    def _timesteps(self, u, step):
        s = self.conf["system"]
        n = self.schedule.num_train_timesteps
        pct = (s["max_step_percent_annealed"]
               if step > s["half_scheduler_max_step"]
               else s["max_step_percent"])
        lo = int(n * s["min_step_percent"])
        hi = int(np.float32(n) * np.float32(pct))
        return (lo + u * float(hi + 1 - lo)).to(torch.int64)

    def _normal(self, shape):
        return torch.randn(shape, generator=self.gen, dtype=torch.float32,
                           device=self.dev)

    # ---- the prior ---------------------------------------------------------
    def _encode(self, img, eps, with_grad=False, grad_out=None):
        """Latents of [B, H, W, 3] images in [0, 1], in chunks; with
        `grad_out` (the latents' gradient) returns the images' gradient."""
        size = self.guidance_cfg.get("image_size", 512)
        outs = []
        for i in range(0, img.shape[0], ENCODE_CHUNK):
            x = img[i:i + ENCODE_CHUNK].detach()
            if grad_out is None:
                with torch.no_grad():
                    mean, logvar = self.vae.encode(
                        resize_bilinear(x, size) * 2.0 - 1.0)
                    outs.append(sample_latent(mean, logvar,
                                              eps=eps[i:i + ENCODE_CHUNK])
                                * VAE_SCALE)
                continue
            x.requires_grad_(True)
            with torch.enable_grad():
                mean, logvar = self.vae.encode(
                    resize_bilinear(x, size) * 2.0 - 1.0)
                lat = sample_latent(mean, logvar,
                                    eps=eps[i:i + ENCODE_CHUNK]) * VAE_SCALE
                outs.append(torch.autograd.grad(
                    lat, x, grad_out[i:i + ENCODE_CHUNK])[0])
        return torch.cat(outs)

    def _unet(self, lat_in, dep_in, t, text):
        g = self.guidance_cfg
        o, ts = g["original_size"], g["target_size"]
        time_ids = torch.tensor([[o, o, 0, 0, ts, ts]], dtype=torch.float32,
                                device=self.dev).repeat(lat_in.shape[0], 1)
        with torch.no_grad():
            return self.unet(lat_in, dep_in, t, text, time_ids)

    def sds(self, pose, rgb, depth3, text, t, draws, step):
        """(loss_sds, d loss / d rgb, d loss / d depth3) of the dual-branch
        ANPG guidance."""
        g = self.guidance_cfg
        if g["mode"] != "anpg":
            raise ValueError("the plain trainer follows the anpg mode")
        b = rgb.shape[0]
        latents = self._encode(rgb, draws["rgb"])
        dep_raw = self._encode(depth3, draws["depth"])
        dep_lat = (dep_raw - DEPTH_MEAN) / DEPTH_STD * RGB_STD + RGB_MEAN
        whole = ((self._encode(pose, draws["pose"]) - WHOLE_MEAN)
                 / WHOLE_STD * RGB_STD + RGB_MEAN)
        lat_noisy = self.schedule.add_noise(latents, draws["noise"], t)
        dep_noisy = self.schedule.add_noise(dep_lat, draws["depth_noise"], t)
        whole3 = whole.repeat(3, 1, 1, 1)
        pred = self._unet(torch.cat([lat_noisy.repeat(3, 1, 1, 1), whole3], -1),
                          torch.cat([dep_noisy.repeat(3, 1, 1, 1), whole3], -1),
                          t.repeat(3), text)
        e_text, e_neg, e_null = pred.chunk(3, dim=0)
        delta_c = g["guidance_scale"] * (e_text - e_null)
        mask = (t < g.get("anpg_boundary_t", 200)).float().reshape(b, 1, 1, 1)
        score = delta_c + mask * e_null + (1.0 - mask) * (e_null - e_neg)
        w = self.schedule.sds_weight(t, g["weighting_strategy"])
        grad = w.reshape(b, 1, 1, 1) * score
        if g["grad_clip_pixel"]:
            gn = torch.linalg.vector_norm(grad, dim=-1, keepdim=True) + 1e-8
            grad = gn.clamp_max(g["grad_clip_threshold"]) * grad / gn
        grad = torch.nan_to_num(grad)
        clip = c_schedule(self.conf["system"]["grad_clip"], step)
        grad = grad.clamp(-clip, clip)
        d_rgb = latents - (latents - grad[..., :4])
        d_dep = dep_lat - (dep_lat - grad[..., 4:8])
        lw = g["lw_depth"]
        loss = 0.5 * (d_rgb ** 2).sum() / b + lw * (d_dep ** 2).sum() / b
        g_rgb = self._encode(rgb, draws["rgb"], grad_out=d_rgb / b)
        g_dep = self._encode(depth3, draws["depth"],
                             grad_out=2.0 * lw * d_dep / b
                             * (RGB_STD / DEPTH_STD))
        return loss, g_rgb, g_dep

    # ---- the step ----------------------------------------------------------
    def _render(self, params, cams, with_grad):
        s = self.conf["system"]
        feats = torch.cat([params["sh_dc"][:, None, :], params["sh_rest"]],
                          dim=1)
        q = params["quats"]
        return render(params["means"], torch.exp(params["log_scales"]), q,
                      feats, torch.sigmoid(params["opacity_logits"])[:, 0],
                      self.scene.alive, cams, self.background,
                      s["sh_degree"], self.raster_cfg,
                      s.get("tile_capacity", 4096), with_grad)

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
        text_vd, uncond_vd, _, _, null = self.prompts
        text = torch.cat([text_vd[idx], uncond_vd[idx],
                          null.expand(b, *null.shape)], dim=0)
        size = s["pose_image_size"]
        pose, _ = draw_humansd_pose(self.pose_points, cams.mvp_mtx, size,
                                    size, cams.azimuth.abs() > 120.0)
        t = self._timesteps(u, st)
        down = 2 ** (len(self.conf["vae"]["block_out_channels"]) - 1)
        lat = self.guidance_cfg.get("image_size", 512) // down
        ch = self.conf["vae"]["latent_channels"]
        draws = {k: self._normal((b, lat, lat, ch))
                 for k in ("rgb", "depth", "pose", "noise", "depth_noise")}

        cam = camera_from_c2w(cams.c2w, cams.fovy, cc.height, cc.width)
        views = [cam[i] for i in range(b)]
        with torch.no_grad():
            out = self._render(self.params, views, False)
        img = out["image"].requires_grad_(True)
        dep = out["depth"][..., None].requires_grad_(True)
        opacity = dep / (dep.max().detach() + 1e-5)
        dmin = dep.amin(dim=(1, 2, 3), keepdim=True)
        dmax = dep.amax(dim=(1, 2, 3), keepdim=True)
        depth3 = ((dep - dmin) / (dmax - dmin + 1e-10)).expand(-1, -1, -1, 3)
        loss_sds, g_rgb, g_dep3 = self.sds(pose, img.detach(),
                                           depth3.detach(), text, t, draws,
                                           st)
        sparsity = torch.sqrt(opacity ** 2 + 0.01).mean()
        oc = opacity.clamp(1e-3, 1.0 - 1e-3)
        opaque = (-(oc * torch.log(oc) + (1 - oc) * torch.log(1 - oc))).mean()
        l_sds = c_schedule(s["lambda_sds"], st)
        l_sp = c_schedule(s["lambda_sparsity"], st)
        l_op = c_schedule(s["lambda_opaque"], st)
        surrogate = (l_sds * ((img * g_rgb).sum() + (depth3 * g_dep3).sum())
                     + l_sp * sparsity + l_op * opaque)
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
