"""Structure-Aware SDS guidance: ANPG / SDS gradients and the
reparameterized loss.

Port of humangaussian_tpu/guidance/dual_branch.py. Per step
(`DualBranchGuidance.__call__`):

  1. resize the rgb and depth renders to `image_size`^2
     (`ops/resize.py`: `jax.image.resize`'s antialiased weights, its
     backward added in a fixed order) and VAE-encode both; the depth
     latents are renormalized to the rgb latents' statistics;
  2. encode the skeleton pose image -> `whole_latents`, renormalized, and
     channel-concatenate it onto BOTH noisy latents as conditioning;
  3. one batched UNet forward on 3B inputs ([cond | neg | null] text
     embeddings) -> the ANPG gradient
       delta_c = s * (e_text - e_null)
       delta_d = t < 200 ? e_null : (e_null - e_neg)
       grad    = w(t) * (delta_c + delta_d),  w = 1 - alpha_bar_t
     with an optional per-pixel norm clamp (mode `sds` is plain CFG-SDS on
     a 2B batch, mode `sjc` Score Jacobian Chaining, `compute_grad_sjc`);
  4. the reparameterized loss, so that autograd carries `grad` into the
     renderer: 0.5 ||latents - sg(latents - g_rgb)||^2 / B
     + lw_depth ||depth_latents - sg(depth_latents - g_depth)||^2 / B.

The UNet runs under `torch.no_grad()` (the score is consumed through a
stop-gradient); the two differentiated encodes run under
`torch.utils.checkpoint` when `remat_encode` is on, which recomputes the
encoder in the backward instead of keeping its convolution activations.

With a `branch_num > 1` UNet the step takes a list of structure images,
encodes each, and adds one `lw_depth` term a branch to the loss.
`guidance_eval` is the training-time visualization: the 1-step x0 estimate
and a DDIM rollout from the current noise level, decoded, for both
branches.

Noise: every draw comes from a `torch.Generator` in a fixed order or is
passed in (`noise=`, `depth_noise=`, `latent_eps=`), so a test can inject
the reference's draws. This replaces the reference's `per_sample_normal`,
which folds each sample's id into the key so that its draws do not depend
on how a batch is sharded: a torch generator cannot replay JAX's keys. The
data-parallel step (dist/parallel.py) draws the whole batch's noise with
`step_draws` and hands each rank its rows instead.

Layout: images are `[B, H, W, 3]` in [0, 1], latents and `grad`
`[B, h, w, C]`, as in the reference; the VAE and the UNet turn them
channels-first inside.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from humangaussian_torch.guidance.schedule import DiffusionSchedule
from humangaussian_torch.guidance.vae import sample_latent
from humangaussian_torch.ops.resize import resize_bilinear
from humangaussian_torch.utils.profiling import trace_annotation

# latent-space normalization constants of the joint model
RGB_MEAN = 0.14654
RGB_STD = 1.03744
WHOLE_MEAN = -0.2481
WHOLE_STD = 1.45647
DEPTH_MEAN = 0.21360
DEPTH_STD = 1.20629

VAE_SCALE = 0.18215  # sd-vae-ft-mse scaling_factor


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale: float):
    """CFG std rescale (Lin et al., section 3.4)."""
    axes = tuple(range(1, noise_cfg.dim()))
    std_text = noise_pred_text.std(dim=axes, keepdim=True, unbiased=False)
    std_cfg = noise_cfg.std(dim=axes, keepdim=True, unbiased=False)
    rescaled = noise_cfg * (std_text / std_cfg.clamp_min(1e-8))
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    guidance_scale: float = 100.0
    weighting_strategy: str = "sds"
    lw_depth: float = 0.5
    grad_clip_pixel: bool = True
    grad_clip_threshold: float = 1.0
    original_size: int = 1024
    target_size: int = 1024
    anpg_boundary_t: int = 200  # below it delta_d is e_null alone
    mode: str = "anpg"  # "anpg" | "sds" | "sjc"
    guidance_rescale: float = 0.0
    latent_size: int = 64
    image_size: int = 512
    remat_encode: bool = True  # recompute the VAE encoder in the backward


def _repeat(x, k: int):
    return x.repeat(k, *([1] * (x.dim() - 1)))


def anpg_score(pred, t, guidance_scale: float, boundary_t: int):
    """The ANPG (NFSD) score of a 3-way [cond | neg | null] prediction
    [3B, ...]: s (e_text - e_null) + (t < boundary_t ? e_null : e_null -
    e_neg)."""
    e_text, e_neg, e_null = pred.chunk(3, dim=0)
    delta_c = guidance_scale * (e_text - e_null)
    mask = (t < boundary_t).float().reshape(-1, *([1] * (pred.dim() - 1)))
    delta_d = mask * e_null + (1.0 - mask) * (e_null - e_neg)
    return delta_c + delta_d


def clip_pixel_norm(grad, threshold: float):
    """Each pixel's gradient vector (the last axis) scaled to a norm of at
    most `threshold`."""
    gnorm = torch.linalg.vector_norm(grad, dim=-1, keepdim=True) + 1e-8
    return gnorm.clamp_max(threshold) * grad / gnorm


class DualBranchGuidance:
    """The frozen prior (UNet, VAE, schedule) and the guidance math.

    The modules' parameters do not require gradients; the object is not an
    `nn.Module` because nothing of it is trained."""

    def __init__(self, unet, vae, schedule: DiffusionSchedule,
                 cfg: GuidanceConfig = GuidanceConfig()):
        if cfg.mode not in ("anpg", "sds", "sjc"):
            raise ValueError(f"unknown guidance mode {cfg.mode!r}; expected "
                             "'anpg', 'sds' or 'sjc'")
        self.unet = unet.eval().requires_grad_(False)
        self.vae = vae.eval().requires_grad_(False)
        self.schedule = schedule
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.schedule.alphas_cumprod.device

    @property
    def branch_num(self) -> int:
        return self.unet.cfg.branch_num

    def _normal(self, shape, generator):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=self.device)

    # ---- VAE transport ---------------------------------------------------
    def encode_images(self, imgs, generator=None, eps=None):
        """[B, H, W, 3] in [0, 1] -> sampled latents [B, h, w, 4] times
        VAE_SCALE; `eps` [B, h, w, 4] replaces the generator's draw."""
        mean, logvar = self.vae.encode(imgs * 2.0 - 1.0)
        return sample_latent(mean, logvar, generator, eps) * VAE_SCALE

    def decode_latents(self, latents):
        img = self.vae.decode(latents / VAE_SCALE)
        return (img * 0.5 + 0.5).clamp(0.0, 1.0)

    # ---- UNet scoring ----------------------------------------------------
    def _unet_eps(self, rgb_lat_in, depth_lat_in, t, text_embeddings):
        """[kB, h, w, 8] inputs (`depth_lat_in` a list of `branch_num` of
        them when there are several branches) -> [kB, h, w, 4 (1 +
        branch_num)] predictions (rgb, then each branch), without
        gradients."""
        c = self.cfg
        with trace_annotation("hg.read.time_ids"):  # host values to the card
            time_ids = torch.tensor(
                [[c.original_size, c.original_size, 0, 0, c.target_size,
                  c.target_size]], dtype=torch.float32,
                device=rgb_lat_in.device)
        time_ids = time_ids.repeat(rgb_lat_in.shape[0], 1)
        with torch.no_grad():
            return self.unet(rgb_lat_in, depth_lat_in, t, text_embeddings,
                             time_ids)

    def _unet_k(self, k, latents_noisy, depth_noisy, whole_latents, t, text):
        """The UNet on k copies of the batch; `depth_noisy` is one tensor or
        a list of one a branch."""
        whole = _repeat(whole_latents, k)
        lat_in = torch.cat([_repeat(latents_noisy, k), whole], dim=-1)
        deps = depth_noisy if isinstance(depth_noisy, list) else [depth_noisy]
        dep_in = [torch.cat([_repeat(d, k), whole], dim=-1) for d in deps]
        return self._unet_eps(lat_in, dep_in if len(deps) > 1 else dep_in[0],
                              t.repeat(k), text)

    def compute_grad(self, latents, depth_latents, whole_latents, t,
                     text_embeddings, generator=None, noise=None,
                     depth_noise=None):
        """ANPG (or plain CFG-SDS) gradient for both branches.

        latents, depth_latents, whole_latents [B, h, w, 4] (depth_latents a
        list of one a branch when there are several); text_embeddings
        [3B, L, D] in [cond | neg | null] order; t [B] int. `noise` /
        `depth_noise` [B, h, w, 4] (a list for several branches) replace the
        generator's draws, made in that order. Returns grad [B, h, w,
        4 (1 + branches)]."""
        c = self.cfg
        b = latents.shape[0]
        multi = isinstance(depth_latents, list)
        deps = depth_latents if multi else [depth_latents]
        if noise is None:
            noise = self._normal(latents.shape, generator)
        if depth_noise is None:
            dnoises = [self._normal(d.shape, generator) for d in deps]
        else:
            dnoises = depth_noise if multi else [depth_noise]
        latents_noisy = self.schedule.add_noise(latents, noise, t)
        depth_noisy = [self.schedule.add_noise(d, n, t)
                       for d, n in zip(deps, dnoises)]
        if not multi:
            depth_noisy = depth_noisy[0]

        if c.mode == "anpg":
            pred = self._unet_k(3, latents_noisy, depth_noisy, whole_latents,
                                t, text_embeddings)
            score = anpg_score(pred, t, c.guidance_scale, c.anpg_boundary_t)
        else:
            # 2-way [cond | neg] batch and the CFG with the TEXT prediction
            # as its base term: e_text + s (e_text - e_uncond)
            pred = self._unet_k(2, latents_noisy, depth_noisy, whole_latents,
                                t, text_embeddings[: 2 * b])
            e_text, e_uncond = pred.chunk(2, dim=0)
            noise_pred = e_text + c.guidance_scale * (e_text - e_uncond)
            if c.guidance_rescale > 0.0:
                noise_pred = rescale_noise_cfg(noise_pred, e_text,
                                               c.guidance_rescale)
            score = noise_pred - torch.cat([noise, *dnoises], dim=-1)

        w = self.schedule.sds_weight(t, c.weighting_strategy)
        grad = w.reshape(b, 1, 1, 1) * score
        if c.grad_clip_pixel:
            grad = clip_pixel_norm(grad, c.grad_clip_threshold)
        return torch.nan_to_num(grad)

    def compute_grad_sjc(self, latents, depth_latents, whole_latents, t,
                         text_embeddings, generator=None, noise=None,
                         depth_noise=None, var_red: bool = True):
        """Score Jacobian Chaining gradient [B, h, w, 8]: sigma =
        sqrt((1 - abar) / abar), zs = y + sigma eps, the UNet scores
        zs / sqrt(1 + sigma^2) with the 2-way CFG over [cond | neg], Ds =
        zs - sigma pred, grad = -(Ds - y) / sigma (variance-reduced; -(Ds -
        zs) / sigma without `var_red`). Single-branch."""
        c = self.cfg
        b = latents.shape[0]
        abar = self.schedule.alphas_cumprod[t]
        sigma = torch.sqrt((1.0 - abar) / abar).reshape(b, 1, 1, 1)
        if noise is None:
            noise = self._normal(latents.shape, generator)
        if depth_noise is None:
            depth_noise = self._normal(depth_latents.shape, generator)
        zs = latents + sigma * noise
        dzs = depth_latents + sigma * depth_noise
        scale = torch.sqrt(1.0 + sigma ** 2)
        pred = self._unet_k(2, zs / scale, dzs / scale, whole_latents, t,
                            text_embeddings[: 2 * b])
        e_text, e_uncond = pred.chunk(2, dim=0)
        noise_pred = e_text + c.guidance_scale * (e_text - e_uncond)
        if c.guidance_rescale > 0.0:
            noise_pred = rescale_noise_cfg(noise_pred, e_text,
                                           c.guidance_rescale)
        zs_all = torch.cat([zs, dzs], dim=-1)
        y_all = torch.cat([latents, depth_latents], dim=-1)
        sigma2 = sigma.expand(zs_all.shape)
        ds = zs_all - sigma2 * noise_pred
        ref = y_all if var_red else zs_all
        return torch.nan_to_num(-(ds - ref) / sigma2)

    # ---- sampling ----------------------------------------------------------
    def denoise_pred(self, latents_noisy, depth_noisy, whole_latents, t,
                     text2):
        """2-way CFG model output for both branches; text2 [2B, L, D] is
        [cond | neg]."""
        pred = self._unet_k(2, latents_noisy, depth_noisy, whole_latents, t,
                            text2)
        e_text, e_uncond = pred.chunk(2, dim=0)
        out = e_text + self.cfg.guidance_scale * (e_text - e_uncond)
        if self.cfg.guidance_rescale > 0.0:
            out = rescale_noise_cfg(out, e_text, self.cfg.guidance_rescale)
        return out

    @torch.no_grad()
    def guidance_eval(self, latents_noisy, depth_noisy, whole_latents,
                      t_start, text2, num_steps: int = 50):
        """The training-time visualization: the 1-step x0 estimate at
        `t_start` and a DDIM rollout over the trailing timesteps at or
        below each sample's `t_start`, for both branches, decoded. Returns
        {imgs_1step, depths_1step, imgs_final, depths_final}, [B, H, W, 3]
        in [0, 1]."""
        sched = self.schedule
        pred0 = self.denoise_pred(latents_noisy, depth_noisy, whole_latents,
                                  t_start, text2)
        x0_rgb = sched.pred_original(pred0[..., :4], latents_noisy, t_start)
        x0_depth = sched.pred_original(pred0[..., 4:], depth_noisy, t_start)

        lat, dep = latents_noisy, depth_noisy
        ts = sched.trailing_timesteps(num_steps)
        for i, t_i in enumerate(ts):
            t_prev = ts[i + 1] if i + 1 < len(ts) else -1
            t_arr = torch.full_like(t_start, int(t_i))
            t_prev_arr = torch.full_like(t_start, int(t_prev))
            active = (int(t_i) <= t_start).reshape(-1, 1, 1, 1)
            pred = self.denoise_pred(lat, dep, whole_latents, t_arr, text2)
            lat = torch.where(active, sched.ddim_step(
                pred[..., :4], lat, t_arr, t_prev_arr), lat)
            dep = torch.where(active, sched.ddim_step(
                pred[..., 4:], dep, t_arr, t_prev_arr), dep)

        def undepth(z):  # invert the depth-latent renormalization
            return (z - RGB_MEAN) / RGB_STD * DEPTH_STD + DEPTH_MEAN

        return {"imgs_1step": self.decode_latents(x0_rgb),
                "depths_1step": self.decode_latents(undepth(x0_depth)),
                "imgs_final": self.decode_latents(lat),
                "depths_final": self.decode_latents(undepth(dep))}

    @torch.no_grad()
    def sample_joint(self, pose_image, text2, generator=None,
                     num_steps: int = 50, latents=None, depth_latents=None,
                     latent_eps=None):
        """Text -> (image, depth) sampling: joint DDIM denoising of the rgb
        and depth latents from pure noise, both conditioned on the pose
        image; the depth latents are un-normalized before decoding.

        pose_image [B, H, W, 3] in [0, 1]; text2 [2B, L, D] = [cond | neg].
        `latents` / `depth_latents` [B, h, w, 4] replace the initial noise
        and `latent_eps` the pose encode's draw. Returns (images, depths),
        both [B, H, W, 3] in [0, 1]."""
        c = self.cfg
        b = pose_image.shape[0]
        whole_latents = self.encode_images(
            resize_bilinear(pose_image, c.image_size), generator, latent_eps)
        whole_latents = (
            (whole_latents - WHOLE_MEAN) / WHOLE_STD * RGB_STD + RGB_MEAN
        )
        shape = (b, c.latent_size, c.latent_size, 4)
        if latents is None:
            latents = self._normal(shape, generator)
        if depth_latents is None:
            depth_latents = self._normal(shape, generator)

        ts = self.schedule.trailing_timesteps(num_steps)
        for i, t_i in enumerate(ts):
            t_prev = ts[i + 1] if i + 1 < len(ts) else -1
            t_arr = torch.full((b,), int(t_i), dtype=torch.int64,
                               device=self.device)
            t_prev_arr = torch.full_like(t_arr, int(t_prev))
            pred = self.denoise_pred(latents, depth_latents, whole_latents,
                                     t_arr, text2)
            latents = self.schedule.ddim_step(pred[..., :4], latents, t_arr,
                                              t_prev_arr)
            depth_latents = self.schedule.ddim_step(
                pred[..., 4:], depth_latents, t_arr, t_prev_arr)

        depth_out = (
            (depth_latents - RGB_MEAN) / RGB_STD * DEPTH_STD + DEPTH_MEAN
        )
        return self.decode_latents(latents), self.decode_latents(depth_out)

    def step_draws(self, b: int, generator=None) -> dict:
        """The normal draws `__call__` makes for a batch of `b` from
        `generator`, in its order, as the keyword arguments that replace
        them ({latent_eps, noise, depth_noise}): what the data-parallel
        step draws for the whole batch before it hands each rank its
        rows."""
        c = self.cfg
        nb = self.branch_num
        down = 2 ** (len(self.vae.cfg.block_out_channels) - 1)
        shape = (b, c.image_size // down, c.image_size // down,
                 self.vae.cfg.latent_channels)
        keys = ["rgb", "depth", "pose"] + [f"depth{i}" for i in range(1, nb)]
        eps = {key: self._normal(shape, generator) for key in keys}
        noise = self._normal(shape, generator)
        dnoise = [self._normal(shape, generator) for _ in range(nb)]
        return {"latent_eps": eps, "noise": noise,
                "depth_noise": dnoise[0] if nb == 1 else dnoise}

    # ---- the public step ---------------------------------------------------
    def __call__(self, pose_image, rgb, depth, text_embeddings, t,
                 generator=None, grad_clip_val=None, latent_eps=None,
                 noise=None, depth_noise=None, elevation=None, azimuth=None,
                 camera_distances=None):
        """One guidance step.

        pose_image [B, H, W, 3]: the skeleton conditioning render; rgb
        [B, H, W, 3]: the differentiable render; depth [B, H, W, 3]: the
        normalized structure image, or a list of `branch_num` of them;
        text_embeddings [3B, L, D] = [cond | neg | null]; t [B] int
        timesteps. `latent_eps` is a dict with any of "rgb", "depth",
        "pose" (and "depth1", ... for further branches) -> [B, h, w, 4]
        replacing the encodes' draws; `noise` / `depth_noise` replace the
        gradient's. The camera angles are taken and ignored: the view
        dependence is already in `text_embeddings`.

        Returns {"loss_sds", "grad_norm", "grad"}: `loss_sds` carries the
        gradient into rgb and depth; `grad` [B, h, w, 4 (1 + branches)] is
        detached."""
        c = self.cfg
        depths = list(depth) if isinstance(depth, (list, tuple)) else [depth]
        nb = self.branch_num
        if len(depths) != nb:
            raise ValueError(f"got {len(depths)} structure images for a "
                             f"branch_num={nb} UNet")
        if c.mode == "sjc" and nb != 1:
            raise NotImplementedError("SJC guidance is single-branch")
        b = rgb.shape[0]
        eps = latent_eps or {}

        down = 2 ** (len(self.vae.cfg.block_out_channels) - 1)
        lat_shape = (b, c.image_size // down, c.image_size // down,
                     self.vae.cfg.latent_channels)

        # draws in a fixed order (rgb, depth, pose, further branches, then
        # the gradient's) so a seeded generator reproduces a step; they are
        # made outside the checkpointed encodes, whose recomputation must
        # see the same draw
        depth_keys = ["depth"] + [f"depth{i}" for i in range(1, nb)]
        draws = {
            key: eps[key] if key in eps else self._normal(lat_shape,
                                                          generator)
            for key in ("rgb", "depth", "pose", *depth_keys[1:])
        }

        def encode(img, key):
            # the span inside the checkpointed function also marks its
            # recompute in the backward
            def fn(x):
                with trace_annotation("hg.guidance.encode"):
                    return self.encode_images(x, eps=draws[key])

            with trace_annotation("hg.guidance.encode"):
                x = resize_bilinear(img, c.image_size)
            if c.remat_encode and x.requires_grad:
                return checkpoint(fn, x, use_reentrant=False)
            return fn(x)

        latents = encode(rgb, "rgb")
        depth_latents = [
            (encode(d, key) - DEPTH_MEAN) / DEPTH_STD * RGB_STD + RGB_MEAN
            for d, key in zip(depths, depth_keys)]
        with torch.no_grad():
            whole_latents = encode(pose_image, "pose")
            whole_latents = (
                (whole_latents - WHOLE_MEAN) / WHOLE_STD * RGB_STD + RGB_MEAN
            )
            grad_fn = (self.compute_grad_sjc if c.mode == "sjc"
                       else self.compute_grad)
            dls = [d.detach() for d in depth_latents]
            with trace_annotation("hg.guidance.unet"):
                grad = grad_fn(latents.detach(), dls[0] if nb == 1 else dls,
                               whole_latents, t, text_embeddings, generator,
                               noise=noise, depth_noise=depth_noise)
            if grad_clip_val is not None:
                grad = grad.clamp(-grad_clip_val, grad_clip_val)

        # the reparameterized SDS loss, one lw_depth term a branch
        target = (latents - grad[..., :4]).detach()
        loss_sds = 0.5 * ((latents - target) ** 2).sum() / b
        for i, dl in enumerate(depth_latents):
            d_target = (dl - grad[..., 4 * (i + 1): 4 * (i + 2)]).detach()
            loss_sds = loss_sds + c.lw_depth * ((dl - d_target) ** 2).sum() / b
        return {
            "loss_sds": loss_sds,
            "grad_norm": torch.linalg.vector_norm(grad),
            "grad": grad,
        }


def sample_timesteps(batch: int, min_step: int, max_step: int,
                     generator=None, device="cuda"):
    """t ~ U[min_step, max_step] inclusive, [batch] int64."""
    return torch.randint(min_step, max_step + 1, (batch,),
                         generator=generator, device=device)


def min_max_steps(num_train_timesteps: int, min_percent: float,
                  max_percent: float):
    """The timestep range of a (min, max) percent pair; the avatar system
    anneals max from 0.98 to 0.5."""
    return (int(num_train_timesteps * min_percent),
            int(num_train_timesteps * max_percent))
