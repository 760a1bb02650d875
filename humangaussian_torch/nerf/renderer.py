"""NeRF volume renderer: static-shape stratified ray marching.

Port of humangaussian_tpu/nerf/renderer.py (the reference's
nerf-volume-renderer with nerfacc's occupancy-grid estimator replaced by a
fixed number of stratified samples inside each ray's box interval, plus an
optional coarse-to-fine importance pass). Compositing:
alpha_i = 1 - exp(-sigma_i dt_i), T_i = prod_{j<i} (1 - alpha_j + 1e-10),
comp_rgb = sum w_i c_i + (1 - opacity) background(dirs).

Differences from the JAX module:

- `NerfVolumeRenderer` is a plain class over `nn.Module`s that hold their
  parameters (`renderer.field`, a ModuleDict of geometry, material and
  background, is what an optimizer and a state dict see); there is no
  `init_params`: the modules are built on their device by the caller.
- The random draws (the stratified jitter and the importance pass's `u`)
  come from a `torch.Generator`, or are injected as unit uniforms
  (`jitter` [R, S], `fine_u` [R, n]), as JAX's keys' draws.
- `render_image` takes a batch of cameras (c2w [B, 4, 4], fovy [B]) and
  renders all their rays in one `render_rays` call, where the JAX system
  vmaps `render_image` per camera; every ray is computed independently,
  so the outputs are the same.
- `get_rays` (JAX nerf/renderer.py, re-exported by data/image.py) takes
  one camera or a batch, with a float or per-camera tensor fovy.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn


def get_rays(c2w: torch.Tensor, fovy, height: int, width: int):
    """Per-pixel rays, OpenGL convention (the camera looks down -z), pixel
    centres at +0.5. c2w [4,4] / [3,4] with a float or 0-d fovy, or
    [B,4,4] with fovy [B]. Returns (origins, dirs), each [(B,) H, W, 3] on
    c2w's device."""
    f32 = dict(dtype=torch.float32, device=c2w.device)
    fovy = torch.as_tensor(fovy, **f32)
    focal = (0.5 * height / torch.tan(0.5 * fovy))[..., None]
    x = (torch.arange(width, **f32) + 0.5 - width / 2) / focal
    y = (torch.arange(height, **f32) + 0.5 - height / 2) / focal
    grid = fovy.shape + (height, width)
    yy = y[..., :, None].expand(grid)
    xx = x[..., None, :].expand(grid)
    dirs_cam = torch.stack([xx, -yy, -torch.ones_like(xx)], dim=-1)
    rot = c2w[..., :3, :3]
    dirs = dirs_cam @ rot.transpose(-1, -2)[..., None, :, :]
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    origins = c2w[..., None, None, :3, 3].expand(dirs.shape)
    return origins, dirs


def ray_aabb(origins, dirs, radius: float, near_min: float = 0.05):
    """Ray / [-r, r]^3 box intersection -> (t_near, t_far) per ray; rays
    that miss get an empty (t_near >= t_far) interval."""
    inv = 1.0 / torch.where(torch.abs(dirs) > 1e-8, dirs, 1e-8)
    t0 = (-radius - origins) * inv
    t1 = (radius - origins) * inv
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    t_near = torch.clamp_min(t_near, near_min)
    return t_near, torch.maximum(t_far, t_near)


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    num_samples_per_ray: int = 96
    radius: float = 1.0
    randomized: bool = True
    near_plane: float = 0.05
    num_importance_samples: int = 0  # coarse-to-fine: extra samples from
    #   the coarse pass's weight PDF


def sample_pdf(t, weights, n_samples: int, u=None):
    """Inverse-CDF resampling of n_samples depths from the coarse pass's
    piecewise-constant weight PDF (stop-gradient on the weights). t [R,S],
    weights [R,S] -> [R,n]; `u` [R,n] unit uniforms jitter the stratified
    positions (None: the stratum centres)."""
    r, s = t.shape
    w = weights.detach() + 1e-5  # sampling is an estimator
    cdf = torch.cumsum(w, dim=-1)
    cdf = cdf / cdf[:, -1:]
    base = (torch.arange(n_samples, dtype=torch.float32, device=t.device)
            + 0.5) / n_samples
    if u is not None:
        u = torch.clamp(base[None, :] + (u - 0.5) / n_samples, 1e-5,
                        1.0 - 1e-5)
    else:
        u = base.expand(r, n_samples)
    u = u.contiguous()
    idx = torch.searchsorted(cdf.contiguous(), u)  # left side, as JAX's
    idx = torch.clamp(idx, 0, s - 1)
    prev = torch.clamp_min(idx - 1, 0)
    cdf_lo = torch.where(idx > 0, torch.gather(cdf, 1, prev), 0.0)
    cdf_hi = torch.gather(cdf, 1, idx)
    t_hi = torch.gather(t, 1, idx)
    t_lo = torch.where(idx > 0, torch.gather(t, 1, prev), t_hi)
    frac = (u - cdf_lo) / torch.clamp_min(cdf_hi - cdf_lo, 1e-8)
    return t_lo + frac * (t_hi - t_lo)


def composite_weights(alpha):
    """w_i = alpha_i prod_{j<i} (1 - alpha_j + 1e-10) along the last axis."""
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    return alpha * trans


def stratified_depths(t_near, t_far, s: int, jitter=None):
    """[R, S] depths at the stratum centres, moved by (u - 0.5) / S of the
    unit uniforms `jitter` [R, S] when given."""
    frac = (torch.arange(s, dtype=torch.float32, device=t_near.device)
            + 0.5) / s
    frac = (frac[None, :] + (jitter - 0.5) / s if jitter is not None
            else frac.expand(t_near.shape[0], s))
    return t_near[:, None] + (t_far - t_near)[:, None] * frac


def flatten_cameras(c2w, fovy, height: int, width: int, *per_camera):
    """Rays of one camera or a batch, flattened to [R, 3], and the
    per-camera tensors `per_camera` (each [(B,) H*W, ...] or None)
    flattened alike; returns (lead shape, origins, dirs, *flattened)."""
    origins, dirs = get_rays(c2w, fovy, height, width)
    lead = origins.shape[:-1]
    flat = [None if x is None else x.reshape((-1,) + x.shape[-1:])
            for x in per_camera]
    return (lead, origins.reshape(-1, 3), dirs.reshape(-1, 3), *flat)


def unflatten(out: dict, lead) -> dict:
    return {k: v.reshape(lead + v.shape[1:]) for k, v in out.items()}


class NerfVolumeRenderer:
    """Renders rays through a geometry, a material and a background
    (`nn.Module`s holding their parameters, grouped in `self.field`)."""

    def __init__(self, geometry, material, background,
                 cfg: RendererConfig = RendererConfig()):
        self.geometry = geometry
        self.material = material
        self.background = background
        self.cfg = cfg
        self.field = nn.ModuleDict({"geometry": geometry,
                                    "material": material,
                                    "background": background})

    def reset_parameters(self, generator=None):
        """Redraw the modules' parameters in the JAX `init_params` order
        (geometry, material, background) from `generator`."""
        for module in self.field.values():
            module.reset_parameters(generator)

    def _draws(self, r: int, jitter, fine_u, generator):
        """The jitter and importance uniforms of r rays: as injected, drawn
        from `generator`, or None (the stratum centres)."""
        c = self.cfg
        if not c.randomized:
            return None, None
        dev = generator.device if generator is not None else None
        if jitter is None and generator is not None:
            jitter = torch.rand((r, c.num_samples_per_ray),
                                generator=generator, device=dev)
        if (c.num_importance_samples > 0 and fine_u is None
                and generator is not None):
            fine_u = torch.rand((r, c.num_importance_samples),
                                generator=generator, device=dev)
        return jitter, fine_u

    def render_rays(self, origins, dirs, jitter=None, fine_u=None,
                    generator=None, light_positions=None,
                    shading: str = "albedo", output_normal: bool = False):
        """origins / dirs [R, 3] -> {comp_rgb [R,C], comp_rgb_fg, opacity
        [R,1], depth [R,1], weights [R,S(+n)], comp_normal [R,3] with
        `output_normal`}."""
        c = self.cfg
        s = c.num_samples_per_ray
        jitter, fine_u = self._draws(origins.shape[0], jitter, fine_u,
                                     generator)
        t_near, t_far = ray_aabb(origins, dirs, c.radius, c.near_plane)
        t = stratified_depths(t_near, t_far, s, jitter)

        if c.num_importance_samples > 0:
            # coarse sigma-only pass -> importance-resample -> the union of
            # coarse and fine depths feeds the shaded pass below
            dt_c = (t_far - t_near)[:, None] / s
            pts_c = origins[:, None, :] + dirs[:, None, :] * t[..., None]
            with torch.no_grad():
                sigma_c = self.geometry(pts_c)["density"][..., 0]
            t_fine = sample_pdf(t, composite_weights(
                1.0 - torch.exp(-sigma_c * dt_c)),
                c.num_importance_samples, fine_u)
            t = torch.sort(torch.cat([t, t_fine], dim=-1), dim=-1).values
            # per-section dt from the merged, non-uniform depths
            dt = torch.diff(t, dim=-1, append=torch.maximum(
                t_far, t[:, -1] + 1e-4)[:, None])
        else:
            dt = (t_far - t_near)[:, None] / s
        pts = origins[:, None, :] + dirs[:, None, :] * t[..., None]

        geo = self.geometry(pts, output_normal=output_normal)
        sigma = geo["density"][..., 0]
        weights = composite_weights(1.0 - torch.exp(-sigma * dt))

        mat_kwargs = {}
        if output_normal:
            mat_kwargs["normal"] = geo["normal"]
            mat_kwargs["positions"] = pts
            if light_positions is not None:
                mat_kwargs["light_positions"] = light_positions[:, None, :]
        rgb = self.material(geo["features"], shading=shading, **mat_kwargs)

        comp_rgb = torch.sum(weights[..., None] * rgb, dim=-2)
        opacity = torch.sum(weights, dim=-1, keepdim=True)
        depth = torch.sum(weights * t, dim=-1, keepdim=True)
        bg = self.background(dirs)
        out = {
            "comp_rgb": comp_rgb + (1.0 - opacity) * bg,
            "comp_rgb_fg": comp_rgb,
            "opacity": opacity,
            "depth": depth,
            "weights": weights,
        }
        if output_normal:
            out["comp_normal"] = torch.sum(weights[..., None] * geo["normal"],
                                           dim=-2)
        return out

    def render_image(self, c2w, fovy, height: int, width: int, jitter=None,
                     fine_u=None, generator=None, camera_position=None,
                     shading: str = "albedo", output_normal: bool = False):
        """One camera (c2w [4,4]) or a batch (c2w [B,4,4], fovy [B]) ->
        the outputs of `render_rays` shaped [(B,) H, W, ...]. `jitter`
        [(B,) H*W, S] and `fine_u` [(B,) H*W, n] are unit uniforms;
        `camera_position` [(B,) 3] places the point light."""
        light = None
        if camera_position is not None:
            light = camera_position[..., None, :].expand(
                camera_position.shape[:-1] + (height * width, 3))
        lead, o, d, jitter, fine_u, light = flatten_cameras(
            c2w, fovy, height, width, jitter, fine_u, light)
        out = self.render_rays(o, d, jitter, fine_u, generator, light,
                               shading, output_normal)
        return unflatten(out, lead)
