"""Frozen plain copy of `humangaussian_torch/data/cameras.py` for the benchmark's
reference (imports rewritten; kernel calls replaced by plain torch in
`portbench/reference/common.py`). Original docstring:

Camera batches: the random training curriculum and the evaluation orbit.

Port of humangaussian_tpu/data/cameras.py:

- `sample_camera_batch`: one training batch. With probability
  `head_prob` (between `head_start_step` and `head_end_step`) the cameras
  orbit the head (short distances, azimuth in `head_azimuth_range`, the
  centre raised by `head_offset`); else with `back_prob` the back; else,
  with `frontal_prob`, a frontal azimuth window; else the full body.
  Elevation is uniform in angle or uniform on the sphere (a 50/50 choice
  per batch); azimuth is stratified across the batch when
  `batch_uniform_azimuth` is set; fovy is uniform in `fovy_range`; lights
  are drawn around the cameras. `mvp_mtx` is the matrix the pose images
  are drawn with (OpenGL projection, y flipped, near 0.1, far 1000).
- `eval_camera_batch`: the azimuth sweep at fixed elevation, distance and
  FoV (4 val views, 120 test views).

The JAX sampler is a pure function of a PRNG key, which torch cannot
replay. Here it is split in two: `camera_draws` makes the raw unit draws
(uniforms in [0, 1) and standard normals) from a `torch.Generator` on the
device, and `camera_batch_from_draws` is a pure function of those draws
and the host step. JAX's `uniform(minval, maxval)` is `u * (max - min) +
min` of its unit draw, and the same affine form is applied here, so a test
that hands in the JAX unit draws of the same keys gets the JAX batch.
The curriculum choice stays on the device (no host sync): `is_head` and
`is_back` are 0-d bool tensors.

World frame: right-handed, z up; each camera looks at its (offset) centre.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from portbench.reference.common import resolve_device


@dataclasses.dataclass(frozen=True)
class RandomCameraConfig:
    """The JAX RandomCameraConfig: every training and evaluation field,
    with the same defaults."""

    batch_size: int = 8
    height: int = 1024
    width: int = 1024
    elevation_range: tuple = (-30.0, 30.0)
    azimuth_range: tuple = (-180.0, 180.0)
    camera_distance_range: tuple = (1.5, 2.0)
    fovy_range: tuple = (40.0, 70.0)
    camera_perturb: float = 0.0
    center_perturb: float = 0.0
    up_perturb: float = 0.0
    light_distance_range: tuple = (0.8, 1.5)
    light_position_perturb: float = 1.0
    batch_uniform_azimuth: bool = True
    # zoom-in curriculum
    enable_near_head_poses: bool = True
    head_offset: float = 0.65
    head_camera_distance_range: tuple = (0.4, 0.6)
    head_prob: float = 0.25
    head_start_step: int = 1200
    head_end_step: int = 3600
    head_azimuth_range: tuple = (0.0, 180.0)
    enable_near_back_poses: bool = True
    back_offset: float = 0.65
    back_camera_distance_range: tuple = (0.6, 0.8)
    back_prob: float = 0.20
    back_start_step: int = 1200
    back_end_step: int = 3600
    back_azimuth_range: tuple = (-180.0, 0.0)
    frontal_prob: float = 0.0
    frontal_azimuth_range: tuple = (45.0, 135.0)
    # eval
    eval_height: int = 1024
    eval_width: int = 1024
    eval_elevation_deg: float = 15.0
    eval_camera_distance: float = 2.0
    eval_fovy_deg: float = 70.0
    n_val_views: int = 4
    n_test_views: int = 120


class CameraBatch(NamedTuple):
    c2w: torch.Tensor  # [B,4,4] OpenGL camera-to-world
    mvp_mtx: torch.Tensor  # [B,4,4] proj @ w2c (pose-image convention)
    camera_positions: torch.Tensor  # [B,3]
    light_positions: torch.Tensor  # [B,3]
    elevation: torch.Tensor  # [B] degrees
    azimuth: torch.Tensor  # [B] degrees
    camera_distances: torch.Tensor  # [B]
    fovy: torch.Tensor  # [B] radians
    is_head: torch.Tensor | bool  # [] bool on the device for a training
    is_back: torch.Tensor | bool  # batch, False for the evaluation orbit


def get_projection_matrix(fovy, aspect_wh, near=0.1, far=1000.0):
    """[B,4,4] OpenGL projection with y flipped, z in [-1,1]."""
    t = torch.tan(fovy / 2.0)
    zeros = torch.zeros_like(fovy)
    rows = [
        torch.stack([1.0 / (t * aspect_wh), zeros, zeros, zeros], -1),
        torch.stack([zeros, -1.0 / t, zeros, zeros], -1),
        torch.stack(
            [zeros, zeros,
             torch.full_like(fovy, -(far + near) / (far - near)),
             torch.full_like(fovy, -2.0 * far * near / (far - near))], -1,
        ),
        torch.stack([zeros, zeros, torch.full_like(fovy, -1.0), zeros], -1),
    ]
    return torch.stack(rows, dim=1)


def get_mvp_matrix(c2w, proj_mtx):
    rt = c2w[:, :3, :3].transpose(1, 2)
    t = -rt @ c2w[:, :3, 3:]
    w2c = torch.zeros_like(c2w)
    w2c[:, :3, :3] = rt
    w2c[:, :3, 3:] = t
    w2c[:, 3, 3] = 1.0
    return proj_mtx @ w2c


def _c2w_from_lookat(camera_positions, center, up):
    lookat = center - camera_positions
    lookat = lookat / torch.linalg.norm(lookat, dim=-1, keepdim=True)
    right = torch.linalg.cross(lookat, up)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    up2 = torch.linalg.cross(right, lookat)
    up2 = up2 / torch.linalg.norm(up2, dim=-1, keepdim=True)
    b = camera_positions.shape[0]
    c2w = torch.zeros((b, 4, 4), dtype=torch.float32,
                      device=camera_positions.device)
    c2w[:, :3, 0] = right
    c2w[:, :3, 1] = up2
    c2w[:, :3, 2] = -lookat
    c2w[:, :3, 3] = camera_positions
    c2w[:, 3, 3] = 1.0
    return c2w


def _linspace(start: float, stop: float, num: int, endpoint: bool, f32):
    """jnp.linspace's f32 formula start (1 - s) + stop s, s = i / div, so
    the sweep's angles round as the JAX package's do."""
    div = num - 1 if endpoint else num
    step = torch.arange(div, **f32) / div
    out = start * (1 - step) + stop * step
    if endpoint:
        out = torch.cat([out, torch.full((1,), stop, **f32)])
    return out


# the unit draws of one training batch of b cameras, in the order of the
# JAX sampler's keys 0-10: (name, numbers per camera, or a fixed count)
_UNIFORMS = (("choice", None, 4), ("elevation_uniform", 1, 0),
             ("elevation_sphere", 1, 0), ("azimuth", 1, 0),
             ("distance", 1, 0), ("camera_perturb", 3, 0), ("fovy", 1, 0),
             ("light_distance", 1, 0))
_NORMALS = (("center_perturb", 3), ("up_perturb", 3), ("light_dir", 3))


def camera_draws(batch: int, generator: torch.Generator | None = None,
                 device="cuda") -> dict:
    """The raw draws of one training batch, from `generator`: uniforms in
    [0, 1) `choice` [4] (mode, head, back, frontal), `elevation_uniform`,
    `elevation_sphere`, `azimuth`, `distance`, `fovy`, `light_distance`
    [B] and `camera_perturb` [B, 3]; standard normals `center_perturb`,
    `up_perturb` and `light_dir` [B, 3]. Two generator calls in all."""
    dev = resolve_device(device) if generator is None else generator.device
    sizes = [fixed or batch * per for _, per, fixed in _UNIFORMS]
    u = torch.rand(sum(sizes), generator=generator, device=dev,
                   dtype=torch.float32)
    out = {}
    for (name, per, fixed), part in zip(_UNIFORMS, u.split(sizes)):
        out[name] = part if fixed else part.reshape(batch, per).squeeze(-1)
    n = torch.randn(len(_NORMALS) * batch * 3, generator=generator,
                    device=dev, dtype=torch.float32)
    for (name, _), part in zip(_NORMALS, n.split(batch * 3)):
        out[name] = part.reshape(batch, 3)
    return out


def _uniform(u, lo, hi):
    """JAX's uniform(minval, maxval) of the unit draw u: u * (hi - lo) + lo
    in float32."""
    lo32 = torch.tensor(lo, dtype=torch.float32, device=u.device)
    hi32 = torch.tensor(hi, dtype=torch.float32, device=u.device)
    return torch.maximum(lo32, u * (hi32 - lo32) + lo32)


def camera_batch_from_draws(draws: dict, step: int,
                            cfg: RandomCameraConfig = RandomCameraConfig()
                            ) -> CameraBatch:
    """The training batch of `draws` (see `camera_draws`) at host `step`."""
    b = draws["azimuth"].shape[0]
    u_mode, u_head, u_back, u_front = draws["choice"].unbind(0)
    head_on = (u_head < cfg.head_prob) & (
        cfg.enable_near_head_poses
        and cfg.head_start_step <= step <= cfg.head_end_step)
    back_on = (~head_on) & (u_back < cfg.back_prob) & (
        cfg.enable_near_back_poses
        and cfg.back_start_step <= step <= cfg.back_end_step)
    frontal_on = (~head_on) & (~back_on) & (u_front < cfg.frontal_prob)
    dev = u_mode.device

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    def pick(head_v, back_v, base_v):
        return torch.where(head_on, f32(head_v),
                           torch.where(back_on, f32(back_v), base_v))

    az_lo = pick(cfg.head_azimuth_range[0], cfg.back_azimuth_range[0],
                 torch.where(frontal_on, f32(cfg.frontal_azimuth_range[0]),
                             f32(cfg.azimuth_range[0])))
    az_hi = pick(cfg.head_azimuth_range[1], cfg.back_azimuth_range[1],
                 torch.where(frontal_on, f32(cfg.frontal_azimuth_range[1]),
                             f32(cfg.azimuth_range[1])))
    dist_lo = pick(cfg.head_camera_distance_range[0],
                   cfg.back_camera_distance_range[0],
                   f32(cfg.camera_distance_range[0]))
    dist_hi = pick(cfg.head_camera_distance_range[1],
                   cfg.back_camera_distance_range[1],
                   f32(cfg.camera_distance_range[1]))
    z_offset = pick(cfg.head_offset, cfg.back_offset, f32(0.0))

    # elevation: 50% uniform in angle, 50% uniform on the sphere
    lo, hi = cfg.elevation_range
    elev_uniform = _uniform(draws["elevation_uniform"], lo, hi)
    u = _uniform(draws["elevation_sphere"], (lo + 90.0) / 180.0,
                 (hi + 90.0) / 180.0)
    elev_sphere = torch.rad2deg(torch.arcsin(2.0 * u - 1.0))
    elevation_deg = torch.where(u_mode < 0.5, elev_uniform, elev_sphere)

    # azimuth, stratified across the batch
    frac = draws["azimuth"]
    if cfg.batch_uniform_azimuth:
        frac = (frac + torch.arange(b, device=dev)) / b
    azimuth_deg = frac * (az_hi - az_lo) + az_lo
    camera_distances = draws["distance"] * (dist_hi - dist_lo) + dist_lo

    elevation = torch.deg2rad(elevation_deg)
    azimuth = torch.deg2rad(azimuth_deg)
    camera_positions = torch.stack(
        [
            camera_distances * torch.cos(elevation) * torch.cos(azimuth),
            camera_distances * torch.cos(elevation) * torch.sin(azimuth),
            camera_distances * torch.sin(elevation),
        ],
        dim=-1,
    )
    lift = torch.stack([torch.zeros_like(z_offset),
                        torch.zeros_like(z_offset), z_offset])
    center = torch.zeros_like(camera_positions) + lift
    camera_positions = camera_positions + lift

    up = f32([0.0, 0.0, 1.0]).expand(b, 3)
    if cfg.camera_perturb > 0:
        camera_positions = camera_positions + _uniform(
            draws["camera_perturb"], -cfg.camera_perturb, cfg.camera_perturb)
    if cfg.center_perturb > 0:
        center = center + draws["center_perturb"] * cfg.center_perturb
    if cfg.up_perturb > 0:
        up = up + draws["up_perturb"] * cfg.up_perturb

    fovy = torch.deg2rad(_uniform(draws["fovy"], *cfg.fovy_range))
    light_distances = _uniform(draws["light_distance"],
                               *cfg.light_distance_range)
    light_dir = (camera_positions
                 + draws["light_dir"] * cfg.light_position_perturb)
    light_dir = light_dir / torch.linalg.norm(light_dir, dim=-1,
                                              keepdim=True)
    light_positions = light_dir * light_distances[:, None]

    c2w = _c2w_from_lookat(camera_positions, center, up)
    proj = get_projection_matrix(fovy, cfg.width / cfg.height)
    return CameraBatch(
        c2w=c2w,
        mvp_mtx=get_mvp_matrix(c2w, proj),
        camera_positions=camera_positions,
        light_positions=light_positions,
        elevation=elevation_deg,
        azimuth=azimuth_deg,
        camera_distances=camera_distances,
        fovy=fovy,
        is_head=head_on,
        is_back=back_on,
    )


def sample_camera_batch(generator: torch.Generator | None, step: int,
                        cfg: RandomCameraConfig = RandomCameraConfig(),
                        device="cuda") -> CameraBatch:
    """One training batch at host `step`, drawn from `generator` (on its
    device; `device` serves when the generator is None)."""
    return camera_batch_from_draws(
        camera_draws(cfg.batch_size, generator, device), step, cfg)


def c2w_from_angles(elevation_deg, azimuth_deg, camera_distances):
    """[B] spherical angles (degrees) and distances -> [B,4,4] c2w of
    cameras looking at the origin (z-up world)."""
    elevation = torch.deg2rad(torch.as_tensor(elevation_deg,
                                              dtype=torch.float32))
    azimuth = torch.deg2rad(torch.as_tensor(azimuth_deg, dtype=torch.float32,
                                            device=elevation.device))
    d = torch.as_tensor(camera_distances, dtype=torch.float32,
                        device=elevation.device)
    camera_positions = torch.stack(
        [
            d * torch.cos(elevation) * torch.cos(azimuth),
            d * torch.cos(elevation) * torch.sin(azimuth),
            d * torch.sin(elevation),
        ],
        dim=-1,
    )
    up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                      device=elevation.device).expand(camera_positions.shape)
    return _c2w_from_lookat(camera_positions,
                            torch.zeros_like(camera_positions), up)


def eval_camera_batch(cfg: RandomCameraConfig = RandomCameraConfig(),
                      split: str = "test", device="cuda") -> CameraBatch:
    """Deterministic azimuth sweep: `val` (n_val_views, endpoint excluded)
    or `test` (n_test_views, -180..180 inclusive)."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    n = cfg.n_val_views if split == "val" else cfg.n_test_views
    if split == "val":
        azimuth_deg = _linspace(-180.0, 180.0, n + 1, True, f32)[:n]
    else:
        azimuth_deg = _linspace(-180.0, 180.0, n, True, f32)
    elevation_deg = torch.full((n,), cfg.eval_elevation_deg, **f32)
    camera_distances = torch.full((n,), cfg.eval_camera_distance, **f32)
    elevation = torch.deg2rad(elevation_deg)
    azimuth = torch.deg2rad(azimuth_deg)
    camera_positions = torch.stack(
        [
            camera_distances * torch.cos(elevation) * torch.cos(azimuth),
            camera_distances * torch.cos(elevation) * torch.sin(azimuth),
            camera_distances * torch.sin(elevation),
        ],
        dim=-1,
    )
    center = torch.zeros_like(camera_positions)
    up = torch.tensor([0.0, 0.0, 1.0], **f32).expand(n, 3)
    fovy = torch.deg2rad(torch.full((n,), cfg.eval_fovy_deg, **f32))
    c2w = _c2w_from_lookat(camera_positions, center, up)
    proj = get_projection_matrix(fovy, cfg.eval_width / cfg.eval_height)
    mvp = get_mvp_matrix(c2w, proj)
    return CameraBatch(
        c2w=c2w,
        mvp_mtx=mvp,
        camera_positions=camera_positions,
        light_positions=camera_positions,
        elevation=elevation_deg,
        azimuth=azimuth_deg,
        camera_distances=camera_distances,
        fovy=fovy,
        is_head=False,
        is_back=False,
    )
