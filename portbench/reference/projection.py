"""Frozen plain copy of `humangaussian_torch/ops/projection.py` for the benchmark's
reference (imports rewritten; kernel calls replaced by plain torch in
`portbench/reference/common.py`). Original docstring:

Per-Gaussian screen-space preprocessing ("project") for splatting.

Port of humangaussian_tpu/ops/projection.py. For every (padded) Gaussian:
2D screen mean, view depth, conic (inverse 2D covariance), CUDA 3-sigma
radius, view-dependent RGB and the tile rectangle it may touch. Same
semantics as the JAX module:

- near cull at view z <= `near` (0.2);
- EWA cov2D = J W Sigma W^T J^T with the t/z clamp at 1.3 tan(fov/2),
  then +0.3 on the diagonal;
- `radii` = ceil(3 sqrt(lambda_max)) of the dilated cov2D, capped at
  `max_radius_px` = (rect_side - 1) * tile / 2;
- pixel coords via ndc2Pix(v, S) = ((v+1) S - 1) / 2;
- the tile rect uses per-axis, opacity-aware extents min(3, sqrt(q_max))
  sqrt(cov) (q_max = 2 ln(opa / alpha_min), with a 1e-3 margin), capped
  like the radius, truncated toward zero and clipped to the tile grid;
- SH -> RGB with +0.5 and a clamp at 0.

The arithmetic is written as elementwise columns in the JAX module's
order, so rects and radii agree with it exactly. `RasterizeConfig` keeps
only the fields this port reads; the JAX config's TPU-only knobs
(pair_factor, big_capacity, class_fracs, bwd_routing, panel_math,
cumsum_bf16, tight_cull) have no counterpart: binning is sized
dynamically and always applies the exact tile-ellipse cull.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from portbench.reference.camera import Camera
from portbench.reference.sh import eval_sh


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Rasterization parameters."""

    tile: int = 32  # pixel tile edge (the CUDA kernel is built for 32)
    max_tiles_per_gaussian: int = 9  # cap on the rect area (side * side)
    near: float = 0.2  # near-cull plane
    alpha_min: float = 1.0 / 255.0  # contribution threshold
    alpha_max: float = 0.99  # alpha clamp
    transmittance_eps: float = 1e-4  # per-pixel early stop on T

    @property
    def rect_side(self) -> int:
        s = int(self.max_tiles_per_gaussian**0.5)
        if s * s != self.max_tiles_per_gaussian:
            raise ValueError("max_tiles_per_gaussian must be a square number")
        return s

    @property
    def max_radius_px(self) -> float:
        # rect width w <= floor((2r-1)/T) + 2, so w <= s iff r <= (s-1)*T/2
        return (self.rect_side - 1) * self.tile / 2.0


class ProjectedGaussians(NamedTuple):
    """Per-Gaussian screen primitives ([N]-shaped, padded like the scene)."""

    means2d: torch.Tensor  # [N,2] pixel coords
    depths: torch.Tensor  # [N] view-space z
    conics: torch.Tensor  # [N,3] inverse 2D covariance (a, b, c)
    radii: torch.Tensor  # [N] int32 screen radius, 0 = culled
    rgb: torch.Tensor  # [N,3] view-dependent colour (clamped >= 0)
    opacities: torch.Tensor  # [N]
    rect: torch.Tensor  # [N,4] int32 tile rect (x0, y0, x1, y1), x1/y1 excl.
    visible: torch.Tensor  # [N] bool


def project_gaussians(
    means: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    features: torch.Tensor,
    opacities: torch.Tensor,
    alive: torch.Tensor,
    camera: Camera,
    sh_degree: int,
    cfg: RasterizeConfig = RasterizeConfig(),
    scale_modifier: float = 1.0,
    means2d_offset: torch.Tensor | None = None,
) -> ProjectedGaussians:
    """Project padded Gaussians into one camera's screen space."""
    f32 = torch.float32
    view = camera.view.to(f32)
    full_proj = camera.full_proj.to(f32)
    w, h = camera.width, camera.height
    focal_x = camera.focal_x
    focal_y = camera.focal_y

    mx_, my_, mz_ = means[:, 0].to(f32), means[:, 1].to(f32), \
        means[:, 2].to(f32)

    def xform(mat, j, w_row=3):
        return (mx_ * mat[0, j] + my_ * mat[1, j] + mz_ * mat[2, j]
                + mat[w_row, j])

    pv_x = xform(view, 0)
    pv_y = xform(view, 1)
    depth = xform(view, 2)
    p_w = 1.0 / (xform(full_proj, 3) + 1e-7)
    proj_x = xform(full_proj, 0) * p_w
    proj_y = xform(full_proj, 1) * p_w

    in_front = depth > cfg.near

    # quat -> rotation entries as [N] columns (w-x-y-z, normalized)
    q0, q1, q2, q3 = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    # the norm's gradient is 0 where q = 0 (the PLY loader's padded slots),
    # not NaN; its value is unchanged on every row
    qsq = q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3
    zero = qsq == 0.0
    qnrm = torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, qsq))) \
        + 1e-12
    qw, qx, qy, qz = q0 / qnrm, q1 / qnrm, q2 / qnrm, q3 / qnrm
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    s0 = scales[:, 0] * scale_modifier
    s1 = scales[:, 1] * scale_modifier
    s2 = scales[:, 2] * scale_modifier
    # M = R diag(s); Sigma = M M^T, six unique entries
    m00, m01, m02 = r00 * s0, r01 * s1, r02 * s2
    m10, m11, m12 = r10 * s0, r11 * s1, r12 * s2
    m20, m21, m22 = r20 * s0, r21 * s1, r22 * s2
    sxx = m00 * m00 + m01 * m01 + m02 * m02
    sxy = m00 * m10 + m01 * m11 + m02 * m12
    sxz = m00 * m20 + m01 * m21 + m02 * m22
    syy = m10 * m10 + m11 * m11 + m12 * m12
    syz = m10 * m20 + m11 * m21 + m12 * m22
    szz = m20 * m20 + m21 * m21 + m22 * m22

    limx = 1.3 * camera.tan_fovx
    limy = 1.3 * camera.tan_fovy
    z_safe = torch.where(in_front, depth, 1.0)
    txtz = torch.clamp(pv_x / z_safe, -limx, limx) * z_safe
    tytz = torch.clamp(pv_y / z_safe, -limy, limy) * z_safe

    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z
    # JW rows as [N] columns: J = d(pixel)/d(view), W = world->cam rotation
    w_rot = view[:3, :3].T
    a0 = focal_x * inv_z
    a2x = -focal_x * txtz * inv_z2
    b1 = focal_y * inv_z
    b2y = -focal_y * tytz * inv_z2
    u0 = a0 * w_rot[0, 0] + a2x * w_rot[2, 0]
    u1 = a0 * w_rot[0, 1] + a2x * w_rot[2, 1]
    u2 = a0 * w_rot[0, 2] + a2x * w_rot[2, 2]
    v0 = b1 * w_rot[1, 0] + b2y * w_rot[2, 0]
    v1 = b1 * w_rot[1, 1] + b2y * w_rot[2, 1]
    v2 = b1 * w_rot[1, 2] + b2y * w_rot[2, 2]
    su0 = sxx * u0 + sxy * u1 + sxz * u2
    su1 = sxy * u0 + syy * u1 + syz * u2
    su2 = sxz * u0 + syz * u1 + szz * u2
    sv0 = sxx * v0 + sxy * v1 + sxz * v2
    sv1 = sxy * v0 + syy * v1 + syz * v2
    sv2 = sxz * v0 + syz * v1 + szz * v2
    cov_a = u0 * su0 + u1 * su1 + u2 * su2 + 0.3
    cov_b = v0 * su0 + v1 * su1 + v2 * su2
    cov_c = v0 * sv0 + v1 * sv1 + v2 * sv2 + 0.3

    det = cov_a * cov_c - cov_b * cov_b
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, 1.0)
    inv_det = 1.0 / det_safe
    conic = torch.stack(
        [cov_c * inv_det, -cov_b * inv_det, cov_a * inv_det], dim=-1
    )

    mid = 0.5 * (cov_a + cov_c)
    lam_max = mid + torch.sqrt(torch.clamp_min(mid * mid - det_safe, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam_max))
    radius_f = torch.clamp_max(radius_f, cfg.max_radius_px)

    mean2d = torch.stack(
        [
            ((proj_x + 1.0) * w - 1.0) * 0.5,
            ((proj_y + 1.0) * h - 1.0) * 0.5,
        ],
        dim=-1,
    )
    if means2d_offset is not None:
        mean2d = mean2d + means2d_offset

    # tile rect from the opacity-aware per-axis contribution extents
    opa_col = opacities.reshape(-1)
    q_max = 2.0 * torch.log(
        torch.clamp_min(opa_col, 1e-12) / (cfg.alpha_min * (1.0 - 1e-3))
    )
    s_eff = torch.sqrt(torch.clamp(q_max, 0.0, 9.0))
    ext_x = torch.clamp_max(torch.ceil(s_eff * torch.sqrt(cov_a)),
                            cfg.max_radius_px)
    ext_y = torch.clamp_max(torch.ceil(s_eff * torch.sqrt(cov_c)),
                            cfg.max_radius_px)
    tiles_x = -(-w // cfg.tile)
    tiles_y = -(-h // cfg.tile)
    ex = ext_x.detach()
    ey = ext_y.detach()
    mx = mean2d.detach()
    i32 = torch.int32
    # .to(int32) truncates toward zero, as the JAX astype does
    x0 = torch.clamp(((mx[:, 0] - ex) / cfg.tile).to(i32), 0, tiles_x)
    y0 = torch.clamp(((mx[:, 1] - ey) / cfg.tile).to(i32), 0, tiles_y)
    x1 = torch.clamp(
        ((mx[:, 0] + ex + cfg.tile - 1) / cfg.tile).to(i32), 0, tiles_x
    )
    y1 = torch.clamp(
        ((mx[:, 1] + ey + cfg.tile - 1) / cfg.tile).to(i32), 0, tiles_y
    )
    rect_nonempty = (x1 > x0) & (y1 > y0)

    visible = alive & in_front & det_ok & (radius_f > 0) & rect_nonempty
    radii = torch.where(visible, radius_f, 0.0).to(i32)
    rect = torch.stack([x0, y0, x1, y1], dim=-1) * visible[:, None].to(i32)

    dx = mx_ - camera.campos[0]
    dy_ = my_ - camera.campos[1]
    dz = mz_ - camera.campos[2]
    dnrm = torch.sqrt(dx * dx + dy_ * dy_ + dz * dz) + 1e-12
    dirs = torch.stack([dx / dnrm, dy_ / dnrm, dz / dnrm], dim=-1)
    rgb_raw = eval_sh(sh_degree, features, dirs) + 0.5
    rgb = torch.clamp_min(rgb_raw, 0.0)

    return ProjectedGaussians(
        means2d=mean2d,
        depths=depth,
        conics=conic,
        radii=radii,
        rgb=rgb,
        opacities=opacities.reshape(-1),
        rect=rect,
        visible=visible,
    )
