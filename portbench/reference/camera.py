"""Frozen plain copy of `humangaussian_torch/core/camera.py` for the benchmark's
reference (imports rewritten; kernel calls replaced by plain torch in
`portbench/reference/common.py`). Original docstring:

Camera model and projection math.

Port of humangaussian_tpu/core/camera.py, same conventions:

- c2w matrices are OpenGL style (x right, y up, z backward); the splatting
  stack uses COLMAP style, so the world-to-camera rotation rows 1:3 and the
  translation are negated.
- `view` and `full_proj` are stored TRANSPOSED (row-vector convention): a
  point transforms as `[p, 1] @ M`.
- The perspective matrix maps z to [0, 1] with z_sign=+1.
- FoVx follows from FoVy through the focal length at the image height.

The JAX `Camera` is a flax pytree that vmap batches; here a `Camera` holds
tensors that may carry leading batch dimensions (`camera_from_c2w` on a
[B,4,4] c2w), and indexing it (`cams[i]`) picks one camera.
"""
from __future__ import annotations

import dataclasses

import torch


def fov_to_focal(fov: torch.Tensor, pixels):
    """Field of view (radians) -> focal length in pixels."""
    return pixels / (2.0 * torch.tan(fov / 2.0))


def focal_to_fov(focal: torch.Tensor, pixels):
    """Focal length in pixels -> field of view (radians)."""
    return 2.0 * torch.atan(pixels / (2.0 * focal))


def perspective_projection(znear, zfar, fovx, fovy) -> torch.Tensor:
    """OpenGL-like perspective matrix [..., 4, 4] with z in [0,1], z_sign=+1
    (column-vector form; callers transpose for the row-vector convention).
    `fovx`/`fovy` are tensors; leading dimensions batch."""
    tan_half_fovy = torch.tan(fovy / 2.0)
    tan_half_fovx = torch.tan(fovx / 2.0)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    zero = torch.zeros_like(top)
    one = torch.ones_like(top)
    rows = [
        [znear / right, zero, zero, zero],
        [zero, znear / top, zero, zero],
        [zero, zero, zero + zfar / (zfar - znear),
         zero - (zfar * znear) / (zfar - znear)],
        [zero, zero, one, zero],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera(s) for splatting. Array fields may carry leading
    batch dimensions; `height`/`width` are plain ints."""

    view: torch.Tensor  # [...,4,4] world->camera, TRANSPOSED
    full_proj: torch.Tensor  # [...,4,4] view @ proj, TRANSPOSED
    campos: torch.Tensor  # [...,3] camera center in world space
    tan_fovx: torch.Tensor  # [...]
    tan_fovy: torch.Tensor  # [...]
    height: int
    width: int

    @property
    def focal_x(self):
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self):
        return self.height / (2.0 * self.tan_fovy)

    def __len__(self) -> int:
        if self.view.dim() != 3:
            raise TypeError("len() of an unbatched Camera")
        return self.view.shape[0]

    def __getitem__(self, i) -> "Camera":
        return Camera(
            view=self.view[i], full_proj=self.full_proj[i],
            campos=self.campos[i], tan_fovx=self.tan_fovx[i],
            tan_fovy=self.tan_fovy[i], height=self.height, width=self.width,
        )


def camera_from_c2w(
    c2w: torch.Tensor,
    fovy,
    height: int,
    width: int,
    znear: float = 0.01,
    zfar: float = 100.0,
) -> Camera:
    """Camera(s) from OpenGL c2w [...,4,4] and vertical FoV (radians).
    Tensors follow `c2w`'s device."""
    c2w = c2w.to(torch.float32)
    fovy = torch.as_tensor(fovy, dtype=torch.float32, device=c2w.device)
    fovy = fovy.expand(c2w.shape[:-2])
    focal = fov_to_focal(fovy, height)
    fovx = focal_to_fov(focal, width)

    w2c = torch.linalg.inv(c2w).clone()
    w2c[..., 1:3, :3] *= -1.0
    w2c[..., :3, 3] *= -1.0

    view = w2c.transpose(-1, -2)
    proj = perspective_projection(znear, zfar, fovx, fovy).transpose(-1, -2)
    full_proj = view @ proj
    campos = torch.linalg.inv(view)[..., 3, :3]
    return Camera(
        view=view,
        full_proj=full_proj,
        campos=campos,
        tan_fovx=torch.tan(fovx / 2.0),
        tan_fovy=torch.tan(fovy / 2.0),
        height=height,
        width=width,
    )


def look_at_c2w(eye: torch.Tensor, target: torch.Tensor,
                up: torch.Tensor) -> torch.Tensor:
    """OpenGL camera-to-world [4,4] from eye/target/up tensors (z points
    backward). The result is on `eye`'s device."""
    eye = eye.to(torch.float32)
    fwd = target - eye
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, up.to(fwd.dtype))
    right = right / torch.linalg.norm(right)
    true_up = torch.linalg.cross(right, fwd)
    c2w = torch.eye(4, dtype=torch.float32, device=eye.device)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = eye
    return c2w
