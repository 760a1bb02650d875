"""Frozen plain copy of `humangaussian_torch/smplx/lbs.py` for the benchmark's
reference (imports rewritten; kernel calls replaced by plain torch in
`portbench/reference/common.py`). Original docstring:

SMPL-X linear blend skinning forward pass in torch.

Port of humangaussian_tpu/smplx/lbs.py:

  v_shaped = T + S beta + E psi
  J        = regressor(v_shaped)
  v_posed  = v_shaped + P (R(theta) - I)
  verts    = sum_j w_j A_j(theta, J) v_posed      (LBS)

with A_j the world transform of joint j relative to its rest pose, composed
down the kinematic tree in a Python loop over the 55 joints. The model's
array fields are tensors (`convert.smplx_from_numpy`); `parents` stays a
numpy array of Python-loop indices.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.common import resolve_device
from portbench.reference.model import NUM_BODY_JOINTS, SMPLXModel


class SMPLXPose(NamedTuple):
    """Axis-angle pose parameters."""

    global_orient: torch.Tensor  # [3]
    body_pose: torch.Tensor  # [21,3]
    jaw_pose: torch.Tensor  # [3]
    leye_pose: torch.Tensor  # [3]
    reye_pose: torch.Tensor  # [3]
    left_hand_pose: torch.Tensor  # [15,3]
    right_hand_pose: torch.Tensor  # [15,3]

    @classmethod
    def rest(cls, body_pose: torch.Tensor | None = None,
             device="cuda") -> "SMPLXPose":
        """Zero pose, optionally with `body_pose` (whose device wins)."""
        if isinstance(body_pose, torch.Tensor):
            dev = body_pose.device
        else:
            dev = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        z3 = torch.zeros((3,), **f32)
        return cls(
            global_orient=z3,
            body_pose=torch.zeros((NUM_BODY_JOINTS, 3), **f32)
            if body_pose is None
            else torch.as_tensor(body_pose, **f32),
            jaw_pose=z3,
            leye_pose=z3,
            reye_pose=z3,
            left_hand_pose=torch.zeros((15, 3), **f32),
            right_hand_pose=torch.zeros((15, 3), **f32),
        )

    def full_pose(self, hands_mean=None,
                  flat_hand_mean: bool = True) -> torch.Tensor:
        """[55,3] axis-angle in SMPL-X joint order."""
        lh, rh = self.left_hand_pose, self.right_hand_pose
        if not flat_hand_mean and hands_mean is not None:
            hm = torch.as_tensor(hands_mean, dtype=torch.float32,
                                 device=lh.device).reshape(2, 15, 3)
            lh = lh + hm[0]
            rh = rh + hm[1]
        return torch.cat(
            [
                self.global_orient[None],
                self.body_pose,
                self.jaw_pose[None],
                self.leye_pose[None],
                self.reye_pose[None],
                lh,
                rh,
            ],
            dim=0,
        )


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [...,3] -> rotation matrices [...,3,3]."""
    angle = torch.linalg.norm(aa, dim=-1, keepdim=True)
    axis = aa / torch.clamp_min(angle, 1e-8)
    s = torch.sin(angle)[..., None]
    c = torch.cos(angle)[..., None]
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(x)
    k = torch.stack(
        [
            torch.stack([zeros, -z, y], dim=-1),
            torch.stack([z, zeros, -x], dim=-1),
            torch.stack([-y, x, zeros], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + s * k + (1.0 - c) * (k @ k)


def lbs_forward(
    model: SMPLXModel,
    pose: SMPLXPose,
    betas: torch.Tensor | None = None,
    expression: torch.Tensor | None = None,
    flat_hand_mean: bool = True,
):
    """SMPL-X forward. Returns (vertices [V,3], joints [55+L,3]); the
    trailing L joints are the surface landmarks in smplx package order."""
    v_template = model.v_template
    parents = np.asarray(model.parents)

    v_shaped = v_template
    if betas is not None and model.shapedirs.numel():
        v_shaped = v_shaped + torch.einsum("vcs,s->vc", model.shapedirs, betas)
    if expression is not None and model.exprdirs.numel():
        v_shaped = v_shaped + torch.einsum(
            "vcs,s->vc", model.exprdirs, expression
        )

    joints_rest = model.j_regressor @ v_shaped  # [J,3]

    full_pose = pose.full_pose(model.hands_mean, flat_hand_mean)
    rmats = rodrigues(full_pose)  # [J,3,3]

    eye3 = torch.eye(3, dtype=rmats.dtype, device=rmats.device)
    pose_feature = (rmats[1:] - eye3).reshape(-1)
    v_posed = v_shaped
    if model.posedirs.numel():
        v_posed = v_posed + torch.einsum("vcp,p->vc", model.posedirs,
                                         pose_feature)

    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=rmats.dtype,
                          device=rmats.device)

    def make_tf(r, t):
        return torch.cat([torch.cat([r, t[:, None]], dim=1), bottom], dim=0)

    transforms = [make_tf(rmats[0], joints_rest[0])]
    for i in range(1, model.j_regressor.shape[0]):
        p = int(parents[i])
        local = make_tf(rmats[i], joints_rest[i] - joints_rest[p])
        transforms.append(transforms[p] @ local)
    world = torch.stack(transforms)  # [J,4,4]
    joints_posed = world[:, :3, 3]

    # remove the rest-pose joint translation: A = T - [0 | R_w j_rest]
    correction = torch.einsum("jab,jb->ja", world[:, :3, :3], joints_rest)
    rel = world.clone()
    rel[:, :3, 3] = rel[:, :3, 3] - correction

    vert_tf = torch.einsum("vj,jab->vab", model.lbs_weights, rel)
    verts = (
        torch.einsum("vab,vb->va", vert_tf[:, :3, :3], v_posed)
        + vert_tf[:, :3, 3]
    )

    # a stand-in body with fewer vertices than SMPL-X still carries the
    # release landmark ids (load_smplx_npz); clamp them into range as the
    # JAX gather does
    landmarks = verts[model.landmark_vertex_ids.clamp(max=verts.shape[0] - 1)]
    joints_out = torch.cat([joints_posed, landmarks], dim=0)
    return verts, joints_out


def joint_world_rotations(model: SMPLXModel, pose: SMPLXPose) -> torch.Tensor:
    """Global (world-frame) rotation of every kinematic joint, [J,3,3]: the
    rotation part of `lbs_forward`'s world transforms. The viewer's
    skeleton dragging conjugates a screen-space rotation with it into a
    joint's parent frame."""
    rmats = rodrigues(pose.full_pose(model.hands_mean, flat_hand_mean=True))
    parents = np.asarray(model.parents)
    world = [rmats[0]]
    for i in range(1, model.j_regressor.shape[0]):
        world.append(world[int(parents[i])] @ rmats[i])
    return torch.stack(world)
