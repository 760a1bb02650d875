"""What the benchmark makes from `--seed` and hands to the program and to
the plain reference alike: the SMPL-X stand-in, seeded prior weights,
prompt embeddings, the animated avatar and its motion.

Weights and the avatar are made on the device by a `torch.Generator` in a
few large calls; the stand-in mesh and the motion are small host arrays.
Nothing here imports the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from portbench.reference.model import (
    NUM_JOINTS,
    SMPLX_LANDMARK_VERTEX_IDS,
    SMPLXModel,
)

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    """A device generator for one use of `seed` (`salt` keeps the uses
    apart); any whole number is a seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + salt) & SEED_MASK)


def standin_model(n_ring: int = 64, n_seg_per_bone: int = 27,
                  radius: float = 0.2) -> SMPLXModel:
    """The procedural SMPL-X stand-in: the 55-joint skeleton and kinematic
    tree, a tube skinned to the spine chain (10,368 tube vertices and 55
    joint anchors, 20,608 faces; the release has 10,475 and 20,908), zero
    blend shapes and the release's landmark vertex ids."""
    j = NUM_JOINTS
    parents = np.array(
        [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
         18, 19, 15, 22, 23, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35,
         20, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52,
         53], dtype=np.int32)
    joints = np.zeros((j, 3), np.float32)
    for idx, y in {0: 0.0, 3: 0.15, 6: 0.3, 9: 0.45, 12: 0.6,
                   15: 0.7}.items():
        joints[idx] = (0.0, y, 0.0)
    fixed = {1: (-0.08, -0.05, 0.0), 2: (0.08, -0.05, 0.0),
             4: (-0.09, -0.4, 0.0), 5: (0.09, -0.4, 0.0),
             7: (-0.09, -0.8, 0.0), 8: (0.09, -0.8, 0.0),
             10: (-0.09, -0.85, 0.1), 11: (0.09, -0.85, 0.1),
             13: (-0.07, 0.55, 0.0), 14: (0.07, 0.55, 0.0),
             16: (-0.15, 0.55, 0.0), 17: (0.15, 0.55, 0.0),
             18: (-0.4, 0.55, 0.0), 19: (0.4, 0.55, 0.0),
             20: (-0.65, 0.55, 0.0), 21: (0.65, 0.55, 0.0),
             22: (0.0, 0.72, 0.05), 23: (-0.03, 0.75, 0.05),
             24: (0.03, 0.75, 0.05)}
    for idx, xyz in fixed.items():
        joints[idx] = xyz
    for f in range(25, 40):
        joints[f] = joints[20] + (-(0.02 + 0.01 * (f - 25)), 0.0, 0.0)
    for f in range(40, 55):
        joints[f] = joints[21] + ((0.02 + 0.01 * (f - 40)), 0.0, 0.0)

    chain = [0, 3, 6, 9, 12, 15]
    ys = np.linspace(-0.05, 0.75, len(chain) * n_seg_per_bone)
    theta = np.linspace(0, 2 * np.pi, n_ring, endpoint=False)
    yj = np.array([joints[c][1] for c in chain])
    verts, weights = [], []
    for y in ys:
        verts.append(np.stack([radius * np.cos(theta), np.full_like(theta, y),
                               radius * np.sin(theta)], axis=1))
        upper = np.clip(np.searchsorted(yj, y), 1, len(chain) - 1)
        lower = upper - 1
        t = np.clip((y - yj[lower]) / max(yj[upper] - yj[lower], 1e-6), 0, 1)
        w = np.zeros((n_ring, j), np.float32)
        w[:, chain[lower]] = 1.0 - t
        w[:, chain[upper]] = t
        weights.append(w)
    v_template = np.concatenate(verts + [joints]).astype(np.float32)
    anchor_w = np.eye(j, dtype=np.float32)
    lbs_weights = np.concatenate(weights + [anchor_w]).astype(np.float32)
    v = v_template.shape[0]
    j_regressor = np.zeros((j, v), np.float32)
    j_regressor[:, v - j:] = anchor_w
    r = np.arange(len(ys) - 1)[:, None] * n_ring
    k = np.arange(n_ring)[None, :]
    a, b = r + k, r + (k + 1) % n_ring
    c, d = a + n_ring, b + n_ring
    faces = np.stack([np.stack([a, b, c], -1), np.stack([b, d, c], -1)],
                     axis=2).reshape(-1, 3).astype(np.int32)
    return SMPLXModel(
        v_template=v_template,
        shapedirs=np.zeros((v, 3, 10), np.float32),
        exprdirs=np.zeros((v, 3, 10), np.float32),
        posedirs=np.zeros((v, 3, (j - 1) * 9), np.float32),
        j_regressor=j_regressor, lbs_weights=lbs_weights, parents=parents,
        faces=faces, landmark_vertex_ids=SMPLX_LANDMARK_VERTEX_IDS.copy(),
        hands_mean=np.zeros((90,), np.float32))


NORMS = (nn.GroupNorm, nn.LayerNorm)


def seeded_state_dict(module: nn.Module, seed: int, device, salt: int,
                      dtype=torch.bfloat16) -> dict:
    """Weights for every parameter of `module` (built on the meta device;
    only its names, shapes and layer kinds are read), in `dtype` on
    `device`, from one normal draw: a convolution's or linear layer's
    weight and bias with std 1/sqrt(3 fan_in) (the std of torch's default
    uniform initializers), a norm's weight 1 and bias 0."""
    specs = []
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            is_norm = isinstance(m, NORMS) or (
                hasattr(m, "num_groups") and p.dim() == 1)
            if is_norm:
                std, fill = 0.0, 1.0 if pname == "weight" else 0.0
            else:
                w = m.weight if hasattr(m, "weight") else p
                fan_in = math.prod(w.shape[1:]) if w.dim() > 1 else w.shape[0]
                std, fill = 1.0 / math.sqrt(3.0 * fan_in), 0.0
            specs.append((name, tuple(p.shape), std, fill))
    total = sum(math.prod(s) for _, s, _, _ in specs)
    flat = torch.randn(total, generator=generator(seed, device, salt),
                       device=device, dtype=torch.float32)
    out, i = {}, 0
    for name, shape, std, fill in specs:
        n = math.prod(shape)
        x = flat[i:i + n].view(shape)
        out[name] = (x.mul_(std).add_(fill) if std else
                     torch.full(shape, fill, device=device)).to(dtype)
        i += n
    return out


def prompt_embeddings(seed: int, device, seq: int = 77, dim: int = 1024):
    """(text_vd [4, L, D], uncond_vd [4, L, D], text, uncond, null [L, D])
    float32 stand-ins for the CLIP embeddings of the prompt, its view
    decorations and the negative and empty prompts."""
    x = torch.randn((11, seq, dim), generator=generator(seed, device, 3),
                    device=device)
    return x[0:4], x[4:8], x[8], x[9], x[10]


def walk_cycle(seed: int, n_frames: int, fps: float = 30.0,
               period_s: float = 1.0) -> np.ndarray:
    """[T, 21, 3] body poses: per joint and axis a sine of the walk's
    period with an amplitude (normal, 0.3 rad) and a phase drawn from the
    seed; the same set of curves for any seed's length."""
    rng = np.random.default_rng(int(seed) & SEED_MASK)
    amp = 0.3 * rng.normal(size=(1, 21, 3))
    phase = rng.uniform(0, 2 * np.pi, size=(1, 21, 3))
    t = np.arange(n_frames)[:, None, None] / fps
    return (amp * np.sin(2 * np.pi * t / period_s + phase)).astype(np.float32)


def _rest_surface(model: SMPLXModel, scale_delta: float = -10.0):
    """The rest-pose mesh in the animator's frame: (vertices, faces)."""
    v = model.v_template.astype(np.float64)
    center = (v.max(0) + v.min(0)) / 2
    scale = 0.6 / np.max(v.max(0) - v.min(0)) * 1.1 ** (-scale_delta)
    return (v - center) * scale, np.asarray(model.faces, np.int64)


def knn3_mean_sq(pts: torch.Tensor) -> torch.Tensor:
    """[N] mean squared distance to the 3 nearest other points (a k-d tree
    on the host: exact, and seconds for half a million points), on the
    points' device."""
    from scipy.spatial import cKDTree

    x = pts.detach().cpu().numpy().astype(np.float64)
    d, _ = cKDTree(x).query(x, k=4)
    return torch.from_numpy((d[:, 1:] ** 2).mean(axis=1)).float().to(
        pts.device)


def avatar(model: SMPLXModel, n: int, seed: int, device) -> dict:
    """A trained avatar's stand-in: `n` Gaussians area-uniform on the
    stand-in's rest surface (in the animator's frame), offset along the
    face normal by at most 5e-3, isotropic scales from the 3-NN distances
(on the host),
    skin-toned colours, opacities in [0.3, 0.95], random rotations, SH
    degree 0. A dict of float32 tensors on `device`."""
    g = generator(seed, device, 5)
    verts, faces = _rest_surface(model)
    vt = torch.from_numpy(verts).to(device)
    ft = torch.from_numpy(faces).to(device)
    a, b, c = vt[ft[:, 0]], vt[ft[:, 1]], vt[ft[:, 2]]
    cross = torch.linalg.cross(b - a, c - a)
    area = 0.5 * torch.linalg.norm(cross, dim=1)
    idx = torch.multinomial(area, n, replacement=True, generator=g)
    u = torch.rand((n, 4), generator=g, device=device, dtype=torch.float64)
    r1, r2 = u[:, 0].sqrt(), u[:, 1]
    pts = ((1 - r1)[:, None] * a[idx] + (r1 * (1 - r2))[:, None] * b[idx]
           + (r1 * r2)[:, None] * c[idx])
    normal = cross[idx] / (2 * area[idx])[:, None]
    pts = (pts + normal * (u[:, 2:3] * 1e-2 - 5e-3)).float()
    mean_sq = knn3_mean_sq(pts)
    rgb = (torch.tensor([0.8, 0.6, 0.5], device=device)
           + 0.1 * torch.randn((n, 3), generator=g, device=device)).clamp(0, 1)
    opa = 0.3 + 0.65 * torch.rand((n, 1), generator=g, device=device)
    return {
        "means": pts,
        "log_scales": torch.log(torch.sqrt(mean_sq.clamp_min(1e-7)))[:, None]
        .expand(n, 3).contiguous(),
        "quats": torch.randn((n, 4), generator=g, device=device),
        "sh_dc": (rgb - 0.5) / 0.28209479177387814,
        "sh_rest": torch.zeros((n, 0, 3), device=device),
        "opacity_logits": torch.log(opa / (1 - opa)),
    }
