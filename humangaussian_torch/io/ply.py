"""Gaussian-scene PLY import/export, byte-compatible with the JAX package.

Port of humangaussian_tpu/io/ply.py (numpy; copied, not imported). Schema:
binary little-endian, one `vertex` element with f4 properties

  x y z nx ny nz f_dc_{0..2} f_rest_{0..3(K-1)-1} opacity
  scale_{0..2} rot_{0..3}

with the SH rest coefficients flattened CHANNEL-major, scales and opacity in
raw (log / logit) form and zero normals.

`load_ply(..., animation_convention=True)` applies the animation loader's
axis shim: swap y/z in positions and scales, swap quaternion z/w
components and negate w.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from humangaussian_torch import resolve_device
from humangaussian_torch.core.scene import GaussianScene

_HEADER = """ply
format binary_little_endian 1.0
element vertex {n}
{props}
end_header
"""


def _property_names(sh_rest_coeffs: int) -> list[str]:
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * sh_rest_coeffs)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_ply(scene: GaussianScene, path: str) -> int:
    """Write the alive Gaussians to `path`. Returns the number written."""

    def host(x):
        return x.detach().cpu().numpy()

    alive = host(scene.alive)
    xyz = host(scene.means).astype(np.float32)[alive]
    n = xyz.shape[0]
    k_rest = scene.sh_rest.shape[1]
    f_rest = (
        host(scene.sh_rest).astype(np.float32)[alive]
        .transpose(0, 2, 1)
        .reshape(n, 3 * k_rest)
    )
    cols = np.concatenate(
        [
            xyz,
            np.zeros_like(xyz),
            host(scene.sh_dc).astype(np.float32)[alive],
            f_rest,
            host(scene.opacity_logits).astype(np.float32)[alive],
            host(scene.log_scales).astype(np.float32)[alive],
            host(scene.quats).astype(np.float32)[alive],
        ],
        axis=1,
    ).astype("<f4")

    props = "\n".join(f"property float {p}" for p in _property_names(k_rest))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_HEADER.format(n=n, props=props).encode("ascii"))
        f.write(cols.tobytes())
    return n


def _parse_header(f) -> tuple[int, list[str]]:
    line = f.readline().strip()
    if line != b"ply":
        raise ValueError("not a PLY file")
    n = None
    props: list[str] = []
    fmt = None
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        parts = line.decode("ascii", "replace").strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            if parts[1] != "vertex" and n is not None:
                raise ValueError("only single-element vertex PLYs supported")
            n = int(parts[2])
        elif parts[0] == "property":
            props.append(parts[-1])
        elif parts[0] == "end_header":
            break
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt!r}")
    return n, props


def load_ply(
    path: str,
    capacity: int | None = None,
    animation_convention: bool = False,
    device="cuda",
) -> GaussianScene:
    """Read a Gaussian PLY into a padded GaussianScene on `device`.
    `capacity` defaults to the point count rounded up to a multiple of 256."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        n, props = _parse_header(f)
        data = np.frombuffer(f.read(4 * n * len(props)), dtype="<f4").reshape(
            n, len(props)
        )
    col = {name: i for i, name in enumerate(props)}

    def grab(names):
        return np.stack([data[:, col[p]] for p in names], axis=1)

    xyz = grab(["x", "y", "z"])
    sh_dc = grab(["f_dc_0", "f_dc_1", "f_dc_2"])
    rest_names = sorted(
        (p for p in props if p.startswith("f_rest_")),
        key=lambda p: int(p.split("_")[-1]),
    )
    k_rest = len(rest_names) // 3
    if rest_names:
        sh_rest = grab(rest_names).reshape(n, 3, k_rest).transpose(0, 2, 1)
    else:
        sh_rest = np.zeros((n, 0, 3), np.float32)
    opacity = data[:, col["opacity"]][:, None]
    log_scales = grab(["scale_0", "scale_1", "scale_2"])
    quats = grab(["rot_0", "rot_1", "rot_2", "rot_3"])

    if animation_convention:
        xyz = xyz[:, [0, 2, 1]]
        log_scales = log_scales[:, [0, 2, 1]]
        quats = quats[:, [0, 1, 3, 2]]
        quats = quats * np.array([-1.0, 1.0, 1.0, 1.0], np.float32)

    if capacity is None:
        capacity = -(-n // 256) * 256
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    pad = capacity - n

    def padded(x, fill=0.0):
        x = np.asarray(x, np.float32)
        full = np.concatenate(
            [x, np.full((pad,) + x.shape[1:], fill, np.float32)], axis=0
        )
        return torch.from_numpy(full).to(dev)

    return GaussianScene(
        means=padded(xyz),
        log_scales=padded(log_scales, -10.0),
        quats=padded(quats),
        sh_dc=padded(sh_dc),
        sh_rest=padded(sh_rest),
        opacity_logits=padded(opacity, -10.0),
        alive=torch.arange(capacity, device=dev) < n,
    )
