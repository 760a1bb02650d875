"""Input encodings of the implicit fields: NeRF frequencies and the
Instant-NGP multiresolution hash grid.

Port of humangaussian_tpu/nerf/encoding.py (the tiny-cuda-nn encodings the
reference requests through `get_encoding`). Differences from the JAX
module:

- The spatial hash multiplies by the three Instant-NGP primes in int64
  where JAX multiplies in uint32 and relies on wraparound. The products
  fit (4095 x 2,654,435,761 is below 2^63), and XOR and the `& (T - 1)`
  mask keep only low bits, so the indices are the uint32 ones.
- The level resolution is floor(float32(base * scale^l)), the Python
  double rounded to float32 first, as `jnp.floor` of a Python float does.
- The levels are computed in one pass over a [P, L] batch and the eight
  corners of every level gathered with one `index_select` from the
  flattened [L * T, F] table, where JAX loops over the levels. On the card
  the gather's backward is an `index_add_`, a scatter-add in unspecified
  order; this is a library op, not a kernel port (the JAX package computes
  it in jnp, not in Pallas).
- The table is an `nn.Parameter` initialized uniform in +-1e-4 from a
  `torch.Generator`, as the Flax initializer does from its key.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from humangaussian_torch import resolve_device

# the three large primes of the Instant-NGP spatial hash
PRIMES = (1, 2654435761, 805459861)


def init_generator(generator: torch.Generator | None) -> torch.Generator:
    """The CPU generator parameters are drawn from (the Flax initializers'
    key): `generator` when given, else one seeded with 0."""
    return generator if generator is not None else \
        torch.Generator().manual_seed(0)


class FrequencyEncoding(nn.Module):
    """NeRF sin/cos encoding: [.., D] -> [.., 2 * D * n_frequencies], per
    frequency the D sines, then the D cosines."""

    def __init__(self, n_frequencies: int = 6, in_dims: int = 3):
        super().__init__()
        self.n_frequencies = n_frequencies
        self.n_output_dims = 2 * in_dims * n_frequencies

    def forward(self, x):
        freqs = 2.0 ** torch.arange(self.n_frequencies, dtype=torch.float32,
                                    device=x.device)
        xb = x[..., None, :] * freqs[:, None]  # [.., L, D]
        enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)
        return enc.reshape(x.shape[:-1] + (-1,))

    def reset_parameters(self, generator=None):
        pass


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    """tcnn's HashGrid settings as the reference configures them (n_levels
    16, 2 features a level, 2^19 entries, base resolution 16, per-level
    scale ~1.447)."""

    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.4472692374403782


def level_resolutions(cfg: HashGridConfig) -> list[int]:
    """floor(base * scale^l) per level, the double rounded to float32 first
    (JAX's `jnp.floor` of the Python float)."""
    return [int(math.floor(np.float32(cfg.base_resolution
                                      * cfg.per_level_scale ** li)))
            for li in range(cfg.n_levels)]


def hash_rows(p0: torch.Tensor, res: torch.Tensor, t_size: int):
    """Table rows of the 8 corners of each cell, corner-major. p0 [P, L, 3]
    int64 lower corners, res [L] int64 resolutions -> [8, P, L] int64 in
    [0, t_size), corner i * 4 + j * 2 + k at offset (i, j, k). Corner-major
    keeps every corner's block contiguous (stacking on the last axis
    strides each write by 8 elements)."""
    hi = (res - 1)[None, :]
    per_axis = []
    for a in range(3):
        lo = p0[..., a].clamp_min(0).minimum(hi)
        up = (p0[..., a] + 1).clamp_min(0).minimum(hi)
        per_axis.append((lo * PRIMES[a], up * PRIMES[a]))
    hx, hy, hz = per_axis
    return torch.stack([(hx[i] ^ hy[j] ^ hz[k]) & (t_size - 1)
                        for i in (0, 1) for j in (0, 1) for k in (0, 1)])


def corner_weights(frac: torch.Tensor) -> torch.Tensor:
    """Trilinear weights [8, P, L] of frac [P, L, 3], corners ordered as
    `hash_rows`'s."""
    f = frac.unbind(-1)
    w = [(1.0 - f[a], f[a]) for a in range(3)]
    return torch.stack([w[0][i] * w[1][j] * w[2][k]
                        for i in (0, 1) for j in (0, 1) for k in (0, 1)])


class HashGridEncoding(nn.Module):
    """Multiresolution hash grid over [0, 1]^3 inputs: [.., 3] ->
    [.., n_levels * F], level-major."""

    def __init__(self, cfg: HashGridConfig = HashGridConfig(),
                 device="cuda", generator=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.n_output_dims = cfg.n_levels * cfg.n_features_per_level
        self.table = nn.Parameter(torch.empty(
            (cfg.n_levels, 1 << cfg.log2_hashmap_size,
             cfg.n_features_per_level), dtype=torch.float32, device=dev))
        self.resolutions = level_resolutions(cfg)
        self.register_buffer("res", torch.tensor(
            self.resolutions, dtype=torch.int64, device=dev),
            persistent=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        gen = init_generator(generator)
        self.table.copy_(torch.empty(self.table.shape).uniform_(
            -1e-4, 1e-4, generator=gen))

    def corners(self, x):
        """(rows [8, P, L] int32 into the flattened [L * T, F] table,
        trilinear weights [8, P, L]) of the P points of x [.., 3]."""
        c = self.cfg
        t_size = 1 << c.log2_hashmap_size
        pts = x.reshape(-1, 3)
        scale = (self.res.to(torch.float32) - 1.0)[None, :, None]
        p = pts[:, None, :] * scale  # [P, L, 3]
        p0 = torch.floor(p)
        offsets = torch.arange(c.n_levels, device=x.device,
                               dtype=torch.int64) * t_size
        rows = (hash_rows(p0.to(torch.int64), self.res, t_size)
                + offsets[None, None, :]).to(torch.int32)
        return rows, corner_weights(p - p0)

    def forward(self, x):
        rows, weights = self.corners(x)
        feats = torch.index_select(
            self.table.reshape(-1, self.cfg.n_features_per_level), 0,
            rows.reshape(-1)).reshape(rows.shape + (-1,))  # [8, P, L, F]
        out = (feats * weights[..., None]).sum(dim=0)
        return out.reshape(x.shape[:-1] + (self.n_output_dims,))
