"""Antialiased bilinear resize with a backward that adds in a fixed order.

Reference: `jax.image.resize(x, shape, "bilinear")` (antialias on), as
`humangaussian_tpu/guidance/dual_branch.py` and the other guidances call
it. JAX builds, for each axis whose size changes, a dense [in, out]
triangle-filter weight matrix (`jax._src.image.scale.compute_weight_mat`)
and contracts the image with it, H first, then W; its gradient is the same
contraction with the matrix transposed.

The port computes the same weights (`weight_matrix`, a numpy copy of
`compute_weight_mat` for the triangle kernel, in float32 as JAX computes
them) but keeps each axis as a band instead of the dense einsum over a
mostly-zero matrix: for each output, the few inputs it reads and their
weights, and for each input, the outputs that read it (`Band`). Forward
and backward are both gathers along the axis, one tap at a time in a
fixed order, so a gradient repeats bit for bit on every run, with torch's
deterministic algorithms on or off. This replaces `F.interpolate(...,
mode="bilinear", antialias=True)`, whose CUDA backward scatters with
atomics and has no deterministic implementation.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 weights of the antialiased triangle
    filter: `compute_weight_mat(in, out, out / in, 0, triangle, True)`.

    Output o samples the input at `(o + 0.5) / scale - 0.5`; the kernel's
    argument is divided by `max(1 / scale, 1)` (wider when shrinking,
    plain interpolation when growing); each output's weights are divided
    by their sum (zero where the sum is at most 1000 eps), and outputs
    whose sample lies outside [-0.5, in - 0.5] are zeroed."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = (np.abs(sample_f[None, :]
                - np.arange(in_size, dtype=np.float32)[:, None])
         / kernel_scale)
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > np.float32(1000.0 * _EPS32),
                 w / np.where(total != 0, total, np.float32(1.0)),
                 np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= np.float32(in_size - 0.5))
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def _taps(mat: np.ndarray) -> tuple:
    """Rows of `mat` ([n_out, n_in]) as taps: ([K, n_out] input indices,
    [K, n_out] weights) with each row's nonzero entries in increasing
    input order; a row with fewer than K padded with weight 0 on its last
    index (0 for an empty row), so every gather stays in bounds."""
    nz = mat != 0
    k = max(int(nz.sum(axis=1).max(initial=0)), 1)
    idx = np.zeros((mat.shape[0], k), np.int64)
    w = np.zeros((mat.shape[0], k), np.float32)
    for o in range(mat.shape[0]):
        (cols,) = np.nonzero(nz[o])
        if len(cols):
            idx[o, :len(cols)] = cols
            idx[o, len(cols):] = cols[-1]
            w[o, :len(cols)] = mat[o, cols]
    return idx.T.copy(), w.T.copy()


@dataclasses.dataclass(frozen=True)
class Band:
    """One axis of the resize on one device: tap k of output o reads input
    `idx[k, o]` with weight `w[k, o]`; the backward's taps `idx_t`, `w_t`
    ([K_t, in]) list, for each input, the outputs that read it in
    increasing order."""
    idx: torch.Tensor
    w: torch.Tensor
    idx_t: torch.Tensor
    w_t: torch.Tensor

    def transposed(self) -> "Band":
        return Band(self.idx_t, self.w_t, self.idx, self.w)


@functools.lru_cache(maxsize=64)
def band(in_size: int, out_size: int, device: torch.device,
         dtype: torch.dtype) -> Band:
    """The cached `Band` of `weight_matrix(in_size, out_size)`, weights
    cast to `dtype` (JAX casts the matrix to the image's dtype)."""
    mat = weight_matrix(in_size, out_size)
    parts = _taps(mat.T) + _taps(mat)
    return Band(*[torch.from_numpy(a).to(
        device, dtype if a.dtype == np.float32 else torch.int64)
        for a in parts])


def _gather_sum(x: torch.Tensor, dim: int, b: Band) -> torch.Tensor:
    """y[..., o, ...] = sum_k w[k, o] * x[..., idx[k, o], ...] along `dim`,
    added in k order; one output-sized temporary at a time."""
    shape = [1] * x.dim()
    shape[dim] = -1
    y = x.index_select(dim, b.idx[0]).mul_(b.w[0].view(shape))
    for k in range(1, b.idx.shape[0]):
        y.addcmul_(x.index_select(dim, b.idx[k]), b.w[k].view(shape))
    return y


class AxisResize(torch.autograd.Function):
    """The resize along one axis; its backward is the same gather with the
    transposed band (so it is differentiable again)."""

    @staticmethod
    def forward(ctx, x, dim: int, b: Band):
        ctx.dim, ctx.band = dim, b
        return _gather_sum(x, dim, b)

    @staticmethod
    def backward(ctx, g):
        return AxisResize.apply(g, ctx.dim, ctx.band.transposed()), None, None


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """[B, H, W, C] -> [B, size, size, C] (or [B, h, w, C] for `size`
    (h, w)), as `jax.image.resize(x, (B, h, w, C), "bilinear")`: half-pixel
    centres and, when shrinking, the triangle filter widened by the scale.
    An axis whose size does not change is left as it is (the input itself
    when neither changes)."""
    hw = (size, size) if isinstance(size, int) else tuple(size)
    for dim, out in zip((1, 2), hw):
        if x.shape[dim] != out:
            x = AxisResize.apply(
                x, dim, band(x.shape[dim], out, x.device, x.dtype))
    return x
