"""Fused GroupNorm(+SiLU) with hand-written kernels and an analytic
backward.

Port of humangaussian_tpu/ops/groupnorm.py. The op normalizes over the
channel-minor axis of `[N, ..., C]` (the reference's layout, kept here so
both packages see the same arrays), per (sample, group), with f32
statistics; the output is cast back to `x.dtype`. The forward of a CUDA
tensor is one launch of one kernel (csrc/groupnorm_fwd.cu,
`group_norm_fwd`):

  sums (K3's work): per (sample, channel) sum and sum of squares over the
      R = prod(...) rows of `[N, R, C]`, as per-split partials added in a
      fixed order into [N, 2, C] (no atomics, no zero-fill: bit-equal from
      run to run);
  normalize (+SiLU) (K3a's work): per (sample, group) mean and rstd from
      those sums (variance as E[x^2] - mean^2, clamped at 0), per-channel
      a = gamma * rstd, b = beta - mu * a, then y = act(x * a + b).

K3 and K3a alone (`group_norm_stats`, `group_norm_apply`) are the
kernel's sums-only and normalize-only modes. Under autograd the op saves
the sums, and the backward is two kernels, each of which forms the group
mean and rstd from the saved sums as the forward did (so no torch code
runs for them):

  backward sums (kernel K5, csrc/groupnorm_stats.cu): per (sample,
      channel) S1 = sum(dy) and S2 = sum(dy * xhat) into [N, 2, C], as
      per-split partials added in a fixed order (no atomics, no zero-fill:
      bit-equal from run to run), with xhat and the SiLU derivative
      recomputed from (x, dz) in registers;
  input gradient (kernel K5a, csrc/groupnorm_bwd_dx.cu): each block forms
      its sample's group means of gamma * S1 and gamma * S2, then writes
      16 bytes a thread, recomputing xhat and dy from (x, dz),

  dx = rstd * (gamma * dy - mean_g(gamma dy) - xhat * mean_g(gamma dy xhat)).

So the backward of a CUDA tensor is K5 and K5a, two launches that write
every output once (capturable in a CUDA graph); dgamma and dbias (the sums
of S2 and S1 over samples) are computed only when asked for.

Dispatch: a CUDA tensor launches the kernels, a CPU tensor takes the plain
versions (`group_norm_fwd_plain`, `group_norm_stats_plain`,
`group_norm_apply_plain`, `group_norm_bwd_stats_plain`,
`group_norm_bwd_dx_plain`); nothing else decides, and nothing falls back
from a kernel to a plain version.

Dropped from the reference: `_pick_block_rows` and the pure-XLA route for
row counts no block divides (the CUDA kernels take any row count), the
revisited `[2, C]` output block (per-split partials added in split order
take its place) and `FORCE_PALLAS_INTERPRET`.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch import nn

from humangaussian_torch.kernels import (
    GROUPNORM_BWD_DX,
    GROUPNORM_BWD_STATS,
    GROUPNORM_FWD,
)

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# the forward kernel (csrc/groupnorm_fwd.cu): its block, the vectors a
# channel block spans at most, the rows a thread loads at once, and the
# persistent blocks it keeps on each SM
_THREADS = 256
_MAX_BLOCK_VECTORS = 64
_UNROLL = 8
_BLOCKS_PER_SM = 3
_FUSED, _SUMS_ONLY, _APPLY_ONLY = 0, 1, 2


def fwd_block_vectors(vectors: int) -> tuple:
    """(channel blocks across C, vectors across a block, rows a block
    covers at once) of the forward kernel, for C of `vectors` vectors. A C
    narrower than a warp is one block rounded up to a power of two; a
    wider one is cut into blocks of 32 to 64 vectors (the last may be
    narrower), the width that leaves the fewest of the blocks' threads
    idle (the widest among equals)."""
    if vectors < 32:
        cbv = 1 << max(0, (vectors - 1).bit_length())
        return 1, cbv, _THREADS // cbv
    best = (-1.0, 0)
    for cbv in range(min(_MAX_BLOCK_VECTORS, vectors), 31, -1):
        nbc = math.ceil(vectors / cbv)
        busy = vectors * (_THREADS // cbv) / (nbc * _THREADS)
        if busy > best[0] + 1e-9:
            best = (busy, cbv)
    cbv = best[1]
    return math.ceil(vectors / cbv), cbv, _THREADS // cbv


def fwd_row_splits(samples: int, rows: int, channel_blocks: int, deep: int,
                   target_blocks: int) -> int:
    """Row splits per (sample, channel block): the fewest that keep the
    `target_blocks` persistent blocks at least 95% busy over the tiles
    (each block takes every target-th tile, so a last round that few
    blocks take costs a whole round), at most four tiles a block, each
    tile at least one step of the block's rows and none empty; else the
    busiest."""
    per_split = samples * channel_blocks
    most = max(1, min(4 * target_blocks // per_split,
                      rows // (deep * _UNROLL)))
    best = (0.0, 1)
    for splits in range(1, most + 1):
        if (splits - 1) * math.ceil(rows / splits) >= rows:
            continue  # the last split would hold no row
        tiles = per_split * splits
        busy = tiles / (target_blocks * math.ceil(tiles / target_blocks))
        if busy >= 0.95:
            return splits
        if busy > best[0] + 1e-9:
            best = (busy, splits)
    return best[1]


# K5 (csrc/groupnorm_stats.cu): its block, the channels a block spans, the
# rows a thread loads at once, and the persistent blocks an SM (its launch
# bounds guarantee two)
_BWD_THREADS = 256
_BWD_CHANNELS = 64
_BWD_UNROLL = 4
_BWD_BLOCKS_PER_SM = 2


def bwd_row_splits(per_split: int, rows: int, step: int,
                   target_blocks: int) -> int:
    """K5's row splits per (sample, channel block), `per_split` tiles a
    split: the fewest that keep the `target_blocks` persistent blocks at
    least 90% busy over whole rounds of tiles, each split at least four
    steps of `step` rows (at most 1024 splits); else the busiest."""
    most = min(1024, max(1, rows // (4 * step)))
    best = (0.0, 1)
    for splits in range(1, most + 1):
        tiles = per_split * splits
        busy = tiles / (target_blocks * math.ceil(tiles / target_blocks))
        if busy > best[0] + 1e-9:
            best = (busy, splits)
        if busy >= 0.9:
            break
    return best[1]


class _BwdLaunch(NamedTuple):
    vector: bool
    splits: int
    blocks: int
    sync_words: int
    partial_floats: int


@functools.lru_cache(maxsize=256)
def _bwd_launch(sms: int, samples: int, rows: int, channels: int,
                itemsize: int, aligned: bool) -> _BwdLaunch:
    """K5's numbers for one shape on a card of `sms` SMs: 16-byte vectors
    where C and the pointers allow them, the row splits (none empty), the
    persistent blocks and the scratch sizes."""
    vec = 16 // itemsize
    vector = aligned and channels % vec == 0
    width = vec if vector else 1
    nbc = math.ceil(channels / _BWD_CHANNELS)
    step = _BWD_THREADS // (_BWD_CHANNELS // width) * _BWD_UNROLL
    target = sms * _BWD_BLOCKS_PER_SM
    splits = bwd_row_splits(samples * nbc, rows, step, target)
    splits = math.ceil(rows / math.ceil(rows / splits))  # none empty
    tiles = samples * nbc * splits
    blocks = min(target, tiles)
    return _BwdLaunch(vector, splits, blocks, 1 + blocks + tiles,
                      samples * splits * 2 * channels)


class _FwdLaunch(NamedTuple):
    vector: bool
    block_vectors: int
    splits: int
    blocks: int
    sync_words: int
    partial_floats: int


@functools.lru_cache(maxsize=256)
def _fwd_launch(sms: int, samples: int, rows: int, channels: int,
                itemsize: int, aligned: bool) -> _FwdLaunch:
    """The forward kernel's numbers for one shape on a card of `sms` SMs:
    16-byte vectors where C and the pointers allow them, the channel
    blocks, the row splits, the persistent blocks and the scratch sizes."""
    vec = 16 // itemsize
    vector = aligned and channels % vec == 0
    nbc, cbv, deep = fwd_block_vectors(channels // (vec if vector else 1))
    target = sms * _BLOCKS_PER_SM
    splits = fwd_row_splits(samples, rows, nbc, deep, target)
    tiles = samples * nbc * splits
    blocks = max(1, min(target, tiles))
    return _FwdLaunch(vector, cbv, splits, blocks, 1 + blocks + tiles,
                      samples * splits * 2 * channels)


# per (card, stream): 32-bit words that carry the readiness flags and
# generation of the forward kernel and K5 from eager launch to launch
# (zeroed once; csrc/groupnorm_sync.cuh)
_SYNC: dict = {}


def _sync_words(device: torch.device, stream, words: int) -> torch.Tensor:
    """The flag words of a forward or K5 launch on `stream`. Eager launches
    on one stream share a buffer that is never reset (the kernels keep a
    generation in it, and a launch starts only once the one before it on
    the stream has ended). A launch under stream capture takes words of
    its own, zeroed in the graph: a graph's replay then never meets the
    flags of another graph's or of an eager launch."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(words, dtype=torch.int32, device=device)
    key = (device.index, stream.cuda_stream)
    buf = _SYNC.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(max(words, 4096), dtype=torch.int32,
                          device=device)
        _SYNC[key] = buf
    return buf


def _launch_fwd(mode, x3, sums_in, gamma, beta, groups, eps, silu, y,
                sums_out):
    n, rows, c = x3.shape
    aligned = x3.data_ptr() % 16 == 0 and (y is None or
                                            y.data_ptr() % 16 == 0)
    with torch.cuda.device(x3.device):
        index = torch.cuda.current_device()
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        how = _fwd_launch(sms, n, rows, c, x3.element_size(), aligned)
        stream = torch.cuda.current_stream(x3.device)
        partials = sync = None
        if mode != _APPLY_ONLY:
            partials = torch.empty(how.partial_floats, dtype=torch.float32,
                                   device=x3.device)
            sync = _sync_words(x3.device, stream, how.sync_words)

        def ptr(t):
            return None if t is None else t.data_ptr()

        GROUPNORM_FWD.launch(
            x3.data_ptr(), ptr(sums_in), ptr(gamma), ptr(beta), n, rows, c,
            groups, eps, int(x3.dtype == torch.bfloat16), int(silu), mode,
            how.block_vectors, how.splits, how.blocks, int(how.vector),
            ptr(y), ptr(sums_out), ptr(partials),
            0 if partials is None else partials.numel(), ptr(sync),
            0 if sync is None else sync.numel(), stream.cuda_stream)


def _check_x3(name, x3):
    if not isinstance(x3, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x3.dim() != 3:
        raise ValueError(f"{name} must be [N, R, C], got {tuple(x3.shape)}")
    if not x3.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_kernel_input(name, x3):
    if x3.dtype not in _KERNEL_DTYPES:
        raise TypeError(
            f"the GroupNorm kernels take bfloat16 or float32, {name} is "
            f"{x3.dtype}")
    if x3.device.type != "cuda":
        raise ValueError(f"no GroupNorm kernel for device {x3.device}")


def _check_f32_args(x3, *named):
    """Each (name, tensor, shape) must be float32 of that shape on x3's
    device."""
    for name, t, shape in named:
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device != x3.device:
            raise ValueError(
                f"{name} must be float32 {shape} on {x3.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_groups(channels: int, groups: int):
    if groups <= 0 or channels % groups:
        raise ValueError(
            f"{channels} channels do not divide into {groups} groups")


def group_norm_stats_plain(x3: torch.Tensor) -> torch.Tensor:
    """The sums' function (K3's) in plain torch: [N, R, C] -> [N, 2, C]
    f32."""
    xf = x3.to(torch.float32)
    return torch.stack([xf.sum(dim=1), (xf * xf).sum(dim=1)], dim=1)


def group_norm_stats(x3: torch.Tensor) -> torch.Tensor:
    """Per (sample, channel) sum and sum of squares of `x3` [N, R, C]
    (contiguous) as f32 [N, 2, C]: the forward kernel's sums-only mode (K3)
    for a CUDA tensor, the plain version for a CPU tensor."""
    _check_x3("x3", x3)
    if x3.device.type == "cpu":
        return group_norm_stats_plain(x3)
    _check_kernel_input("x3", x3)
    n, _, c = x3.shape
    out = torch.empty((n, 2, c), dtype=torch.float32, device=x3.device)
    # the sums know no groups: one group a channel
    _launch_fwd(_SUMS_ONLY, x3, None, None, None, c, 0.0, False, None, out)
    return out


def group_stats(sums: torch.Tensor, rows: int, groups: int, eps: float):
    """[N, 2, C] channel sums -> per-channel mu, rstd [N, C] f32."""
    n, _, c = sums.shape
    cg = c // groups
    m = rows * cg  # elements per (sample, group)
    gsum = sums.reshape(n, 2, groups, cg).sum(dim=3)  # [N, 2, G]
    mean = gsum[:, 0] / m
    var = (gsum[:, 1] / m - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    return (mean.repeat_interleave(cg, dim=1),
            rstd.repeat_interleave(cg, dim=1))


def group_norm_apply_plain(x3, sums, gamma, beta, groups: int, eps: float,
                           silu: bool) -> torch.Tensor:
    """K3a's function in plain torch: x3 [N, R, C] and its K3 sums
    [N, 2, C] -> act(x3 * a + b) in x3's dtype, from the reference's group
    combine and normalize arithmetic."""
    mu_c, rstd_c = group_stats(sums, x3.shape[1], groups, eps)
    a = (gamma * rstd_c)[:, None, :]  # [N, 1, C]
    b = (beta - mu_c * gamma * rstd_c)[:, None, :]
    y = x3.to(torch.float32) * a + b
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x3.dtype)


def group_norm_apply(x3, sums, gamma, beta, groups: int, eps: float,
                     silu: bool) -> torch.Tensor:
    """GroupNorm(+SiLU) of `x3` [N, R, C] (contiguous) from its sums
    [N, 2, C] f32 and gamma, beta [C] f32, in x3's dtype: K3a for a CUDA
    tensor, the plain version for a CPU tensor."""
    _check_x3("x3", x3)
    n, rows, c = x3.shape
    _check_f32_args(x3, ("sums", sums, (n, 2, c)), ("gamma", gamma, (c,)),
                    ("beta", beta, (c,)))
    _check_groups(c, groups)
    if x3.device.type == "cpu":
        return group_norm_apply_plain(x3, sums, gamma, beta, groups, eps,
                                      silu)
    _check_kernel_input("x3", x3)
    out = torch.empty_like(x3)
    _launch_fwd(_APPLY_ONLY, x3, sums.contiguous(), gamma.contiguous(),
                beta.contiguous(), groups, eps, silu, out, None)
    return out


def group_norm_fwd_plain(x3, gamma, beta, groups: int, eps: float,
                         silu: bool) -> tuple:
    """The fused forward's function in plain torch: (y, sums) =
    (`group_norm_apply_plain` on `group_norm_stats_plain`'s sums, those
    sums)."""
    sums = group_norm_stats_plain(x3)
    return (group_norm_apply_plain(x3, sums, gamma, beta, groups, eps, silu),
            sums)


def group_norm_fwd(x3, gamma, beta, groups: int, eps: float,
                   silu: bool) -> tuple:
    """GroupNorm(+SiLU) of `x3` [N, R, C] (contiguous) with gamma, beta [C]
    f32: (y in x3's dtype, the f32 [N, 2, C] sums the backward reads). One
    launch of the forward kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    _check_x3("x3", x3)
    n, _, c = x3.shape
    _check_f32_args(x3, ("gamma", gamma, (c,)), ("beta", beta, (c,)))
    _check_groups(c, groups)
    if x3.device.type == "cpu":
        return group_norm_fwd_plain(x3, gamma, beta, groups, eps, silu)
    _check_kernel_input("x3", x3)
    y = torch.empty_like(x3)
    sums = torch.empty((n, 2, c), dtype=torch.float32, device=x3.device)
    _launch_fwd(_FUSED, x3, None, gamma.contiguous(), beta.contiguous(),
                groups, eps, silu, y, sums)
    return y, sums


def _dy_xhat(x3, dz3, mu_c, rstd_c, gamma, beta, silu):
    """f32 (dy, xhat) of the backward: dy is dz through the SiLU
    derivative, recomputed from x as the kernel recomputes it."""
    xhat = (x3.to(torch.float32) - mu_c[:, None, :]) * rstd_c[:, None, :]
    dy = dz3.to(torch.float32)
    if silu:
        y = xhat * gamma + beta
        sig = torch.sigmoid(y)
        dy = dy * sig * (1.0 + y * (1.0 - sig))
    return dy, xhat


def _check_bwd_args(x3, dz3, fwd_sums, gamma, beta, groups):
    _check_x3("x3", x3)
    _check_x3("dz3", dz3)
    n, _, c = x3.shape
    if dz3.shape != x3.shape or dz3.dtype != x3.dtype \
            or dz3.device != x3.device:
        raise ValueError(
            f"dz3 must match x3 ({x3.dtype} {tuple(x3.shape)} on "
            f"{x3.device}), got {dz3.dtype} {tuple(dz3.shape)} on "
            f"{dz3.device}")
    _check_f32_args(x3, ("fwd_sums", fwd_sums, (n, 2, c)),
                    ("gamma", gamma, (c,)), ("beta", beta, (c,)))
    _check_groups(c, groups)


def group_norm_bwd_stats_plain(x3, dz3, fwd_sums, gamma, beta, groups: int,
                               eps: float, silu: bool) -> torch.Tensor:
    """K5's function in plain torch: [N, 2, C] f32 (sum dy, sum dy*xhat)."""
    mu_c, rstd_c = group_stats(fwd_sums, x3.shape[1], groups, eps)
    dy, xhat = _dy_xhat(x3, dz3, mu_c, rstd_c, gamma, beta, silu)
    return torch.stack([dy.sum(dim=1), (dy * xhat).sum(dim=1)], dim=1)


def group_norm_bwd_stats(x3, dz3, fwd_sums, gamma, beta, groups: int,
                         eps: float, silu: bool) -> torch.Tensor:
    """Per (sample, channel) S1 = sum(dy), S2 = sum(dy * xhat) as f32
    [N, 2, C] from x3, dz3 [N, R, C] (same dtype, contiguous), the
    forward's sums [N, 2, C] (K3's; the group mean and rstd come from them)
    and gamma, beta [C], f32: K5 for CUDA tensors, the plain version for
    CPU tensors."""
    _check_bwd_args(x3, dz3, fwd_sums, gamma, beta, groups)
    n, rows, c = x3.shape
    if x3.device.type == "cpu":
        return group_norm_bwd_stats_plain(x3, dz3, fwd_sums, gamma, beta,
                                          groups, eps, silu)
    _check_kernel_input("x3", x3)
    out = torch.empty((n, 2, c), dtype=torch.float32, device=x3.device)
    if out.numel() == 0 or rows == 0:
        return out.zero_()
    aligned = x3.data_ptr() % 16 == 0 and dz3.data_ptr() % 16 == 0
    with torch.cuda.device(x3.device):
        index = torch.cuda.current_device()
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        how = _bwd_launch(sms, n, rows, c, x3.element_size(), aligned)
        stream = torch.cuda.current_stream(x3.device)
        partials = torch.empty(how.partial_floats, dtype=torch.float32,
                               device=x3.device)
        sync = _sync_words(x3.device, stream, how.sync_words)
        GROUPNORM_BWD_STATS.launch(
            x3.data_ptr(), dz3.data_ptr(), fwd_sums.contiguous().data_ptr(),
            gamma.contiguous().data_ptr(), beta.contiguous().data_ptr(), n,
            rows, c, groups, eps, int(x3.dtype == torch.bfloat16), int(silu),
            how.splits, how.blocks, int(how.vector), out.data_ptr(),
            partials.data_ptr(), partials.numel(), sync.data_ptr(),
            sync.numel(), stream.cuda_stream)
    return out


def _group_means(sums, gamma, rows: int, groups: int):
    """Per-channel [N, 1, C] group means of gamma * S1 and gamma * S2 over
    the (sample, group)'s rows x channels elements."""
    n, _, c = sums.shape
    cg = c // groups
    m = rows * cg
    means = (gamma * sums).reshape(n, 2, groups, cg).sum(dim=3) / m
    means = means.repeat_interleave(cg, dim=2)
    return means[:, 0, None, :], means[:, 1, None, :]


def group_norm_bwd_dx_plain(x3, dz3, fwd_sums, gamma, beta, sums,
                            groups: int, eps: float,
                            silu: bool) -> torch.Tensor:
    """K5a's function in plain torch: dx [N, R, C] in x3's dtype from
    (x3, dz3), the forward's sums and K5's sums [N, 2, C], the reference's
    dx arithmetic."""
    rows = x3.shape[1]
    mu_c, rstd_c = group_stats(fwd_sums, rows, groups, eps)
    mean1_c, mean2_c = _group_means(sums, gamma, rows, groups)
    dy, xhat = _dy_xhat(x3, dz3, mu_c, rstd_c, gamma, beta, silu)
    dx = rstd_c[:, None, :] * (gamma * dy - mean1_c - xhat * mean2_c)
    return dx.to(x3.dtype)


def group_norm_bwd_dx(x3, dz3, fwd_sums, gamma, beta, sums, groups: int,
                      eps: float, silu: bool) -> torch.Tensor:
    """The input gradient of GroupNorm(+SiLU) as [N, R, C] in x3's dtype,
    from x3, dz3 [N, R, C] (same dtype, contiguous), the forward's sums,
    gamma, beta [C] and K5's sums [N, 2, C] (all f32): K5a for CUDA
    tensors, the plain version for CPU tensors."""
    _check_bwd_args(x3, dz3, fwd_sums, gamma, beta, groups)
    n, rows, c = x3.shape
    _check_f32_args(x3, ("sums", sums, (n, 2, c)))
    if x3.device.type == "cpu":
        return group_norm_bwd_dx_plain(x3, dz3, fwd_sums, gamma, beta, sums,
                                       groups, eps, silu)
    _check_kernel_input("x3", x3)
    if rows * c >= 2**31:
        raise ValueError(f"{rows} x {c} elements per sample exceed 2^31")
    dx = torch.empty_like(x3)
    with torch.cuda.device(x3.device):
        GROUPNORM_BWD_DX.launch(
            x3.data_ptr(), dz3.data_ptr(), fwd_sums.contiguous().data_ptr(),
            gamma.contiguous().data_ptr(), beta.contiguous().data_ptr(),
            sums.contiguous().data_ptr(), n, rows, c, groups, eps,
            int(x3.dtype == torch.bfloat16), int(silu), dx.data_ptr(),
            torch.cuda.current_stream(x3.device).cuda_stream)
    return dx


def _as_rows(x):
    n, c = x.shape[0], x.shape[-1]
    return x.reshape(n, -1, c)


class _GroupNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, silu):
        x3 = _as_rows(x.contiguous())
        gamma = scale.to(torch.float32)
        beta = bias.to(torch.float32)
        y, sums = group_norm_fwd(x3, gamma, beta, groups, eps, silu)
        ctx.save_for_backward(x3, scale, bias, sums)
        ctx.cfg = (groups, eps, silu, x.shape)
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dz):
        x3, scale, bias, fwd_sums = ctx.saved_tensors
        groups, eps, silu, shape = ctx.cfg
        dz3 = _as_rows(dz.contiguous())
        gamma = scale.to(torch.float32)
        beta = bias.to(torch.float32)
        sums = group_norm_bwd_stats(x3, dz3, fwd_sums, gamma, beta, groups,
                                    eps, silu)
        dx = group_norm_bwd_dx(x3, dz3, fwd_sums, gamma, beta, sums, groups,
                               eps, silu).reshape(shape)
        # the frozen priors ask for dx alone
        want_scale, want_bias = ctx.needs_input_grad[1:3]
        dscale = sums[:, 1].sum(dim=0).to(scale.dtype) if want_scale else None
        dbias = sums[:, 0].sum(dim=0).to(bias.dtype) if want_bias else None
        return dx, dscale, dbias, None, None, None


def group_norm_act(x, scale, bias, groups: int, eps: float,
                   silu: bool) -> torch.Tensor:
    """GroupNorm over the channel-minor axis of `x` [N, ..., C], optionally
    fused with SiLU. Statistics per (sample, group) in f32; the output is
    cast back to `x.dtype`. Differentiable in x, scale and bias.

    Matches `nn.GroupNorm(groups, C, eps)` (+ `F.silu`) applied to the
    channel-major view of `x`, with f32 statistics; C must be divisible by
    `groups`."""
    if x.dim() < 2:
        raise ValueError(f"x must be [N, ..., C], got {tuple(x.shape)}")
    c = x.shape[-1]
    _check_groups(c, groups)
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(
            f"scale and bias must be [{c}], got {tuple(scale.shape)} and "
            f"{tuple(bias.shape)}")
    return _GroupNormAct.apply(x, scale, bias, groups, eps, silu)


class GroupNormAct(nn.Module):
    """`nn.GroupNorm` (+ optional fused SiLU) on a channels-first
    activation `[N, C, H, W]`, through `group_norm_act`.

    Parameters are `weight` and `bias` [C], the names `nn.GroupNorm` and the
    diffusers checkpoints use. The op itself is channel-minor, so the module
    permutes to `[N, H, W, C]` and back; for a `channels_last` activation,
    which is what the UNet and the VAE keep, both permutes are views and
    cost nothing."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 silu: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = eps
        self.silu = silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        y = group_norm_act(x.permute(0, 2, 3, 1), self.weight, self.bias,
                           self.num_groups, self.eps, self.silu)
        return y.permute(0, 3, 1, 2)

    def extra_repr(self):
        return (f"{self.num_groups}, {self.num_channels}, eps={self.eps}, "
                f"silu={self.silu}")
