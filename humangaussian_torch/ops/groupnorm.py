"""Fused GroupNorm(+SiLU) with hand-written kernels and an analytic
backward.

Port of humangaussian_tpu/ops/groupnorm.py. The op normalizes over the
channel-minor axis of `[N, ..., C]` (the reference's layout, kept here so
both packages see the same arrays), per (sample, group), with f32
statistics; the output is cast back to `x.dtype`. The forward is two
kernels:

  statistics (kernel K3, csrc/groupnorm_stats.cu): per (sample, channel)
      sum and sum of squares over the R = prod(...) rows of `[N, R, C]`
      into a zeroed [N, 2, C];
  normalize (+SiLU) (kernel K3a, csrc/groupnorm_apply.cu): each block
      forms its sample's group mean and rstd (variance as E[x^2] - mean^2,
      clamped at 0) and per-channel a = gamma * rstd, b = beta - mu * a in
      shared memory, then writes y = act(x * a + b) 16 bytes a thread.

So the forward of a CUDA tensor is K3, one zero-fill and K3a. Under
autograd the op saves the sums, and the backward is two kernels, each of
which forms the group mean and rstd from the saved sums as K3a did (so no
torch code runs for them):

  backward sums (kernel K5, csrc/groupnorm_stats.cu): per (sample,
      channel) S1 = sum(dy) and S2 = sum(dy * xhat) into [N, 2, C], which
      its entry point zeroes first, with xhat and the SiLU derivative
      recomputed from (x, dz) in registers;
  input gradient (kernel K5a, csrc/groupnorm_bwd_dx.cu): each block forms
      its sample's group means of gamma * S1 and gamma * S2, then writes
      16 bytes a thread, recomputing xhat and dy from (x, dz),

  dx = rstd * (gamma * dy - mean_g(gamma dy) - xhat * mean_g(gamma dy xhat)).

So the backward of a CUDA tensor is K5 (after a memset) and K5a; dgamma
and dbias (the sums of S2 and S1 over samples) are computed only when
asked for.

Dispatch: a CUDA tensor launches K3 / K3a / K5 / K5a, a CPU tensor takes
the plain versions (`group_norm_stats_plain`, `group_norm_apply_plain`,
`group_norm_bwd_stats_plain`, `group_norm_bwd_dx_plain`); nothing else
decides, and nothing falls back from a kernel to a plain version.

Dropped from the reference: `_pick_block_rows` and the pure-XLA route for
row counts no block divides (the CUDA kernels take any row count), the
revisited `[2, C]` output block (blocks have no order on a GPU; partial
sums meet through atomicAdd) and `FORCE_PALLAS_INTERPRET`.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from humangaussian_torch.kernels import (
    GROUPNORM_BWD_DX,
    GROUPNORM_BWD_STATS,
    GROUPNORM_FWD_APPLY,
    GROUPNORM_FWD_STATS,
)

# the kernels' block: 64 channels wide, 8 rows per step
_CHANNELS_PER_BLOCK = 64
_ROWS_PER_STEP = 8
# blocks a launch should reach where the rows allow it (132 SMs x 8)
_TARGET_BLOCKS = 1056
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def rows_per_block(samples: int, rows: int, channels: int) -> int:
    """Rows each block of K3 (the forward statistics) reduces: the whole of
    `rows` when samples x channel blocks already fill the card, else split
    (in multiples of the 8 rows a block takes per step, at least 32) so
    that the launch reaches about `_TARGET_BLOCKS` blocks. (K5's entry
    point sizes its own slices by its occupancy.)"""
    base = samples * math.ceil(channels / _CHANNELS_PER_BLOCK)
    splits = max(1, min(math.ceil(_TARGET_BLOCKS / max(base, 1)),
                        rows // (4 * _ROWS_PER_STEP)))
    per = math.ceil(rows / splits)
    return max(_ROWS_PER_STEP,
               math.ceil(per / _ROWS_PER_STEP) * _ROWS_PER_STEP)


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
    """K3's function in plain torch: [N, R, C] -> [N, 2, C] f32."""
    xf = x3.to(torch.float32)
    return torch.stack([xf.sum(dim=1), (xf * xf).sum(dim=1)], dim=1)


def group_norm_stats(x3: torch.Tensor) -> torch.Tensor:
    """Per (sample, channel) sum and sum of squares of `x3` [N, R, C]
    (contiguous) as f32 [N, 2, C]: K3 for a CUDA tensor, the plain version
    for a CPU tensor."""
    _check_x3("x3", x3)
    if x3.device.type == "cpu":
        return group_norm_stats_plain(x3)
    _check_kernel_input("x3", x3)
    n, rows, c = x3.shape
    out = torch.zeros((n, 2, c), dtype=torch.float32, device=x3.device)
    with torch.cuda.device(x3.device):
        GROUPNORM_FWD_STATS.launch(
            x3.data_ptr(), n, rows, c, rows_per_block(n, rows, c),
            int(x3.dtype == torch.bfloat16), out.data_ptr(),
            torch.cuda.current_stream(x3.device).cuda_stream)
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
    if rows * c >= 2**31:
        raise ValueError(f"{rows} x {c} elements per sample exceed 2^31")
    out = torch.empty_like(x3)
    with torch.cuda.device(x3.device):
        GROUPNORM_FWD_APPLY.launch(
            x3.data_ptr(), sums.contiguous().data_ptr(),
            gamma.contiguous().data_ptr(), beta.contiguous().data_ptr(), n,
            rows, c, groups, eps, int(x3.dtype == torch.bfloat16), int(silu),
            out.data_ptr(), torch.cuda.current_stream(x3.device).cuda_stream)
    return out


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
    # the entry point zeroes `out` and picks its own row slices
    out = torch.empty((n, 2, c), dtype=torch.float32, device=x3.device)
    with torch.cuda.device(x3.device):
        GROUPNORM_BWD_STATS.launch(
            x3.data_ptr(), dz3.data_ptr(), fwd_sums.contiguous().data_ptr(),
            gamma.contiguous().data_ptr(), beta.contiguous().data_ptr(), n,
            rows, c, groups, eps, int(x3.dtype == torch.bfloat16), int(silu),
            out.data_ptr(), torch.cuda.current_stream(x3.device).cuda_stream)
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
        sums = group_norm_stats(x3)
        y = group_norm_apply(x3, sums, gamma, beta, groups, eps, silu)
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
