"""Self-attention over the diffusion UNet's image tokens, with a
hand-written forward kernel.

Port of humangaussian_tpu/ops/attention.py. `self_attention(q, k, v)` is
non-causal multi-head attention on `[B, S, H, D]` (the reference's layout):

  logits = (q k^T) * sm_scale        f32
  p      = exp(logits - rowmax)      f32, cast to the input dtype BEFORE
                                     the PV product
  l      = rowsum(p)                 from the f32 p
  out    = (p v) / l                 f32 accumulation, cast to the input dtype

Forward: kernel K4 (csrc/attention_fwd.cu) for CUDA tensors,
`self_attention_plain`, which repeats that arithmetic in torch, for CPU
tensors; nothing else decides. The kernel takes bfloat16, D = 64 and
sequence lengths that are multiples of 128 (every self-attention site of
the UNet that passes the `n % 128 == 0` gate); anything else on a CUDA
tensor raises. It makes one pass over K/V with an online softmax, so it
rounds p to bfloat16 relative to the running row maximum where the plain
version uses the final one: one bf16 rounding of each p either way.
Backward: recomputed through `softmax_attention`, the ordinary
normalize-then-cast formulation, as the reference's VJP recomputes through
its XLA einsums.

Dropped from the reference: the `[B*H, S, D]` fold (the kernel's TMA
tensor maps read the `[B, S, H, D]` strides directly), the `[block_q, S]`
logits tile and the whole-head K/V blocks in VMEM (the CUDA kernel streams
128-key tiles; see the source).
"""
from __future__ import annotations

import math

import torch

from humangaussian_torch.kernels import ATTENTION_FWD

KERNEL_HEAD_DIM = 64
KERNEL_SEQ_MULTIPLE = 128


def _check_qkv(q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if x.dim() != 4:
            raise ValueError(
                f"{name} must be [B, S, H, D], got {tuple(x.shape)}")
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"{name} is {x.dtype} on {x.device}, q is {q.dtype} on "
                f"{q.device}")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or tuple(k.shape[2:]) != (h, d):
        raise ValueError(
            f"k and v must both be [{b}, M, {h}, {d}], got "
            f"{tuple(k.shape)} and {tuple(v.shape)}")


def self_attention_plain(q, k, v, sm_scale: float) -> torch.Tensor:
    """K4's function in plain torch, one batch entry at a time (the f32
    logits of a whole batch at S = 4096 would take gigabytes)."""
    outs = []
    for qb, kb, vb in zip(q, k, v):  # [S, H, D]
        logits = torch.einsum("nhd,mhd->hnm", qb.float(), kb.float())
        logits = logits * sm_scale
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1)  # [H, S]
        out = torch.einsum("hnm,mhd->nhd", p.to(q.dtype).float(), vb.float())
        outs.append((out / l.t()[:, :, None]).to(q.dtype))
    return torch.stack(outs)


def softmax_attention(q, k, v, sm_scale: float) -> torch.Tensor:
    """The ordinary formulation (f32 logits, softmax normalized before the
    cast, PV product accumulated in f32): the second oracle of the tests
    and the function the backward differentiates."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * sm_scale
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float()).to(q.dtype)


def _check_kernel_args(q, k, sm_scale):
    """What K4 takes; checked for every device but the CPU."""
    b, s, h, d = q.shape
    m = k.shape[1]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernel takes bfloat16, got {q.dtype}")
    if d != KERNEL_HEAD_DIM:
        raise ValueError(
            f"the attention kernel is built for head dim {KERNEL_HEAD_DIM}, "
            f"got {d}")
    if s % KERNEL_SEQ_MULTIPLE or m % KERNEL_SEQ_MULTIPLE or m == 0:
        raise ValueError(
            f"the attention kernel needs sequence lengths that are multiples "
            f"of {KERNEL_SEQ_MULTIPLE}, got {s} queries and {m} keys")
    if b * h > 65535:
        raise ValueError(f"batch x heads = {b * h} exceeds the grid's 65535")
    if not sm_scale > 0:
        raise ValueError(f"the attention kernel takes sm_scale > 0, got "
                         f"{sm_scale}")


def _attention_forward(q, k, v, sm_scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return self_attention_plain(q, k, v, sm_scale)
    _check_kernel_args(q, k, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    b, s, h, _ = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the attention kernel needs 16-byte aligned q, k, v")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        ATTENTION_FWD.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            k.shape[1], h, sm_scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    return out


class _SelfAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        ctx.save_for_backward(q, k, v)
        ctx.sm_scale = sm_scale
        return _attention_forward(q, k, v, sm_scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (x.detach().requires_grad_(True)
                   for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = softmax_attention(q, k, v, ctx.sm_scale)
        return (*torch.autograd.grad(out, (q, k, v), g), None)


def self_attention(q, k, v, sm_scale: float | None = None) -> torch.Tensor:
    """Non-causal multi-head attention, `[B, S, H, D]` layout.

    q [B, S, H, D]; k, v [B, M, H, D] (every UNet site has M == S).
    Returns [B, S, H, D] in q's dtype, differentiable in q, k and v."""
    _check_qkv(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _SelfAttention.apply(q, k, v, float(sm_scale))
