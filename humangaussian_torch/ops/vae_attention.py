"""The VAE mid block's attention, one head of width 512, with hand-written
kernels for its forward and for the logits pass of its backward.

`vae_attention(q, k, v)` is softmax(q k^T / sqrt(C)) v on [B, n, C]
tensors, the reference's `humangaussian_tpu/guidance/vae.py:85-87`
(float32 logits of the bf16 q and k, a float32 softmax, the probabilities
rounded to v's type before the PV product), differentiable in q, k and v.

Forward: csrc/vae_attention.cu's `hg_vae_attention_fwd`;
`vae_attention_fwd_plain` repeats its arithmetic in torch as the reference
the tests hold it to. The kernel never writes the logits: it
streams k and v in tiles of `KEY_TILE` keys with an online softmax, rounds
p to bf16 against the running row maximum (as K4 does), accumulates P V in
float32 and divides by the row sum at the end; it also returns the float32
log-sum-exp of each row for the backward.

Backward, from q, k, v, out, lse and dout: `hg_vae_attention_bwd` (its
reference `vae_attention_bwd_plain`) recomputes the logits, forms
P = exp(q k^T scale - lse), dP = dout v^T in float32, D = rowsum(dout *
out) and dS = P (dP - D) scale, and writes P and dS in bf16, over as many
batch entries at a time as `PROBS_CAP_BYTES` of them take (one at SDXL's
16,384 tokens, the whole batch at 4,096); then dq = dS k, dk = dS^T q and
dv = P^T dout are bf16 products with float32 accumulation. Every sum runs
in a fixed order: a backward repeats itself bit for bit.

The kernels take bfloat16, C = 512, n a multiple of 64 and contiguous
tensors on a CUDA device (`kernel_applies` is the gate
guidance/vae.py::AttnBlock routes on); anything else, CPU tensors
included, raises. The scale is 1 / sqrt(C).
"""
from __future__ import annotations

import math

import torch

from humangaussian_torch.kernels import VAE_ATTENTION_BWD, VAE_ATTENTION_FWD

WIDTH = 512  # the channels the kernels are built for
ROW_MULTIPLE = 64  # n must be a multiple of the kernels' 64-row blocks
KEY_TILE = 32  # keys a step of the forward's online softmax
PROBS_CAP_BYTES = 1 << 30  # the bf16 P and dS of one backward chunk
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def kernel_applies(q: torch.Tensor) -> bool:
    """Whether the kernels take this q: CUDA, bfloat16, [B, n, 512] with n a
    positive multiple of 64. Decided from device, dtype and shape alone."""
    return (q.is_cuda and q.dtype == torch.bfloat16 and q.dim() == 3
            and q.shape[-1] == WIDTH and q.shape[1] > 0
            and q.shape[1] % ROW_MULTIPLE == 0)


def backward_chunk(batch: int, n: int) -> int:
    """Batch entries a backward chunk holds: their bf16 P and dS within
    PROBS_CAP_BYTES, at least one."""
    return max(1, min(batch, PROBS_CAP_BYTES // (2 * 2 * n * n)))


def vae_attention_fwd_plain(q, k, v):
    """The forward kernel's arithmetic in torch, one batch entry at a time:
    float32 logits, an online softmax over tiles of KEY_TILE keys with p
    rounded to q's type against the running row maximum, float32 P V, the
    division by the row sum at the end. Returns (out, lse)."""
    c = q.shape[-1]
    scale_log2 = LOG2E / math.sqrt(c)
    outs, lses = [], []
    for qb, kb, vb in zip(q, k, v):
        s = qb.float() @ kb.float().T  # [n, n]
        n = s.shape[0]
        m = torch.full((n,), -math.inf, device=q.device)
        l = torch.zeros((n,), device=q.device)
        o = torch.zeros((n, c), device=q.device)
        for t0 in range(0, s.shape[1], KEY_TILE):
            st = s[:, t0:t0 + KEY_TILE]
            new = torch.maximum(m, st.amax(dim=1) * scale_log2)
            alpha = torch.exp2(m - new)
            p = torch.exp2(st * scale_log2 - new[:, None])
            l = l * alpha + p.sum(dim=1)
            o = o * alpha[:, None] + p.to(q.dtype).float() @ \
                vb[t0:t0 + KEY_TILE].float()
            m = new
        outs.append((o / l[:, None]).to(q.dtype))
        lses.append((m + torch.log2(l)) * LN2)
    return torch.stack(outs), torch.stack(lses)


def vae_attention_bwd_plain(q, k, v, out, lse, dout):
    """The backward's arithmetic in torch, one batch entry at a time:
    P = exp(q k^T scale - lse) and dP = dout v^T in float32, D =
    rowsum(dout * out), dS = P (dP - D) scale rounded to q's type, then
    dq = dS k, dk = dS^T q, dv = P^T dout with float32 sums. Returns
    (dq, dk, dv)."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    grads = ([], [], [])
    for qb, kb, vb, ob, lb, gb in zip(q, k, v, out, lse, dout):
        s = qb.float() @ kb.float().T
        p = torch.exp2(s * (scale * LOG2E) - lb[:, None] * LOG2E)
        dp = gb.float() @ vb.float().T
        d = (gb.float() * ob.float()).sum(dim=1)
        ds = (p * (dp - d[:, None]) * scale).to(dt).float()
        grads[0].append((ds @ kb.float()).to(dt))
        grads[1].append((ds.T @ qb.float()).to(dt))
        grads[2].append((p.to(dt).float().T @ gb.float()).to(dt))
    return tuple(torch.stack(g) for g in grads)


def _check_kernel_args(q, k, v):
    """What the kernels take, checked before the device."""
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"{name} is {x.dtype} on {x.device}, q is {q.dtype} on "
                f"{q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(
            f"the VAE attention kernel takes bfloat16, got {q.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"the VAE attention kernel takes q, k, v of one [B, n, C] shape, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, n, c = q.shape
    if c != WIDTH:
        raise ValueError(
            f"the VAE attention kernel is built for width {WIDTH}, got {c}")
    if n == 0 or n % ROW_MULTIPLE:
        raise ValueError(
            f"the VAE attention kernel needs n a multiple of {ROW_MULTIPLE}, "
            f"got {n}")
    if not 0 < b <= 65535:
        raise ValueError(f"the VAE attention kernel takes 1 to 65535 batch "
                         f"entries, got {b}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"the VAE attention kernel takes contiguous "
                             f"tensors; {name} has strides {x.stride()}")


def _launch_args(q):
    if q.device.type != "cuda":
        raise ValueError(f"no VAE attention kernel for device {q.device}")
    return (torch.cuda.current_stream(q.device).cuda_stream,
            1.0 / math.sqrt(q.shape[-1]))


def _forward(q, k, v):
    _check_kernel_args(q, k, v)
    stream, scale = _launch_args(q)
    b, n, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        VAE_ATTENTION_FWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), lse.data_ptr(), b, n, scale,
                                 stream)
    return out, lse


def _backward(q, k, v, out, lse, dout):
    dout = dout.contiguous()
    stream, scale = _launch_args(q)
    b, n, _ = q.shape
    chunk = backward_chunk(b, n)
    p = torch.empty((chunk, n, n), dtype=q.dtype, device=q.device)
    ds = torch.empty_like(p)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    with torch.cuda.device(q.device):
        for s in range(0, b, chunk):
            e = min(b, s + chunk)
            pc, dsc = p[:e - s], ds[:e - s]
            VAE_ATTENTION_BWD.launch(
                q[s].data_ptr(), k[s].data_ptr(), v[s].data_ptr(),
                out[s].data_ptr(), dout[s].data_ptr(), lse[s].data_ptr(),
                pc.data_ptr(), dsc.data_ptr(), e - s, n, scale, stream)
            torch.matmul(dsc, k[s:e], out=dq[s:e])
            torch.matmul(dsc.transpose(1, 2), q[s:e], out=dk[s:e])
            torch.matmul(pc.transpose(1, 2), dout[s:e], out=dv[s:e])
    return dq, dk, dv


class _VAEAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _forward(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        return _backward(*ctx.saved_tensors, g)


def vae_attention(q, k, v) -> torch.Tensor:
    """softmax(q k^T / sqrt(C)) v for q, k, v [B, n, C]; returns [B, n, C] in
    q's type, differentiable in q, k and v."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k and v must share one [B, n, C] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return _VAEAttention.apply(q, k, v)
