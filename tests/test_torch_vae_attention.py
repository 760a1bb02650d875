"""The VAE mid block's fused attention (ops/vae_attention.py) on the CPU:
the wrapper's checks, the gate `AttnBlock` routes on, and the plain
versions of the kernels' arithmetic against the reference formulation
(`guidance/vae.py::attend`). The kernels themselves run in
tests/test_torch_kernels.py on a card."""
import math
import types

import pytest
import torch

from humangaussian_torch import kernels
from humangaussian_torch.guidance import vae as port_vae
from humangaussian_torch.ops import vae_attention

torch.set_num_threads(1)


def _qkv(b, n, c, dtype=torch.float32, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn((b, n, c), generator=gen).to(device, dtype)
                 for _ in range(3))


@pytest.mark.parametrize("bad", ["float32", "width", "length", "strided",
                                 "shapes", "device", "cpu"])
def test_wrapper_rejects_what_the_kernels_do_not_take(bad):
    """The wrapper launches the kernels or raises, and it checks the
    arguments before the device: neither the meta device nor the CPU has a
    kernel, and neither falls back to the plain versions."""
    q, k, v = (torch.empty((2, 128, 512), device="meta",
                           dtype=torch.bfloat16) for _ in range(3))
    err, match = ValueError, "VAE attention kernel"
    if bad == "float32":
        q, k, v, err = q.float(), k.float(), v.float(), TypeError
    elif bad == "width":
        q, k, v = (torch.empty((2, 128, 256), device="meta",
                               dtype=torch.bfloat16) for _ in range(3))
        match = "width 512"
    elif bad == "length":
        q, k, v = (torch.empty((2, 96, 512), device="meta",
                               dtype=torch.bfloat16) for _ in range(3))
        match = "multiple of 64"
    elif bad == "strided":
        q = torch.empty((2, 128, 1024), device="meta",
                        dtype=torch.bfloat16)[..., ::2]
        match = "contiguous"
    elif bad == "shapes":
        k = k[:, :64]
        match = "one \\[B, n, C\\] shape"
    elif bad == "device":
        match = "no VAE attention kernel for device meta"
    else:
        q, k, v = (torch.zeros((2, 128, 512), dtype=torch.bfloat16)
                   for _ in range(3))
        match = "no VAE attention kernel for device cpu"
    kernels.reset_launch_counts()
    with pytest.raises(err, match=match):
        vae_attention.vae_attention(q, k, v)
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("case,applies", [
    ("card", True), ("cpu", False), ("float32", False), ("width", False),
    ("length", False), ("empty", False), ("rank", False)])
def test_gate_reads_device_dtype_and_shape(case, applies):
    """The kernels take a CUDA bf16 [B, n, 512] q with n a positive multiple
    of 64; nothing but device, dtype and shape decides."""
    shape, dtype, cuda = (8, 4096, 512), torch.bfloat16, True
    if case == "cpu":
        cuda = False
    elif case == "float32":
        dtype = torch.float32
    elif case == "width":
        shape = (8, 4096, 64)
    elif case == "length":
        shape = (8, 4032 + 32, 512)
    elif case == "empty":
        shape = (8, 0, 512)
    elif case == "rank":
        shape = (8, 4096, 1, 512)
    q = types.SimpleNamespace(is_cuda=cuda, dtype=dtype, shape=shape,
                              dim=lambda: len(shape))
    assert vae_attention.kernel_applies(q) is applies


@pytest.mark.parametrize("routed", [False, True])
def test_attn_block_routes_by_the_gate(routed, monkeypatch):
    """`AttnBlock` sends q, k, v to the fused op where the gate says so and
    to `attend` / `chunked_attention` elsewhere, with the same parameters
    and the same function: bf16 in, bf16 out. On the CPU the gate is
    closed; opened (as on a card), with the kernels' entry points swapped
    for their plain versions, the op matches the reference path within
    bf16 rounding, output and input gradient."""
    torch.manual_seed(0)
    blk = port_vae.AttnBlock(512, 32).to(torch.bfloat16).requires_grad_(False)
    x0 = torch.randn((2, 512, 8, 8)).to(torch.bfloat16)
    cot = torch.randn((2, 512, 8, 8)).to(torch.bfloat16)
    calls = []
    own_fused, own_attend = vae_attention.vae_attention, port_vae.attend

    def fused(q, k, v):
        calls.append(("fused", q.dtype, tuple(q.shape)))
        return own_fused(q, k, v)

    def attend(q, k, v):
        calls.append(("attend", q.dtype, tuple(q.shape)))
        return own_attend(q, k, v)

    def run():
        x = x0.clone().requires_grad_(True)
        y = blk(x)
        (y.float() * cot.float()).sum().backward()
        return y.detach(), x.grad

    monkeypatch.setattr(port_vae, "attend", attend)
    want = run()
    assert calls == [("attend", torch.bfloat16, (2, 64, 512))]
    if routed:
        calls.clear()
        monkeypatch.setattr(vae_attention, "vae_attention", fused)
        monkeypatch.setattr(vae_attention, "kernel_applies",
                            lambda q: q.dtype == torch.bfloat16)
        monkeypatch.setattr(vae_attention, "_forward",
                            vae_attention.vae_attention_fwd_plain)
        monkeypatch.setattr(vae_attention, "_backward",
                            vae_attention.vae_attention_bwd_plain)
        got = run()
        assert calls == [("fused", torch.bfloat16, (2, 64, 512))]
        assert got[0].dtype == torch.bfloat16
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                       atol=2e-2 * float(b.abs().max()))


def test_attn_block_float32_never_reaches_the_kernels(monkeypatch):
    """The float32 tiny VAE (C = 32) takes the reference path, chunked past
    the logits cap as before."""
    calls = []
    own = port_vae.chunked_attention

    def spy(q, k, v, rows):
        calls.append(rows)
        return own(q, k, v, rows)

    def fused(q, k, v):
        raise AssertionError("the fused op ran")

    monkeypatch.setattr(port_vae, "chunked_attention", spy)
    monkeypatch.setattr(vae_attention, "vae_attention", fused)
    monkeypatch.setattr(port_vae, "ATTN_CAP_BYTES", 2 * 64 * 4 * 16)
    blk = port_vae.AttnBlock(32, 8)
    with torch.no_grad():
        blk(torch.randn((2, 32, 8, 8)))
    assert calls == [16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c", [(2, 96, 64), (1, 128, 512), (2, 80, 48)])
def test_plain_forward_matches_attend(dtype, b, n, c):
    """The forward kernel's arithmetic (online softmax over key tiles, p
    rounded against the running maximum, normalised after PV) against the
    reference's one-pass softmax: float32 to round-off, bf16 within one
    ulp of the largest output; its lse is the logits' logsumexp."""
    q, k, v = _qkv(b, n, c, dtype, seed=n + c)
    out, lse = vae_attention.vae_attention_fwd_plain(q, k, v)
    want = port_vae.attend(q, k, v)
    assert out.dtype == dtype and out.shape == (b, n, c)
    logits = q.float() @ k.float().transpose(1, 2) / math.sqrt(c)
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), rtol=0,
                               atol=1e-5)
    err = float((out.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    assert err <= (1e-6 if dtype == torch.float32 else 2.0 ** -7) * top


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_matches_attend_gradients(dtype):
    """The backward's arithmetic (P from lse, float32 dP, D from out, dS
    rounded once to q's type) against autograd through `attend`: float32
    to round-off, bf16 within 2% of each gradient's largest entry."""
    b, n, c = 2, 96, 64
    q, k, v = _qkv(b, n, c, dtype, seed=5)
    g = torch.randn((b, n, c), generator=torch.Generator().manual_seed(6)) \
        .to(dtype)
    out, lse = vae_attention.vae_attention_fwd_plain(q, k, v)
    got = vae_attention.vae_attention_bwd_plain(q, k, v, out, lse, g)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    port_vae.attend(*xs).backward(g)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, x in zip(got, xs):
        assert a.dtype == dtype
        err = float((a.float() - x.grad.float()).abs().max())
        assert err <= tol * float(x.grad.float().abs().max())


def test_op_autograd_over_the_plain_versions_matches_attend(monkeypatch):
    """The autograd function with the kernels' entry points swapped for
    their plain versions (as chip_smoke.py's plain run swaps them): no
    launch, and the output and the three gradients equal those of `attend`
    in float32 to round-off. Saved tensors and gradients reach the right
    arguments."""
    monkeypatch.setattr(vae_attention, "_forward",
                        vae_attention.vae_attention_fwd_plain)
    monkeypatch.setattr(vae_attention, "_backward",
                        vae_attention.vae_attention_bwd_plain)
    q, k, v = _qkv(2, 64, 32, seed=9)
    g = torch.randn((2, 64, 32), generator=torch.Generator().manual_seed(3))
    kernels.reset_launch_counts()
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = vae_attention.vae_attention(*xs)
    out.backward(g)
    rs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = port_vae.attend(*rs)
    ref.backward(g)
    assert set(kernels.launch_counts().values()) == {0}
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    for a, r in zip(xs, rs):
        torch.testing.assert_close(a.grad, r.grad, rtol=1e-5, atol=1e-6)


def test_backward_chunks_hold_the_probabilities_under_the_cap():
    """bf16 P and dS of a backward chunk within 1 GiB: one batch entry at
    SDXL's 16,384 tokens, the whole batch of 8 at SD2's 4,096."""
    assert vae_attention.backward_chunk(8, 16384) == 1
    assert vae_attention.backward_chunk(8, 4096) == 8
    assert vae_attention.backward_chunk(24, 4096) == 16
    assert vae_attention.backward_chunk(1, 65536) == 1
    for b, n in ((8, 16384), (8, 4096), (24, 4096)):
        chunk = vae_attention.backward_chunk(b, n)
        assert 2 * 2 * chunk * n * n <= vae_attention.PROBS_CAP_BYTES


def test_kernels_are_registered_from_one_source():
    """Both entry points live in csrc/vae_attention.cu and count their
    launches in the registry."""
    for kernel in (kernels.VAE_ATTENTION_FWD, kernels.VAE_ATTENTION_BWD):
        assert kernel in kernels.KERNELS
        assert kernel.source.name == "vae_attention.cu"
        assert kernel.source.exists()
    counts = kernels.launch_counts()
    assert "vae_attention_fwd" in counts and "vae_attention_bwd" in counts
