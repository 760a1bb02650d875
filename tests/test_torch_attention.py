"""ops/attention.py of the port against the JAX package's attention.

The same numpy q, k, v go through `humangaussian_tpu.ops.attention
.self_attention` (its Pallas kernel in interpret mode, as on any non-TPU
backend) and through the port, whose CPU path is the plain version of its
CUDA kernel. Tolerances are the JAX package's own for its kernel: float32
2e-5, bfloat16 2e-2; gradients 5e-4 of max-|grad|. The CUDA kernel's own
rounding (an online softmax over 128-key tiles) is emulated in torch here
and held to 2^-7 of max |out|, the limit the kernel meets against the
plain version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.ops import attention as port_attn
from humangaussian_tpu.ops import attention as jax_attn

torch.set_num_threads(1)
KERNEL_TILE = 128  # keys per tile of csrc/attention_fwd.cu
BF16_ULP_OF_PEAK = 2.0 ** -7


def _qkv(b, s, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("s,d", [(128, 64), (256, 64), (128, 16)])
def test_float32_matches_pallas_kernel(s, d):
    q, k, v = _qkv(2, s, 2, d)
    want = np.asarray(jax_attn.self_attention(*map(jnp.asarray, (q, k, v))))
    got = port_attn.self_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (2, s, 2, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("s", [128, 256])
def test_bfloat16_matches_pallas_kernel(s):
    q, k, v = _qkv(2, s, 2, 64, seed=1)
    want = jax_attn.self_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)))
    got = port_attn.self_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2)


def test_plain_rounds_p_before_the_pv_product():
    """The plain version repeats the kernel's arithmetic (p cast before PV,
    l from the f32 p), so in bfloat16 it is closer to the Pallas kernel
    than the normalize-then-cast oracle is to either; and both of the
    port's formulations agree with the JAX package's `_xla_attention`."""
    q, k, v = _qkv(2, 128, 2, 64, seed=2)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    scale = 0.125
    plain = port_attn.self_attention_plain(*tb, scale).float().numpy()
    oracle = port_attn.softmax_attention(*tb, scale).float().numpy()
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(4, 128, 64)  # noqa: E731
    jx = jax_attn._xla_attention(*map(fold, jb), scale)
    jx = np.asarray(jx.astype(jnp.float32)).reshape(2, 2, 128, 64)
    jx = jx.transpose(0, 2, 1, 3)
    pallas = np.asarray(
        jax_attn.self_attention(*jb).astype(jnp.float32))
    np.testing.assert_allclose(oracle, jx, atol=2e-2)
    np.testing.assert_allclose(plain, jx, atol=2e-2)
    assert np.abs(plain - pallas).max() <= np.abs(oracle - pallas).max()


@pytest.mark.parametrize("s,d", [(128, 64), (128, 16)])
def test_gradients_match_jax(s, d):
    """Both backwards recompute through the normalize-then-cast softmax:
    5e-4 of each gradient's max."""
    q, k, v = _qkv(1, s, 2, d, seed=3)
    cot = np.random.RandomState(4).randn(1, s, 2, d).astype(np.float32)
    jgrads = jax.grad(
        lambda a, b, c: jnp.sum(jax_attn.self_attention(a, b, c) * cot),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    (port_attn.self_attention(*ts) * torch.from_numpy(cot)).sum().backward()
    for name, t, want in zip("qkv", ts, jgrads):
        want = np.asarray(want)
        np.testing.assert_allclose(t.grad.numpy(), want,
                                   atol=5e-4 * np.abs(want).max(),
                                   err_msg=f"d{name}")


def test_explicit_scale_matches_pallas_kernel():
    q, k, v = _qkv(1, 128, 2, 64, seed=5)
    want = np.asarray(jax_attn.self_attention(
        *map(jnp.asarray, (q, k, v)), sm_scale=0.05))
    got = port_attn.self_attention(*map(torch.from_numpy, (q, k, v)),
                                   sm_scale=0.05)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_query_rows_past_the_last_full_block():
    """S = 384 (a 16 x 24 latent; the UNet's gate admits any multiple of
    128). The JAX kernel's grid has S // 256 query blocks of 256 rows, so
    rows 256-383 of its output are never written; the port computes every
    row and matches the JAX package's `_xla_attention` on all of them."""
    q, k, v = _qkv(1, 384, 2, 64, seed=7)

    def fold(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(2, 384, 64)

    want = np.asarray(jax_attn._xla_attention(fold(q), fold(k), fold(v),
                                              0.125))
    want = want.reshape(1, 2, 384, 64).transpose(0, 2, 1, 3)
    got = port_attn.self_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    jax_out = np.asarray(jax_attn.self_attention(*map(jnp.asarray,
                                                      (q, k, v))))
    np.testing.assert_allclose(jax_out[:, :256], want[:, :256], atol=2e-5)
    assert not np.allclose(jax_out[:, 256:], want[:, 256:], atol=2e-5)


def test_more_keys_than_queries():
    """k, v longer than q. The JAX kernel's K/V block is sized by the query
    length, so with M != S it attends to the first S keys only (no UNet
    site has M != S); the port attends to all M, as `_xla_attention`
    does, which is the oracle here."""
    rng = np.random.RandomState(6)
    q = rng.randn(1, 128, 2, 64).astype(np.float32)
    k = rng.randn(1, 256, 2, 64).astype(np.float32)
    v = rng.randn(1, 256, 2, 64).astype(np.float32)
    def fold(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(2, x.shape[1], 64)

    want = np.asarray(jax_attn._xla_attention(fold(q), fold(k), fold(v),
                                              0.125))
    want = want.reshape(1, 2, 128, 64).transpose(0, 2, 1, 3)
    got = port_attn.self_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    first = np.asarray(jax_attn.self_attention(
        jnp.asarray(q), jnp.asarray(k[:, :128]), jnp.asarray(v[:, :128])))
    np.testing.assert_allclose(
        np.asarray(jax_attn.self_attention(*map(jnp.asarray, (q, k, v)))),
        first, atol=2e-5)


def online_softmax_emulation(q, k, v, sm_scale, tile=KERNEL_TILE):
    """The arithmetic of the CUDA kernel, in torch: keys in tiles of
    `tile`, a running row maximum m, p = exp(logit - m) in f32 rounded to
    bfloat16 for the PV product, the accumulator and l rescaled by
    exp(m_old - m) in f32, l summed from the f32 p, out = acc / l."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * sm_scale
    b, h, s, m_keys = logits.shape
    m = torch.full((b, h, s, 1), -torch.inf)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, q.shape[-1]))
    for t0 in range(0, m_keys, tile):
        t = logits[..., t0:t0 + tile]
        m_new = torch.maximum(m, t.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(t - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhnm,bmhd->bhnd", p.to(q.dtype).float(),
            v[:, t0:t0 + tile].float())
        m = m_new
    return (acc / l).permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("sharpen", [1.0, 8.0])
def test_online_softmax_rounding_matches_pallas_and_plain(sharpen):
    """The kernel rounds p to bf16 relative to the running maximum, not the
    final one. Emulated at S = 512 (four key tiles, bf16, 2 heads), with
    ordinary logits and with q sharpened 8x (the maximum moves often), it
    stays within 2^-7 of max |out| of the JAX Pallas kernel (interpret
    mode) and of the plain version."""
    q, k, v = _qkv(1, 512, 2, 64, seed=7)
    q = q * sharpen
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    emulated = online_softmax_emulation(*tb, 0.125).float().numpy()
    plain = port_attn.self_attention_plain(*tb, 0.125).float().numpy()
    pallas = np.asarray(jax_attn.self_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    ).astype(jnp.float32))
    for name, want in (("pallas", pallas), ("plain", plain)):
        err = np.abs(emulated - want).max()
        assert err <= BF16_ULP_OF_PEAK * np.abs(want).max(), (name, err)
    # one tile covering every key is the plain version's arithmetic
    whole = online_softmax_emulation(*tb, 0.125, tile=512).float().numpy()
    np.testing.assert_allclose(whole, plain,
                               atol=BF16_ULP_OF_PEAK * np.abs(plain).max())


@pytest.mark.parametrize("bad", ["rank", "kv_shape", "dtype", "heads",
                                 "not_tensor", "length", "kernel_dtype",
                                 "kernel_scale"])
def test_wrapper_rejects_bad_arguments(bad):
    q, k, v = (torch.zeros(1, 128, 2, 64) for _ in range(3))
    if bad in ("length", "kernel_dtype", "kernel_scale"):
        # off the CPU the kernel's own limits apply before any launch: keys
        # in multiples of 128, bfloat16, a positive scale (the meta device
        # has no kernel, so a call that passed them would raise "no
        # attention kernel")
        q, k, v = (torch.zeros(1, 128, 2, 64, device="meta",
                               dtype=torch.bfloat16) for _ in range(3))
        if bad == "length":
            k, v = (torch.zeros(1, 192, 2, 64, device="meta",
                                dtype=torch.bfloat16) for _ in range(2))
            with pytest.raises(ValueError, match="multiples of 128"):
                port_attn.self_attention(q, k, v)
        elif bad == "kernel_scale":
            with pytest.raises(ValueError, match="sm_scale > 0"):
                port_attn.self_attention(q, k, v, sm_scale=-0.125)
        else:
            q, k, v = q.float(), k.float(), v.float()
            with pytest.raises(TypeError, match="bfloat16"):
                port_attn.self_attention(q, k, v)
        return
    if bad == "rank":
        q = q[0]
    elif bad == "kv_shape":
        v = v[:, :64]
    elif bad == "dtype":
        k = k.double()
    elif bad == "heads":
        k, v = k[:, :, :1], v[:, :, :1]
    elif bad == "not_tensor":
        q = q.numpy()
    with pytest.raises((TypeError, ValueError)):
        port_attn.self_attention(q, k, v)
