"""ops/groupnorm.py of the port against the JAX package's fused GroupNorm.

The same numpy inputs go through `humangaussian_tpu.ops.groupnorm` (its
Pallas statistics kernels in interpret mode) and through the port, whose
CPU path is the plain version of its CUDA kernels. Tolerances: float32
2e-5 absolute (the JAX package's own tests hold its op to that against
flax), bfloat16 activations 0.05 (one bf16 rounding of values up to a few
units, at another place in the two frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.ops import groupnorm as port_gn
from humangaussian_tpu.ops import groupnorm as jax_gn

torch.set_num_threads(1)

F32_TOL = 2e-5
BF16_TOL = 0.05


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 1.5 + 0.7).astype(np.float32)
    scale = (1 + 0.2 * rng.randn(c)).astype(np.float32)
    bias = (0.2 * rng.randn(c)).astype(np.float32)
    cot = rng.randn(*shape).astype(np.float32)
    return x, scale, bias, cot


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setattr(jax_gn, "FORCE_PALLAS_INTERPRET", True)


@pytest.mark.parametrize("shape", [(2, 16, 16, 32), (3, 8, 4, 16)])
def test_stats_match_pallas_kernel(pallas, shape):
    """K3's plain version against `_fwd_stats` (interpret): 2e-5 of the
    largest sum."""
    x, *_ = _inputs(shape)
    n, c = shape[0], shape[-1]
    x3 = x.reshape(n, -1, c)
    br = jax_gn._pick_block_rows(x3.shape[1], c)
    assert br > 0
    want = np.asarray(jax_gn._fwd_stats(jnp.asarray(x3), br))
    got = port_gn.group_norm_stats(torch.from_numpy(x3)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL * np.abs(want).max())


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape,groups", [
    ((2, 16, 16, 32), 8),  # Pallas statistics on the JAX side
    ((2, 5, 7, 24), 4),  # 35 rows: odd, the JAX side's pure-XLA route
])
def test_forward_and_gradients_match_jax(pallas, shape, groups, silu):
    x, scale, bias, cot = _inputs(shape, seed=1)

    def jloss(x_, s_, b_):
        y = jax_gn.group_norm_act(x_, s_, b_, groups, 1e-5, silu)
        return jnp.sum(y * cot), y

    (_, jy), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))

    tx, ts, tb = (torch.tensor(a, requires_grad=True)
                  for a in (x, scale, bias))
    ty = port_gn.group_norm_act(tx, ts, tb, groups, 1e-5, silu)
    (ty * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=F32_TOL)
    for name, got, want in zip(("dx", "dscale", "dbias"),
                               (tx.grad, ts.grad, tb.grad), jgrads):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, atol=F32_TOL * max(1.0, np.abs(want).max()),
            err_msg=name)


@pytest.mark.parametrize("silu", [True, False])
def test_bfloat16_activations_match_jax(pallas, silu):
    """bf16 in, f32 statistics, bf16 out on both sides: 0.05 absolute on
    the output and on dx."""
    shape, groups = (2, 16, 16, 32), 8
    x, scale, bias, cot = _inputs(shape, seed=2)
    xb = jnp.asarray(x).astype(jnp.bfloat16)

    def jloss(x_):
        y = jax_gn.group_norm_act(x_, jnp.asarray(scale), jnp.asarray(bias),
                                  groups, 1e-5, silu)
        return jnp.sum(y.astype(jnp.float32) * cot), y

    (_, jy), jdx = jax.value_and_grad(jloss, has_aux=True)(xb)
    tx = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    ty = port_gn.group_norm_act(tx, torch.tensor(scale), torch.tensor(bias),
                                groups, 1e-5, silu)
    assert ty.dtype == torch.bfloat16
    (ty.float() * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(
        ty.detach().float().numpy(), np.asarray(jy.astype(jnp.float32)),
        atol=BF16_TOL)
    np.testing.assert_allclose(
        tx.grad.float().numpy(), np.asarray(jdx.astype(jnp.float32)),
        atol=BF16_TOL)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("rows", [(16, 16), (5, 7)])
def test_module_matches_library_groupnorm(rows, silu):
    """Second oracle: GroupNormAct on a channels-first activation against
    nn.GroupNorm (+ SiLU), output and the three gradients, 2e-5."""
    rng = np.random.RandomState(3)
    c, groups = 24, 4
    x = (rng.randn(2, c, *rows) * 1.5 + 0.7).astype(np.float32)
    cot = torch.tensor(rng.randn(2, c, *rows).astype(np.float32))
    ours = port_gn.GroupNormAct(groups, c, eps=1e-5, silu=silu)
    ref = torch.nn.GroupNorm(groups, c, eps=1e-5)
    with torch.no_grad():
        ours.weight.copy_(torch.tensor(1 + 0.2 * rng.randn(c)))
        ours.bias.copy_(torch.tensor(0.2 * rng.randn(c)))
    ref.load_state_dict(ours.state_dict())

    grads = []
    outs = []
    for module, act in ((ours, False), (ref, silu)):
        xt = torch.tensor(x, requires_grad=True)
        y = module(xt)
        if act:
            y = torch.nn.functional.silu(y)
        (y * cot).sum().backward()
        outs.append(y.detach().numpy())
        grads.append((xt.grad, module.weight.grad, module.bias.grad))
    np.testing.assert_allclose(outs[0], outs[1], atol=F32_TOL)
    for name, a, b in zip(("dx", "dweight", "dbias"), *grads):
        np.testing.assert_allclose(
            a.numpy(), b.numpy(),
            atol=F32_TOL * max(1.0, float(b.abs().max())), err_msg=name)


def test_backward_stats_plain_matches_pallas_kernel(pallas):
    """K5's plain version against `_bwd_stats` (interpret)."""
    shape, groups = (2, 16, 16, 32), 8
    x, scale, bias, dz = _inputs(shape, seed=4)
    n, c = shape[0], shape[-1]
    x3, dz3 = x.reshape(n, -1, c), dz.reshape(n, -1, c)
    sums = port_gn.group_norm_stats_plain(torch.from_numpy(x3))
    mu_c, rstd_c = port_gn.group_stats(sums, x3.shape[1], groups, 1e-5)
    for silu in (True, False):
        want = np.asarray(jax_gn._bwd_stats(
            jnp.asarray(x3), jnp.asarray(dz3),
            jnp.asarray(mu_c.numpy())[:, None, :],
            jnp.asarray(rstd_c.numpy())[:, None, :],
            jnp.stack([jnp.asarray(scale), jnp.asarray(bias)])[None],
            jax_gn._pick_block_rows(x3.shape[1], c), silu))
        got = port_gn.group_norm_bwd_stats(
            torch.from_numpy(x3), torch.from_numpy(dz3), sums,
            torch.from_numpy(scale), torch.from_numpy(bias), groups, 1e-5,
            silu).numpy()
        np.testing.assert_allclose(got, want,
                                   atol=F32_TOL * np.abs(want).max())


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_dx_plain_matches_jax_backward(pallas, dtype, silu):
    """K5a's plain version, fed K3's and K5's plain sums, is the dx of the
    JAX `_gn_bwd` (its Pallas backward statistics in interpret mode):
    float32 2e-5 of max |dx|, bfloat16 activations 0.05."""
    shape, groups = (2, 16, 16, 32), 8
    x, scale, bias, dz = _inputs(shape, seed=6)
    n, c = shape[0], shape[-1]
    jdt = jnp.dtype(dtype)
    jx, jdz = jnp.asarray(x).astype(jdt), jnp.asarray(dz).astype(jdt)
    _, res = jax_gn._gn_fwd(jx, jnp.asarray(scale), jnp.asarray(bias),
                            groups, 1e-5, silu)
    want, _, _ = jax_gn._gn_bwd(groups, 1e-5, silu, res, jdz)
    want = np.asarray(want.astype(jnp.float32)).reshape(n, -1, c)

    tdt = getattr(torch, dtype)
    x3 = torch.from_numpy(x).to(tdt).reshape(n, -1, c)
    dz3 = torch.from_numpy(dz).to(tdt).reshape(n, -1, c)
    gamma, beta = torch.from_numpy(scale), torch.from_numpy(bias)
    fwd = port_gn.group_norm_stats_plain(x3)
    sums = port_gn.group_norm_bwd_stats_plain(x3, dz3, fwd, gamma, beta,
                                              groups, 1e-5, silu)
    got = port_gn.group_norm_bwd_dx_plain(x3, dz3, fwd, gamma, beta, sums,
                                          groups, 1e-5, silu)
    assert got.dtype == tdt and got.shape == x3.shape
    atol = F32_TOL * max(1.0, np.abs(want).max()) if dtype == "float32" \
        else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol)
    # the wrapper's CPU path is the plain version
    assert torch.equal(port_gn.group_norm_bwd_dx(
        x3, dz3, fwd, gamma, beta, sums, groups, 1e-5, silu), got)


@pytest.mark.parametrize("silu", [True, False])
def test_backward_with_frozen_parameters_gives_dx_alone(silu):
    """With scale and bias frozen (the VAE's and the UNet's), the backward
    computes no dscale / dbias and gives the same dx as with them."""
    shape, groups = (2, 8, 8, 16), 4
    x, scale, bias, cot = _inputs(shape, seed=7)
    cot = torch.from_numpy(cot)
    dxs = []
    for trainable in (True, False):
        tx = torch.tensor(x, requires_grad=True)
        ts, tb = (torch.tensor(a, requires_grad=trainable)
                  for a in (scale, bias))
        y = port_gn.group_norm_act(tx, ts, tb, groups, 1e-5, silu)
        (y * cot).sum().backward()
        assert (ts.grad is None) == (not trainable)
        assert (tb.grad is None) == (not trainable)
        dxs.append(tx.grad)
    assert torch.equal(dxs[0], dxs[1])


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,groups", [((2, 16, 16, 32), 8),
                                          ((2, 5, 7, 24), 4)])
def test_apply_plain_matches_jax_forward(pallas, shape, groups, dtype,
                                         silu):
    """K3a's plain version on K3's plain sums is the whole forward of the
    JAX `group_norm_act` (its Pallas statistics in interpret mode where
    the rows allow): float32 2e-5, bfloat16 activations 0.05."""
    x, scale, bias, _ = _inputs(shape, seed=5)
    n, c = shape[0], shape[-1]
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    want = np.asarray(jax_gn.group_norm_act(
        jx, jnp.asarray(scale), jnp.asarray(bias), groups, 1e-5,
        silu).astype(jnp.float32))
    x3 = torch.from_numpy(x).to(getattr(torch, dtype)).reshape(n, -1, c)
    sums = port_gn.group_norm_stats_plain(x3)
    got = port_gn.group_norm_apply_plain(
        x3, sums, torch.from_numpy(scale), torch.from_numpy(bias), groups,
        1e-5, silu)
    assert got.dtype == x3.dtype and got.shape == x3.shape
    np.testing.assert_allclose(got.float().numpy().reshape(shape), want,
                               atol=F32_TOL if dtype == "float32"
                               else BF16_TOL)
    # the wrapper's CPU path is the plain version
    assert torch.equal(port_gn.group_norm_apply(
        x3, sums, torch.from_numpy(scale), torch.from_numpy(bias), groups,
        1e-5, silu), got)


@pytest.mark.parametrize("n,rows,c,want_blocks", [
    (24, 4096, 320, 1080),  # 5 channel blocks x 24 samples x 9 row slices
    (24, 64, 2560, 1920),
    (2, 37, 48, 2),
    (1, 7, 3, 1),
])
def test_rows_per_block_fills_the_card(n, rows, c, want_blocks):
    per = port_gn.rows_per_block(n, rows, c)
    assert per % 8 == 0 and per >= 8
    slices = -(-rows // per)
    assert n * -(-c // 64) * slices == want_blocks
    assert (slices - 1) * per < rows  # no empty slice


@pytest.mark.parametrize("bad", ["groups", "scale", "ndim", "rank3",
                                 "noncontig", "dz", "mu", "apply_sums",
                                 "apply_groups", "apply_gamma", "dx_sums",
                                 "dx_groups", "dx_dz"])
def test_wrappers_reject_bad_arguments(bad):
    x = torch.zeros(2, 4, 4, 8)
    scale, bias = torch.ones(8), torch.zeros(8)
    x3 = torch.zeros(2, 16, 8)
    sums = torch.zeros(2, 2, 8)
    with pytest.raises((TypeError, ValueError)):
        if bad == "groups":
            port_gn.group_norm_act(x, scale, bias, 3, 1e-5, True)
        elif bad == "scale":
            port_gn.group_norm_act(x, torch.ones(4), bias, 4, 1e-5, True)
        elif bad == "ndim":
            port_gn.group_norm_act(torch.zeros(8), scale, bias, 4, 1e-5,
                                   True)
        elif bad == "rank3":
            port_gn.group_norm_stats(x)
        elif bad == "noncontig":
            port_gn.group_norm_stats(x3.transpose(1, 2))
        elif bad == "dz":
            port_gn.group_norm_bwd_stats(x3, x3[:, :8].contiguous(), sums,
                                         scale, bias, 4, 1e-5, True)
        elif bad == "mu":  # the forward statistics the backward reads
            port_gn.group_norm_bwd_stats(x3, x3, sums[:1], scale, bias, 4,
                                         1e-5, True)
        elif bad == "apply_sums":
            port_gn.group_norm_apply(x3, torch.zeros(2, 8), scale, bias, 4,
                                     1e-5, True)
        elif bad == "apply_groups":
            port_gn.group_norm_apply(x3, torch.zeros(2, 2, 8), scale, bias,
                                     3, 1e-5, True)
        elif bad == "apply_gamma":
            port_gn.group_norm_apply(x3, torch.zeros(2, 2, 8), scale.double(),
                                     bias, 4, 1e-5, True)
        elif bad == "dx_sums":
            port_gn.group_norm_bwd_dx(x3, x3, sums, scale, bias,
                                      torch.zeros(2, 8), 4, 1e-5, True)
        elif bad == "dx_groups":
            port_gn.group_norm_bwd_dx(x3, x3, sums, scale, bias, sums, 3,
                                      1e-5, True)
        elif bad == "dx_dz":
            port_gn.group_norm_bwd_dx(x3, x3.double(), sums, scale, bias,
                                      sums, 4, 1e-5, True)
