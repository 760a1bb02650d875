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
    """The sums' (K3's) plain version against `_fwd_stats` (interpret): 2e-5 of the
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


H100_SMS = 132  # streaming multiprocessors of the H100 SXM
# (samples, rows, channels, itemsize): the UNet's and the VAE's main-path
# shapes, the IF UNet's, the tiny configs', an odd one and the GAN
# renderer's norms (float32)
LAUNCH_SHAPES = [
    (2, 37, 48, 4), (24, 4096, 320, 2), (24, 4096, 960, 2), (24, 64, 2560, 2),
    (8, 262144, 128, 2), (8, 65536, 128, 2), (8, 65536, 256, 2),
    (8, 16384, 256, 2), (8, 16384, 512, 2), (8, 4096, 512, 2),
    (16, 4096, 704, 2), (16, 4096, 2112, 2), (16, 64, 5632, 2), (1, 7, 3, 4),
    (1, 4096, 576, 4), (1, 65536, 16, 4),
]


@pytest.mark.parametrize("n,rows,c,itemsize", LAUNCH_SHAPES)
@pytest.mark.parametrize("sms", [H100_SMS, 8])
def test_fwd_launch_covers_each_element_once(n, rows, c, itemsize, sms):
    """The forward kernel's launch numbers (`_fwd_launch`): channel blocks
    of a width the kernel takes (a power of two below 32 vectors, else 32
    to 64, the busiest such width) cover every channel once; row splits
    cover every row once, none empty; the splits keep the persistent
    blocks 95% busy or are the busiest allowed; the blocks are at most
    three an SM and no more than the tiles; the scratch sizes are what the
    kernel checks."""
    how = port_gn._fwd_launch(sms, n, rows, c, itemsize, True)
    vec = 16 // itemsize
    assert how.vector == (c % vec == 0)
    vectors = c // vec if how.vector else c
    nbc, cbv, deep = port_gn.fwd_block_vectors(vectors)
    assert cbv == how.block_vectors and deep == 256 // cbv
    assert 1 <= cbv <= 64 and (cbv >= 32 or cbv & (cbv - 1) == 0)
    cover = np.zeros(vectors, np.int64)
    for cb in range(nbc):
        cover[cb * cbv:(cb + 1) * cbv] += 1
    assert (cover == 1).all() and (nbc - 1) * cbv < vectors
    if vectors >= 32:  # no width of 32 to 64 leaves fewer threads idle
        busy = vectors * deep / (nbc * 256)
        assert all(vectors * (256 // w) / (-(-vectors // w) * 256)
                   <= busy + 1e-9 for w in range(32, min(64, vectors) + 1))
    else:  # the narrowest power of two that holds C
        assert cbv >= vectors and (cbv == 1 or cbv // 2 < vectors)
    splits, per = how.splits, -(-rows // how.splits)
    assert 1 <= splits <= rows and (splits - 1) * per < rows
    tiles = n * nbc * splits
    target = 3 * sms
    assert how.blocks == min(target, tiles)

    def busy(s):
        t = n * nbc * s
        return t / (target * -(-t // target))

    most = max(1, min(4 * target // (n * nbc), rows // (deep * 8)))
    assert splits <= most
    assert busy(splits) >= 0.95 or all(
        busy(s) <= busy(splits) + 1e-9 for s in range(1, most + 1)
        if (s - 1) * -(-rows // s) < rows)
    assert how.sync_words == 1 + how.blocks + tiles
    assert how.partial_floats == n * splits * 2 * c
    # a pointer off 16 bytes takes the scalar tiles
    assert not port_gn._fwd_launch(sms, n, rows, c, itemsize, False).vector


def _kernel_order_sums(x3, sms):
    """The forward kernel's sums of a float32 `x3` in plain torch, in the
    order of its float32 additions at `_fwd_launch`'s numbers: each thread
    adds its rows of a split one after another (every `deep`-th row), the
    threads of a block meet (a warp's lanes by an xor butterfly where a
    block is at most 32 vectors wide, then slot by slot), and every tile
    adds the splits in order."""
    n, rows, c = x3.shape
    how = port_gn._fwd_launch(sms, n, rows, c, 4, True)
    _, cbv, deep = port_gn.fwd_block_vectors(c // 4 if how.vector else c)
    per = -(-rows // how.splits)
    both = torch.stack([x3, x3 * x3], 1)  # [n, 2, rows, c]
    out = torch.zeros((n, 2, c), dtype=torch.float32)
    for s in range(how.splits):
        part = both[:, :, s * per:(s + 1) * per]
        part = torch.nn.functional.pad(part, (0, 0, 0, -part.shape[2] % deep))
        lanes = part.reshape(n, 2, -1, deep, c)
        acc = torch.zeros((n, 2, deep, c), dtype=torch.float32)
        for k in range(lanes.shape[2]):
            acc = acc + lanes[:, :, k]
        if cbv <= 32:  # 8 warps of 32 / cbv row lanes each
            r = 32 // cbv
            w = acc.reshape(n, 2, 8, r, c)
            k = 1
            while k < r:
                w = w + w[:, :, :, torch.arange(r) ^ k]
                k *= 2
            acc = w[:, :, :, 0]
        tile = torch.zeros((n, 2, c), dtype=torch.float32)
        for y in range(acc.shape[2]):
            tile = tile + acc[:, :, y]
        out = out + tile
    return out


@pytest.mark.parametrize("n,rows,c", [
    (2, 37, 48),  # one split, 12 vectors: one 16-lane block
    (3, 2048, 64),
    (4, 300, 160),  # 40 vectors: a block wider than a warp
    (1, 65536, 16),  # 128 splits of 512 rows
])
def test_kernel_order_sums_within_tolerance(n, rows, c):
    """The forward kernel's fixed-order float32 sums (emulated in plain
    torch at the H100's launch numbers) stay within 1e-5 of the float64
    sum of magnitudes (GN_STATS_TOL of chip_smoke.py) of the exact sums."""
    rng = np.random.RandomState(8)
    x3 = torch.from_numpy(
        (rng.randn(n, rows, c) * 1.5 + 0.7).astype(np.float32))
    got = _kernel_order_sums(x3, H100_SMS)
    x64 = x3.double()
    want = torch.stack([x64.sum(1), (x64 * x64).sum(1)], 1)
    scale = torch.stack([x64.abs().sum(1), (x64 * x64).sum(1)], 1)
    assert float(((got.double() - want).abs() / scale).max()) <= 1e-5


@pytest.mark.parametrize("n,rows,c,itemsize", LAUNCH_SHAPES)
@pytest.mark.parametrize("sms", [H100_SMS, 8])
def test_bwd_launch_covers_each_row_once(n, rows, c, itemsize, sms):
    """K5's launch numbers (`_bwd_launch`): row splits cover every row once,
    none empty; they keep the persistent blocks 90% busy over whole rounds
    of tiles or are the busiest allowed; the blocks are at most two an SM
    and no more than the tiles; the scratch sizes are what the kernel
    checks."""
    how = port_gn._bwd_launch(sms, n, rows, c, itemsize, True)
    vec = 16 // itemsize
    assert how.vector == (c % vec == 0)
    width = vec if how.vector else 1
    nbc = -(-c // 64)
    splits, per = how.splits, -(-rows // how.splits)
    assert 1 <= splits <= rows and (splits - 1) * per < rows
    cover = np.zeros(rows, np.int64)
    for s in range(splits):
        cover[s * per:(s + 1) * per] += 1
    assert (cover == 1).all()
    tiles = n * nbc * splits
    target = 2 * sms
    assert how.blocks == min(target, tiles)
    step = 256 // (64 // width) * 4
    most = min(1024, max(1, rows // (4 * step)))

    def busy(k):
        t = n * nbc * k
        return t / (target * -(-t // target))

    chosen = port_gn.bwd_row_splits(n * nbc, rows, step, target)
    assert splits == -(-rows // -(-rows // chosen)) and chosen <= most
    assert busy(chosen) >= 0.9 or all(
        busy(k) <= busy(chosen) + 1e-9 for k in range(1, most + 1))
    assert how.sync_words == 1 + how.blocks + tiles
    assert how.partial_floats == n * splits * 2 * c
    # a pointer off 16 bytes takes the one-channel loop
    assert not port_gn._bwd_launch(sms, n, rows, c, itemsize, False).vector


def _bwd_kernel_order_sums(x3, dz3, fwd_sums, gamma, beta, groups, silu,
                           sms):
    """K5's sums of float32 inputs in plain torch, in the order of its
    float32 additions at `_bwd_launch`'s numbers: each thread adds its rows
    of a split one after another (every `deep`-th row), a tile adds its
    row lanes one after another, and the finish adds the tiles' partials
    split by split."""
    n, rows, c = x3.shape
    how = port_gn._bwd_launch(sms, n, rows, c, 4, True)
    deep = 256 // (64 // (4 if how.vector else 1))
    mu_c, rstd_c = port_gn.group_stats(fwd_sums, rows, groups, 1e-5)
    dy, xhat = port_gn._dy_xhat(x3, dz3, mu_c, rstd_c, gamma, beta, silu)
    both = torch.stack([dy, dy * xhat], 1)  # [n, 2, rows, c]
    per = -(-rows // how.splits)
    out = torch.zeros((n, 2, c), dtype=torch.float32)
    for s in range(how.splits):
        part = both[:, :, s * per:(s + 1) * per]
        part = torch.nn.functional.pad(part, (0, 0, 0, -part.shape[2] % deep))
        lanes = part.reshape(n, 2, -1, deep, c)
        acc = torch.zeros((n, 2, deep, c), dtype=torch.float32)
        for k in range(lanes.shape[2]):
            acc = acc + lanes[:, :, k]
        tile = torch.zeros((n, 2, c), dtype=torch.float32)
        for y in range(deep):
            tile = tile + acc[:, :, y]
        out = out + tile
    return out


@pytest.mark.parametrize("n,rows,c", [
    (2, 4096, 64),  # 16 splits
    (4, 1024, 96),  # 4 splits, a 32-channel second block
    (3, 300, 160),  # one split
])
def test_bwd_split_partials_match_plain_and_jax(pallas, n, rows, c):
    """K5's split partials added in a fixed order (emulated in plain torch
    at the H100's launch numbers) against K5's plain version and, where
    its row count has a block, the JAX `_bwd_stats` (interpret): 2e-5 of
    the largest sum."""
    groups = 8
    x, scale, bias, dz = _inputs((n, rows, c), seed=9)
    x3, dz3 = torch.from_numpy(x), torch.from_numpy(dz)
    gamma, beta = torch.from_numpy(scale), torch.from_numpy(bias)
    sums = port_gn.group_norm_stats_plain(x3)
    assert port_gn._bwd_launch(H100_SMS, n, rows, c, 4, True).splits \
        == {4096: 16, 1024: 4, 300: 1}[rows]
    for silu in (True, False):
        got = _bwd_kernel_order_sums(x3, dz3, sums, gamma, beta, groups, silu,
                                     H100_SMS).numpy()
        plain = port_gn.group_norm_bwd_stats_plain(
            x3, dz3, sums, gamma, beta, groups, 1e-5, silu).numpy()
        np.testing.assert_allclose(got, plain,
                                   atol=F32_TOL * np.abs(plain).max())
        block = jax_gn._pick_block_rows(rows, c)
        if block:
            mu_c, rstd_c = port_gn.group_stats(sums, rows, groups, 1e-5)
            want = np.asarray(jax_gn._bwd_stats(
                jnp.asarray(x), jnp.asarray(dz),
                jnp.asarray(mu_c.numpy())[:, None, :],
                jnp.asarray(rstd_c.numpy())[:, None, :],
                jnp.stack([jnp.asarray(scale), jnp.asarray(bias)])[None],
                block, silu))
            np.testing.assert_allclose(got, want,
                                       atol=F32_TOL * np.abs(want).max())


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,groups", [((2, 16, 16, 32), 8),
                                          ((2, 5, 7, 24), 4)])
def test_fwd_plain_matches_jax_forward(pallas, shape, groups, dtype, silu):
    """The fused forward's plain version against the JAX `group_norm_act`
    forward (Pallas statistics in interpret mode where the rows allow): y
    within float32 2e-5 / bfloat16 0.05, the sums within 2e-5 of the
    largest of the JAX `_fwd_stats` (or of its XLA route's sums)."""
    x, scale, bias, _ = _inputs(shape, seed=9)
    n, c = shape[0], shape[-1]
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    want = np.asarray(jax_gn.group_norm_act(
        jx, jnp.asarray(scale), jnp.asarray(bias), groups, 1e-5,
        silu).astype(jnp.float32))
    jx3 = jx.reshape(n, -1, c)
    br = jax_gn._pick_block_rows(jx3.shape[1], c)
    if br:
        want_sums = np.asarray(jax_gn._fwd_stats(jx3, br))
    else:
        xf = jx3.astype(jnp.float32)
        want_sums = np.asarray(jnp.stack([xf.sum(1), (xf * xf).sum(1)], 1))
    x3 = torch.from_numpy(x).to(getattr(torch, dtype)).reshape(n, -1, c)
    gamma, beta = torch.from_numpy(scale), torch.from_numpy(bias)
    y, sums = port_gn.group_norm_fwd_plain(x3, gamma, beta, groups, 1e-5,
                                           silu)
    assert y.dtype == x3.dtype and sums.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy().reshape(shape), want,
                               atol=F32_TOL if dtype == "float32"
                               else BF16_TOL)
    np.testing.assert_allclose(sums.numpy(), want_sums,
                               atol=F32_TOL * np.abs(want_sums).max())
    # the wrapper's CPU path is the plain version
    y2, sums2 = port_gn.group_norm_fwd(x3, gamma, beta, groups, 1e-5, silu)
    assert torch.equal(y2, y) and torch.equal(sums2, sums)


@pytest.mark.parametrize("bad", ["groups", "scale", "ndim", "rank3",
                                 "noncontig", "dz", "mu", "apply_sums",
                                 "apply_groups", "apply_gamma", "dx_sums",
                                 "dx_groups", "dx_dz", "fwd_groups",
                                 "fwd_gamma", "fwd_beta", "fwd_rank3",
                                 "fwd_noncontig", "fwd_not_tensor"])
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
        elif bad == "fwd_groups":
            port_gn.group_norm_fwd(x3, scale, bias, 3, 1e-5, True)
        elif bad == "fwd_gamma":
            port_gn.group_norm_fwd(x3, scale.double(), bias, 4, 1e-5, True)
        elif bad == "fwd_beta":
            port_gn.group_norm_fwd(x3, scale, torch.zeros(4), 4, 1e-5, True)
        elif bad == "fwd_rank3":
            port_gn.group_norm_fwd(x, scale, bias, 4, 1e-5, True)
        elif bad == "fwd_noncontig":
            port_gn.group_norm_fwd(torch.zeros(2, 8, 16).transpose(1, 2),
                                   scale, bias, 4, 1e-5, True)
        elif bad == "fwd_not_tensor":
            port_gn.group_norm_fwd(x3.tolist(), scale, bias, 4, 1e-5, True)
