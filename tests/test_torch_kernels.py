"""The port's kernel plumbing: import isolation, wrapper checks, and the
kernels against their plain versions on a card.

The kernel-vs-plain tests need an NVIDIA GPU (marker `cuda`) and skip
without one; on the card they hold K1 to `composite_plain` at 1e-4 absolute
on image and alpha and 1e-3 on depth, with at most 1e-4 of the pixels
allowed past that (the 1e-4 saturation knife-edge and exp rounding), and
K2 + K2b to `composite_backward_plain` at 1e-4 of each column's
max-|grad|, with at most 1e-3 of the rows past that (a pair flipped at the
knife-edge moves a row by its whole contribution), their reruns bit-equal
and K2b alone on K2's sub-tile rows bit-equal to its plain version; the
GroupNorm forward kernel's sums (alone or fused) and K5 to
`group_norm_stats_plain` / `group_norm_bwd_stats_plain` at 1e-5 of the
largest sum, its y (alone as K3a or fused) to `group_norm_apply_plain` and
K5a to `group_norm_bwd_dx_plain` within one bfloat16 ulp on all but 1e-4
of the outputs (bfloat16) or 1e-5 of the largest output (float32), their
reruns and a CUDA graph's replays of the op bit-equal; K4 to
`self_attention_plain` at 2^-7 of the largest output (one bfloat16 ulp at
the peak).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from humangaussian_torch import kernels
from humangaussian_torch.ops.projection import RasterizeConfig
from humangaussian_torch.ops.rasterize_tiled import (
    composite,
    composite_backward,
    composite_backward_pairs,
    composite_backward_plain,
    composite_plain,
    feature_row_grads,
    feature_row_grads_plain,
    pair_routing,
)
from humangaussian_torch.ops import attention, groupnorm
from port_parity_torch import (
    projected_composite_args,
    random_composite_args,
    random_groupnorm_args,
    random_qkv,
)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Import every humangaussian_torch module (and chip_smoke.py) in a
    fresh interpreter: neither jax, flax, optax nor humangaussian_tpu may
    load, and importing dist.parallel starts no process group."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import humangaussian_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'humangaussian_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m in ('flax', 'optax') or m.startswith(('flax.', 'optax.'))"
        " or m.startswith('humangaussian_tpu')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 48, names\n"
        "for n in ('train.photo', 'train.optim', 'densify', 'losses', "
        "'config', 'ops.knn', 'data.photo', 'apps.launch', 'ops.groupnorm', "
        "'ops.attention', 'utils.schedules', 'guidance.schedule', "
        "'guidance.vae', 'guidance.unet', 'guidance.prompt', "
        "'guidance.dual_branch', 'guidance.controlnet', 'nerf.gan', "
        "'nerf.explicit', 'registry', 'train.adan', 'train.optimizers', "
        "'utils.profiling', 'dist.parallel'):\n"
        "    assert 'humangaussian_torch.' + n in names, n\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "print('ok', len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_cpu_takes_plain_and_does_not_count():
    args = random_composite_args()
    kernels.reset_launch_counts()
    out = composite(*args)
    assert out["image"].shape == (1, 64, 64, 3)
    ref = composite_plain(*args)
    np.testing.assert_array_equal(out["image"].numpy(), ref["image"].numpy())
    grads = tuple(torch.ones_like(out[k]) for k in ("image", "depth", "alpha"))
    dfeats = composite_backward(*args[:5], out, grads, *args[5:])
    np.testing.assert_array_equal(
        dfeats.numpy(),
        composite_backward_plain(*args[:5], ref, grads, *args[5:]).numpy())
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("bad", [
    "feats_dtype", "gids_dtype", "starts_len", "feats_width",
    "noncontig", "background", "tiles", "not_tensor",
])
def test_wrapper_rejects_bad_arguments(bad):
    feats, gids, starts, counts, bg, tx, ty = random_composite_args()
    if bad == "feats_dtype":
        feats = feats.double()
    elif bad == "gids_dtype":
        gids = gids.long()
    elif bad == "starts_len":
        starts = starts[:-1]
    elif bad == "feats_width":
        feats = feats[:, :8].contiguous()
    elif bad == "noncontig":
        feats = torch.cat([feats, feats], dim=1)[:, ::2]
    elif bad == "background":
        bg = torch.zeros(4)
    elif bad == "tiles":
        tx = 3
    elif bad == "not_tensor":
        counts = counts.tolist()
    with pytest.raises((TypeError, ValueError)):
        composite(feats, gids, starts, counts, bg, tx, ty)


def test_wrapper_never_falls_back_off_the_cpu():
    """Only CPU tensors take the plain version: a tensor on any other
    device launches the kernel or raises (the meta device has no kernel),
    and a tile edge other than the compiled 32 raises first."""
    args = random_composite_args(device="meta")
    with pytest.raises(ValueError, match="no compositing kernel"):
        composite(*args)
    with pytest.raises(ValueError, match="built for tile 32"):
        composite(*args, cfg=RasterizeConfig(tile=16))


def test_backward_never_falls_back_off_the_cpu():
    args = random_composite_args(device="meta")
    out = {"image": torch.empty((1, 64, 64, 3), device="meta"),
           "depth": torch.empty((1, 64, 64), device="meta"),
           "final_t": torch.empty((1, 64, 64), device="meta"),
           "n_contrib": torch.empty((1, 64, 64), dtype=torch.int32,
                                    device="meta")}
    grads = (out["image"], out["depth"], out["depth"])
    with pytest.raises(ValueError, match="no compositing kernel"):
        composite_backward(*args[:5], out, grads, *args[5:])


def test_backward_wrapper_rejects_bad_cotangents():
    """The shape check guards the kernel; the plain version gets the same
    arguments, so a wrong shape fails there too."""
    args = random_composite_args()
    out = composite(*args)
    grads = (torch.ones((1, 64, 64, 3)), torch.ones((1, 64, 32)),
             torch.ones((1, 64, 64)))
    with pytest.raises((ValueError, RuntimeError)):
        composite_backward(*args[:5], out, grads, *args[5:])


def test_guidance_wrappers_take_plain_on_the_cpu_and_do_not_count():
    x3, dz3, gamma, beta = random_groupnorm_args()
    q, k, v = random_qkv(s=64, d=16)
    kernels.reset_launch_counts()
    sums = groupnorm.group_norm_stats(x3)
    assert torch.equal(sums, groupnorm.group_norm_stats_plain(x3))
    assert torch.equal(
        groupnorm.group_norm_bwd_stats(x3, dz3, sums, gamma, beta, 8, 1e-5,
                                       True),
        groupnorm.group_norm_bwd_stats_plain(x3, dz3, sums, gamma, beta, 8,
                                             1e-5, True))
    assert torch.equal(
        groupnorm.group_norm_apply(x3, sums, gamma, beta, 8, 1e-5, True),
        groupnorm.group_norm_apply_plain(x3, sums, gamma, beta, 8, 1e-5,
                                         True))
    assert torch.equal(attention.self_attention(q, k, v),
                       attention.self_attention_plain(q, k, v, 0.25))
    assert set(kernels.launch_counts().values()) == {0}
    y, fsums = groupnorm.group_norm_fwd(x3, gamma, beta, 8, 1e-5, True)
    want_y, want_sums = groupnorm.group_norm_fwd_plain(x3, gamma, beta, 8,
                                                       1e-5, True)
    assert torch.equal(y, want_y) and torch.equal(fsums, want_sums)
    assert set(kernels.launch_counts().values()) == {0}
    assert set(kernels.launch_counts()) == {
        "rasterize_fwd", "rasterize_bwd", "rasterize_bwd_rows",
        "groupnorm_fwd",
        "groupnorm_bwd_stats", "groupnorm_bwd_dx", "attention_fwd"}


def test_group_norm_bwd_dx_takes_plain_on_the_cpu_and_does_not_count():
    """K5a's wrapper on CPU tensors is its plain version, and the op's
    backward on CPU tensors launches nothing."""
    x3, dz3, gamma, beta = random_groupnorm_args()
    sums = groupnorm.group_norm_stats(x3)
    kernels.reset_launch_counts()
    for silu in (True, False):
        s5 = groupnorm.group_norm_bwd_stats(x3, dz3, sums, gamma, beta, 8,
                                            1e-5, silu)
        assert torch.equal(
            groupnorm.group_norm_bwd_dx(x3, dz3, sums, gamma, beta, s5, 8,
                                        1e-5, silu),
            groupnorm.group_norm_bwd_dx_plain(x3, dz3, sums, gamma, beta, s5,
                                              8, 1e-5, silu))
    x = x3.reshape(2, 37, 1, 48).requires_grad_(True)
    y = groupnorm.group_norm_act(x, gamma, beta, 8, 1e-5, True)
    (dx,) = torch.autograd.grad(y, x, dz3.reshape(y.shape))
    assert torch.isfinite(dx).all()
    assert set(kernels.launch_counts().values()) == {0}


def test_group_norm_bwd_dx_never_falls_back_off_the_cpu():
    """Tensors on any device but the CPU launch K5a or raise, and the
    wrapper checks the arguments before the device: the meta device has no
    kernel."""
    x3, dz3, gamma, beta = random_groupnorm_args(device="meta")
    sums = torch.empty((2, 2, 48), device="meta")
    with pytest.raises(ValueError, match="no GroupNorm kernel"):
        groupnorm.group_norm_bwd_dx(x3, dz3, sums, gamma, beta, sums, 8,
                                    1e-5, True)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        groupnorm.group_norm_bwd_dx(x3.double(), dz3.double(), sums, gamma,
                                    beta, sums, 8, 1e-5, True)
    for args, what in (
            ((x3, dz3, sums, gamma, beta, sums[:, :1], 8), "sums"),
            ((x3, dz3, sums[:1], gamma, beta, sums, 8), "fwd_sums"),
            ((x3, dz3, sums, gamma, beta, sums, 7), "groups"),
            ((x3, dz3[:1], sums, gamma, beta, sums, 8), "dz3"),
            ((x3, dz3, sums, gamma, beta, torch.zeros(2, 2, 48), 8),
             "sums")):
        with pytest.raises(ValueError, match=what):
            groupnorm.group_norm_bwd_dx(*args, 1e-5, True)


def test_guidance_wrappers_never_fall_back_off_the_cpu():
    """A tensor on any device but the CPU launches the kernel or raises
    (the meta device has no kernel)."""
    x3, dz3, gamma, beta = random_groupnorm_args(device="meta")
    sums = torch.empty((2, 2, 48), device="meta")
    with pytest.raises(ValueError, match="no GroupNorm kernel"):
        groupnorm.group_norm_stats(x3)
    with pytest.raises(ValueError, match="no GroupNorm kernel"):
        groupnorm.group_norm_bwd_stats(x3, dz3, sums, gamma, beta, 8, 1e-5,
                                       True)
    with pytest.raises(ValueError, match="no GroupNorm kernel"):
        groupnorm.group_norm_act(x3, gamma, beta, 8, 1e-5, True)
    with pytest.raises(ValueError, match="no GroupNorm kernel"):
        groupnorm.group_norm_apply(x3, sums, gamma, beta, 8, 1e-5, True)
    with pytest.raises(ValueError, match="no GroupNorm kernel"):
        groupnorm.group_norm_fwd(x3, gamma, beta, 8, 1e-5, True)
    q, k, v = random_qkv(device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no attention kernel"):
        attention.self_attention(q, k, v)


@pytest.mark.parametrize("kernel,stem", [
    (kernels.RASTERIZE_FWD, "rasterize_fwd"),
    (kernels.RASTERIZE_BWD, "rasterize_bwd"),
    (kernels.GROUPNORM_FWD, "groupnorm_fwd"),
    (kernels.GROUPNORM_BWD_STATS, "groupnorm_stats"),
    (kernels.GROUPNORM_BWD_DX, "groupnorm_bwd_dx"),
    (kernels.ATTENTION_FWD, "attention_fwd"),
])
def test_kernel_build_naming(kernel, stem):
    lib = kernel.library_path()
    assert lib.parent == kernels.BUILD_DIR
    assert lib.name.startswith(stem + "-") and lib.suffix == ".so"
    assert kernel.source.exists()
    assert kernel in kernels.KERNELS
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _k1_within_limits(out, ref):
    for key, atol in (("image", 1e-4), ("alpha", 1e-4), ("depth", 1e-3)):
        err = (out[key] - ref[key]).abs()
        if err.dim() == 4:
            err = err.amax(dim=-1)
        assert int((err > atol).sum()) <= max(1, err.numel() // 10000), key
    assert torch.isfinite(out["image"]).all()


def _k2_within_limits(got, want, max_bad_fraction):
    assert torch.isfinite(got).all()
    for j in range(10):
        scale = float(want[:, j].abs().max())
        err = (got[:, j] - want[:, j]).abs() / scale
        assert int((err > 1e-4).sum()) <= max(
            1, int(err.numel() * max_bad_fraction)), j


@pytest.mark.cuda
@pytest.mark.parametrize("cams", [1, 3])
def test_kernel_matches_plain(cuda_device, cams):
    args = random_composite_args(device=cuda_device, cams=cams, tiles_x=3,
                                 tiles_y=2, n=400, pairs_per_tile=300)
    kernels.reset_launch_counts()
    out = composite(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rasterize_fwd"] == 1
    _k1_within_limits(out, composite_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("cams", [1, 3])
def test_backward_kernel_matches_plain(cuda_device, cams):
    args = random_composite_args(device=cuda_device, cams=cams, tiles_x=3,
                                 tiles_y=2, n=400, pairs_per_tile=300)
    feats = args[0].clone().requires_grad_(True)
    kernels.reset_launch_counts()
    out = composite(feats, *args[1:])
    g = torch.Generator(device="cpu").manual_seed(cams)
    cot = [torch.randn(out[k].shape, generator=g).to(cuda_device)
           for k in ("image", "depth", "alpha")]
    loss = sum((out[k] * c).sum()
               for k, c in zip(("image", "depth", "alpha"), cot))
    (got,) = torch.autograd.grad(loss, feats)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["rasterize_fwd"], counts["rasterize_bwd"]) == (1, 1)
    plain = composite_plain(*args)
    want = composite_backward_plain(*args[:5], plain, cot, *args[5:])
    _k2_within_limits(got, want, 1e-3)


@pytest.mark.cuda
def test_kernels_match_plain_on_a_2x2_rect_batch_of_8(cuda_device):
    """K1 and K2 against their plain versions on a binned 8-camera batch
    with the training rect (max_tiles_per_gaussian 4), as the guidance
    step renders: one launch each."""
    args, cfg = projected_composite_args(device=cuda_device, seed=8, n=4000,
                                         hw=(128, 160), cams=8, max_tiles=4)
    feats = args[0].clone().requires_grad_(True)
    kernels.reset_launch_counts()
    out = composite(feats, *args[1:], cfg)
    g = torch.Generator(device="cpu").manual_seed(8)
    cot = [torch.randn(out[k].shape, generator=g).to(cuda_device)
           for k in ("image", "depth", "alpha")]
    loss = sum((out[k] * c).sum()
               for k, c in zip(("image", "depth", "alpha"), cot))
    (got,) = torch.autograd.grad(loss, feats)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["rasterize_fwd"], counts["rasterize_bwd"]) == (1, 1)
    ref = composite_plain(*args, cfg)
    _k1_within_limits(out, ref)
    want = composite_backward_plain(*args[:5], ref, cot, *args[5:], cfg)
    _k2_within_limits(got, want, 1e-3)


@pytest.mark.cuda
def test_backward_kernels_repeat_bit_for_bit_on_a_2x2_rect_batch_of_8(
        cuda_device):
    """K2 + K2b run twice on the binned 8-camera batch with the training
    rect give the same bits (every sum in a fixed order), within K2's
    limits of the plain version; K2b alone on K2's sub-tile rows gives its
    plain version's bits."""
    args, cfg = projected_composite_args(device=cuda_device, seed=8, n=4000,
                                         hw=(128, 160), cams=8, max_tiles=4)
    routing = pair_routing(*args[1:4], args[0].shape[0])
    out = composite(*args, cfg)
    g = torch.Generator(device="cpu").manual_seed(9)
    cot = [torch.randn(out[k].shape, generator=g).to(cuda_device)
           for k in ("image", "depth", "alpha")]
    kernels.reset_launch_counts()
    got = [composite_backward(*args[:5], out, cot, *args[5:], cfg, routing)
           for _ in range(2)]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["rasterize_bwd"], counts["rasterize_bwd_rows"]) == (2, 2)
    assert torch.equal(got[0], got[1])
    ref = composite_plain(*args, cfg)
    want = composite_backward_plain(*args[:5], ref, cot, *args[5:], cfg,
                                    routing)
    _k2_within_limits(got[0], want, 1e-3)
    rows, mask = composite_backward_pairs(*args[:5], out, cot, *args[5:],
                                          cfg)
    assert torch.equal(
        feature_row_grads(rows, mask, *routing, args[0]),
        feature_row_grads_plain(rows, mask, *routing, args[0]))


GN_KERNEL_SHAPES = [
    (2, 37, 48, torch.float32),  # odd rows
    (3, 50, 33, torch.float32),  # odd channel count: the scalar loads
    (4, 1024, 320, torch.bfloat16),
    (2, 64, 2560, torch.bfloat16),
    (1, 65536, 128, torch.bfloat16),  # the VAE's 256^2 level
    (2, 300, 96, torch.float32),  # 4-channel float32 vectors
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,c,dtype", GN_KERNEL_SHAPES)
def test_groupnorm_kernels_match_plain(cuda_device, n, rows, c, dtype):
    x3, dz3, gamma, beta = random_groupnorm_args(cuda_device, 1, n, rows, c,
                                                 dtype)
    kernels.reset_launch_counts()
    got = groupnorm.group_norm_stats(x3)
    want = groupnorm.group_norm_stats_plain(x3)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # one group a channel: every channel normalized on its own
    for silu in (True, False):
        got5 = groupnorm.group_norm_bwd_stats(x3, dz3, want, gamma, beta, c,
                                              1e-5, silu)
        want5 = groupnorm.group_norm_bwd_stats_plain(x3, dz3, want, gamma,
                                                     beta, c, 1e-5, silu)
        assert float((got5 - want5).abs().max()) <= 1e-5 * float(
            want5.abs().max())
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["groupnorm_fwd"] == 1
    assert counts["groupnorm_bwd_stats"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,c,dtype", GN_KERNEL_SHAPES)
def test_groupnorm_backward_kernels_repeat_bit_for_bit(cuda_device, n, rows,
                                                        c, dtype):
    """K5 and K5a run twice on the same inputs give the same bits (K5's
    split partials are added in a fixed order)."""
    x3, dz3, gamma, beta = random_groupnorm_args(cuda_device, 2, n, rows, c,
                                                 dtype)
    fsums = groupnorm.group_norm_stats(x3)
    for silu in (True, False):
        sums = [groupnorm.group_norm_bwd_stats(x3, dz3, fsums, gamma, beta, c,
                                               1e-5, silu) for _ in range(2)]
        dx = [groupnorm.group_norm_bwd_dx(x3, dz3, fsums, gamma, beta, s, c,
                                          1e-5, silu) for s in sums]
        torch.cuda.synchronize()
        assert torch.equal(sums[0], sums[1])
        assert torch.equal(dx[0], dx[1])


@pytest.mark.cuda
def test_group_norm_act_backward_replays_from_a_cuda_graph(cuda_device):
    """`group_norm_act` forward and backward (the fused forward, K5, K5a:
    no memset, no per-call query, flag words of their own under capture)
    captured in a CUDA graph and replayed give an eager call's bits."""
    x3, dz3, gamma, beta = random_groupnorm_args(cuda_device, 4, 8, 1024, 320,
                                                 torch.bfloat16)
    x = x3.reshape(8, 32, 32, 320).requires_grad_(True)
    dz = dz3.reshape(8, 32, 32, 320)
    scale = gamma.clone().requires_grad_(True)
    bias = beta.clone().requires_grad_(True)

    def step():  # keeps no autograd graph alive past the call
        y = groupnorm.group_norm_act(x, scale, bias, 32, 1e-5, True)
        return (y.detach(), *torch.autograd.grad(y, (x, scale, bias), dz))

    want = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = step()
    for _ in range(3):
        for t in got:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,c,groups,dtype", [
    (2, 37, 48, 8, torch.float32),  # odd rows
    (3, 50, 33, 3, torch.float32),  # no 16-byte vectors: the scalar loop
    (4, 1024, 320, 32, torch.bfloat16),
    (2, 64, 2560, 32, torch.bfloat16),
])
def test_groupnorm_apply_kernel_matches_plain(cuda_device, n, rows, c,
                                              groups, dtype):
    x3, _, gamma, beta = random_groupnorm_args(cuda_device, 3, n, rows, c,
                                               dtype)
    sums = groupnorm.group_norm_stats_plain(x3)
    kernels.reset_launch_counts()
    for silu in (True, False):
        got = groupnorm.group_norm_apply(x3, sums, gamma, beta, groups, 1e-5,
                                         silu)
        torch.cuda.synchronize()
        want = groupnorm.group_norm_apply_plain(x3, sums, gamma, beta,
                                                groups, 1e-5, silu)
        assert got.dtype == dtype and torch.isfinite(got).all()
        err = (got.float() - want.float()).abs()
        if dtype == torch.bfloat16:
            _, e = torch.frexp(want.float().abs().clamp_min(2.0 ** -126))
            ulp = torch.ldexp(torch.ones_like(err), e - 8)
            assert float((err > ulp).float().mean()) <= 1e-4
        else:
            assert float(err.max()) <= 1e-5 * float(want.abs().max())
    assert kernels.launch_counts()["groupnorm_fwd"] == 2


def _within_one_ulp(got, want, dtype):
    """bfloat16: all but 1e-4 of the outputs within one ulp of plain;
    float32: within 1e-5 of the largest output."""
    assert got.dtype == dtype and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        _, e = torch.frexp(want.float().abs().clamp_min(2.0 ** -126))
        ulp = torch.ldexp(torch.ones_like(err), e - 8)
        assert float((err > ulp).float().mean()) <= 1e-4
    else:
        assert float(err.max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,c,groups,dtype,offset", [
    (2, 37, 48, 8, torch.float32, 0),  # odd rows
    (3, 50, 33, 3, torch.float32, 0),  # no 16-byte vectors
    (4, 1024, 320, 32, torch.bfloat16, 0),
    (2, 64, 2560, 32, torch.bfloat16, 0),
    (6, 256, 320, 32, torch.bfloat16, 0),
    (2, 4096, 128, 32, torch.bfloat16, 0),
    # x and y 4 bytes off 16: the scalar tiles at a vector-wide C
    (2, 2048, 96, 32, torch.float32, 1),
])
def test_group_norm_fwd_kernel_matches_plain(cuda_device, n, rows, c, groups,
                                             dtype, offset):
    """The fused forward (one launch) against its plain version: sums
    within 1e-5 of the largest, y within one bfloat16 ulp (or 1e-5 in
    float32); a second launch gives the same bits."""
    x3, _, gamma, beta = random_groupnorm_args(cuda_device, 5, n, rows, c,
                                               dtype)
    if offset:  # the same values at an address off 16 bytes
        flat = torch.empty(x3.numel() + offset, dtype=dtype,
                           device=cuda_device)
        flat[offset:] = x3.reshape(-1)
        x3 = flat[offset:].view(n, rows, c)
        assert x3.data_ptr() % 16
    kernels.reset_launch_counts()
    for silu in (True, False):
        y, sums = groupnorm.group_norm_fwd(x3, gamma, beta, groups, 1e-5,
                                           silu)
        y2, sums2 = groupnorm.group_norm_fwd(x3, gamma, beta, groups, 1e-5,
                                             silu)
        torch.cuda.synchronize()
        want_y, want_sums = groupnorm.group_norm_fwd_plain(
            x3, gamma, beta, groups, 1e-5, silu)
        assert float((sums - want_sums).abs().max()) <= 1e-5 * float(
            want_sums.abs().max())
        assert torch.equal(sums, sums2) and torch.equal(y, y2)
        # y against plain on the kernel's own sums
        _within_one_ulp(y, groupnorm.group_norm_apply_plain(
            x3, sums, gamma, beta, groups, 1e-5, silu), dtype)
    assert kernels.launch_counts()["groupnorm_fwd"] == 4


@pytest.mark.cuda
def test_group_norm_fwd_replays_from_cuda_graphs(cuda_device):
    """The fused forward captured in two CUDA graphs and replayed, with
    eager launches on the same inputs in between, then the two graphs
    replayed on two streams at once: every replay gives the eager launch's
    bits (each captured launch has flag words of its own)."""
    args = [random_groupnorm_args(cuda_device, seed, 8, 1024, 320,
                                  torch.bfloat16) for seed in (7, 8)]
    eager = [groupnorm.group_norm_fwd(x3, gamma, beta, 32, 1e-5, True)
             for x3, _, gamma, beta in args]
    torch.cuda.synchronize()
    graphs, outs = [], []
    for x3, _, gamma, beta in args:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(groupnorm.group_norm_fwd(x3, gamma, beta, 32, 1e-5,
                                                 True))
        graphs.append(graph)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())

    def agree():
        torch.cuda.synchronize()
        for (y, sums), (want_y, want_sums) in zip(outs, eager):
            assert torch.equal(y, want_y) and torch.equal(sums, want_sums)
            y.zero_()
            sums.zero_()
        torch.cuda.synchronize()  # the zeros land before the next replays

    for _ in range(3):
        for graph, (x3, _, gamma, beta) in zip(graphs, args):
            graph.replay()
            groupnorm.group_norm_fwd(x3, gamma, beta, 32, 1e-5, True)
        agree()
    for _ in range(5):
        for graph, stream in zip(graphs, streams):
            with torch.cuda.stream(stream):
                graph.replay()
        agree()


@pytest.mark.cuda
def test_group_norm_fwd_sums_and_modes_agree(cuda_device):
    """The sums-only mode gives the same bits twice; the normalize-only
    mode on the fused launch's sums gives the fused launch's y."""
    x3, _, gamma, beta = random_groupnorm_args(cuda_device, 6, 4, 1024, 320,
                                               torch.bfloat16)
    a = groupnorm.group_norm_stats(x3)
    assert torch.equal(a, groupnorm.group_norm_stats(x3))
    y, sums = groupnorm.group_norm_fwd(x3, gamma, beta, 32, 1e-5, True)
    assert torch.equal(groupnorm.group_norm_apply(x3, sums, gamma, beta, 32,
                                                  1e-5, True), y)


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,c,groups,dtype", [
    (2, 37, 48, 8, torch.float32),  # odd rows
    (3, 50, 33, 3, torch.float32),  # no 16-byte vectors: the scalar loop
    (4, 1024, 320, 32, torch.bfloat16),  # a UNet shape
    (1, 65536, 128, 32, torch.bfloat16),  # the VAE's 256^2 level
])
def test_groupnorm_bwd_dx_kernel_matches_plain(cuda_device, n, rows, c,
                                               groups, dtype):
    x3, dz3, gamma, beta = random_groupnorm_args(cuda_device, 4, n, rows, c,
                                                 dtype)
    fwd = groupnorm.group_norm_stats_plain(x3)
    kernels.reset_launch_counts()
    for silu in (True, False):
        sums = groupnorm.group_norm_bwd_stats_plain(x3, dz3, fwd, gamma, beta,
                                                    groups, 1e-5, silu)
        got = groupnorm.group_norm_bwd_dx(x3, dz3, fwd, gamma, beta, sums,
                                          groups, 1e-5, silu)
        torch.cuda.synchronize()
        want = groupnorm.group_norm_bwd_dx_plain(x3, dz3, fwd, gamma, beta,
                                                 sums, groups, 1e-5, silu)
        assert got.dtype == dtype and torch.isfinite(got).all()
        err = (got.float() - want.float()).abs()
        if dtype == torch.bfloat16:
            _, e = torch.frexp(want.float().abs().clamp_min(2.0 ** -126))
            ulp = torch.ldexp(torch.ones_like(err), e - 8)
            assert float((err > ulp).float().mean()) <= 1e-4
        else:
            assert float(err.max()) <= 1e-5 * float(want.abs().max())
    assert kernels.launch_counts()["groupnorm_bwd_dx"] == 2


@pytest.mark.cuda
def test_group_norm_act_on_the_card_matches_the_library(cuda_device):
    """Output and input gradient of the op (K3 forward, K5 backward) against
    F.group_norm + F.silu in float32, 2e-5."""
    import torch.nn.functional as F

    x3, dz3, gamma, beta = random_groupnorm_args(cuda_device, 2, 2, 256, 64)
    x = x3.reshape(2, 16, 16, 64).requires_grad_(True)
    y = groupnorm.group_norm_act(x, gamma, beta, 8, 1e-5, True)
    (dx,) = torch.autograd.grad(y, x, dz3.reshape(y.shape))
    xr = x3.reshape(2, 16, 16, 64).permute(0, 3, 1, 2).detach() \
        .requires_grad_(True)
    yr = F.silu(F.group_norm(xr, 8, gamma, beta, 1e-5))
    (dxr,) = torch.autograd.grad(
        yr, xr, dz3.reshape(2, 16, 16, 64).permute(0, 3, 1, 2))
    assert float((y.permute(0, 3, 1, 2) - yr).detach().abs().max()) <= 2e-5
    assert float((dx.permute(0, 3, 1, 2) - dxr).abs().max()) <= 2e-5 * max(
        1.0, float(dxr.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,m", [(2, 256, 3, None), (1, 1024, 2, None),
                                     (1, 128, 2, 384)])
def test_attention_kernel_matches_plain(cuda_device, b, s, h, m):
    q, k, v = random_qkv(cuda_device, 2, b, s, h, 64, torch.bfloat16, m)
    kernels.reset_launch_counts()
    got = attention.self_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["attention_fwd"] == 1
    want = attention.self_attention_plain(q, k, v, 0.125)
    assert torch.isfinite(got).all()
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2.0 ** -7 * float(want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float32", "head_dim", "length"])
def test_attention_kernel_rejects_what_it_does_not_take(cuda_device, bad):
    kw = {"float32": dict(dtype=torch.float32),
          "head_dim": dict(d=32, dtype=torch.bfloat16),
          "length": dict(s=192, dtype=torch.bfloat16)}[bad]
    q, k, v = random_qkv(cuda_device, **kw)
    with pytest.raises((TypeError, ValueError)):
        attention.self_attention(q, k, v)


@pytest.mark.cuda
def test_controlnet_guidance_on_the_card_matches_the_plain_versions(
        cuda_device, monkeypatch):
    """The ControlNet guidance at TINY_SD_CONFIG in float32 (its UNet,
    ControlNet and VAE norms on the GroupNorm forward kernel, the
    differentiated encode's on
    K5 / K5a) against the same call through the GroupNorm plain versions:
    loss within 1e-5 relative, render gradient within 1e-4 of its max."""
    from humangaussian_torch.guidance import controlnet, vae
    from humangaussian_torch.guidance.schedule import sd_eps_schedule

    torch.manual_seed(0)
    with torch.device(cuda_device):
        unet = controlnet.UNet2D(controlnet.TINY_SD_CONFIG)
        net = controlnet.ControlNet(controlnet.TINY_SD_CONFIG, (8, 16))
        for p in net.parameters():  # move the zero taps off zero
            p.data.add_(0.05 * torch.randn_like(p))
        prior = vae.AutoencoderKL(vae.tiny_vae_config())
    g = controlnet.ControlNetGuidance(
        unet, net, prior, sd_eps_schedule(device=cuda_device), image_size=16)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    rgb = torch.rand((2, 32, 32, 3), generator=gen, device=cuda_device)
    pose = torch.rand((2, 32, 32, 3), generator=gen, device=cuda_device)
    text = torch.randn((4, 7, 32), generator=gen, device=cuda_device)
    eps, noise = (torch.randn((2, 8, 8, 4), generator=gen,
                              device=cuda_device) for _ in range(2))
    t = torch.tensor([300, 700], device=cuda_device)

    def run():
        x = rgb.clone().requires_grad_(True)
        out = g(pose, x, text, t, latent_eps=eps, noise=noise)
        out["loss_sds"].backward()
        return float(out["loss_sds"].detach()), x.grad

    kernels.reset_launch_counts()
    loss, grad = run()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["groupnorm_fwd"] > 0 and counts["groupnorm_bwd_dx"] > 0
    for name in ("fwd", "bwd_stats", "bwd_dx"):
        monkeypatch.setattr(groupnorm, f"group_norm_{name}",
                            getattr(groupnorm, f"group_norm_{name}_plain"))
    want_loss, want_grad = run()
    assert loss == pytest.approx(want_loss, rel=1e-5)
    assert float((grad - want_grad).abs().max()) <= 1e-4 * float(
        want_grad.abs().max())
