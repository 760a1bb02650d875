"""The port's kernel plumbing: import isolation, wrapper checks, and the
kernels against their plain versions on a card.

The kernel-vs-plain tests need an NVIDIA GPU (marker `cuda`) and skip
without one; on the card they hold K1 to `composite_plain` at 1e-4 absolute
on image and alpha and 1e-3 on depth, with at most 1e-4 of the pixels
allowed past that (the 1e-4 saturation knife-edge and exp rounding), and
K2 + K2b to `composite_backward_plain` at 1e-4 of each column's
max-|grad|, with at most 1e-3 of the rows past that (a pair flipped at the
knife-edge moves a row by its whole contribution), their reruns bit-equal
and K2b alone on K2's sub-tile rows, and on candidate spans that cross
its chunks, bit-equal to its plain version; the
GroupNorm forward kernel's sums (alone or fused) and K5 to
`group_norm_stats_plain` / `group_norm_bwd_stats_plain` at 1e-5 of the
largest sum, its y (alone as K3a or fused) to `group_norm_apply_plain` and
K5a to `group_norm_bwd_dx_plain` within one bfloat16 ulp on all but 1e-4
of the outputs (bfloat16) or 1e-5 of the largest output (float32), their
reruns and a CUDA graph's replays of the op bit-equal; K4 to
`self_attention_plain` at 2^-7 of the largest output (one bfloat16 ulp at
the peak). The antialiased resize of the step (`ops/resize.py`, gathers,
no kernel of its own) repeats its backward bit for bit under strict
deterministic algorithms and matches its CPU result on the card.
"""
import math
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
from humangaussian_torch.ops import attention, conv_bias, groupnorm
from port_parity_torch import (
    long_row_routing,
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
        "'ops.attention', 'ops.conv_bias', 'ops.vae_attention', "
        "'utils.schedules', 'guidance.schedule', "
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


def test_routing_needs_its_three_arrays():
    """The backward's routing is (cand_pos, row_starts, pair_cand): a
    routing without `pair_cand`, or with one of the wrong length, is
    refused before any compositing."""
    args = random_composite_args()
    routing = pair_routing(*args[1:4], args[0].shape[0])
    with pytest.raises(ValueError, match="routing is"):
        composite(*args, routing=routing[:2])
    with pytest.raises(ValueError, match="pair_cand"):
        composite(*args, routing=(*routing[:2], routing[2][:-1]))
    with pytest.raises(ValueError, match="cand_pos"):
        feature_row_grads(torch.zeros(3, 16, 10),
                          torch.zeros(3, 16, dtype=torch.uint8),
                          routing[0][:2], routing[1], args[0])
    assert composite(*args, routing=routing)["image"].shape == (1, 64, 64, 3)


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
    y = torch.randn(2, 16, 5, 3).contiguous(memory_format=torch.channels_last)
    bias = torch.randn(16)
    want = conv_bias.conv_bias_add_plain(y.clone(), bias)
    assert torch.equal(conv_bias.conv_bias_add(y, bias), want)
    assert torch.equal(y, want)  # in place
    assert set(kernels.launch_counts().values()) == {0}
    y, fsums = groupnorm.group_norm_fwd(x3, gamma, beta, 8, 1e-5, True)
    want_y, want_sums = groupnorm.group_norm_fwd_plain(x3, gamma, beta, 8,
                                                       1e-5, True)
    assert torch.equal(y, want_y) and torch.equal(fsums, want_sums)
    assert set(kernels.launch_counts().values()) == {0}
    assert set(kernels.launch_counts()) == {
        "rasterize_fwd", "rasterize_bwd", "rasterize_bwd_rows",
        "groupnorm_fwd",
        "groupnorm_bwd_stats", "groupnorm_bwd_dx", "attention_fwd",
        "conv_bias_add", "vae_attention_fwd", "vae_attention_bwd"}


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


def _conv_output(device, dtype, c=16, layout="channels_last", b=2, h=6, w=5):
    gen = torch.Generator().manual_seed(c + h)
    y = torch.randn((b, c, h, w), generator=gen).to(device, dtype)
    bias = torch.randn((c,), generator=gen).to(device, dtype)
    if layout == "channels_last":
        y = y.contiguous(memory_format=torch.channels_last)
    return y, bias


@pytest.mark.parametrize("bad", ["float64", "bias_dtype", "strided",
                                 "bias_len", "dims", "device"])
def test_conv_bias_add_rejects_what_the_kernel_does_not_take(bad):
    """Off the CPU the wrapper launches the kernel or raises, and it checks
    the arguments before the device: the meta device has no kernel."""
    y, bias = _conv_output("meta", torch.bfloat16)
    err, match = ValueError, "conv bias kernel"
    if bad == "float64":
        y, bias, err = y.double(), bias.double(), TypeError
    elif bad == "bias_dtype":
        bias, err = bias.float(), TypeError
    elif bad == "strided":
        y = y[:, :, ::2]
    elif bad == "bias_len":
        bias = bias[:-1]
    elif bad == "dims":
        y = y[0]
    else:
        match = "no conv bias kernel for device meta"
    with pytest.raises(err, match=match):
        conv_bias.conv_bias_add(y, bias)


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_conv_bias_add_on_the_cpu_is_the_library_add(layout):
    y, bias = _conv_output("cpu", torch.float32, layout=layout)
    want = y + bias.view(1, -1, 1, 1)
    kernels.reset_launch_counts()
    assert conv_bias.conv_bias_add(y, bias) is y
    assert torch.equal(y, want)
    assert kernels.launch_counts()["conv_bias_add"] == 0


@pytest.mark.parametrize("kernel,stem", [
    (kernels.RASTERIZE_FWD, "rasterize_fwd"),
    (kernels.RASTERIZE_BWD, "rasterize_bwd"),
    (kernels.GROUPNORM_FWD, "groupnorm_fwd"),
    (kernels.GROUPNORM_BWD_STATS, "groupnorm_stats"),
    (kernels.GROUPNORM_BWD_DX, "groupnorm_bwd_dx"),
    (kernels.ATTENTION_FWD, "attention_fwd"),
    (kernels.CONV_BIAS_ADD, "conv_bias"),
    (kernels.VAE_ATTENTION_FWD, "vae_attention"),
    (kernels.VAE_ATTENTION_BWD, "vae_attention"),
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
                                          cfg, routing)
    plain_sums = feature_row_grads_plain(rows, mask, *routing[:2], args[0])
    assert torch.equal(feature_row_grads(rows, mask, *routing[:2], args[0]),
                       plain_sums)
    # K2 + K2b in one call: the plain row sums of K2's rows, bit for bit
    assert torch.equal(got[0], plain_sums)


@pytest.mark.cuda
def test_k2b_matches_plain_bit_for_bit_on_rows_that_cross_chunks(
        cuda_device):
    """K2b alone against its plain version on spans of every length (rows
    of up to 300 candidates, across many chunks of a warp; chunks the
    stage ends; rows without candidates and rows whose every candidate was
    cut; an odd last warp), bit for bit, twice."""
    rows, mask, cand_pos, row_starts, feats, all_cut = long_row_routing(
        cuda_device, seed=4, n_rows=3001, longest=300)
    kernels.reset_launch_counts()
    got = [feature_row_grads(rows, mask, cand_pos, row_starts, feats)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rasterize_bwd_rows"] == 2
    want = feature_row_grads_plain(rows, mask, cand_pos, row_starts, feats)
    assert torch.equal(got[0].view(torch.int32), want.view(torch.int32))
    assert torch.equal(got[0], got[1])
    assert bool((got[0][torch.as_tensor(all_cut)] == 0).all())


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


def _resize_grad(x, g, size):
    from humangaussian_torch.ops.resize import resize_bilinear

    x = x.clone().requires_grad_(True)
    y = resize_bilinear(x, size)
    (dx,) = torch.autograd.grad(y, x, g)
    return y.detach(), dx


@pytest.mark.cuda
def test_resize_backward_repeats_bit_for_bit_under_strict_determinism(
        cuda_device):
    """The step's resize, 8 x 1024^2 x 3 -> 512^2: two backwards bit-equal
    with torch's deterministic algorithms on, strict (an op without a
    deterministic implementation would raise)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand((8, 1024, 1024, 3), generator=gen, device=cuda_device)
    g = torch.randn((8, 512, 512, 3), generator=gen, device=cuda_device)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        y1, dx1 = _resize_grad(x, g, 512)
        y2, dx2 = _resize_grad(x, g, 512)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(y1, y2)
    assert torch.equal(dx1, dx2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", [(8, 1024, 512), (2, 1024, 64),
                                   (2, 64, 256)])
def test_resize_on_the_card_matches_the_cpu(cuda_device, b, n, m):
    """The card's forward within 1e-6 absolute and its gradient within
    1e-6 of max-|grad| of the same resize on the CPU."""
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((b, n, n, 3), generator=gen)
    g = torch.randn((b, m, m, 3), generator=gen)
    y_cpu, dx_cpu = _resize_grad(x, g, m)
    y, dx = _resize_grad(x.to(cuda_device), g.to(cuda_device), m)
    assert float((y.cpu() - y_cpu).abs().max()) <= 1e-6
    assert float((dx.cpu() - dx_cpu).abs().max()) <= 1e-6 * float(
        dx_cpu.abs().max())


CONV_BIAS_SHAPES = [  # (C, H, W): the encoder's widths at B = 1, and
    (128, 64, 64), (256, 64, 64), (512, 64, 64),  # quant_conv's 8,
    (8, 64, 64), (3, 64, 64), (320, 16, 24),  # conv_out's 3, and a C that
]                                             # does not divide 256 vectors


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,w", CONV_BIAS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_conv_bias_kernel_matches_plain_bit_for_bit(cuda_device, c, h, w,
                                                    dtype, layout):
    y, bias = _conv_output(cuda_device, dtype, c, layout, b=1, h=h, w=w)
    want = conv_bias.conv_bias_add_plain(y.clone(), bias)
    kernels.reset_launch_counts()
    got = conv_bias.conv_bias_add(y, bias)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["conv_bias_add"] == 1
    assert got is y and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_bias_kernel_off_16_bytes_matches_plain(cuda_device, dtype):
    """A y whose pointer is off 16 bytes takes the scalar path."""
    y0, bias = _conv_output(cuda_device, dtype, 64, b=2, h=9, w=7)
    flat = torch.empty(y0.numel() + 1, device=cuda_device, dtype=dtype)
    y = flat[1:].view(2, 9, 7, 64).permute(0, 3, 1, 2)
    y.copy_(y0)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert y.data_ptr() % 16
    want = conv_bias.conv_bias_add_plain(y0, bias)
    conv_bias.conv_bias_add(y, bias)
    assert torch.equal(y, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float16", "float64", "bias_dtype",
                                 "strided"])
def test_conv_bias_kernel_rejects_what_it_does_not_take(cuda_device, bad):
    y, bias = _conv_output(cuda_device, torch.bfloat16)
    if bad in ("float16", "float64"):
        y, bias = y.to(getattr(torch, bad)), bias.to(getattr(torch, bad))
    elif bad == "bias_dtype":
        bias = bias.float()
    else:
        y = y.permute(0, 1, 3, 2)
    kernels.reset_launch_counts()
    with pytest.raises((TypeError, ValueError)):
        conv_bias.conv_bias_add(y, bias)
    assert kernels.launch_counts()["conv_bias_add"] == 0


def _tiny_vae(device, dtype):
    import dataclasses

    from humangaussian_torch.guidance import vae as port_vae

    torch.manual_seed(3)
    vae = port_vae.AutoencoderKL(dataclasses.replace(
        port_vae.tiny_vae_config(), dtype=dtype))
    with torch.no_grad():  # nonzero biases, so a dropped add would show
        for m in vae.modules():
            if isinstance(m, port_vae.BiasConv2d):
                m.bias.normal_()
    vae.to(device, memory_format=torch.channels_last)
    return vae.requires_grad_(False), port_vae


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vae_on_the_card_matches_the_library_bias_add(cuda_device, dtype,
                                                      monkeypatch):
    """A tiny VAE's encode, its input gradient and a decode with the bias
    kernel equal, bit for bit, the same module with every convolution's
    forward patched to F.conv2d with its bias; the kernel launches once a
    convolution run (none in the backward)."""
    import torch.nn.functional as F

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    vae, port_vae = _tiny_vae(cuda_device, dtype)
    gen = torch.Generator().manual_seed(4)
    img = (torch.rand((2, 16, 16, 3), generator=gen) * 2 - 1).to(cuda_device)
    cot = torch.randn((2, 8, 8, 8), generator=gen).to(cuda_device)
    z = torch.randn((2, 8, 8, 4), generator=gen).to(cuda_device)

    def run():
        x = img.clone().requires_grad_(True)
        mean, logvar = vae.encode(x)
        (torch.cat([mean, logvar], -1) * cot).sum().backward()
        with torch.no_grad():
            return mean, logvar, x.grad, vae.decode(z)

    convs = [m for m in vae.modules() if isinstance(m, port_vae.BiasConv2d)]
    n_encode = sum(isinstance(m, port_vae.BiasConv2d)
                   for m in vae.encoder.modules()) + 1  # quant_conv
    kernels.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["conv_bias_add"] == len(convs)
    assert len(convs) == n_encode + sum(
        isinstance(m, port_vae.BiasConv2d)
        for m in vae.decoder.modules()) + 1  # post_quant_conv
    for m in convs:
        monkeypatch.setattr(m, "forward", lambda x, m=m: F.conv2d(
            x, m.weight, m.bias, m.stride, m.padding, m.dilation, m.groups))
    want = run()
    for a, b, what in zip(got, want, ("mean", "logvar", "d / d image",
                                      "decode")):
        assert torch.isfinite(a).all(), what
        assert torch.equal(a, b), what


@pytest.mark.cuda
def test_vae_convolution_with_a_bias_that_requires_grad_raises(cuda_device):
    """The kernel gives the bias no gradient, so a trainable bias raises
    with grad enabled; frozen or under no_grad it runs."""
    vae, _ = _tiny_vae(cuda_device, torch.float32)
    conv = vae.encoder.conv_in
    x = torch.rand((1, 3, 8, 8), device=cuda_device).contiguous(
        memory_format=torch.channels_last)
    conv.bias.requires_grad_(True)
    with pytest.raises(RuntimeError, match="outside autograd"):
        conv(x)
    with torch.no_grad():
        y = conv(x)
    conv.bias.requires_grad_(False)
    assert torch.equal(conv(x), y)


@pytest.mark.cuda
def test_sdxl_unet_launches_k4_at_every_self_attention_site(cuda_device):
    """SDXL base 1.0's UNet at its published widths (seeded bfloat16
    weights), one sample on 128^2 latents: its 70 self-attention sites
    (10 at 4096 tokens, 60 at 1024) launch K4 70 times and the output is
    finite."""
    from humangaussian_torch.guidance.unet import SDXL_BASE_CONFIG, SingleUNet

    with torch.device("meta"):
        unet = SingleUNet(SDXL_BASE_CONFIG)
    unet.to_empty(device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    with torch.no_grad():
        for p in unet.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    unet.to(memory_format=torch.channels_last).requires_grad_(False)
    x = torch.randn((1, 128, 128, 4), generator=gen, device=cuda_device)
    text = torch.randn((1, 77, 2048), generator=gen, device=cuda_device)
    pooled = torch.randn((1, 1280), generator=gen, device=cuda_device)
    ids = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]],
                       device=cuda_device)
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = unet(x, torch.tensor([500], device=cuda_device), text,
                   text_embeds=pooled, time_ids=ids)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["attention_fwd"] == 70
    assert out.shape == (1, 128, 128, 4) and torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(8, 4096), (2, 16384)])
def test_vae_attention_kernels_match_attend(cuda_device, b, n):
    """The fused forward (one launch) and the backward (one logits pass a
    chunk) at SD2's and SDXL's token counts against autograd through the
    plain `attend`: output and the three gradients within 2^-6 of each
    one's largest entry (two bf16 ulps at the peak)."""
    from humangaussian_torch.guidance.vae import attend
    from humangaussian_torch.ops import vae_attention

    gen = torch.Generator(device=cuda_device).manual_seed(n + b)
    q, k, v, g = (torch.randn((b, n, 512), generator=gen, device=cuda_device)
                  .to(torch.bfloat16) for _ in range(4))
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    kernels.reset_launch_counts()
    out = vae_attention.vae_attention(*xs)
    out.backward(g)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["vae_attention_fwd"] == 1
    assert counts["vae_attention_bwd"] == -(-b // vae_attention.backward_chunk(
        b, n))
    rs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = attend(*rs)
    ref.backward(g)
    for got, want in zip((out.detach(), *(x.grad for x in xs)),
                         (ref.detach(), *(x.grad for x in rs))):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2.0 ** -6 * float(want.float().abs().max())


@pytest.mark.cuda
def test_vae_attention_keeps_the_plain_paths_precision(cuda_device):
    """Against a float64 oracle on the same bf16 inputs (1 x 4096 x 512),
    the kernels' relative error (Frobenius) in out, dq, dk and dv is at
    most 1.1 times that of autograd through the plain `attend`."""
    from humangaussian_torch.guidance.vae import attend
    from humangaussian_torch.ops import vae_attention

    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v, g = (torch.randn((1, 4096, 512), generator=gen,
                              device=cuda_device).to(torch.bfloat16)
                  for _ in range(4))
    xd = [x.double().requires_grad_(True) for x in (q, k, v)]
    logits = xd[0] @ xd[1].transpose(1, 2) / math.sqrt(512)
    oracle = torch.softmax(logits, -1) @ xd[2]
    oracle.backward(g.double())
    want = (oracle.detach(), *(x.grad for x in xd))

    def errors(fn):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*xs)
        out.backward(g)
        return [float((a.double() - w).norm() / w.norm())
                for a, w in zip((out, *(x.grad for x in xs)), want)]

    fused, plain = errors(vae_attention.vae_attention), errors(attend)
    for name, f, p in zip(("out", "dq", "dk", "dv"), fused, plain):
        assert f <= 1.1 * p, (name, f, p)


_DETERMINISTIC_BACKWARD = """
import sys, torch
from humangaussian_torch import kernels
from humangaussian_torch.ops import vae_attention
torch.use_deterministic_algorithms(True)
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(11)
q, k, v, g = (torch.randn((2, 16384, 512), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(4))

def grads():
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = vae_attention.vae_attention(*xs)
    out.backward(g)
    return [out.detach()] + [x.grad for x in xs]

a, b = grads(), grads()
torch.cuda.synchronize()
assert kernels.launch_counts()["vae_attention_bwd"] == 4
assert all(torch.equal(x, y) for x, y in zip(a, b)), "backwards differ"
print("bit-equal")
"""


@pytest.mark.cuda
def test_vae_attention_backward_repeats_bit_for_bit(cuda_device):
    """Two forwards and backwards at (2, 16384, 512) bit-equal with torch's
    deterministic algorithms on, strict (in a process that sets cuBLAS's
    workspace before it starts, as chip_smoke.py does)."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _DETERMINISTIC_BACKWARD],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "bit-equal" in proc.stdout


@pytest.mark.cuda
def test_vae_attention_dispatch_takes_the_fused_kernels(cuda_device,
                                                        monkeypatch):
    """The bf16 `AttnBlock(512, 32)` on the card at SD2's and SDXL's token
    counts (batch 8 at 64^2 and 128^2) launches the fused forward once a
    forward and never calls `chunked_attention` or `attend`; on one
    16,384-token image its output and input gradient match the plain path's
    (the gate closed) within bfloat16 rounding."""
    from humangaussian_torch.guidance import vae as port_vae
    from humangaussian_torch.ops import vae_attention

    torch.manual_seed(0)
    blk = port_vae.AttnBlock(512, 32).to(cuda_device, torch.bfloat16)
    blk.requires_grad_(False)
    calls = []

    def spy(name, own):
        def fn(*args):
            calls.append(name)
            return own(*args)
        return fn

    monkeypatch.setattr(port_vae, "chunked_attention",
                        spy("chunked", port_vae.chunked_attention))
    monkeypatch.setattr(port_vae, "attend", spy("attend", port_vae.attend))

    def image(b, s):
        return torch.randn((b, 512, s, s), device=cuda_device,
                           dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last)

    kernels.reset_launch_counts()
    with torch.no_grad():
        blk(image(8, 64))
        blk(image(8, 128))
    assert kernels.launch_counts()["vae_attention_fwd"] == 2
    assert calls == []
    x0, cot = image(1, 128), image(1, 128)

    def run():
        x = x0.clone().requires_grad_(True)
        y = blk(x)
        (y.float() * cot.float()).sum().backward()
        return y.detach().float(), x.grad.float()

    fused = run()
    assert calls == [] and kernels.launch_counts()["vae_attention_bwd"] == 1
    monkeypatch.setattr(vae_attention, "kernel_applies", lambda q: False)
    plain = run()
    assert calls == ["chunked"] or calls == ["attend"]
    for a, b in zip(fused, plain):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2 * float(
            b.abs().max()))