"""The port's kernel plumbing: import isolation, wrapper checks, and K1 and
K2 against their plain versions on a card.

The kernel-vs-plain tests need an NVIDIA GPU (marker `cuda`) and skip
without one; on the card they hold K1 to `composite_plain` at 1e-4 absolute
on image and alpha and 1e-3 on depth, with at most 1e-4 of the pixels
allowed past that (the 1e-4 saturation knife-edge and exp rounding), and
K2 to `composite_backward_plain` at 1e-4 of each column's max-|grad|, with
at most 1e-3 of the rows past that (a pair flipped at the knife-edge moves
a row by its whole contribution; atomics sum in no fixed order).
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
    composite_backward_plain,
    composite_plain,
)
from port_parity_torch import random_composite_args

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Import every humangaussian_torch module (and chip_smoke.py) in a
    fresh interpreter: neither jax nor humangaussian_tpu may load."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import humangaussian_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'humangaussian_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'flax' or m.startswith('humangaussian_tpu')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 29, names\n"
        "for n in ('train.photo', 'train.optim', 'densify', 'losses', "
        "'config', 'ops.knn', 'data.photo', 'apps.launch'):\n"
        "    assert 'humangaussian_torch.' + n in names, n\n"
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
    assert kernels.launch_counts() == {"rasterize_fwd": 0, "rasterize_bwd": 0}


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


@pytest.mark.parametrize("kernel,stem", [
    (kernels.RASTERIZE_FWD, "rasterize_fwd"),
    (kernels.RASTERIZE_BWD, "rasterize_bwd"),
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


@pytest.mark.cuda
@pytest.mark.parametrize("cams", [1, 3])
def test_kernel_matches_plain(cuda_device, cams):
    args = random_composite_args(device=cuda_device, cams=cams, tiles_x=3, tiles_y=2,
                   n=400, pairs_per_tile=300)
    kernels.reset_launch_counts()
    out = composite(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rasterize_fwd"] == 1
    ref = composite_plain(*args)
    for key, atol in (("image", 1e-4), ("alpha", 1e-4), ("depth", 1e-3)):
        err = (out[key] - ref[key]).abs()
        if err.dim() == 4:
            err = err.amax(dim=-1)
        assert int((err > atol).sum()) <= max(1, err.numel() // 10000), key
    assert torch.isfinite(out["image"]).all()


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
    assert kernels.launch_counts() == {"rasterize_fwd": 1, "rasterize_bwd": 1}
    plain = composite_plain(*args)
    want = composite_backward_plain(*args[:5], plain, cot, *args[5:])
    assert torch.isfinite(got).all()
    for j in range(10):
        scale = float(want[:, j].abs().max())
        err = (got[:, j] - want[:, j]).abs() / scale
        assert int((err > 1e-4).sum()) <= max(1, err.numel() // 1000), j
