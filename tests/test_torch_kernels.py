"""The port's kernel plumbing: import isolation, K1 wrapper checks, and K1
against its plain version on a card.

The kernel-vs-plain test needs an NVIDIA GPU (marker `cuda`) and skips
without one; on the card it holds K1 to `composite_plain` at 1e-4 absolute
on image and alpha and 1e-3 on depth, with at most 1e-4 of the pixels
allowed past that (the 1e-4 saturation knife-edge and exp rounding).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from humangaussian_torch import kernels
from humangaussian_torch.ops.projection import RasterizeConfig
from humangaussian_torch.ops.rasterize_tiled import composite, composite_plain

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
        "assert len(names) >= 20, names\n"
        "print('ok', len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _inputs(device="cpu", seed=0, tiles_x=2, tiles_y=2, cams=1, n=64,
            pairs_per_tile=40):
    rng = np.random.RandomState(seed)
    tile = 32
    w, h = tiles_x * tile, tiles_y * tile
    feats = np.zeros((cams * n, 10), np.float32)
    feats[:, 0] = rng.rand(cams * n) * w
    feats[:, 1] = rng.rand(cams * n) * h
    feats[:, 2] = rng.rand(cams * n) * 0.05 + 0.01
    feats[:, 3] = (rng.rand(cams * n) - 0.5) * 0.01
    feats[:, 4] = rng.rand(cams * n) * 0.05 + 0.01
    feats[:, 5:8] = rng.rand(cams * n, 3)
    feats[:, 8] = rng.rand(cams * n) * 0.9 + 0.05
    feats[:, 9] = rng.rand(cams * n) * 3 + 0.5
    tiles = tiles_x * tiles_y * cams
    gids, starts, counts = [], [], []
    for t in range(tiles):
        cam = t // (tiles_x * tiles_y)
        ids = cam * n + rng.choice(n, pairs_per_tile, replace=False)
        ids = ids[np.argsort(feats[ids, 9], kind="stable")]
        starts.append(len(gids))
        counts.append(len(ids))
        gids.extend(ids.tolist())

    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return (t(feats, torch.float32), t(gids, torch.int32),
            t(starts, torch.int32), t(counts, torch.int32),
            t([0.2, 0.3, 0.4], torch.float32), tiles_x, tiles_y)


def test_cpu_takes_plain_and_does_not_count():
    args = _inputs()
    kernels.reset_launch_counts()
    out = composite(*args)
    assert kernels.launch_counts() == {"rasterize_fwd": 0}
    assert out["image"].shape == (1, 64, 64, 3)
    ref = composite_plain(*args)
    np.testing.assert_array_equal(out["image"].numpy(), ref["image"].numpy())


@pytest.mark.parametrize("bad", [
    "feats_dtype", "gids_dtype", "starts_len", "feats_width",
    "noncontig", "background", "tiles", "not_tensor",
])
def test_wrapper_rejects_bad_arguments(bad):
    feats, gids, starts, counts, bg, tx, ty = _inputs()
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
    args = _inputs(device="meta")
    with pytest.raises(ValueError, match="no compositing kernel"):
        composite(*args)
    with pytest.raises(ValueError, match="built for tile 32"):
        composite(*args, cfg=RasterizeConfig(tile=16))


def test_kernel_build_naming():
    lib = kernels.RASTERIZE_FWD.library_path()
    assert lib.parent == kernels.BUILD_DIR
    assert lib.name.startswith("rasterize_fwd-") and lib.suffix == ".so"
    assert kernels.RASTERIZE_FWD.source.exists()
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
    args = _inputs(device=cuda_device, cams=cams, tiles_x=3, tiles_y=2,
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
