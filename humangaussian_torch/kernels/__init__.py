"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one plain C entry point of a `.cu` file under
`humangaussian_torch/csrc/` (a source may hold several). At first use the
source is compiled by `nvcc` for `sm_90a` into a shared library under
`<repo>/build/kernels/` (named by the source and a hash of it, the `.cuh`
headers beside it and the flags, so an edited source or header rebuilds)
and loaded with ctypes. Building or loading
raises on failure; nothing falls back to a plain version.

Every `Kernel` keeps `launches`, a plain integer that its `launch` adds one
to after each successful launch, so a run can show that its path went
through the kernel (`reset_launch_counts`, `launch_counts`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    root = os.environ.get("CUDA_HOME")
    if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
        return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (set CUDA_HOME); CUDA kernels cannot be built")


class Kernel:
    """One C entry point `symbol(argtypes) -> int` of a CUDA source; it
    returns `cudaGetLastError()` after its launch."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._fn = None

    def library_path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            digest.update(header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{digest.hexdigest()[:12]}.so"

    def build(self) -> Path:
        """Compile the source unless its library exists; returns its path."""
        lib = self.library_path()
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        self.build_log = proc.stdout
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed for {self.source.name}:\n{proc.stdout}")
        os.replace(tmp, lib)
        return lib

    def function(self):
        """The loaded C entry point (builds at first use)."""
        if self._fn is None:
            fn = getattr(ctypes.CDLL(str(self.build())), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self.function()(*args)
        if rc != 0:
            raise RuntimeError(
                f"kernel {self.name} failed to launch: cudaError {rc}"
            )
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong

RASTERIZE_FWD = Kernel(
    "rasterize_fwd", "rasterize_fwd.cu", "hg_rasterize_fwd",
    # feats, gids, starts, counts, background, num_blocks, tiles_x,
    # tiles_y, alpha_min, alpha_max, t_eps, image, depth, alpha,
    # final_t, n_contrib, stream
    [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _P, _P, _P, _P, _P],
)

RASTERIZE_BWD = Kernel(
    "rasterize_bwd", "rasterize_bwd.cu", "hg_rasterize_bwd",
    # feats, gids, starts, counts, num_blocks, tiles_x, tiles_y, alpha_min,
    # alpha_max, t_eps, image, depth, final_t, n_contrib, g_image, g_depth,
    # g_alpha, rows, mask, stream
    [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P,
     _P, _P],
)

RASTERIZE_BWD_ROWS = Kernel(
    "rasterize_bwd_rows", "rasterize_bwd.cu", "hg_rasterize_bwd_rows",
    # rows, mask, cand_pos, row_starts, feats, n_rows, dfeats, stream
    [_P, _P, _P, _P, _P, _I, _P, _P],
)

GROUPNORM_FWD = Kernel(
    "groupnorm_fwd", "groupnorm_fwd.cu", "hg_groupnorm_fwd",
    # x, sums_in, gamma, beta, samples, rows, channels, groups, eps,
    # is_bf16, silu, mode, block_vectors, splits, blocks, vector, y,
    # sums_out, partials, partial_floats, sync, sync_words, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _I, _P,
     _P, _P, _LL, _P, _LL, _P],
)

GROUPNORM_BWD_STATS = Kernel(
    "groupnorm_bwd_stats", "groupnorm_stats.cu", "hg_groupnorm_bwd_stats",
    # x, dz, fwd_sums, gamma, beta, samples, rows, channels, groups, eps,
    # is_bf16, silu, splits, blocks, vector, out, partials, partial_floats,
    # sync, sync_words, stream
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P, _P,
     _LL, _P, _LL, _P],
)

GROUPNORM_BWD_DX = Kernel(
    "groupnorm_bwd_dx", "groupnorm_bwd_dx.cu", "hg_groupnorm_bwd_dx",
    # x, dz, fwd_sums, gamma, beta, sums, samples, rows, channels, groups,
    # eps, is_bf16, silu, dx, stream
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P, _P],
)

ATTENTION_FWD = Kernel(
    "attention_fwd", "attention_fwd.cu", "hg_attention_fwd",
    # q, k, v, out, batch, seq_q, seq_k, heads, scale, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
)

KERNELS = (RASTERIZE_FWD, RASTERIZE_BWD, RASTERIZE_BWD_ROWS, GROUPNORM_FWD,
           GROUPNORM_BWD_STATS, GROUPNORM_BWD_DX, ATTENTION_FWD)


def build_all() -> None:
    """Build every kernel, one nvcc process per source, all started
    together, then load them."""
    per_source = {k.source: k for k in KERNELS}.values()
    with ThreadPoolExecutor(max_workers=len(per_source)) as pool:
        list(pool.map(Kernel.build, per_source))
    for k in KERNELS:
        k.function()


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}
