"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one `.cu` file under `humangaussian_torch/csrc/` with a plain
C entry point. At first use it is compiled by `nvcc` for `sm_90a` into a
shared library under `<repo>/build/kernels/` (named by a hash of the source
and flags, so an edited source rebuilds) and loaded with ctypes. Building or
loading raises on failure; nothing falls back to a plain version.

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
    """One CUDA source with one C entry point `symbol(argtypes) -> int`,
    which returns `cudaGetLastError()` after its launch."""

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
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{digest.hexdigest()[:12]}.so"

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

RASTERIZE_FWD = Kernel(
    "rasterize_fwd", "rasterize_fwd.cu", "hg_rasterize_fwd",
    # feats, gids, starts, counts, background, num_blocks, tiles_x,
    # tiles_y, alpha_min, alpha_max, t_eps, image, depth, alpha,
    # final_t, n_contrib, stream
    [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _P, _P, _P, _P, _P],
)

KERNELS = (RASTERIZE_FWD,)


def build_all() -> None:
    """Build and load every kernel."""
    for k in KERNELS:
        k.function()


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}
