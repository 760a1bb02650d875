"""PyTorch / CUDA port of humangaussian_tpu for NVIDIA Hopper (sm_90a).

The package mirrors the JAX package's module layout (`core/`, `ops/`,
`guidance/`, `smplx/`, `data/`, `train/`, `io/`, `utils/`, `apps/`); each
module's docstring names its JAX counterpart and the TPU-only mechanics it
dropped. It imports torch, numpy and scipy only, never JAX or the JAX
package.

Entry points create their tensors on `device="cuda"` unless the caller asks
for the CPU. On a CUDA tensor every ported kernel launches its hand-written
Hopper kernel (see `humangaussian_torch.kernels`); on a CPU tensor it runs
the kernel's plain PyTorch version, which is what the CPU tests exercise.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or --device cpu) to run on the CPU"
        )
    return dev
