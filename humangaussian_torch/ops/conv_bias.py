"""The bias add after a convolution, with a hand-written kernel.

PyTorch's cuDNN path runs a convolution without its bias and then adds the
bias with `out.add_(bias.view(1, C, 1, 1))`. On a `channels_last`
bfloat16 output that add runs in aten's generic elementwise kernel, at
about a third of the card's bandwidth. `conv_bias_add(y, bias)` is the
same add in place, as one launch of csrc/conv_bias.cu for a CUDA tensor
(bit for bit aten's result: float(y) + float(bias[c]) rounded once to y's
type) and `conv_bias_add_plain` for a CPU tensor; nothing else decides,
and nothing falls back from the kernel to the plain version.

The kernel writes through the data pointer, outside autograd: a caller
adds the bias to a fresh convolution output that no operation has saved,
so the gradient of y + bias with respect to y is the identity it already
has (guidance/vae.py's convolutions). It replaces no kernel of the JAX
package, whose XLA convolutions fuse their bias.
"""
from __future__ import annotations

import torch

from humangaussian_torch.kernels import CONV_BIAS_ADD

_DTYPES = (torch.bfloat16, torch.float32)


def conv_bias_add_plain(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """y += bias over the channels of [B, C, H, W], in place (aten)."""
    return y.add_(bias.view(1, -1, 1, 1))


def conv_bias_add(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """y += bias over the channels of y [B, C, H, W] (`channels_last` or
    contiguous, bfloat16 or float32; bias [C] of y's type), in place;
    returns y. One pass of checks and one ctypes call; the C side makes
    y's card current for the launch, so no device guard is needed here."""
    if y.is_cpu:
        return conv_bias_add_plain(y, bias)
    dtype = y.dtype
    if dtype not in _DTYPES or bias.dtype is not dtype:
        raise TypeError(
            f"the conv bias kernel takes bfloat16 or float32 y and a bias of "
            f"its type, got {dtype} and {bias.dtype}")
    shape = y.shape
    if (len(shape) != 4 or bias.shape != shape[1:2] or bias.stride() != (1,)
            or bias.get_device() != y.get_device()):
        raise ValueError(
            f"the conv bias kernel takes y [B, C, H, W] and a contiguous "
            f"bias [C] on y's device, got {tuple(shape)} on {y.device} and "
            f"{tuple(bias.shape)} on {bias.device}")
    if y.is_contiguous(memory_format=torch.channels_last):
        inner = 1
    elif y.is_contiguous():
        inner = shape[2] * shape[3]
    else:
        raise ValueError(
            f"the conv bias kernel takes a channels_last or contiguous y, got "
            f"strides {y.stride()}")
    if not y.is_cuda:
        raise ValueError(f"no conv bias kernel for device {y.device}")
    device = y.get_device()
    CONV_BIAS_ADD.launch(y.data_ptr(), bias.data_ptr(), y.numel(), shape[1],
                         inner, dtype is torch.bfloat16, device,
                         torch._C._cuda_getCurrentRawStream(device))
    return y
