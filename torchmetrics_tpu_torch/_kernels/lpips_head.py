"""Fused LPIPS head: unit-normalise, weighted squared difference, spatial mean, as one CUDA kernel.

Port of ``torchmetrics_tpu/_kernels/lpips_head.py``. Per pixel the LPIPS
``lin`` head is the scalar

    sum_c  w_c * (f0_c / (||f0|| + eps)  -  f1_c / (||f1|| + eps))^2

and the tap's distance is its mean over the pixels. The oracle graph
(:func:`lpips_head_plain`) writes four full feature maps to get there; kernel
B3 (``torchmetrics_tpu_torch/csrc/lpips_head.cu``) reads both maps once and
writes only the ``(B,)`` result. :func:`lpips_head` takes the plain version
only for CPU tensors; on CUDA tensors it launches the kernel or raises, and
counts its launches in ``lpips_head.launches``.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch import Tensor

from torchmetrics_tpu_torch._kernels.conv_epilogue import KernelCost, _cuda_or_cpu
from torchmetrics_tpu_torch.utilities import nvcc
from torchmetrics_tpu_torch.utilities.compute import full_fp32

__all__ = ["lpips_head", "lpips_head_cost", "lpips_head_plain"]

SOURCE = nvcc.CSRC_DIR / "lpips_head.cu"
_EPS = 1e-10  # image/_lpips.py _normalize_tensor
_PIXELS_PER_BLOCK = 64  # 8 warps, 8 pixels each


def _prepare(f0: Tensor, f1: Tensor, weight: Tensor):
    if f0.ndim != 4 or f1.shape != f0.shape:
        raise ValueError(f"lpips_head: features must be two (B, H, W, C) maps of one shape, got {f0.shape}, {f1.shape}")
    if weight.numel() != f0.shape[-1]:
        raise ValueError(f"lpips_head: weight has {weight.numel()} entries for {f0.shape[-1]} channels")
    return f0.float(), f1.float(), weight.reshape(-1).float()


def _normalize(x: Tensor) -> Tensor:
    return x / (torch.sqrt(torch.sum(x**2, dim=-1, keepdim=True)) + _EPS)


def lpips_head_plain(f0: Tensor, f1: Tensor, weight: Tensor) -> Tensor:
    """The oracle chain in float32: normalise, subtract, square, 1x1 conv, mean over H and W."""
    f0, f1, w = _prepare(f0, f1, weight)
    d = (_normalize(f0) - _normalize(f1)) ** 2
    with full_fp32():
        lin = d @ w  # the 1x1 conv to one output channel
    return lin.mean(dim=(1, 2))


def lpips_head(f0: Tensor, f1: Tensor, weight: Tensor) -> Tensor:
    """Kernel B3: the ``(B,)`` LPIPS distance of one tap, accumulated in float32.

    ``f0``, ``f1``: ``(B, H, W, C)`` features (the JAX package's layout; the
    ``permute(0, 2, 3, 1)`` view of a channels_last NCHW map), cast to float32
    if they are not. ``weight``: the head's ``C`` weights in any shape
    (flax's ``(1, 1, C, 1)``, torch's ``(1, C, 1, 1)`` or flat).
    """
    f0, f1, w = _prepare(f0, f1, weight)
    if not _cuda_or_cpu("lpips_head", f0, f1, w):
        return lpips_head_plain(f0, f1, w)
    if not (f0.is_contiguous() and f1.is_contiguous()):
        raise ValueError("lpips_head: features must be contiguous (B, H, W, C) maps")
    b, h, wd, c = f0.shape
    w = w.contiguous()
    out = torch.zeros(b, dtype=torch.float32, device=f0.device)
    if b == 0 or h * wd == 0:
        return out / (h * wd)
    with torch.cuda.device(f0.device):
        err = _library().tm_lpips_head(
            f0.data_ptr(), f1.data_ptr(), w.data_ptr(), out.data_ptr(), b, h * wd, c, _PIXELS_PER_BLOCK,
            torch.cuda.current_stream(f0.device).cuda_stream,
        )
    nvcc.raise_on_error(_library(), err, "lpips_head")
    lpips_head.launches += 1
    return out.div_(h * wd)


lpips_head.launches = 0  # type: ignore[attr-defined]


@functools.cache
def _library() -> Any:
    import ctypes

    lib = nvcc.load(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.tm_lpips_head.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i64, ptr]
    lib.tm_lpips_head.restype = ctypes.c_int
    return lib


def lpips_head_cost(f0: Tensor, f1: Tensor, weight: Tensor) -> KernelCost:
    """Closed-form operations and bytes (the JAX package's ``lpips_head_cost``): float32 maps read once."""
    n, h, w, c = f0.shape
    pixels = n * h * w
    # per pixel: 2 norms (2C mul-add + sqrt) + 2 scale + diff + square + weighted sum
    flops = float(pixels) * (8.0 * c + 16.0)
    return KernelCost(flops=flops, bytes_accessed=4.0 * (2.0 * pixels * c + c + n))
