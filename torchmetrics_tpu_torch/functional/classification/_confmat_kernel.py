"""Confusion-matrix counts for large class counts: the CUDA kernel, its plain version, its launch count.

Replaces the TPU kernel
``torchmetrics_tpu/functional/classification/_pallas_confmat.py::confusion_matrix_pallas``
(body ``_confmat_kernel``). The kernel is ``torchmetrics_tpu_torch/csrc/confmat.cu``: a
grid-stride histogram with one atomic add per valid row into the ``(C, C)``
matrix, which stays resident in the H100's 50 MB L2. No ``(N, C)`` one-hot
reaches device memory, as on the TPU.

What bounds it: device-memory bytes. It reads ``N * (2 * index_bytes + weight_bytes)``
and writes ``C * C * 4``, at 3.35 TB/s on an H100 SXM. At ImageNet batch size
(N=1024, C=1000) the inputs are 12 KB and the 4 MB output dominates: zeroing
it, and the caller's ``state += update``, move more bytes than the kernel
reads. Accumulating straight into the metric state is left for later work.

The library is built with ``nvcc`` at first use from the source in this
package into ``torchmetrics_tpu_torch/_build/`` and loaded with ``ctypes``
(``utilities/nvcc.py``); ``nvcc`` and ``ctypes`` are only touched then, so
this module imports where there is no CUDA toolkit. :func:`confusion_matrix_cuda`
takes the plain version only for CPU tensors; on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities import nvcc
from torchmetrics_tpu_torch.utilities.data import _one_hot

SOURCE = nvcc.CSRC_DIR / "confmat.cu"

_IDX_KINDS = {torch.int32: 0, torch.int64: 1}
_WEIGHT_NONE, _WEIGHT_MASK, _WEIGHT_FLOAT = 0, 1, 2
_BLOCKS_PER_SM = 8
# rows per one-hot product in the plain version: bounds its (rows, C) float
# one-hots, and keeps each partial count below 2**24, where float32 is exact
_PLAIN_CHUNK = 1 << 20


def _check_inputs(preds: Tensor, target: Tensor, num_classes: int, weights: Optional[Tensor]) -> None:
    if not isinstance(num_classes, int) or num_classes < 1:
        raise ValueError(f"`num_classes` must be a positive int, got {num_classes!r}")
    if preds.ndim != 1 or target.shape != preds.shape:
        raise ValueError(f"`preds` and `target` must be 1-D of one length, got {tuple(preds.shape)} and {tuple(target.shape)}")
    if preds.dtype not in _IDX_KINDS or target.dtype != preds.dtype:
        raise TypeError(f"`preds` and `target` must both be int32 or both int64, got {preds.dtype} and {target.dtype}")
    if target.device != preds.device:
        raise ValueError(f"`preds` and `target` lie on {preds.device} and {target.device}")
    if weights is not None:
        if weights.shape != preds.shape:
            raise ValueError(f"`weights` must have shape {tuple(preds.shape)}, got {tuple(weights.shape)}")
        if weights.dtype not in (torch.bool, torch.float32):
            raise TypeError(f"`weights` must be a bool mask or float32, got {weights.dtype}")
        if weights.device != preds.device:
            raise ValueError(f"`weights` lies on {weights.device}, the labels on {preds.device}")


def _out_dtype(weights: Optional[Tensor]) -> torch.dtype:
    return torch.float32 if weights is not None and weights.dtype == torch.float32 else torch.int32


def confusion_matrix_plain(
    preds: Tensor, target: Tensor, num_classes: int, weights: Optional[Tensor] = None
) -> Tensor:
    """``(C, C)`` matrix, rows=target and cols=preds, as masked one-hot products in PyTorch.

    No weights or a bool mask give int32 counts; float32 weights give float32
    sums. A row whose label lies outside ``[0, C)`` adds nothing.
    """
    _check_inputs(preds, target, num_classes, weights)
    out = torch.zeros((num_classes, num_classes), dtype=_out_dtype(weights), device=preds.device)
    for start in range(0, preds.shape[0], _PLAIN_CHUNK):
        rows = slice(start, start + _PLAIN_CHUNK)
        t_oh = _one_hot(target[rows], num_classes, torch.float32)
        if weights is not None:
            t_oh = t_oh * weights[rows, None].to(torch.float32)
        part = torch.einsum("nc,nd->cd", t_oh, _one_hot(preds[rows], num_classes, torch.float32))
        out += part.to(out.dtype)
    return out


def confusion_matrix_cuda(
    preds: Tensor, target: Tensor, num_classes: int, weights: Optional[Tensor] = None
) -> Tensor:
    """``(C, C)`` matrix, rows=target and cols=preds; the signature of ``confusion_matrix_pallas``.

    ``preds``/``target``: 1-D int32 or int64 labels of one dtype. ``weights``:
    None or a bool mask (int32 counts), or float32 weights (float32 sums).
    CUDA tensors must be contiguous; the kernel runs on the current stream
    and is not waited for. CPU tensors take :func:`confusion_matrix_plain`.
    """
    _check_inputs(preds, target, num_classes, weights)
    if preds.device.type == "cpu":
        return confusion_matrix_plain(preds, target, num_classes, weights)
    if preds.device.type != "cuda":
        raise ValueError(f"confusion_matrix_cuda takes CUDA or CPU tensors, got {preds.device}")
    for name, x in (("preds", preds), ("target", target), ("weights", weights)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"`{name}` must be contiguous")
    if weights is None:
        weight_kind = _WEIGHT_NONE
    else:
        weight_kind = _WEIGHT_MASK if weights.dtype == torch.bool else _WEIGHT_FLOAT
    out = torch.zeros((num_classes, num_classes), dtype=_out_dtype(weights), device=preds.device)
    n = preds.shape[0]
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(preds.device):
        err = lib.tm_confmat(
            preds.data_ptr(),
            target.data_ptr(),
            None if weights is None else weights.data_ptr(),
            n,
            num_classes,
            _IDX_KINDS[preds.dtype],
            weight_kind,
            out.data_ptr(),
            _max_blocks(preds.device.index),
            torch.cuda.current_stream(preds.device).cuda_stream,
        )
    nvcc.raise_on_error(lib, err, "confmat")
    confusion_matrix_cuda.launches += 1
    return out


confusion_matrix_cuda.launches = 0  # type: ignore[attr-defined]


@functools.cache
def _max_blocks(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count * _BLOCKS_PER_SM


@functools.cache
def _library() -> Any:
    import ctypes

    lib = nvcc.load(SOURCE)
    lib.tm_confmat.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.tm_confmat.restype = ctypes.c_int
    return lib
