"""Confusion-matrix counts for large class counts: the CUDA kernel, its plain version, its launch count.

Replaces the TPU kernel
``torchmetrics_tpu/functional/classification/_pallas_confmat.py::confusion_matrix_pallas``
(body ``_confmat_kernel``). The kernel is ``torchmetrics_tpu_torch/csrc/confmat.cu``: a
histogram that reads 8 rows a thread with 16-byte loads, counts the diagonal
cells in each block's shared memory, merges runs of one cell within a thread
and across a warp, and adds into the ``(C, C)`` matrix in the H100's 50 MB L2.
No ``(N, C)`` one-hot reaches device memory, as on the TPU.

What bounds it: device-memory bytes, ``N * (2 * index_bytes + weight_bytes)``
read. Given ``out=`` (a metric's state), it adds into that matrix, so nothing
zeroes or rewrites the whole ``C * C * 4`` bytes; without it the wrapper
zeroes a fresh matrix first.

The library is built with ``nvcc`` at first use from the source in this
package into ``torchmetrics_tpu_torch/_build/`` and loaded with ``ctypes``
(``utilities/nvcc.py``); ``nvcc`` and ``ctypes`` are only touched then, so
this module imports where there is no CUDA toolkit. :func:`confusion_matrix_cuda`
takes the plain version only for CPU tensors; on a CUDA tensor it launches
the kernel or raises.

Under ``torch.func.vmap`` (a ``StreamPool`` step runs each tenant's update
as one lane) the labels and the matrix are batched tensors, which have no
data pointer. There :func:`confusion_matrix_cuda` calls the custom op
``torchmetrics_tpu_torch::confmat_add_``, whose vmap rule counts the whole
micro-batch with one launch of :func:`confusion_matrix_lanes` (kernel
``tm_confmat_lanes``: one grid row per lane). The plain version vmaps by
itself: it counts with an out-of-place ``index_add`` there.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch._kernels.launch_counter import LaunchCounter
from torchmetrics_tpu_torch.utilities import nvcc
from torchmetrics_tpu_torch.utilities.checks import _in_compiled_step, _vmapped

SOURCE = nvcc.CSRC_DIR / "confmat.cu"

_IDX_KINDS = {torch.int32: 0, torch.int64: 1}
_WEIGHT_NONE, _WEIGHT_MASK, _WEIGHT_FLOAT = 0, 1, 2
_BLOCKS_PER_SM = 2  # of 512 threads: each block flushes up to C diagonal counters
_THREADS = 512  # csrc/confmat.cu kThreads
ROWS_PER_STEP = 8  # rows a thread loads at once
MAX_CLASSES = 46340  # the kernel's int32 cell indices: C * C < 2**31
_MAX_LANES = 65535  # the lane-batched kernel's grid rows, one a lane


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


def _check_out(out: Tensor, preds: Tensor, num_classes: int, weights: Optional[Tensor]) -> None:
    """``out=`` must be the contiguous ``(C, C)`` matrix of the output type, on the labels' device."""
    want = _out_dtype(weights)
    if out.shape != (num_classes, num_classes) or out.dtype != want:
        raise ValueError(f"`out` must be a ({num_classes}, {num_classes}) {want} matrix, got {tuple(out.shape)} {out.dtype}")
    if out.device != preds.device:
        raise ValueError(f"`out` lies on {out.device}, the labels on {preds.device}")
    if not out.is_contiguous():
        raise ValueError("`out` must be contiguous")


def vector_head(n: int, arrays) -> int:
    """Rows the kernel takes one at a time before its 16-byte loads: the first row at which every array is aligned.

    ``arrays``: ``(data_ptr, element_size)`` of the labels and weights (a
    16-byte load each) and of a bool mask (element size 1: one 8-byte load
    of 8 rows). Returns ``n`` where no row below 8 aligns them all.
    """
    for head in range(ROWS_PER_STEP):
        if all((ptr + head * size) % (8 if size == 1 else 16) == 0 for ptr, size in arrays):
            return min(head, n)
    return n


def confusion_matrix_plain(
    preds: Tensor, target: Tensor, num_classes: int, weights: Optional[Tensor] = None, out: Optional[Tensor] = None
) -> Tensor:
    """``(C, C)`` matrix, rows=target and cols=preds, as a ``bincount`` of ``target * C + preds`` in PyTorch.

    No weights or a bool mask give int32 counts, exact at any row count;
    float32 weights give float32 sums (added in float64, then rounded once).
    A row whose label lies outside ``[0, C)``, or that the mask drops, goes
    to a spare bin ``C * C`` that is thrown away. With ``out``, the counts
    are added into it and it is returned.

    Inside a compiled update step, and under ``torch.func.vmap``, the counts
    are an out-of-place ``index_add`` into zeros of the same ``C * C + 1``
    bins made from ``cells`` (so as batched as it is), int64 (or float64)
    and so exact, instead of ``bincount``: on a CUDA tensor ``bincount``
    reads its largest bin back to the host, which a CUDA graph cannot
    capture, and it has no batching rule. Both give the same integers, bit
    for bit.
    """
    _check_inputs(preds, target, num_classes, weights)
    if out is not None:
        _check_out(out, preds, num_classes, weights)
    spare = num_classes * num_classes
    counted = (target >= 0) & (target < num_classes) & (preds >= 0) & (preds < num_classes)
    if weights is not None and weights.dtype == torch.bool:
        counted &= weights
    cells = torch.where(counted, target.to(torch.int64) * num_classes + preds, spare)
    float_weights = None if weights is None or weights.dtype == torch.bool else weights.double()
    if _in_compiled_step() or _vmapped(cells):
        zeros = cells.new_zeros(spare + 1, dtype=torch.int64 if float_weights is None else torch.float64)
        ones = torch.ones((), dtype=torch.int64, device=cells.device).expand(cells.shape)
        sums = zeros.index_add(0, cells, ones if float_weights is None else float_weights)
    else:
        sums = torch.bincount(cells, weights=float_weights, minlength=spare + 1)
    counts = sums[:spare].reshape(num_classes, num_classes).to(_out_dtype(weights))
    if out is None:
        return counts
    out += counts
    return out


def confusion_matrix_lanes_plain(
    preds: Tensor, target: Tensor, num_classes: int, weights: Optional[Tensor] = None, out: Optional[Tensor] = None
) -> Tensor:
    """``(B, C, C)`` matrices of ``(B, N)`` labels, one per lane, in PyTorch: one ``bincount`` over ``B`` blocks of bins.

    Lane ``b``'s cells are offset by ``b * (C * C + 1)``, so each lane has
    its own spare bin; otherwise as :func:`confusion_matrix_plain`, bit for
    bit with a call per lane. With ``out`` (``(B, C, C)``) the counts are
    added into it.
    """
    lanes, n = _check_lanes(preds, target, num_classes, weights, out)
    spare = num_classes * num_classes
    counted = (target >= 0) & (target < num_classes) & (preds >= 0) & (preds < num_classes)
    if weights is not None and weights.dtype == torch.bool:
        counted &= weights
    cells = torch.where(counted, target.to(torch.int64) * num_classes + preds, spare)
    cells = cells + torch.arange(lanes, device=cells.device).unsqueeze(1) * (spare + 1)
    float_weights = None if weights is None or weights.dtype == torch.bool else weights.double().reshape(-1)
    sums = torch.bincount(cells.reshape(-1), weights=float_weights, minlength=lanes * (spare + 1))
    counts = sums.reshape(lanes, spare + 1)[:, :spare].reshape(lanes, num_classes, num_classes).to(_out_dtype(weights))
    if out is None:
        return counts
    out += counts
    return out


def _check_lanes(
    preds: Tensor, target: Tensor, num_classes: int, weights: Optional[Tensor], out: Optional[Tensor]
) -> tuple:
    """``(B, N)`` labels (and weights), a ``(B, C, C)`` ``out`` of the output type; returns ``(B, N)``."""
    if preds.ndim != 2:
        raise ValueError(f"lane-batched labels must be (lanes, rows), got {tuple(preds.shape)}")
    lanes, n = preds.shape
    _check_inputs(preds.reshape(-1), target.reshape(-1), num_classes, None if weights is None else weights.reshape(-1))
    if target.shape != preds.shape or (weights is not None and weights.shape != preds.shape):
        raise ValueError(f"lane-batched labels and weights must share the shape {tuple(preds.shape)}")
    if out is not None:
        want = _out_dtype(weights)
        if out.shape != (lanes, num_classes, num_classes) or out.dtype != want:
            raise ValueError(
                f"`out` must be a ({lanes}, {num_classes}, {num_classes}) {want} tensor, got {tuple(out.shape)} {out.dtype}"
            )
        if out.device != preds.device:
            raise ValueError(f"`out` lies on {out.device}, the labels on {preds.device}")
    return lanes, n


def confusion_matrix_lanes(
    preds: Tensor, target: Tensor, num_classes: int, weights: Optional[Tensor] = None, out: Optional[Tensor] = None
) -> Tensor:
    """``(B, C, C)`` matrices of ``(B, N)`` labels in one launch: B1 across the lanes of a pool's micro-batch.

    Lane ``b`` counts rows ``preds[b]``, ``target[b]`` (and ``weights[b]``)
    into ``out[b]``, as :func:`confusion_matrix_cuda` counts one matrix.
    ``out``: a ``(B, C, C)`` tensor of the output type on the labels' device
    (a pool's gathered lanes), into which the counts are added; without it a
    fresh zeroed one is returned. CPU tensors take
    :func:`confusion_matrix_lanes_plain`; CUDA tensors launch
    ``tm_confmat_lanes`` once, whatever ``B``, or raise. Non-contiguous
    inputs are copied contiguous first, and a non-contiguous ``out`` gets
    the counts through a contiguous copy.
    """
    lanes, n = _check_lanes(preds, target, num_classes, weights, out)
    if preds.device.type == "cpu":
        return confusion_matrix_lanes_plain(preds, target, num_classes, weights, out)
    if preds.device.type != "cuda":
        raise ValueError(f"confusion_matrix_lanes takes CUDA or CPU tensors, got {preds.device}")
    if num_classes > MAX_CLASSES:
        raise ValueError(f"confusion_matrix_lanes counts up to {MAX_CLASSES} classes on a GPU, got {num_classes}")
    if lanes > _MAX_LANES:
        raise ValueError(f"confusion_matrix_lanes takes up to {_MAX_LANES} lanes a launch, got {lanes}")
    if out is None:
        out = torch.zeros((lanes, num_classes, num_classes), dtype=_out_dtype(weights), device=preds.device)
    if lanes == 0 or n == 0:
        return out
    preds, target = preds.contiguous(), target.contiguous()
    weights = None if weights is None else weights.contiguous()
    dest = out if out.is_contiguous() else out.contiguous()
    if weights is None:
        weight_kind = _WEIGHT_NONE
    else:
        weight_kind = _WEIGHT_MASK if weights.dtype == torch.bool else _WEIGHT_FLOAT
    steps = -(-n // ROWS_PER_STEP)
    blocks = max(1, min(-(-_max_blocks(preds.device.index) // lanes), -(-steps // _THREADS)))
    lib = _library()
    with torch.cuda.device(preds.device):
        err = lib.tm_confmat_lanes(
            preds.data_ptr(),
            target.data_ptr(),
            None if weights is None else weights.data_ptr(),
            lanes,
            n,
            num_classes,
            _IDX_KINDS[preds.dtype],
            weight_kind,
            dest.data_ptr(),
            blocks,
            torch.cuda.current_stream(preds.device).cuda_stream,
        )
    nvcc.raise_on_error(lib, err, "confmat_lanes")
    confusion_matrix_lanes.launches.hit(preds.device)
    if dest is not out:
        out.copy_(dest)
    return out


confusion_matrix_lanes.launches = LaunchCounter(SOURCE)  # type: ignore[attr-defined]


def _lanes_rule(info: Any, in_dims: tuple, preds: Tensor, target: Tensor, weights: Optional[Tensor], num_classes: int,
                out: Tensor) -> tuple:
    """The vmap rule of ``confmat_add_``: every lane's counts in one :func:`confusion_matrix_lanes` call.

    The labels (and weights) of an unbatched argument are shared by every
    lane. The matrix must be batched: the lanes cannot add into one matrix.
    """
    if in_dims[4] is None:
        raise ValueError("under vmap the confusion matrix `out` must be batched like the labels (one matrix a lane)")

    def lanes(x: Optional[Tensor], dim: Optional[int]) -> Optional[Tensor]:
        if x is None:
            return None
        return x.movedim(dim, 0) if dim is not None else x.unsqueeze(0).expand(info.batch_size, *x.shape)

    confusion_matrix_lanes(
        lanes(preds, in_dims[0]), lanes(target, in_dims[1]), num_classes, lanes(weights, in_dims[2]),
        out=out.movedim(in_dims[4], 0),
    )
    return None, None


@functools.cache
def _confmat_op() -> Any:
    """The custom op ``torchmetrics_tpu_torch::confmat_add_`` with its vmap rule (defined at first use)."""

    @torch.library.custom_op("torchmetrics_tpu_torch::confmat_add_", mutates_args=("out",))
    def confmat_add_(preds: Tensor, target: Tensor, weights: Optional[Tensor], num_classes: int, out: Tensor) -> None:
        confusion_matrix_cuda(preds, target, num_classes, weights, out)

    torch.library.register_vmap("torchmetrics_tpu_torch::confmat_add_", _lanes_rule)
    return confmat_add_


def confusion_matrix_cuda(
    preds: Tensor, target: Tensor, num_classes: int, weights: Optional[Tensor] = None, out: Optional[Tensor] = None
) -> Tensor:
    """``(C, C)`` matrix, rows=target and cols=preds; the signature of ``confusion_matrix_pallas``, plus ``out``.

    ``preds``/``target``: 1-D int32 or int64 labels of one dtype. ``weights``:
    None or a bool mask (int32 counts), or float32 weights (float32 sums).
    ``out``: a contiguous ``(C, C)`` matrix of that type on the labels'
    device, into which the counts are added (a metric's state); without it a
    fresh zeroed matrix is returned. CUDA tensors must be contiguous; the
    kernel runs on the current stream and is not waited for. CPU tensors take
    :func:`confusion_matrix_plain`. Everything is checked before anything is
    added, so a refused call leaves ``out`` as it was.
    """
    _check_inputs(preds, target, num_classes, weights)
    if preds.device.type == "cpu":
        return confusion_matrix_plain(preds, target, num_classes, weights, out)
    if _vmapped(preds, target, weights, out):
        # a lane of a vmapped step: the custom op's vmap rule launches once for every lane
        if out is None:
            out = preds.new_zeros((num_classes, num_classes), dtype=_out_dtype(weights))
        else:
            _check_out(out, preds, num_classes, weights)
        _confmat_op()(preds, target, weights, num_classes, out)
        return out
    if preds.device.type != "cuda":
        raise ValueError(f"confusion_matrix_cuda takes CUDA or CPU tensors, got {preds.device}")
    for name, x in (("preds", preds), ("target", target), ("weights", weights)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"`{name}` must be contiguous")
    if out is not None:
        _check_out(out, preds, num_classes, weights)
    if num_classes > MAX_CLASSES:
        raise ValueError(f"confusion_matrix_cuda counts up to {MAX_CLASSES} classes on a GPU, got {num_classes}")
    if out is None:
        out = torch.zeros((num_classes, num_classes), dtype=_out_dtype(weights), device=preds.device)
    n = preds.shape[0]
    if n == 0:
        return out
    if weights is None:
        weight_kind = _WEIGHT_NONE
    else:
        weight_kind = _WEIGHT_MASK if weights.dtype == torch.bool else _WEIGHT_FLOAT
    head = vector_head(n, [(x.data_ptr(), x.element_size()) for x in (preds, target, weights) if x is not None])
    steps = -(-n // ROWS_PER_STEP)
    blocks = max(1, min(_max_blocks(preds.device.index), -(-steps // _THREADS)))
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
            head,
            out.data_ptr(),
            blocks,
            torch.cuda.current_stream(preds.device).cuda_stream,
        )
    nvcc.raise_on_error(lib, err, "confmat")
    confusion_matrix_cuda.launches.hit(preds.device)
    return out


confusion_matrix_cuda.launches = LaunchCounter(SOURCE)  # type: ignore[attr-defined]


@functools.cache
def _max_blocks(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count * _BLOCKS_PER_SM


@functools.cache
def _library() -> Any:
    import ctypes

    lib = nvcc.load(SOURCE)
    for entry in (lib.tm_confmat, lib.tm_confmat_row_atomics):
        entry.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        entry.restype = ctypes.c_int
    lib.tm_confmat_lanes.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.tm_confmat_lanes.restype = ctypes.c_int
    return lib
