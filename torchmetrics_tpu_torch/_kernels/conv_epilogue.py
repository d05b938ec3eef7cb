"""Fused conv + bias + ReLU for the BN-folded InceptionV3 trunk: two CUDA kernels, their plain versions, counts.

Port of ``torchmetrics_tpu/_kernels/conv_epilogue.py``. After
``fold_batchnorm`` every ``BasicConv2d`` of InceptionV3 ends in
``conv -> + bias -> relu``, which :func:`conv_bias_act` runs in two routes:

- a **pointwise** conv (1x1, stride 1, no padding) is a GEMM on the
  ``(N*H*W, Cin)`` view of the channels_last activation. It runs as kernel
  B2a alone (:func:`matmul_bias_relu`), whose epilogue adds the bias and
  applies ReLU before the one store; no library conv or matmul is called;
- a **spatial** conv is ``F.conv2d`` without bias (cuDNN; the JAX package
  also leaves it to the library, ``lax.conv``), then kernel B2b
  (:func:`bias_relu_`) adds the bias and applies ReLU in one pass over the
  ``(N*H*W, Cout)`` view, in place.

Both kernels live in ``torchmetrics_tpu_torch/csrc/conv_epilogue.cu``, which
says what bounds them and how they are built. The LPIPS trunks do not come
through here: they are plain ``conv + ReLU`` layers, and their heads run
through :mod:`torchmetrics_tpu_torch._kernels.lpips_head`.

Tensors are NCHW in shape and channels_last in memory, weights OIHW. A
wrapper takes the plain version only for a CPU tensor; on a CUDA tensor it
launches its kernel or raises. Each counts its launches in ``.launches``;
:func:`conv_bias_act` counts in ``.layout_copies`` every channels_last copy it
had to make of an input or of the library conv's output. A vmapped lane (a
stream pool's step) goes through the custom op
``torchmetrics_tpu_torch::conv_bias_act``, whose vmap rule folds the lanes
into ``N`` and calls :func:`conv_bias_act` once (:mod:`._kernels.lanes`).
"""

from __future__ import annotations

import functools
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import Tensor

from torchmetrics_tpu_torch._kernels.lanes import fold, lane_op, shared_only, unfold
from torchmetrics_tpu_torch._kernels.launch_counter import LaunchCounter
from torchmetrics_tpu_torch._observability import costs as _obs_costs
from torchmetrics_tpu_torch._observability.costs import ExecutableCost
from torchmetrics_tpu_torch.utilities import nvcc
from torchmetrics_tpu_torch.utilities.checks import _vmapped
from torchmetrics_tpu_torch.utilities.compute import full_fp32

__all__ = [
    "bias_relu_",
    "bias_relu_cost",
    "bias_relu_plain",
    "conv_bias_act",
    "conv_bias_act_cost",
    "matmul_bias_relu",
    "matmul_bias_relu_plain",
]

SOURCE = nvcc.CSRC_DIR / "conv_epilogue.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_EW_BLOCKS_PER_SM = 16
IntPair = Union[int, Sequence[int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    a, b = v
    return (int(a), int(b))


def _rows(t: Tensor) -> Tensor:
    """The ``(N*H*W, C)`` view of a channels_last ``(N, C, H, W)`` tensor; no copy."""
    return t.permute(0, 2, 3, 1).view(-1, t.shape[1])


def _cuda_or_cpu(name: str, *tensors: Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises for a mix or another device."""
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"{name}: all tensors must lie on one device, got {[str(t.device) for t in tensors]}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} takes CUDA or CPU tensors, got {device}")
    if device.type == "cuda" and torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; call it under torch.no_grad()")
    return device.type == "cuda"


def _check_dtype(name: str, *tensors: Tensor) -> None:
    dtype = tensors[0].dtype
    if dtype not in _DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{name}: tensors must all be float32 or all bfloat16, got {[t.dtype for t in tensors]}")


@functools.cache
def _library() -> Any:
    import ctypes

    lib = nvcc.load(SOURCE)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tm_mm_bias_relu.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i32, i32, ptr]
    lib.tm_mm_bias_relu.restype = i32
    lib.tm_mm_bias_relu_tma_smem.argtypes = [i32]
    lib.tm_mm_bias_relu_tma_smem.restype = i32
    lib.tm_bias_relu.argtypes = [ptr, ptr, i64, i64, i32, i32, i64, ptr]
    lib.tm_bias_relu.restype = i32
    return lib


@functools.cache
def _max_blocks(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count * _EW_BLOCKS_PER_SM


def _aligned16(*tensors: Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


# --------------------------------------------------------------------- B2a

_TMA_MAX_ROWS = 2**31 - 1  # TMA box coordinates are signed 32-bit


def _mm_route(dtype: torch.dtype, m: int, k: int, n: int, aligned16: bool) -> str:
    """Which kernel of ``csrc/conv_epilogue.cu`` takes a B2a call on the card.

    ``"tma_wgmma"``: bf16 with ``K % 8 == 0``, ``N % 8 == 0`` and 16-byte
    aligned ``x``, ``w`` and ``out`` (TMA needs 16-byte row strides and bases;
    the epilogue stores 8 columns at once), which every InceptionV3 shape is.
    ``"element"``: any other bf16 call. ``"fma_f32"``: float32. Raises for a
    TMA-shaped call whose rows a 32-bit box coordinate cannot reach.
    """
    if dtype == torch.float32:
        return "fma_f32"
    if not (k % 8 == 0 and n % 8 == 0 and aligned16):
        return "element"
    if m > _TMA_MAX_ROWS or n > _TMA_MAX_ROWS:
        raise ValueError(f"matmul_bias_relu: ({m}, {k}) x ({n}, {k}) is past the TMA kernel's 2**31 - 1 rows")
    return "tma_wgmma"


def matmul_bias_relu_plain(x2d: Tensor, w2d: Tensor, bias: Tensor) -> Tensor:
    """``relu(x2d @ w2d.T + bias)`` accumulated in float32 and rounded once to ``x2d``'s dtype."""
    with full_fp32():
        return torch.relu(x2d.float() @ w2d.float().T + bias.float()).to(x2d.dtype)


def matmul_bias_relu(x2d: Tensor, w2d: Tensor, bias: Tensor, out: Optional[Tensor] = None) -> Tensor:
    """Kernel B2a: ``relu(x2d @ w2d.T + bias)`` with f32 accumulation, one rounding to the input dtype.

    ``x2d`` ``(M, K)``, ``w2d`` ``(N, K)`` (a 1x1 conv weight as ``(Cout, Cin)``),
    ``bias`` ``(N,)``, all contiguous and of one dtype, float32 or bfloat16.
    ``out``, if given, is a contiguous ``(M, N)`` tensor to write into.
    """
    name = "matmul_bias_relu"
    on_cuda = _cuda_or_cpu(name, x2d, w2d, bias)
    _check_dtype(name, x2d, w2d, bias)
    if x2d.ndim != 2 or w2d.ndim != 2 or bias.shape != (w2d.shape[0],) or w2d.shape[1] != x2d.shape[1]:
        raise ValueError(f"{name}: shapes {tuple(x2d.shape)}, {tuple(w2d.shape)}, {tuple(bias.shape)} do not fit")
    m, k = x2d.shape
    n = w2d.shape[0]
    if out is None:
        out = torch.empty((m, n), dtype=x2d.dtype, device=x2d.device)
    elif out.shape != (m, n) or out.dtype != x2d.dtype or out.device != x2d.device or not out.is_contiguous():
        raise ValueError(f"{name}: `out` must be a contiguous {(m, n)} {x2d.dtype} tensor on {x2d.device}")
    if not on_cuda:
        return out.copy_(matmul_bias_relu_plain(x2d, w2d, bias))
    if not (x2d.is_contiguous() and w2d.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"{name}: `x2d`, `w2d` and `bias` must be contiguous")
    if m == 0 or n == 0:
        return out
    if k == 0:
        raise ValueError(f"{name}: K must be positive")
    route = _mm_route(x2d.dtype, m, k, n, _aligned16(x2d, w2d, out))
    with torch.cuda.device(x2d.device):
        err = _library().tm_mm_bias_relu(
            x2d.data_ptr(), w2d.data_ptr(), bias.data_ptr(), out.data_ptr(), m, k, n,
            _DTYPES[x2d.dtype], int(route == "tma_wgmma"), torch.cuda.current_stream(x2d.device).cuda_stream,
        )
    nvcc.raise_on_error(_library(), err, name)
    matmul_bias_relu.launches.hit(x2d.device)
    if _obs_costs.tallying():  # a step's cost is being counted before its capture
        _obs_costs.tally_kernel(conv_bias_act_cost(x2d[:, :, None, None], w2d[:, :, None, None], bias))
    return out


matmul_bias_relu.launches = LaunchCounter(SOURCE)  # type: ignore[attr-defined]


# --------------------------------------------------------------------- B2b

def bias_relu_plain(y2d: Tensor, bias: Tensor) -> Tensor:
    """``relu(y2d + bias)`` computed in float32 and rounded once to ``y2d``'s dtype (a new tensor)."""
    return torch.relu(y2d.float() + bias.float()).to(y2d.dtype)


def bias_relu_(y2d: Tensor, bias: Tensor) -> Tensor:
    """Kernel B2b: overwrite ``y2d`` ``(M, C)`` with ``relu(y2d + bias)``, computed in f32, rounded once.

    ``y2d`` and ``bias`` ``(C,)`` are contiguous and of one dtype, float32 or
    bfloat16. In place, because the caller's ``y2d`` is a fresh conv output
    that nothing else reads: the pass moves one read and one write of it.
    """
    name = "bias_relu_"
    on_cuda = _cuda_or_cpu(name, y2d, bias)
    _check_dtype(name, y2d, bias)
    if y2d.ndim != 2 or bias.shape != (y2d.shape[1],):
        raise ValueError(f"{name}: shapes {tuple(y2d.shape)} and {tuple(bias.shape)} do not fit")
    if not on_cuda:
        return y2d.copy_(bias_relu_plain(y2d, bias))
    if not (y2d.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"{name}: `y2d` and `bias` must be contiguous")
    rows, c = y2d.shape
    if rows == 0 or c == 0:
        return y2d
    vec = c % (16 // y2d.element_size()) == 0 and _aligned16(y2d)
    with torch.cuda.device(y2d.device):
        err = _library().tm_bias_relu(
            y2d.data_ptr(), bias.data_ptr(), rows, c, _DTYPES[y2d.dtype], int(vec),
            _max_blocks(y2d.device.index), torch.cuda.current_stream(y2d.device).cuda_stream,
        )
    nvcc.raise_on_error(_library(), err, name)
    bias_relu_.launches.hit(y2d.device)
    if _obs_costs.tallying():
        _obs_costs.tally_kernel(bias_relu_cost(y2d, bias))
    return y2d


bias_relu_.launches = LaunchCounter(SOURCE)  # type: ignore[attr-defined]


# ------------------------------------------------------------------ public

def _is_pointwise(kernel_hw: Sequence[int], stride: Tuple[int, int], padding: Tuple[int, int]) -> bool:
    return tuple(kernel_hw) == (1, 1) and stride == (1, 1) and padding == (0, 0)


def _channels_last(t: Tensor) -> Tensor:
    if t.is_contiguous(memory_format=torch.channels_last):
        return t
    conv_bias_act.layout_copies += 1
    return t.contiguous(memory_format=torch.channels_last)


def conv_bias_act(x: Tensor, weight: Tensor, bias: Tensor, stride: IntPair = 1, padding: IntPair = 0) -> Tensor:
    """``relu(conv2d(x, weight, stride, padding) + bias)`` through kernels B2a/B2b.

    ``x`` ``(N, Cin, H, W)`` (channels_last in memory, else copied and
    counted), ``weight`` ``(Cout, Cin, kh, kw)``, ``bias`` ``(Cout,)``, all
    of one dtype, float32 or bfloat16: the inputs come promoted to the
    compute dtype, as in the JAX package. Returns a channels_last
    ``(N, Cout, Ho, Wo)`` tensor of that dtype. A vmapped ``x`` takes the
    custom op, whose rule makes this call once for every lane.
    """
    stride, padding = _pair(stride), _pair(padding)
    if _vmapped(x, weight, bias):
        return _conv_op()(x, weight, bias, list(stride), list(padding))
    if x.ndim != 4 or weight.ndim != 4 or weight.shape[1] != x.shape[1]:
        raise ValueError(f"conv_bias_act: shapes {tuple(x.shape)} and {tuple(weight.shape)} do not fit")
    x = _channels_last(x)
    n, cin, h, w = x.shape
    cout = weight.shape[0]
    if _is_pointwise(weight.shape[2:], stride, padding):
        out = torch.empty((n, cout, h, w), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
        matmul_bias_relu(_rows(x), weight.reshape(cout, cin).contiguous(), bias, out=_rows(out))
        return out
    y = _channels_last(F.conv2d(x, weight, None, stride, padding))
    bias_relu_(_rows(y), bias)
    return y


conv_bias_act.layout_copies = 0  # type: ignore[attr-defined]


def _conv_rule(info: Any, in_dims: tuple, x: Tensor, weight: Tensor, bias: Tensor, stride: List[int],
               padding: List[int]) -> tuple:
    """The vmap rule of ``conv_bias_act``: the lanes ``(L, N, C, H, W)`` as one batch of ``L * N``, one call."""
    shared_only("conv_bias_act", in_dims, ("x", "weight", "bias"), ("weight", "bias"))
    lanes = info.batch_size
    return unfold(conv_bias_act(fold(x, in_dims[0], lanes), weight, bias, stride, padding), lanes)


@functools.cache
def _conv_op() -> Any:
    def conv_bias_act_lanes(x: Tensor, weight: Tensor, bias: Tensor, stride: List[int], padding: List[int]) -> Tensor:
        return conv_bias_act(x, weight, bias, stride, padding)

    return lane_op("conv_bias_act", conv_bias_act_lanes, _conv_rule)


# -------------------------------------------------------------------- cost

def conv_bias_act_cost(x: Tensor, weight: Tensor, bias: Tensor, stride: IntPair = 1, padding: IntPair = 0) -> ExecutableCost:
    """Closed-form operations and bytes of :func:`conv_bias_act` (the JAX package's ``conv_bias_act_cost``).

    Reads only shapes and the element size, so meta tensors will do. Bytes
    count the input, weight and bias read once and the output written once.
    """
    n, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (w + 2 * pw - kw) // sw + 1
    out_elems = n * ho * wo * cout
    flops = 2.0 * out_elems * kh * kw * cin + 2.0 * out_elems  # MACs + bias + relu
    elems = n * h * w * cin + kh * kw * cin * cout + cout + out_elems
    return ExecutableCost(flops=flops, bytes_accessed=float(elems * x.element_size()))


def bias_relu_cost(y2d: Tensor, bias: Tensor) -> ExecutableCost:
    """Operations and bytes of :func:`bias_relu_`: one read and one write of ``y2d``, one read of ``bias``."""
    rows, c = y2d.shape
    return ExecutableCost(flops=2.0 * rows * c, bytes_accessed=float((2 * rows * c + c) * y2d.element_size()))
