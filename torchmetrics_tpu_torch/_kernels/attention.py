"""BERT attention core and LayerNorm of the residual sum: two CUDA kernels, their plain versions, counts.

Port of ``torchmetrics_tpu/_kernels/attention.py``.

- :func:`attention` (kernel B4, ``csrc/attention.cu``) fuses the oracle chain
  of ``text/_bert_encoder.py`` -- head split, ``QK^T``, scale, additive mask
  bias, softmax, ``PV``, head merge -- into one launch over ``(B, L, hidden)``
  tensors. The ``(L, L)`` scores never reach device memory and the softmax
  runs in float32 even for bf16 inputs.
- :func:`layernorm_residual` (kernel B5, ``csrc/layernorm_residual.cu``) fuses
  the post-block ``x + h`` with the LayerNorm statistics and affine in one pass
  over the rows, with the fast variance ``mean(y^2) - mean(y)^2``; float32 out.

The ``*_plain`` functions are the JAX package's XLA versions in PyTorch. A
wrapper takes its plain version only for CPU tensors; on CUDA tensors it
launches its kernel or raises, and counts its launches in ``.launches``. Both
sources say what bounds their kernel and how they are built. A vmapped lane
goes through the custom op ``torchmetrics_tpu_torch::attention`` or
``::layernorm_residual``, whose rule folds the lanes into the batch or the
rows and calls the wrapper once (:mod:`._kernels.lanes`).
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
from torch import Tensor

from torchmetrics_tpu_torch._kernels.conv_epilogue import _cuda_or_cpu
from torchmetrics_tpu_torch._kernels.lanes import fold, lane_op, lanes_first, shared_only, unfold
from torchmetrics_tpu_torch._kernels.launch_counter import LaunchCounter
from torchmetrics_tpu_torch._observability import costs as _obs_costs
from torchmetrics_tpu_torch._observability.costs import ExecutableCost
from torchmetrics_tpu_torch.utilities import nvcc
from torchmetrics_tpu_torch.utilities.checks import _vmapped
from torchmetrics_tpu_torch.utilities.compute import full_fp32

__all__ = [
    "attention",
    "attention_cost",
    "attention_plain",
    "layernorm_residual",
    "layernorm_residual_cost",
    "layernorm_residual_plain",
]

ATTENTION_SOURCE = nvcc.CSRC_DIR / "attention.cu"
LAYERNORM_SOURCE = nvcc.CSRC_DIR / "layernorm_residual.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128  # the widest head the kernel's register tiles hold


# --------------------------------------------------------------- attention

def _check_attention(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, num_heads: int) -> None:
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention: q, k, v must be three (B, L, hidden) tensors of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if mask.shape != q.shape[:2]:
        raise ValueError(f"attention: mask must be (B, L) = {tuple(q.shape[:2])}, got {tuple(mask.shape)}")
    if num_heads <= 0 or q.shape[2] % num_heads:
        raise ValueError(f"attention: hidden {q.shape[2]} does not split into {num_heads} heads")


def attention_plain(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, *, num_heads: int) -> Tensor:
    """The oracle chain (``_xla_attention``) in float32, rounded once to ``q``'s dtype."""
    _check_attention(q, k, v, mask, num_heads)
    bsz, length, hidden = q.shape
    head_dim = hidden // num_heads

    def split(t: Tensor) -> Tensor:  # (B, L, H) -> (B, heads, L, head_dim)
        return t.float().reshape(bsz, length, num_heads, head_dim).transpose(1, 2)

    with full_fp32():
        scores = split(q) @ split(k).transpose(-1, -2)
        scores = scores / math.sqrt(head_dim)
        bias = (1.0 - mask[:, None, None, :].float()) * -1e9
        probs = torch.softmax(scores + bias, dim=-1)
        ctx = probs @ split(v)
    return ctx.transpose(1, 2).reshape(bsz, length, hidden).to(q.dtype)


def attention(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, *, num_heads: int) -> Tensor:
    """Kernel B4: ``softmax(QK^T / sqrt(d) + (1 - mask) * -1e9) V`` per head, softmax in float32.

    ``q``, ``k``, ``v``: ``(B, L, hidden)`` of one dtype, float32 or bfloat16,
    each with a contiguous last dimension (every head's columns are read in
    place, four elements a load, so ``head_dim``, the batch and row strides
    and the data pointers must be multiples of 4 elements, as any
    ``F.linear`` output's are). ``mask``: ``(B, L)``, any numeric or bool
    dtype, 1 for a key to attend to. Returns a contiguous ``(B, L, hidden)``
    tensor of ``q``'s dtype. Vmapped inputs take the custom op, whose rule
    makes this call once for every lane.
    """
    if _vmapped(q, k, v, mask):
        return _attention_op()(q, k, v, mask, num_heads)
    name = "attention"
    on_cuda = _cuda_or_cpu(name, q, k, v, mask)
    _check_attention(q, k, v, mask, num_heads)
    if not on_cuda:
        return attention_plain(q, k, v, mask, num_heads=num_heads)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must all be float32 or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    bsz, length, hidden = q.shape
    head_dim = hidden // num_heads
    if head_dim > _MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {head_dim} is over the kernel's {_MAX_HEAD_DIM}")
    if any(t.stride(2) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v need a contiguous last dimension")
    if head_dim % 4 or any(t.stride(0) % 4 or t.stride(1) % 4 or t.data_ptr() % (4 * t.element_size()) for t in (q, k, v)):
        raise ValueError(f"{name}: head_dim, the batch and row strides and the data pointers of q, k, v must be "
                         f"multiples of 4 elements, got head_dim {head_dim}")
    mask = mask.to(torch.float32).contiguous()
    out = torch.empty((bsz, length, hidden), dtype=q.dtype, device=q.device)
    if bsz == 0 or length == 0:
        return out
    with torch.cuda.device(q.device):
        err = _attention_library().tm_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            bsz, length, num_heads, head_dim,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            out.stride(0), out.stride(1), _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        )
    nvcc.raise_on_error(_attention_library(), err, name)
    attention.launches.hit(q.device)
    if _obs_costs.tallying():  # a step's cost is being counted before its capture
        _obs_costs.tally_kernel(attention_cost(q, k, v, mask, num_heads=num_heads))
    return out


attention.launches = LaunchCounter(ATTENTION_SOURCE)  # type: ignore[attr-defined]


def _attention_rule(info: Any, in_dims: tuple, q: Tensor, k: Tensor, v: Tensor, mask: Tensor, num_heads: int) -> tuple:
    """The vmap rule of ``attention``: the lanes' ``(L, B, S, hidden)`` and ``(L, B, S)`` as one batch of ``L * B``.

    An unbatched input (a mask, say) is shared by every lane.
    """
    lanes = info.batch_size
    q, k, v, mask = (fold(t, d, lanes) for t, d in zip((q, k, v, mask), in_dims))
    return unfold(attention(q, k, v, mask, num_heads=num_heads), lanes)


@functools.cache
def _attention_op() -> Any:
    def attention_lanes(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, num_heads: int) -> Tensor:
        return attention(q, k, v, mask, num_heads=num_heads)

    return lane_op("attention", attention_lanes, _attention_rule)


@functools.cache
def _attention_library() -> Any:
    import ctypes

    lib = nvcc.load(ATTENTION_SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.tm_attention.argtypes = [ptr] * 5 + [i64] * 12 + [ctypes.c_int, ptr]
    lib.tm_attention.restype = ctypes.c_int
    lib.tm_attention_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.tm_attention_smem.restype = ctypes.c_int
    return lib


def attention_cost(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, *, num_heads: int) -> ExecutableCost:
    """Closed-form operations and bytes (the JAX package's ``attention_cost``): q, k, v read and out written once."""
    bsz, length, hidden = q.shape
    head_dim = hidden // num_heads
    # QK^T + PV MACs, plus scale/bias/softmax (~6 flops per score)
    flops = bsz * num_heads * (4.0 * length * length * head_dim + 6.0 * length * length)
    bytes_accessed = float(q.element_size()) * 4.0 * bsz * length * hidden + 4.0 * bsz * length
    return ExecutableCost(flops=float(flops), bytes_accessed=bytes_accessed)


# ------------------------------------------------------- layernorm+residual

def _check_layernorm(x: Tensor, h: Tensor, scale: Tensor, bias: Tensor) -> None:
    if x.ndim == 0 or h.shape != x.shape or scale.shape != x.shape[-1:] or bias.shape != x.shape[-1:]:
        raise ValueError(f"layernorm_residual: shapes {tuple(x.shape)}, {tuple(h.shape)}, {tuple(scale.shape)}, "
                         f"{tuple(bias.shape)} do not fit")


def layernorm_residual_plain(x: Tensor, h: Tensor, scale: Tensor, bias: Tensor, *, eps: float) -> Tensor:
    """``LayerNorm(x + h) * scale + bias`` over the last axis in float32 (``_xla_layernorm_residual``)."""
    _check_layernorm(x, h, scale, bias)
    y = x.float() + h.float()
    mu = torch.mean(y, dim=-1, keepdim=True)
    var = torch.mean(y * y, dim=-1, keepdim=True) - mu * mu
    return (y - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def layernorm_residual(x: Tensor, h: Tensor, scale: Tensor, bias: Tensor, *, eps: float) -> Tensor:
    """Kernel B5: ``LayerNorm(x + h) * scale + bias`` over the last axis, float32 out, at any width.

    ``x`` and ``h``: contiguous tensors of one shape, each float32 or
    bfloat16 (they may differ); ``scale``, ``bias``: ``(C,)``. Vmapped
    inputs take the custom op, whose rule makes this call once for every lane.
    """
    if _vmapped(x, h, scale, bias):
        return _layernorm_op()(x, h, scale, bias, eps)
    name = "layernorm_residual"
    on_cuda = _cuda_or_cpu(name, x, h, scale, bias)
    _check_layernorm(x, h, scale, bias)
    if not on_cuda:
        return layernorm_residual_plain(x, h, scale, bias, eps=eps)
    if x.dtype not in _DTYPES or h.dtype not in _DTYPES:
        raise TypeError(f"{name}: x and h must be float32 or bfloat16, got {x.dtype}, {h.dtype}")
    if not (x.is_contiguous() and h.is_contiguous()):
        raise ValueError(f"{name}: x and h must be contiguous")
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if rows == 0 or c == 0:
        return out
    with torch.cuda.device(x.device):
        err = _layernorm_library().tm_layernorm_residual(
            x.data_ptr(), h.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, c,
            _DTYPES[x.dtype], _DTYPES[h.dtype], eps, torch.cuda.current_stream(x.device).cuda_stream,
        )
    nvcc.raise_on_error(_layernorm_library(), err, name)
    layernorm_residual.launches.hit(x.device)
    if _obs_costs.tallying():
        _obs_costs.tally_kernel(layernorm_residual_cost(x, h, scale, bias))
    return out


layernorm_residual.launches = LaunchCounter(LAYERNORM_SOURCE)  # type: ignore[attr-defined]


def _layernorm_rule(info: Any, in_dims: tuple, x: Tensor, h: Tensor, scale: Tensor, bias: Tensor, eps: float) -> tuple:
    """The vmap rule of ``layernorm_residual``: the lanes' rows as more rows of one call (``h`` may be shared)."""
    shared_only("layernorm_residual", in_dims, ("x", "h", "scale", "bias"), ("scale", "bias"))
    lanes = info.batch_size
    x, h = (lanes_first(t, d, lanes).contiguous() for t, d in zip((x, h), in_dims))
    return layernorm_residual(x, h, scale, bias, eps=eps), 0


@functools.cache
def _layernorm_op() -> Any:
    def layernorm_residual_lanes(x: Tensor, h: Tensor, scale: Tensor, bias: Tensor, eps: float) -> Tensor:
        return layernorm_residual(x, h, scale, bias, eps=eps)

    return lane_op("layernorm_residual", layernorm_residual_lanes, _layernorm_rule)


@functools.cache
def _layernorm_library() -> Any:
    import ctypes

    lib = nvcc.load(LAYERNORM_SOURCE)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tm_layernorm_residual.argtypes = [ptr] * 5 + [i64, i64, i32, i32, ctypes.c_float, ptr]
    lib.tm_layernorm_residual.restype = i32
    return lib


def layernorm_residual_cost(x: Tensor, h: Tensor, scale: Tensor, bias: Tensor) -> ExecutableCost:
    """Closed-form operations and bytes (the JAX package's ``layernorm_residual_cost``)."""
    elems = x.numel()
    flops = 9.0 * elems  # add, two stat passes, normalize, affine
    bytes_accessed = float(x.element_size()) * 2.0 * elems + 4.0 * (elems + 2.0 * x.shape[-1])
    return ExecutableCost(flops=float(flops), bytes_accessed=bytes_accessed)
