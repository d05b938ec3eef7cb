"""Fused LPIPS head: unit-normalise, weighted squared difference, spatial mean, as one CUDA kernel.

Port of ``torchmetrics_tpu/_kernels/lpips_head.py``. Per pixel the LPIPS
``lin`` head is the scalar

    sum_c  w_c * (f0_c / (||f0|| + eps)  -  f1_c / (||f1|| + eps))^2

and the tap's distance is its mean over the pixels. The oracle graph
(:func:`lpips_head_plain`) writes four full feature maps to get there; kernel
B3 (``torchmetrics_tpu_torch/csrc/lpips_head.cu``) reads both maps once, in
the trunk's own dtype (float32 or bfloat16, widened in registers), and writes
only the ``(B,)`` result, in one deterministic launch. The launch plan is
:func:`head_plan`. :func:`lpips_head` takes the plain version only for CPU
tensors; on CUDA tensors it launches the kernel or raises, and counts its
launches in ``lpips_head.launches``. A vmapped lane goes through the custom op
``torchmetrics_tpu_torch::lpips_head``, whose rule folds the lanes into ``B``
and calls :func:`lpips_head` once.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch._kernels.conv_epilogue import _cuda_or_cpu
from torchmetrics_tpu_torch._kernels.lanes import fold, lane_op, shared_only, unfold
from torchmetrics_tpu_torch._kernels.launch_counter import LaunchCounter
from torchmetrics_tpu_torch._observability import costs as _obs_costs
from torchmetrics_tpu_torch._observability.costs import ExecutableCost
from torchmetrics_tpu_torch.utilities import nvcc
from torchmetrics_tpu_torch.utilities.checks import _vmapped
from torchmetrics_tpu_torch.utilities.compute import full_fp32

__all__ = ["head_plan", "lpips_head", "lpips_head_cost", "lpips_head_plain"]

SOURCE = nvcc.CSRC_DIR / "lpips_head.cu"
_EPS = 1e-10  # image/_lpips.py _normalize_tensor
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 128  # csrc/lpips_head.cu kThreads
MAX_CLUSTER = 8  # the portable thread-block cluster size
K_STEPS = (1, 2, 3, 4, 6, 8, 12, 16)  # vectors a lane per map that the kernel is instantiated for
MAX_LANE_CHANNELS = 32  # a lane's channels of one pixel, held in registers: K * vec <= 32
MAX_WEIGHT_BYTES = 48 * 1024  # the head's weights in static-size shared memory
_BLOCKS_PER_SM = 2  # the grid covers the SMs at least twice where the rows have the pixels


class HeadPlan(NamedTuple):
    """How kernel B3 cuts one call: ``vec`` elements a load, ``lanes`` lanes a pixel, ``k`` loads a lane per map,
    ``pix`` pixels a group takes a step, ``cluster`` blocks a row (the grid is ``B * cluster``), each over
    ``pixels_per_block`` pixels."""

    vec: int
    lanes: int
    k: int
    pix: int
    cluster: int
    pixels_per_block: int


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def head_plan(b: int, hw: int, c: int, elem_bytes: int, aligned: bool, sms: int) -> HeadPlan:
    """The launch plan of kernel B3 for ``b`` rows of ``hw`` pixels of ``c`` channels of ``elem_bytes`` each.

    ``aligned``: both maps start on a 16-byte boundary, so a lane loads 16
    bytes (8 bf16, 4 float32) at once when ``c`` is a multiple of that. A
    pixel's vectors go to the fewest lanes (a power of two) that divides
    them, at most a warp, with at most 32 channels a lane (so up to 1024
    channels in vectors, 512 of any alignment); the row's pixels go to a
    cluster of up to 8 blocks, enough for ``2 * sms`` blocks in all.
    """
    per16 = 16 // elem_bytes
    vec = per16 if aligned and c % per16 == 0 else 1
    k_steps = [s for s in K_STEPS if s * vec <= MAX_LANE_CHANNELS]
    vectors = c // vec
    lanes = min(vectors & -vectors, 32)  # the largest power of two dividing `vectors`
    k = vectors // lanes
    if k > k_steps[-1]:  # few factors of two: spread over a warp and mask the last vectors
        lanes, k = 32, -(-vectors // 32)
    steps = [s for s in k_steps if s >= k]
    if not steps or c * 4 > MAX_WEIGHT_BYTES:
        raise ValueError(f"lpips_head: {c} channels of {elem_bytes} bytes exceed what the kernel holds in registers")
    k = steps[0]
    pix = 2 if k <= 2 else 1
    pixels_per_step = (THREADS // lanes) * pix
    cluster = min(
        MAX_CLUSTER,
        1 << (-(-_BLOCKS_PER_SM * sms // max(b, 1)) - 1).bit_length(),  # next power of two
        _pow2_floor(-(-hw // pixels_per_step)),
    )
    pixels_per_block = -(-hw // cluster)
    return HeadPlan(vec, lanes, k, pix, cluster, pixels_per_block)


def _prepare(f0: Tensor, f1: Tensor, weight: Tensor):
    if f0.ndim != 4 or f1.shape != f0.shape:
        raise ValueError(f"lpips_head: features must be two (B, H, W, C) maps of one shape, got {f0.shape}, {f1.shape}")
    if weight.numel() != f0.shape[-1]:
        raise ValueError(f"lpips_head: weight has {weight.numel()} entries for {f0.shape[-1]} channels")
    if f0.dtype != f1.dtype or f0.dtype not in _KERNEL_DTYPES:
        f0, f1 = f0.float(), f1.float()
    return f0, f1, weight.reshape(-1).float()


def _normalize(x: Tensor) -> Tensor:
    return x / (torch.sqrt(torch.sum(x**2, dim=-1, keepdim=True)) + _EPS)


def lpips_head_plain(f0: Tensor, f1: Tensor, weight: Tensor) -> Tensor:
    """The oracle chain in float32: normalise, subtract, square, 1x1 conv, mean over H and W."""
    f0, f1, w = _prepare(f0, f1, weight)
    d = (_normalize(f0.float()) - _normalize(f1.float())) ** 2
    with full_fp32():
        lin = d @ w  # the 1x1 conv to one output channel
    return lin.mean(dim=(1, 2))


def lpips_head(f0: Tensor, f1: Tensor, weight: Tensor) -> Tensor:
    """Kernel B3: the ``(B,)`` LPIPS distance of one tap, accumulated in float32.

    ``f0``, ``f1``: ``(B, H, W, C)`` features (the JAX package's layout; the
    ``permute(0, 2, 3, 1)`` view of a channels_last NCHW map), read as they
    are in float32 or bfloat16 and cast to float32 otherwise. ``weight``: the
    head's ``C`` weights in any shape (flax's ``(1, 1, C, 1)``, torch's
    ``(1, C, 1, 1)`` or flat). Vmapped maps take the custom op, whose rule
    makes this call once for every lane.
    """
    if _vmapped(f0, f1, weight):
        return _head_op()(f0, f1, weight)
    f0, f1, w = _prepare(f0, f1, weight)
    if not _cuda_or_cpu("lpips_head", f0, f1, w):
        return lpips_head_plain(f0, f1, w)
    if not (f0.is_contiguous() and f1.is_contiguous()):
        raise ValueError("lpips_head: features must be contiguous (B, H, W, C) maps")
    b, h, wd, c = f0.shape
    if b == 0 or h * wd == 0:  # the mean over no pixels, as the plain version gives it
        return torch.full((b,), float("nan"), dtype=torch.float32, device=f0.device)
    aligned = f0.data_ptr() % 16 == 0 and f1.data_ptr() % 16 == 0
    plan = head_plan(b, h * wd, c, f0.element_size(), aligned, _sm_count(f0.device.index))
    w = w.contiguous()
    out = torch.empty(b, dtype=torch.float32, device=f0.device)
    with torch.cuda.device(f0.device):
        err = _library().tm_lpips_head(
            f0.data_ptr(), f1.data_ptr(), w.data_ptr(), out.data_ptr(), b, h * wd, c, _KERNEL_DTYPES[f0.dtype],
            plan.vec, plan.lanes, plan.k, plan.cluster, plan.pixels_per_block,
            torch.cuda.current_stream(f0.device).cuda_stream,
        )
    nvcc.raise_on_error(_library(), err, "lpips_head")
    lpips_head.launches.hit(f0.device)
    if _obs_costs.tallying():
        _obs_costs.tally_kernel(lpips_head_cost(f0, f1, w))
    return out


lpips_head.launches = LaunchCounter(SOURCE)  # type: ignore[attr-defined]


def _head_rule(info: Any, in_dims: tuple, f0: Tensor, f1: Tensor, weight: Tensor) -> tuple:
    """The vmap rule of ``lpips_head``: the lanes' ``(L, B, H, W, C)`` maps as one batch of ``L * B``, one call.

    The folded maps are made contiguous, as the kernel reads them: a lane's
    half of a pair batch is contiguous, but the lanes' halves are not one run.
    """
    shared_only("lpips_head", in_dims, ("f0", "f1", "weight"), ("weight",))
    lanes = info.batch_size
    f0, f1 = (fold(f, d, lanes).contiguous() for f, d in zip((f0, f1), in_dims))
    return unfold(lpips_head(f0, f1, weight), lanes)


@functools.cache
def _head_op() -> Any:
    def lpips_head_lanes(f0: Tensor, f1: Tensor, weight: Tensor) -> Tensor:
        return lpips_head(f0, f1, weight)

    return lane_op("lpips_head", lpips_head_lanes, _head_rule)


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def _library() -> Any:
    import ctypes

    lib = nvcc.load(SOURCE)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tm_lpips_head.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i32, i32, i32, i32, i32, i64, ptr]
    lib.tm_lpips_head.restype = ctypes.c_int
    return lib


def lpips_head_cost(f0: Tensor, f1: Tensor, weight: Tensor) -> ExecutableCost:
    """Closed-form operations and bytes: the JAX package's ``lpips_head_cost`` with the maps at their element size.

    Float32 maps give the JAX package's numbers; bfloat16 maps, which the
    kernel reads as they are, half the feature bytes.
    """
    n, h, w, c = f0.shape
    pixels = n * h * w
    # per pixel: 2 norms (2C mul-add + sqrt) + 2 scale + diff + square + weighted sum
    flops = float(pixels) * (8.0 * c + 16.0)
    return ExecutableCost(flops=flops, bytes_accessed=2.0 * pixels * c * f0.element_size() + 4.0 * (c + n))
