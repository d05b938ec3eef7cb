"""Banks of IIR biquads (SRMR's gammatone and modulation filterbanks): kernel S1, its plain loop, its count.

The JAX package filters with ``lax.scan`` (``torchmetrics_tpu/functional/audio/srmr.py::_biquad``,
``:130``; scan at ``:153``) and has no Pallas kernel here. :func:`biquad_bank`
runs ``S`` cascaded direct-form II transposed sections over each channel of a
bank: ``K`` channels a row of ``x``, channel ``k`` with its own coefficients.
A CUDA tensor launches kernel S1 (``torchmetrics_tpu_torch/csrc/biquad.cu``),
which says what bounds it; a CPU tensor takes :func:`biquad_bank_plain`, a
per-step loop with the same operations in the same order. There is no switch
between the two and no fallback. Launches are counted in ``biquad_bank.launches``.
A vmapped lane goes through the custom op ``torchmetrics_tpu_torch::biquad_bank``,
whose rule folds the lanes into the rows and calls :func:`biquad_bank` once.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch._compile import device_constant
from torchmetrics_tpu_torch._kernels.conv_epilogue import _cuda_or_cpu
from torchmetrics_tpu_torch._kernels.lanes import fold, lane_op, shared_only, unfold
from torchmetrics_tpu_torch._kernels.launch_counter import LaunchCounter
from torchmetrics_tpu_torch._observability import costs as _obs_costs
from torchmetrics_tpu_torch._observability.costs import ExecutableCost
from torchmetrics_tpu_torch.utilities import nvcc
from torchmetrics_tpu_torch.utilities.checks import _vmapped

__all__ = ["biquad_bank", "biquad_bank_cost", "biquad_bank_plain"]

SOURCE = nvcc.CSRC_DIR / "biquad.cu"
_COEFS = 16  # csrc/biquad.cu kCoefs


def _check(x: Tensor, b: Tensor, a: Tensor, gain: Optional[Tensor]) -> None:
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"biquad_bank: x must be a (rows, T) float32 tensor, got {tuple(x.shape)} {x.dtype}")
    if b.ndim != 3 or b.shape[0] not in (1, 4) or b.shape[2] != 3 or a.shape != (b.shape[1], 3):
        raise ValueError(
            f"biquad_bank: b must be (S, K, 3) with S 1 or 4 and a (K, 3), got {tuple(b.shape)} and {tuple(a.shape)}"
        )
    if (gain is None) != (b.shape[0] == 1) or (gain is not None and gain.shape != (b.shape[1],)):
        raise ValueError("biquad_bank: a gain of (K,) goes with 4 sections, none with 1")


def biquad_bank_plain(x: Tensor, b: Tensor, a: Tensor, gain: Optional[Tensor] = None) -> Tensor:
    """``(rows, K, T)``: each row through each of ``K`` cascades of ``S`` biquads, one time step at a time.

    ``b``: ``(S, K, 3)`` numerators, ``a``: ``(K, 3)`` denominators with
    ``a[:, 0] == 1``, shared by the sections; ``gain``: ``(K,)``, dividing
    the output of a 4-section cascade. The step of each section is
    ``_biquad``'s: ``y = b0 x + z1``, ``z1 = b1 x - a1 y + z2``,
    ``z2 = b2 x - a2 y``, in float32, each operation rounded once.
    """
    _check(x, b, a, gain)
    rows, t_len = x.shape
    k = b.shape[1]
    a1, a2 = a[:, 1].to(x), a[:, 2].to(x)
    y = x[:, None, :].expand(rows, k, t_len)
    for section in b.to(x):
        # b_i * x for every step at once (the same single rounding as inside the loop), as one view a step
        bx0, bx1, bx2 = ((section[:, i, None] * y).unbind(-1) for i in range(3))
        z1 = torch.zeros((rows, k), dtype=x.dtype, device=x.device)
        z2 = torch.zeros_like(z1)
        steps = []
        for t in range(t_len):
            yt = bx0[t] + z1
            z1 = bx1[t] - a1 * yt + z2
            z2 = bx2[t] - a2 * yt
            steps.append(yt)
        y = torch.stack(steps, dim=-1) if steps else torch.empty((rows, k, 0), dtype=x.dtype, device=x.device)
    return y / gain.to(x)[:, None] if gain is not None else y.clone()


@functools.cache
def _library() -> Any:
    import ctypes

    lib = nvcc.load(SOURCE)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tm_biquad_bank.argtypes = [ptr, ptr, ptr, i64, i32, i64, i32, ptr]
    lib.tm_biquad_bank.restype = i32
    return lib


def _pack(b: Tensor, a: Tensor, gain: Optional[Tensor], device: torch.device) -> Tensor:
    """The kernel's ``(K, 16)`` float32 coefficient rows: ``b[s]`` at ``3 s``, ``a1``, ``a2`` at 12, 13, gain at 14."""
    k = b.shape[1]
    coefs = torch.zeros((k, _COEFS), dtype=torch.float32)
    coefs[:, : 3 * b.shape[0]] = b.detach().to("cpu", torch.float32).permute(1, 0, 2).reshape(k, -1)
    coefs[:, 12:14] = a.detach().to("cpu", torch.float32)[:, 1:]
    coefs[:, 14] = 1.0 if gain is None else gain.detach().to("cpu", torch.float32)
    return device_constant(coefs, device)  # a graph's replays read the taps its capture saw


def biquad_bank(x: Tensor, b: Tensor, a: Tensor, gain: Optional[Tensor] = None) -> Tensor:
    """Kernel S1: ``(rows, K, T)`` float32, each row of ``x`` through ``K`` cascades of ``S`` biquads.

    Arguments as :func:`biquad_bank_plain`, whose values it gives. ``x``
    must be contiguous on a CUDA card; the coefficients may lie anywhere. A
    vmapped ``x`` takes the custom op, whose rule makes this call once for every lane.
    """
    if _vmapped(x, b, a, gain):
        return _biquad_op()(x, b, a, gain)
    _check(x, b, a, gain)
    if not _cuda_or_cpu("biquad_bank", x):
        return biquad_bank_plain(x, b, a, gain)
    if not x.is_contiguous():
        raise ValueError("biquad_bank: x must be a contiguous (rows, T) tensor")
    rows, t_len = x.shape
    k = b.shape[1]
    coefs = _pack(b, a, gain, x.device)
    out = torch.empty((rows, k, t_len), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().tm_biquad_bank(
            x.data_ptr(), out.data_ptr(), coefs.data_ptr(), rows, k, t_len, b.shape[0],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    nvcc.raise_on_error(_library(), err, "biquad_bank")
    biquad_bank.launches.hit(x.device)
    if _obs_costs.tallying():  # a step's cost is being counted before its capture
        _obs_costs.tally_kernel(biquad_bank_cost(rows, k, t_len, b.shape[0]))
    return out


biquad_bank.launches = LaunchCounter()  # type: ignore[attr-defined]


def _biquad_rule(info: Any, in_dims: tuple, x: Tensor, b: Tensor, a: Tensor, gain: Optional[Tensor]) -> tuple:
    """The vmap rule of ``biquad_bank``: the lanes' ``(L, rows, T)`` as ``L * rows`` rows of one call."""
    shared_only("biquad_bank", in_dims, ("x", "b", "a", "gain"), ("b", "a", "gain"))
    lanes = info.batch_size
    return unfold(biquad_bank(fold(x, in_dims[0], lanes).contiguous(), b, a, gain), lanes)


@functools.cache
def _biquad_op() -> Any:
    def biquad_bank_lanes(x: Tensor, b: Tensor, a: Tensor, gain: Optional[Tensor]) -> Tensor:
        return biquad_bank(x, b, a, gain)

    return lane_op("biquad_bank", biquad_bank_lanes, _biquad_rule)


def biquad_bank_cost(rows: int, k: int, t_len: int, sections: int) -> ExecutableCost:
    """Operations and bytes of one call: 9 flops a section and sample (+1 for the gain); input read once, output written once."""
    channels = rows * k
    flops = float(channels) * t_len * (9.0 * sections + (1.0 if sections == 4 else 0.0))
    return ExecutableCost(flops=flops, bytes_accessed=4.0 * t_len * (rows + channels))
