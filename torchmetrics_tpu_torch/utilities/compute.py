"""Safe math primitives shared by the metric functionals.

Parity target: reference ``torchmetrics/utilities/compute.py``. Division
by zero and the logit check are resolved with ``torch.where`` on the device, so
neither reads a value back to the host.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
from torch import Tensor


def _safe_divide(num: Tensor, denom: Tensor, zero_division: float = 0.0) -> Tensor:
    """Elementwise division returning ``zero_division`` where ``denom == 0``."""
    num = torch.as_tensor(num)
    denom = torch.as_tensor(denom, device=num.device)
    if not torch.is_floating_point(num):
        num = num.to(torch.float32)
    if not torch.is_floating_point(denom):
        denom = denom.to(torch.float32)
    zero = denom == 0
    res = num / torch.where(zero, torch.ones_like(denom), denom)
    return torch.where(zero, torch.full_like(res, zero_division), res)


def _adjust_weights_safe_divide(
    score: Tensor,
    average: Optional[str],
    multilabel: bool,
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    zero_division: float = 0.0,
) -> Tensor:
    """Apply macro/weighted averaging over per-class scores.

    Parity: reference ``torchmetrics/utilities/compute.py:57-68``. Classes that
    never appear (``tp+fp+fn == 0``) are dropped from the macro average unless
    running multilabel.
    """
    if average is None or average == "none":
        return score
    if average == "weighted":
        weights = (tp + fn).to(torch.float32)
    else:
        weights = torch.ones_like(score)
        if not multilabel:
            weights = torch.where(tp + fp + fn == 0, torch.zeros_like(weights), weights)
    return _safe_divide(torch.sum(weights * score, dim=-1), torch.sum(weights, dim=-1), zero_division)


def _auc_compute_without_check(x: Tensor, y: Tensor, direction: float, axis: int = -1) -> Tensor:
    """Trapezoidal area under (x, y) along ``axis``, assuming x already sorted in ``direction``."""
    dx = torch.diff(x, dim=axis)
    n = y.shape[axis]
    y_avg = (y.narrow(axis, 0, n - 1) + y.narrow(axis, 1, n - 1)) / 2.0
    return torch.sum(y_avg * dx, dim=axis) * direction


def _auc_compute(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    """Area under a curve; with ``reorder`` the points are first sorted by x (stable).

    As in the JAX package, the direction is the sign of the summed steps
    rather than the reference's check that x is monotonic.
    """
    if reorder:
        order = torch.argsort(x, stable=True)
        x, y = x[order], y[order]
    direction = torch.where(torch.diff(x).sum() >= 0, 1.0, -1.0)
    return _auc_compute_without_check(x, y, 1.0) * direction


def auc(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    """Area under the curve through the points (x, y) (functional ``auc``)."""
    return _auc_compute(x, y, reorder=reorder)


def interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """1-D linear interpolation with the reference's semantics (reference ``utilities/compute.py:134-157``).

    The segment of each ``x`` is the count of ``xp`` values at or below it,
    less one, clamped to the segments; slopes are taken in ``xp``'s own
    order, and values past either end are extrapolated linearly. This is
    not ``numpy.interp``, which clamps at the ends and assumes a sorted
    ``xp``: the macro-averaged curves call it on an ``xp`` that is not
    monotonic, where the count-based pick is what the reference returns.
    """
    x, xp, fp = torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp)
    x1 = torch.atleast_1d(x)
    if xp.shape[0] < 2:  # no segment to interpolate over
        fill = fp[0] if fp.numel() else torch.tensor(float("nan"), device=x1.device)
        out = torch.broadcast_to(fill, x1.shape)
        return out[0] if x.ndim == 0 else out
    m = _safe_divide(fp[1:] - fp[:-1], xp[1:] - xp[:-1])
    b = fp[:-1] - m * xp[:-1]
    indices = torch.sum(x1[:, None] >= xp[None, :], dim=1) - 1
    indices = torch.clamp(indices, 0, m.shape[0] - 1)
    out = m[indices] * x1 + b[indices]
    return out[0] if x.ndim == 0 else out


def normalize_logits_if_needed(tensor: Tensor, normalization: Optional[str]) -> Tensor:
    """Apply sigmoid/softmax iff values fall outside [0, 1].

    The reference reads ``tensor.min() < 0 or tensor.max() > 1`` back to the
    host; here the flag stays on the device and selects with ``torch.where``.
    """
    if normalization is None or tensor.numel() == 0:
        # size-0: reference's torch.all on empty is True -> no normalization
        return tensor
    outside = (tensor.min() < 0) | (tensor.max() > 1)
    if normalization == "sigmoid":
        return torch.where(outside, torch.sigmoid(tensor), tensor)
    if normalization == "softmax":
        return torch.where(outside, torch.softmax(tensor, dim=1), tensor)
    raise ValueError(f"Unknown normalization: {normalization}")


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """Run float32 convolutions and matrix products in full float32 inside the block.

    cuDNN runs a float32 convolution in TF32 (a 10-bit mantissa) unless
    ``torch.backends.cudnn.allow_tf32`` is false, and cuBLAS does the same for
    matrix products when ``torch.backends.cuda.matmul.allow_tf32`` is set. The
    JAX package asks for ``precision="highest"`` in float32; this is its
    counterpart. Both flags are restored on exit, so the caller's settings
    outside the block are untouched.
    """
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _safe_matmul(x: Tensor, y: Tensor) -> Tensor:
    """``x @ y.T`` in full float32 (JAX ``utilities/compute.py:19``, ``precision="highest"``).

    Runs inside :func:`full_fp32`, so cuBLAS takes no TF32 path whatever the
    caller's flags. Half-precision inputs are multiplied in float32 and the
    product is cast back to ``x``'s dtype.
    """
    half = (torch.float16, torch.bfloat16)
    with full_fp32():
        if x.dtype in half or y.dtype in half:
            return torch.matmul(x.to(torch.float32), y.to(torch.float32).T).to(x.dtype)
        return torch.matmul(x, y.T)


def _safe_sqrt(x: Tensor) -> Tensor:
    """``sqrt`` with a zero gradient at 0; a non-positive input gives 0 (JAX ``utilities/compute.py:37``)."""
    positive = x > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, x, torch.ones_like(x))), torch.zeros_like(x))


def _safe_xlogy(x: Tensor, y: Tensor) -> Tensor:
    """``x * log(y)`` that is 0 wherever ``x == 0``, also where ``y == 0`` (JAX ``utilities/compute.py:64``)."""
    zero = x == 0
    res = x * torch.log(torch.where(zero, torch.ones_like(y), y))
    return torch.where(zero, torch.zeros_like(res), res)


def _safe_pow(base: Tensor, exp: Tensor) -> Tensor:
    """``base ** exp`` with finite gradients where the true derivative diverges (JAX ``utilities/compute.py:51``).

    Forward values are unchanged, ``0 ** 0 == 1`` and NaN for a negative base
    with a fractional exponent included; the non-positive branch is computed
    on a detached base, so the gradient at ``base == 0`` with ``exp < 1`` is 0,
    not inf.
    """
    positive = base > 0
    safe = torch.where(positive, base, torch.ones_like(base)) ** exp
    return torch.where(positive, safe, base.detach() ** exp)
