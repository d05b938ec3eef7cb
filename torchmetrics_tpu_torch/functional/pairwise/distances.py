"""Pairwise distance and similarity matrices (port of ``torchmetrics_tpu/functional/pairwise/distances.py``).

Cosine, linear and euclidean are one full-float32 matrix product each
(``_safe_matmul``, no TF32); euclidean keeps the Gram identity
``‖x‖² + ‖y‖² − 2x·y`` of the JAX package, then the safe square root.
Manhattan and Minkowski reduce ``|x_i − y_j|`` over the features: XLA fuses
that broadcast into its reduction, eager PyTorch would build the whole
``(N, M, d)`` temporary, so the rows of ``x`` go in tiles whose temporary
stays within ``_TILE_BYTES``. The same elementwise terms are summed over the
same axis as in the JAX package (``torch.cdist`` would sum in another order).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.compute import _safe_matmul, _safe_sqrt

_TILE_BYTES = 1 << 28  # 256 MiB of float32 temporaries a tile


def _check_input(x: Tensor, y: Optional[Tensor], zero_diagonal: Optional[bool]) -> Tuple[Tensor, Tensor, bool]:
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {x.shape}")
    if y is not None:
        y = torch.as_tensor(y, dtype=torch.float32)
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x, y, zero_diagonal


def _reduce_distance_matrix(distmat: Tensor, reduction: Optional[str] = None) -> Tensor:
    if reduction == "mean":
        return torch.mean(distmat, dim=-1)
    if reduction == "sum":
        return torch.sum(distmat, dim=-1)
    if reduction is None or reduction == "none":
        return distmat
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")


def _zero_diagonal(distance: Tensor, zero_diagonal: bool) -> Tensor:
    """Zero the first ``min(N, M)`` diagonal entries of a freshly computed matrix, in place."""
    if zero_diagonal:
        distance.fill_diagonal_(0)
    return distance


def _tile_rows(n_y: int, d: int) -> int:
    """Rows of ``x`` a tile, so that the ``(rows, M, d)`` float32 temporary stays within ``_TILE_BYTES``."""
    return max(1, _TILE_BYTES // max(1, 4 * n_y * d))


def _tiled(x: Tensor, y: Tensor, row_fn: Callable[[Tensor], Tensor]) -> Tensor:
    """``row_fn(|x[rows, None] - y[None]|)`` reduced over the features, tile by tile of ``x``'s rows."""
    out = torch.empty((x.shape[0], y.shape[0]), dtype=torch.float32, device=x.device)
    rows = _tile_rows(y.shape[0], x.shape[1])
    for start in range(0, x.shape[0], rows):
        out[start : start + rows] = row_fn(torch.abs(x[start : start + rows, None, :] - y[None, :, :]))
    return out


def pairwise_cosine_similarity(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise cosine similarity between the rows of ``x`` and ``y`` (or ``x`` with itself).

    Example:
        >>> import torch
        >>> x = torch.tensor([[2., 3.], [3., 5.], [5., 8.]])
        >>> y = torch.tensor([[1., 0.], [2., 1.]])
        >>> pairwise_cosine_similarity(x, y).shape
        torch.Size([3, 2])
    """
    x, y, zd = _check_input(x, y, zero_diagonal)
    return _reduce_distance_matrix(_zero_diagonal(_safe_matmul(_unit_rows(x), _unit_rows(y)), zd), reduction)


def _unit_rows(x: Tensor) -> Tensor:
    """Rows over their norms, with float32's subnormals flushed to 0 as XLA flushes them (JAX `distances.py:74`).

    The JAX package divides by ``max(norm, 1e-38)``, and 1e-38 is a float32
    subnormal: flushed, the clamp is 0, so an all-zero row (or one of
    subnormals only) comes out NaN, as in the original torchmetrics.
    """
    tiny = torch.finfo(torch.float32).tiny
    x = torch.where(x.abs() < tiny, torch.zeros_like(x), x)
    norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.where(norm < tiny, torch.zeros_like(norm), norm)


def pairwise_euclidean_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise euclidean distances through the Gram identity ``‖x−y‖² = ‖x‖² + ‖y‖² − 2x·y``.

    Example:
        >>> import torch
        >>> x = torch.tensor([[2., 3.], [3., 5.], [5., 8.]])
        >>> pairwise_euclidean_distance(x).shape
        torch.Size([3, 3])
    """
    x, y, zd = _check_input(x, y, zero_diagonal)
    x_norm = torch.sum(x * x, dim=1, keepdim=True)
    y_norm = torch.sum(y * y, dim=1)
    distance = x_norm + y_norm[None, :] - 2 * _safe_matmul(x, y)
    distance = _safe_sqrt(torch.clamp(distance, min=0.0))  # a finite gradient at duplicate rows
    return _reduce_distance_matrix(_zero_diagonal(distance, zd), reduction)


def pairwise_manhattan_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise manhattan (L1) distances.

    Example:
        >>> import torch
        >>> x = torch.tensor([[2., 3.], [3., 5.], [5., 8.]])
        >>> float(pairwise_manhattan_distance(x)[0, 1])
        3.0
    """
    x, y, zd = _check_input(x, y, zero_diagonal)
    distance = _tiled(x, y, lambda diff: torch.sum(diff, dim=-1))
    return _reduce_distance_matrix(_zero_diagonal(distance, zd), reduction)


def pairwise_minkowski_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    exponent: float = 2,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise minkowski distances of order ``exponent``.

    Example:
        >>> import torch
        >>> x = torch.tensor([[2., 3.], [3., 5.], [5., 8.]])
        >>> pairwise_minkowski_distance(x, exponent=3).shape
        torch.Size([3, 3])
    """
    if not (isinstance(exponent, (float, int)) and exponent >= 1):
        raise ValueError(f"Argument `exponent` must be a float or int greater than 1, but got {exponent}")
    x, y, zd = _check_input(x, y, zero_diagonal)
    distance = _tiled(x, y, lambda diff: torch.sum(diff**exponent, dim=-1) ** (1.0 / exponent))
    return _reduce_distance_matrix(_zero_diagonal(distance, zd), reduction)


def pairwise_linear_similarity(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise linear similarity (inner products).

    Example:
        >>> import torch
        >>> x = torch.tensor([[2., 3.], [3., 5.], [5., 8.]])
        >>> y = torch.tensor([[1., 0.], [2., 1.]])
        >>> float(pairwise_linear_similarity(x, y)[0, 0])
        2.0
    """
    x, y, zd = _check_input(x, y, zero_diagonal)
    return _reduce_distance_matrix(_zero_diagonal(_safe_matmul(x, y), zd), reduction)
