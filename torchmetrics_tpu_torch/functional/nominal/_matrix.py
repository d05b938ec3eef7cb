"""Column-pairwise nominal-association matrices (port of ``torchmetrics_tpu/functional/nominal/_matrix.py``).

The association between every pair of categorical columns of an
``(N, num_features)`` data matrix. Each pair's value is written into a
float32 matrix on the input's device, where the JAX package reads each
value back to fill a numpy matrix. The pairs still wait on the device one
by one: each sizes its contingency matrix from ``torch.unique``, drops its
empty rows and columns by a boolean index and, with ``bias_correction``,
reads ``n - 1`` back for the correction, as the JAX package does.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.nominal import (
    _nominal_input_validation,
    cramers_v,
    pearsons_contingency_coefficient,
    theils_u,
    tschuprows_t,
)


def _pairwise_matrix(matrix: Tensor, pair_fn: Callable[[Tensor, Tensor], Tensor], symmetric: bool = True) -> Tensor:
    """A diagonal of ones, ``out[i, j] = pair_fn(x_i, x_j)``; ``out[j, i]`` the same value or ``pair_fn(x_j, x_i)``."""
    matrix = torch.as_tensor(matrix)
    num_variables = matrix.shape[1]
    out = torch.ones((num_variables, num_variables), dtype=torch.float32, device=matrix.device)
    for i, j in itertools.combinations(range(num_variables), 2):
        x, y = matrix[:, i], matrix[:, j]
        out[i, j] = pair_fn(x, y)
        out[j, i] = out[i, j] if symmetric else pair_fn(y, x)
    return out


def cramers_v_matrix(
    matrix: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Cramér's V between all pairs of columns of a categorical data matrix.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.nominal import cramers_v_matrix
        >>> matrix = torch.randint(0, 4, (200, 5), generator=torch.Generator().manual_seed(42))
        >>> cramers_v_matrix(matrix).shape
        torch.Size([5, 5])
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _pairwise_matrix(matrix, lambda x, y: cramers_v(x, y, bias_correction, nan_strategy, nan_replace_value))


def tschuprows_t_matrix(
    matrix: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Tschuprow's T between all pairs of columns of a categorical data matrix."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _pairwise_matrix(matrix, lambda x, y: tschuprows_t(x, y, bias_correction, nan_strategy, nan_replace_value))


def pearsons_contingency_coefficient_matrix(
    matrix: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Pearson's contingency coefficient between all column pairs."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _pairwise_matrix(
        matrix, lambda x, y: pearsons_contingency_coefficient(x, y, nan_strategy, nan_replace_value)
    )


def theils_u_matrix(
    matrix: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Theil's U between all column pairs (asymmetric: ``out[i, j] = U(x_i | x_j)``)."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _pairwise_matrix(matrix, lambda x, y: theils_u(x, y, nan_strategy, nan_replace_value), symmetric=False)
