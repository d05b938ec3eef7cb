"""Shared regression helpers (port of ``torchmetrics_tpu/functional/regression/utils.py``).

``_rank_data`` gives the average ranks (ties averaged) from one stable sort:
a tie run that starts at sorted position ``s`` and holds ``c`` equal values
ranks ``s + (c + 1) / 2``, the count of smaller values plus half the count of
equal ones, as the JAX package's O(n²) comparison computes it. Both are
integers or half-integers in float32, so below 2**24 the two are equal bit
for bit. A NaN counts as one value of its own here; the JAX package ranks it
0.5 and leaves it out of every other rank.
"""

from __future__ import annotations

import torch
from torch import Tensor


def _check_data_shape_to_num_outputs(preds: Tensor, target: Tensor, num_outputs: int) -> None:
    """Validate (N,) for num_outputs=1 or (N, M) for num_outputs=M."""
    if preds.ndim > 2 or target.ndim > 2:
        raise ValueError(
            f"Expected both predictions and target to be either 1- or 2-dimensional tensors,"
            f" but got {target.ndim} and {preds.ndim}."
        )
    cond1 = num_outputs == 1 and not (preds.ndim == 1 or preds.shape[1] == 1)
    cond2 = num_outputs > 1 and (preds.ndim < 2 or preds.shape[1] != num_outputs)
    if cond1 or cond2:
        raise ValueError(
            f"Expected argument `num_outputs` to match the second dimension of input, but got {num_outputs}"
            f" and {preds.shape}"
        )


def _rank_1d(x: Tensor) -> Tensor:
    sorted_x, order = torch.sort(x, stable=True)
    _, inverse, counts = torch.unique_consecutive(sorted_x, return_inverse=True, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    sorted_rank = (starts.to(torch.float32) + (counts.to(torch.float32) + 1.0) / 2.0)[inverse]
    return torch.empty_like(sorted_rank).scatter_(0, order, sorted_rank)


def _rank_data(data: Tensor) -> Tensor:
    """Average ranks (1-indexed, float32) along the last axis; ties get the mean rank."""
    x = torch.as_tensor(data).to(torch.float32)
    if x.ndim == 1:
        return _rank_1d(x)
    rows = x.reshape(-1, x.shape[-1])
    return torch.stack([_rank_1d(row) for row in rows]).reshape(x.shape)
