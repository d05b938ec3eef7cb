"""KL divergence (port of ``torchmetrics_tpu/functional/regression/kl_divergence.py``)."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.compute import _safe_xlogy


def _kld_update(p: Tensor, q: Tensor, log_prob: bool) -> Tuple[Tensor, int]:
    _check_same_shape(p, q)
    p = torch.as_tensor(p, dtype=torch.float32)
    q = torch.as_tensor(q, dtype=torch.float32)
    if p.ndim != 2 or q.ndim != 2:
        raise ValueError(f"Expected both p and q distribution to be 2D but got {p.ndim} and {q.ndim} respectively")
    total = p.shape[0]
    if log_prob:
        measures = torch.sum(torch.exp(p) * (p - q), dim=-1)
    else:
        p = p / p.sum(dim=-1, keepdim=True)
        q = q / q.sum(dim=-1, keepdim=True)
        q = torch.clamp(q, min=torch.finfo(q.dtype).eps)
        measures = torch.sum(_safe_xlogy(p, p / q), dim=-1)
    return measures, total


def _kld_compute(measures: Tensor, total: Union[int, Tensor], reduction: Optional[str] = "mean") -> Tensor:
    if reduction == "sum":
        return measures.sum()
    if reduction == "mean":
        return measures.sum() / total
    if reduction is None or reduction == "none":
        return measures
    return measures / total


def kl_divergence(p: Tensor, q: Tensor, log_prob: bool = False, reduction: Optional[str] = "mean") -> Tensor:
    """KL(P || Q) between empirical distributions.

    Example:
        >>> import torch
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1/3, 1/3, 1/3]])
        >>> round(float(kl_divergence(p, q)), 4)
        0.0853
    """
    measures, total = _kld_update(p, q, log_prob)
    return _kld_compute(measures, total, reduction)
