"""Functional retrieval metrics (port of ``torchmetrics_tpu/functional/retrieval/``).

Each public function scores one query's 1-D ``(preds, target)``; the
batched mask-aware kernels of ``_masked`` also carry the modular metrics.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.retrieval import _masked as _mk


def _check_retrieval_functional_inputs(
    preds: Tensor, target: Tensor, allow_non_binary_target: bool = False
) -> Tuple[Tensor, Tensor]:
    preds = torch.as_tensor(preds).reshape(-1).to(torch.float32)
    target = torch.as_tensor(target).reshape(-1)
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must be of the same shape")
    if not allow_non_binary_target:
        target = (target > 0).to(torch.int32)
    return preds, target


def _full(preds: Tensor, target: Tensor, kernel: Callable, allow_non_binary: bool = False, **kw) -> Tensor:
    """One query through a batched kernel, as a batch of one with every entry valid."""
    preds, target = _check_retrieval_functional_inputs(preds, target, allow_non_binary)
    mask = torch.ones(preds.shape, dtype=torch.bool, device=preds.device)
    return kernel(preds[None], target[None], mask[None], **kw)[0]


def retrieval_average_precision(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Average precision for a single query.

    Example:
        >>> import torch
        >>> retrieval_average_precision(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]))
        tensor(0.8333)
    """
    return _full(preds, target, _mk.average_precision_masked, top_k=top_k)


def retrieval_reciprocal_rank(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Reciprocal rank of the first relevant document."""
    return _full(preds, target, _mk.reciprocal_rank_masked, top_k=top_k)


def retrieval_precision(preds: Tensor, target: Tensor, top_k: Optional[int] = None, adaptive_k: bool = False) -> Tensor:
    """Precision@k for a single query."""
    return _full(preds, target, _mk.precision_masked, top_k=top_k, adaptive_k=adaptive_k)


def retrieval_recall(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Recall@k for a single query."""
    return _full(preds, target, _mk.recall_masked, top_k=top_k)


def retrieval_fall_out(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Fall-out@k (the share of the irrelevant documents retrieved) for a single query."""
    return _full(preds, target, _mk.fall_out_masked, top_k=top_k)


def retrieval_hit_rate(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Hit rate@k for a single query."""
    return _full(preds, target, _mk.hit_rate_masked, top_k=top_k)


def retrieval_r_precision(preds: Tensor, target: Tensor) -> Tensor:
    """R-precision (precision at R, the number of relevant documents)."""
    return _full(preds, target, _mk.r_precision_masked)


def retrieval_auroc(
    preds: Tensor, target: Tensor, top_k: Optional[int] = None, max_fpr: Optional[float] = None
) -> Tensor:
    """Per-query AUROC from the Mann-Whitney rank statistic; ``max_fpr`` gives the McClish-corrected partial AUC."""
    if max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
        raise ValueError(f"Arguments `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")
    return _full(preds, target, _mk.auroc_masked, top_k=top_k, max_fpr=max_fpr)


def retrieval_normalized_dcg(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Normalized discounted cumulative gain (graded relevance supported)."""
    return _full(preds, target, _mk.ndcg_masked, allow_non_binary=True, top_k=top_k)


def retrieval_precision_recall_curve(
    preds: Tensor, target: Tensor, max_k: Optional[int] = None, adaptive_k: bool = False
) -> Tuple[Tensor, Tensor, Tensor]:
    """(precision@k, recall@k, k) for k = 1..max_k, for a single query."""
    preds, target = _check_retrieval_functional_inputs(preds, target)
    n = preds.shape[-1]
    max_k = min(max_k or n, n)
    p, t = preds[None], target[None]
    mask = torch.ones_like(p, dtype=torch.bool)
    precisions = torch.cat([_mk.precision_masked(p, t, mask, top_k=k, adaptive_k=adaptive_k) for k in range(1, max_k + 1)])
    recalls = torch.cat([_mk.recall_masked(p, t, mask, top_k=k) for k in range(1, max_k + 1)])
    return precisions, recalls, torch.arange(1, max_k + 1, device=preds.device)


__all__ = [
    "retrieval_auroc",
    "retrieval_average_precision",
    "retrieval_fall_out",
    "retrieval_hit_rate",
    "retrieval_normalized_dcg",
    "retrieval_precision",
    "retrieval_precision_recall_curve",
    "retrieval_r_precision",
    "retrieval_recall",
    "retrieval_reciprocal_rank",
]
