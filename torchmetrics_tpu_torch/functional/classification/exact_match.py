"""Exact match (port of ``torchmetrics_tpu/functional/classification/exact_match.py``).

A sample counts only if *every* element or label in it is predicted
correctly, so the sufficient statistics are ``correct`` / ``total`` sample
counts rather than tp/fp/tn/fn.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.enums import ClassificationTaskNoBinary


def _exact_match_reduce(correct: Tensor, total: Tensor) -> Tensor:
    return _safe_divide(correct, total)


def _multiclass_exact_match_update(
    preds: Tensor,
    target: Tensor,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Per-sample all-correct counts over the trailing dims, int32."""
    match = preds == target
    if ignore_index is not None:
        match = match | (target == ignore_index)
    n = target.shape[0]
    correct = torch.all(match.reshape(n, -1), dim=1).to(torch.int32)
    if multidim_average == "global":
        return correct.sum(dtype=torch.int32), torch.full((), n, dtype=torch.int32, device=correct.device)
    return correct, torch.ones_like(correct)


def multiclass_exact_match(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass exact match (all positions in a sample correct).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_exact_match
        >>> target = torch.tensor([[0, 2, 1], [2, 1, 0]])
        >>> preds = torch.tensor([[0, 2, 1], [2, 1, 1]])
        >>> multiclass_exact_match(preds, target, num_classes=3)
        tensor(0.5000)
    """
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, 1, None, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, 1)
    correct, total = _multiclass_exact_match_update(preds, target, multidim_average, ignore_index)
    return _exact_match_reduce(correct, total)


def _multilabel_exact_match_update(
    preds: Tensor,
    target: Tensor,
    valid: Tensor,
    multidim_average: str = "global",
) -> Tuple[Tensor, Tensor]:
    """All labels correct per (sample, spatial...) position (reference ``exact_match.py:128-133``)."""
    match = (preds == target) | ~valid
    n = target.shape[0]
    pos_correct = torch.all(match, dim=1)  # (N, ...): all labels right at each position
    if multidim_average == "global":
        flat = pos_correct.reshape(-1)
        return flat.sum(dtype=torch.int32), torch.full((), flat.shape[0], dtype=torch.int32, device=flat.device)
    flat = pos_correct.reshape(n, -1)
    return flat.sum(dim=1, dtype=torch.int32), torch.full((n,), flat.shape[1], dtype=torch.int32, device=flat.device)


def multilabel_exact_match(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel exact match (all labels in a sample correct)."""
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target, valid = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    correct, total = _multilabel_exact_match_update(preds, target, valid, multidim_average)
    return _exact_match_reduce(correct, total)


def exact_match(
    preds: Tensor,
    target: Tensor,
    task: str,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task dispatcher for exact match (no binary task, as in the reference)."""
    task = ClassificationTaskNoBinary.from_str(task)
    if task == ClassificationTaskNoBinary.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_exact_match(preds, target, num_classes, multidim_average, ignore_index, validate_args)
    if task == ClassificationTaskNoBinary.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_exact_match(
            preds, target, num_labels, threshold, multidim_average, ignore_index, validate_args
        )
    raise ValueError(f"Not handled value: {task}")
