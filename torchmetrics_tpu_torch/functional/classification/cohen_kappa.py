"""Cohen's kappa (port of ``torchmetrics_tpu/functional/classification/cohen_kappa.py``).

Parity target: reference ``torchmetrics/functional/classification/cohen_kappa.py``. Kappa is
reduced from the confusion matrix in float32, with the disagreement weights built in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _binary_confusion_matrix_update,
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
)
from torchmetrics_tpu_torch.utilities.enums import ClassificationTaskNoMultilabel

_ALLOWED_WEIGHTS = ("linear", "quadratic", "none", None)


def _cohen_kappa_reduce(confmat: Tensor, weights: Optional[str] = None) -> Tensor:
    """Kappa from a confusion matrix with None/linear/quadratic disagreement weighting (JAX ``cohen_kappa.py:24-45``)."""
    confmat = confmat.to(torch.float32)
    n_classes = confmat.shape[0]
    sum0 = confmat.sum(dim=0)
    sum1 = confmat.sum(dim=1)
    expected = torch.outer(sum1, sum0) / sum0.sum()

    if weights is None:
        w_mat = torch.ones((n_classes, n_classes), dtype=torch.float32, device=confmat.device)
        w_mat = w_mat - torch.eye(n_classes, dtype=torch.float32, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        w_mat = torch.arange(n_classes, dtype=torch.float32, device=confmat.device)
        w_mat = torch.abs(w_mat[:, None] - w_mat[None, :])
        if weights == "quadratic":
            w_mat = w_mat**2
    else:
        raise ValueError(
            f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'"
        )
    k = torch.sum(w_mat * confmat) / torch.sum(w_mat * expected)
    return 1.0 - k


def _binary_cohen_kappa_arg_validation(
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    weights: Optional[str] = None,
) -> None:
    _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize=None)
    if weights not in _ALLOWED_WEIGHTS:
        raise ValueError(f"Expected argument `weight` to be one of {_ALLOWED_WEIGHTS}, but got {weights}.")


def binary_cohen_kappa(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Cohen's kappa for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_cohen_kappa
        >>> binary_cohen_kappa(torch.tensor([0.35, 0.85, 0.48, 0.01]), torch.tensor([1, 1, 0, 0]))
        tensor(0.5000)
    """
    if validate_args:
        _binary_cohen_kappa_arg_validation(threshold, ignore_index, weights)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target, valid = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    confmat = _binary_confusion_matrix_update(preds, target, valid)
    return _cohen_kappa_reduce(confmat, weights if weights != "none" else None)


def _multiclass_cohen_kappa_arg_validation(
    num_classes: int,
    ignore_index: Optional[int] = None,
    weights: Optional[str] = None,
) -> None:
    _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize=None)
    if weights not in _ALLOWED_WEIGHTS:
        raise ValueError(f"Expected argument `weight` to be one of {_ALLOWED_WEIGHTS}, but got {weights}.")


def multiclass_cohen_kappa(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Cohen's kappa for multiclass tasks."""
    if validate_args:
        _multiclass_cohen_kappa_arg_validation(num_classes, ignore_index, weights)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    confmat = _multiclass_confusion_matrix_update(preds, target, valid, num_classes)
    return _cohen_kappa_reduce(confmat, weights if weights != "none" else None)


def cohen_kappa(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching Cohen's kappa (binary/multiclass)."""
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_cohen_kappa(preds, target, threshold, weights, ignore_index, validate_args)
    if task == ClassificationTaskNoMultilabel.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_cohen_kappa(preds, target, num_classes, weights, ignore_index, validate_args)
    raise ValueError(f"Not handled value: {task}")
