"""Hinge loss (port of ``torchmetrics_tpu/functional/classification/hinge.py``).

Parity target: reference ``torchmetrics/functional/classification/hinge.py``. The state is a
float32 sum of the per-sample losses (one per class under one-vs-all) and a float32 count.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.compute import normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.data import _one_hot
from torchmetrics_tpu_torch.utilities.enums import ClassificationTaskNoMultilabel


def _hinge_loss_compute(measure: Tensor, total: Tensor) -> Tensor:
    return measure / total


def _binary_hinge_loss_arg_validation(squared: bool, ignore_index: Optional[int] = None) -> None:
    if not isinstance(squared, bool):
        raise ValueError(f"Expected argument `squared` to be an bool but got {squared}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_hinge_loss_tensor_validation(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> None:
    _check_same_shape(preds, target)
    if not torch.is_floating_point(preds):
        raise ValueError(
            "Expected argument `preds` to be floating tensor with probabilities/logits"
            f" but got tensor with dtype {preds.dtype}"
        )


def _hinge_loss_format(
    preds: Tensor, target: Tensor, num_classes: Optional[int] = None, ignore_index: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    """float32 scores as ``(N,)`` (binary) or ``(N*, C)`` rows, ignored positions dropped."""
    preds = preds.to(torch.float32)
    target = target.reshape(-1)
    preds = preds.reshape(-1) if num_classes is None else torch.movedim(preds, 1, -1).reshape(-1, num_classes)
    if ignore_index is not None:
        keep = target != ignore_index
        preds, target = preds[keep], target[keep]
    return preds, target


def _binary_hinge_loss_update(preds: Tensor, target: Tensor, squared: bool) -> Tuple[Tensor, Tensor]:
    # as the reference's confusion-matrix format step: a sigmoid only when a score lies outside [0, 1]
    preds = normalize_logits_if_needed(preds, "sigmoid")
    target = torch.where(target == 1, 1.0, -1.0)
    measures = torch.clamp(1 - target * preds, min=0)
    if squared:
        measures = measures**2
    return torch.sum(measures), torch.full((), target.shape[0], dtype=torch.float32, device=preds.device)


def binary_hinge_loss(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    ignore_index: Optional[int] = None,
    validate_args: bool = False,
) -> Tensor:
    """Hinge loss for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_hinge_loss
        >>> preds = torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> binary_hinge_loss(preds, target)
        tensor(0.6900)
    """
    if validate_args:
        _binary_hinge_loss_arg_validation(squared, ignore_index)
        _binary_hinge_loss_tensor_validation(preds, target, ignore_index)
    preds, target = _hinge_loss_format(preds, target, None, ignore_index)
    measures, total = _binary_hinge_loss_update(preds, target, squared)
    return _hinge_loss_compute(measures, total)


def _multiclass_hinge_loss_arg_validation(
    num_classes: int,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _binary_hinge_loss_arg_validation(squared, ignore_index)
    allowed_mm = ("crammer-singer", "one-vs-all")
    if multiclass_mode not in allowed_mm:
        raise ValueError(f"Expected argument `multiclass_mode` to be one of {allowed_mm}, but got {multiclass_mode}.")


def _multiclass_hinge_loss_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    squared: bool,
    multiclass_mode: str,
) -> Tuple[Tensor, Tensor]:
    preds = normalize_logits_if_needed(preds, "softmax")
    target_oh = _one_hot(target, num_classes, torch.bool)
    if multiclass_mode == "crammer-singer":
        margin = torch.sum(torch.where(target_oh, preds, 0.0), dim=1)
        margin = margin - torch.max(torch.where(target_oh, -torch.inf, preds), dim=1).values
        measures = torch.clamp(1 - margin, min=0)  # (N,)
    else:
        # one-vs-all keeps per-class losses: a (C,) state (reference ``hinge.py:163-176``)
        target_pm = torch.where(target_oh, 1.0, -1.0)
        measures = torch.clamp(1 - target_pm * preds, min=0)  # (N, C)
    if squared:
        measures = measures**2
    return torch.sum(measures, dim=0), torch.full((), target.shape[0], dtype=torch.float32, device=preds.device)


def multiclass_hinge_loss(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = False,
) -> Tensor:
    """Hinge loss for multiclass tasks (crammer-singer or one-vs-all)."""
    if validate_args:
        _multiclass_hinge_loss_arg_validation(num_classes, squared, multiclass_mode, ignore_index)
    preds, target = _hinge_loss_format(preds, target, num_classes, ignore_index)
    measures, total = _multiclass_hinge_loss_update(preds, target, num_classes, squared, multiclass_mode)
    return _hinge_loss_compute(measures, total)


def hinge_loss(
    preds: Tensor,
    target: Tensor,
    task: str,
    num_classes: Optional[int] = None,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching hinge loss (binary/multiclass)."""
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_hinge_loss(preds, target, squared, ignore_index, validate_args)
    if task == ClassificationTaskNoMultilabel.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_hinge_loss(preds, target, num_classes, squared, multiclass_mode, ignore_index, validate_args)
    raise ValueError(f"Not handled value: {task}")
