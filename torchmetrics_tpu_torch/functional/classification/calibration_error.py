"""Calibration error: binned ECE/MCE (port of ``torchmetrics_tpu/functional/classification/calibration_error.py``).

Parity target: reference ``torchmetrics/functional/classification/calibration_error.py``. The
``n_bins + 1`` bin boundaries are ``jax.numpy.linspace``'s float32 grid (``torch.linspace``
rounds some of them differently, which moves a confidence lying on a boundary into the
neighbouring bin). A confidence goes to bucket ``searchsorted(boundaries[1:-1], right=True)``,
and the per-bin counts and float32 sums are ``index_add_`` segment sums. On CUDA their adds
land in an order that varies from run to run, so per-bin sums, and the error, vary in the last
bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape, _in_compiled_step
from torchmetrics_tpu_torch.utilities.compute import _safe_divide, normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.enums import ClassificationTaskNoMultilabel


def _bin_boundaries(n_bins: int, device: Optional[torch.device] = None) -> Tensor:
    """``n_bins + 1`` float32 boundaries over ``[0, 1]``, equal to ``jax.numpy.linspace(0, 1, n_bins + 1)``."""
    return _adjust_threshold_arg(n_bins + 1, device)


def _binning_bucketize(confidences: Tensor, accuracies: Tensor, bin_boundaries: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-bin (accuracy, confidence, proportion) from segment sums over the bucket indices."""
    n_bins = bin_boundaries.shape[0] - 1
    idx = torch.clamp(torch.searchsorted(bin_boundaries[1:-1], confidences, right=True), 0, n_bins - 1)

    def segment_sum(values: Tensor) -> Tensor:
        return torch.zeros(n_bins, dtype=torch.float32, device=values.device).index_add_(0, idx, values)

    counts = segment_sum(torch.ones(idx.shape[0], dtype=torch.float32, device=idx.device))
    conf_bin = _safe_divide(segment_sum(confidences.to(torch.float32)), counts)
    acc_bin = _safe_divide(segment_sum(accuracies.to(torch.float32)), counts)
    prop_bin = counts / confidences.shape[0]
    return acc_bin, conf_bin, prop_bin


def _ce_compute(
    confidences: Tensor,
    accuracies: Tensor,
    bin_boundaries: Tensor,
    norm: str = "l1",
    debias: bool = False,
) -> Tensor:
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Argument `norm` is expected to be one of 'l1', 'l2', 'max' but got {norm}")
    if isinstance(bin_boundaries, int):
        bin_boundaries = _bin_boundaries(bin_boundaries, confidences.device)
    acc_bin, conf_bin, prop_bin = _binning_bucketize(confidences, accuracies, bin_boundaries)

    if norm == "l1":
        return torch.sum(torch.abs(acc_bin - conf_bin) * prop_bin)
    if norm == "max":
        return torch.max(torch.abs(acc_bin - conf_bin))
    ce = torch.sum(torch.square(acc_bin - conf_bin) * prop_bin)
    if debias:
        debias_bins = _safe_divide(acc_bin * (acc_bin - 1) * prop_bin, prop_bin * confidences.shape[0] - 1)
        ce = ce + torch.sum(debias_bins)
    return torch.sqrt(ce) if bool(ce > 0) else torch.zeros((), device=ce.device)


def _binary_calibration_error_arg_validation(
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(n_bins, int) or n_bins < 1:
        raise ValueError(f"Expected argument `n_bins` to be an integer larger than 0, but got {n_bins}")
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Expected argument `norm` to be one of 'l1', 'l2' or 'max' but got {norm}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_calibration_error_tensor_validation(
    preds: Tensor, target: Tensor, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if not torch.is_floating_point(preds):
        raise ValueError(f"Expected argument `preds` to be floating tensor but got {preds.dtype}")


def _binary_calibration_error_format(
    preds: Tensor, target: Tensor, ignore_index: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    """Flatten, drop ignored positions and map logits to probabilities."""
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    if ignore_index is not None:
        keep = target != ignore_index
        preds, target = preds[keep], target[keep]
    return normalize_logits_if_needed(preds, "sigmoid"), target


def _binary_calibration_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    # reference semantics: the confidence is the predicted probability and the
    # accuracy is the label, not the max-probability/argmax-match of the multiclass path
    return preds, target.to(torch.float32)


def binary_calibration_error(
    preds: Tensor,
    target: Tensor,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Expected/maximum calibration error for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_calibration_error
        >>> preds = torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> binary_calibration_error(preds, target, n_bins=2, norm='l1')
        tensor(0.2900)
    """
    if validate_args:
        _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        _binary_calibration_error_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_calibration_error_format(preds, target, ignore_index)
    confidences, accuracies = _binary_calibration_error_update(preds, target)
    return _ce_compute(confidences, accuracies, _bin_boundaries(n_bins, preds.device), norm)


def _multiclass_calibration_error_arg_validation(
    num_classes: int,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)


def _multiclass_calibration_error_format(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    """``(N, C, ...)`` scores to ``(N*, C)`` rows, ignored positions dropped."""
    target = target.reshape(-1)
    preds = torch.movedim(preds, 1, -1).reshape(-1, num_classes)
    if ignore_index is not None:
        keep = target != ignore_index
        preds, target = preds[keep], target[keep]
    return preds, target


def _multiclass_calibration_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Top-1 confidence and hit per row; softmax first unless every score lies in ``[0, 1]``.

    Eagerly the choice is one host read; inside a compiled step it is made on
    the device, with the softmax always computed.
    """
    in_range = torch.all((preds >= 0) & (preds <= 1))
    if _in_compiled_step():
        preds = torch.where(in_range, preds, torch.softmax(preds, dim=1))
    elif not bool(in_range):
        preds = torch.softmax(preds, dim=1)
    confidences, predictions = torch.max(preds, dim=1)
    accuracies = (predictions == target).to(torch.float32)
    return confidences, accuracies


def multiclass_calibration_error(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Top-1 calibration error for multiclass tasks."""
    if validate_args:
        _multiclass_calibration_error_arg_validation(num_classes, n_bins, norm, ignore_index)
    preds, target = _multiclass_calibration_error_format(preds, target, num_classes, ignore_index)
    confidences, accuracies = _multiclass_calibration_error_update(preds, target)
    return _ce_compute(confidences, accuracies, _bin_boundaries(n_bins, preds.device), norm)


def calibration_error(
    preds: Tensor,
    target: Tensor,
    task: str,
    n_bins: int = 15,
    norm: str = "l1",
    num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching calibration error (binary/multiclass)."""
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_calibration_error(preds, target, n_bins, norm, ignore_index, validate_args)
    if task == ClassificationTaskNoMultilabel.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_calibration_error(preds, target, num_classes, n_bins, norm, ignore_index, validate_args)
    raise ValueError(f"Not handled value: {task}")
