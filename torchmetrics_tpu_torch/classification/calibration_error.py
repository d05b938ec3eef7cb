"""Modular calibration error (port of ``torchmetrics_tpu/classification/calibration_error.py``).

The states are ``cat`` lists (ring buffers under ``cat_state_capacity``) of
per-sample confidence and accuracy; the binning happens at ``compute``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from torch import Tensor

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.calibration_error import (
    _bin_boundaries,
    _binary_calibration_error_arg_validation,
    _binary_calibration_error_format,
    _binary_calibration_error_tensor_validation,
    _binary_calibration_error_update,
    _ce_compute,
    _multiclass_calibration_error_arg_validation,
    _multiclass_calibration_error_format,
    _multiclass_calibration_error_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.checks import _no_value_flags
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat
from torchmetrics_tpu_torch.utilities.enums import ClassificationTaskNoMultilabel


class _AbstractCalibrationError(Metric):
    """Owns the confidence/accuracy ``cat`` states and the binned compute."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def _create_state(self) -> None:
        self.add_state("confidences", [], dist_reduce_fx="cat")
        self.add_state("accuracies", [], dist_reduce_fx="cat")

    def _traced_value_flags(self, preds: Tensor, target: Tensor) -> Tuple[Tuple[str, ...], Tensor]:
        return _no_value_flags(preds, target)  # the eager checks read shapes and dtypes only

    def compute(self) -> Tensor:
        confidences = dim_zero_cat(self.confidences)
        accuracies = dim_zero_cat(self.accuracies)
        return _ce_compute(confidences, accuracies, _bin_boundaries(self.n_bins, confidences.device), self.norm)


class BinaryCalibrationError(_AbstractCalibrationError):
    """Expected/maximum calibration error for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryCalibrationError
        >>> metric = BinaryCalibrationError(n_bins=2, norm='l1', device="cpu")
        >>> metric.update(torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75]), torch.tensor([0, 0, 1, 1, 1]))
        >>> metric.compute()
        tensor(0.2900)
    """

    def __init__(
        self,
        n_bins: int = 15,
        norm: str = "l1",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        # config set in `__init__` itself: the R1 certifier proves the class against it
        self.n_bins = n_bins
        self.norm = norm
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state()

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_calibration_error_tensor_validation(preds, target, self.ignore_index)
        preds, target = _binary_calibration_error_format(preds, target, self.ignore_index)
        confidences, accuracies = _binary_calibration_error_update(preds, target)
        self.confidences.append(confidences)
        self.accuracies.append(accuracies)


class MulticlassCalibrationError(_AbstractCalibrationError):
    """Top-1 calibration error for multiclass tasks."""

    def __init__(
        self,
        num_classes: int,
        n_bins: int = 15,
        norm: str = "l1",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_calibration_error_arg_validation(num_classes, n_bins, norm, ignore_index)
        self.num_classes = num_classes
        # config set in `__init__` itself: the R1 certifier proves the class against it
        self.n_bins = n_bins
        self.norm = norm
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state()

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _multiclass_calibration_error_format(preds, target, self.num_classes, self.ignore_index)
        confidences, accuracies = _multiclass_calibration_error_update(preds, target)
        self.confidences.append(confidences)
        self.accuracies.append(accuracies)


class CalibrationError(_ClassificationTaskWrapper):
    """Task-dispatching calibration error (binary/multiclass)."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        n_bins: int = 15,
        norm: str = "l1",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"n_bins": n_bins, "norm": norm, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryCalibrationError(**kwargs)
        if task == ClassificationTaskNoMultilabel.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassCalibrationError(num_classes, **kwargs)
        raise ValueError(f"Task {task} not supported!")
