"""Modular precision-recall curve metrics (port of ``torchmetrics_tpu/classification/precision_recall_curve.py``).

Parity target: reference ``torchmetrics/classification/precision_recall_curve.py``.
With ``thresholds=None`` the states are ``preds``/``target`` cat lists (ring
buffers under ``cat_state_capacity``) and ``compute`` gives the exact curve;
otherwise one ``(T, 2, 2)`` / ``(T, C, 2, 2)`` int32 ``confmat`` state, summed
in place and reduced by ``"sum"`` across processes. ``plot`` draws the
curve on the host (``utilities/plot.py``).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.auroc import _reduce_auroc
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _adjust_threshold_arg,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.checks import _no_value_flags, _target_set_value_flags
from torchmetrics_tpu_torch.utilities.compute import _auc_compute_without_check
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat
from torchmetrics_tpu_torch.utilities.enums import ClassificationTask
from torchmetrics_tpu_torch.utilities.plot import plot_curve


def _curve_score(curve_computed: Any, multi: bool) -> Any:
    """The area under ``(x, y)``: one a class or label where ``multi``, else one."""
    if multi:
        return _reduce_auroc(curve_computed[0], curve_computed[1], average=None)
    return _auc_compute_without_check(curve_computed[0], curve_computed[1], 1.0)


def _plot_prc(metric: Any, curve: Any, score: Any, ax: Any, multi: bool) -> Any:
    """Shared PRC ``plot`` body (JAX ``classification/precision_recall_curve.py:44``)."""
    curve_computed = curve or metric.compute()
    # x-axis is recall, y-axis is precision
    curve_computed = (curve_computed[1], curve_computed[0], curve_computed[2])
    if score is True and not curve:
        score = _curve_score(curve_computed, multi)
    elif score is True:
        score = None
    return plot_curve(
        curve_computed, score=score, ax=ax, label_names=("Recall", "Precision"), name=type(metric).__name__
    )


class BinaryPrecisionRecallCurve(Metric):
    """Binary precision-recall curve.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryPrecisionRecallCurve
        >>> metric = BinaryPrecisionRecallCurve(thresholds=5, device="cpu")
        >>> metric.update(torch.tensor([0.0, 0.5, 0.7, 0.8]), torch.tensor([0, 1, 1, 0]))
        >>> precision, recall, thresholds = metric.compute()
        >>> thresholds.shape
        torch.Size([5])
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        self.ignore_index = ignore_index
        self.validate_args = validate_args

        thresholds = _adjust_threshold_arg(thresholds, self.device)
        self.register_buffer("thresholds", thresholds, persistent=False)  # moves with the metric's states
        if thresholds is None:
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("confmat", default=torch.zeros((thresholds.shape[0], 2, 2), dtype=torch.int32), dist_reduce_fx="sum")

    def _traced_value_flags(self, preds: Tensor, target: Tensor) -> Tuple[Tuple[str, ...], Tensor]:
        # the eager validator's only value check (JAX ``precision_recall_curve.py:116``)
        return _target_set_value_flags(target, self.ignore_index)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_precision_recall_curve_tensor_validation(preds, target, self.ignore_index)
        preds, target, _ = _binary_precision_recall_curve_format(preds, target, None, self.ignore_index)
        state = _binary_precision_recall_curve_update(preds, target, self.thresholds)
        if isinstance(state, tuple):
            self.preds.append(state[0])
            self.target.append(state[1])
        else:
            self.confmat += state

    def _final_state(self):
        if self.thresholds is None:
            return dim_zero_cat(self.preds), dim_zero_cat(self.target)
        return self.confmat

    def compute(self):
        return _binary_precision_recall_curve_compute(self._final_state(), self.thresholds)

    def plot(self, curve: Optional[Any] = None, score: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        """Plot the precision-recall curve, optionally annotated with the area under it."""
        return _plot_prc(self, curve, score, ax, multi=False)


class MulticlassPrecisionRecallCurve(Metric):
    """Multiclass (one-vs-rest) precision-recall curves."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        self.num_classes = num_classes
        self.average = average
        self.ignore_index = ignore_index
        self.validate_args = validate_args

        thresholds = _adjust_threshold_arg(thresholds, self.device)
        self.register_buffer("thresholds", thresholds, persistent=False)  # moves with the metric's states
        if thresholds is None:
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")
        else:
            shape = (thresholds.shape[0], 2, 2) if average == "micro" else (thresholds.shape[0], num_classes, 2, 2)
            self.add_state("confmat", default=torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum")

    def _traced_value_flags(self, preds: Tensor, target: Tensor) -> Tuple[Tuple[str, ...], Tensor]:
        return _no_value_flags(preds, target)  # the eager checks read shapes and dtypes only

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_precision_recall_curve_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target, _ = _multiclass_precision_recall_curve_format(
            preds, target, self.num_classes, None, self.ignore_index, self.average
        )
        state = _multiclass_precision_recall_curve_update(
            preds, target, self.num_classes, self.thresholds, self.average
        )
        if isinstance(state, tuple):
            self.preds.append(state[0])
            self.target.append(state[1])
        else:
            self.confmat += state

    def _final_state(self):
        if self.thresholds is None:
            return dim_zero_cat(self.preds), dim_zero_cat(self.target)
        return self.confmat

    def compute(self):
        return _multiclass_precision_recall_curve_compute(
            self._final_state(), self.num_classes, self.thresholds, self.average
        )

    def plot(self, curve: Optional[Any] = None, score: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        """Plot the precision-recall curves, optionally annotated with the area under each."""
        return _plot_prc(self, curve, score, ax, multi=True)


class MultilabelPrecisionRecallCurve(Metric):
    """Per-label precision-recall curves."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_labels: int,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args

        thresholds = _adjust_threshold_arg(thresholds, self.device)
        self.register_buffer("thresholds", thresholds, persistent=False)  # moves with the metric's states
        if thresholds is None:
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")
        else:
            self.add_state(
                "confmat",
                default=torch.zeros((thresholds.shape[0], num_labels, 2, 2), dtype=torch.int32),
                dist_reduce_fx="sum",
            )

    def _traced_value_flags(self, preds: Tensor, target: Tensor) -> Tuple[Tuple[str, ...], Tensor]:
        return _no_value_flags(preds, target)  # the eager checks read shapes and dtypes only

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_precision_recall_curve_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target, _ = _multilabel_precision_recall_curve_format(
            preds, target, self.num_labels, None, self.ignore_index
        )
        state = _multilabel_precision_recall_curve_update(
            preds, target, self.num_labels, self.thresholds, self.ignore_index
        )
        if isinstance(state, tuple):
            self.preds.append(state[0])
            self.target.append(state[1])
        else:
            self.confmat += state

    def _final_state(self):
        if self.thresholds is None:
            return dim_zero_cat(self.preds), dim_zero_cat(self.target)
        return self.confmat

    def compute(self):
        return _multilabel_precision_recall_curve_compute(
            self._final_state(), self.num_labels, self.thresholds, self.ignore_index
        )

    def plot(self, curve: Optional[Any] = None, score: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        """Plot the precision-recall curves, optionally annotated with the area under each."""
        return _plot_prc(self, curve, score, ax, multi=True)


class PrecisionRecallCurve(_ClassificationTaskWrapper):
    """Task-dispatching precision-recall curve."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryPrecisionRecallCurve(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassPrecisionRecallCurve(num_classes, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelPrecisionRecallCurve(num_labels, **kwargs)
        raise ValueError(f"Task {task} not supported!")
