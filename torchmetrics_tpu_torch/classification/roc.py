"""Modular ROC metrics (port of ``torchmetrics_tpu/classification/roc.py``).

Parity target: reference ``torchmetrics/classification/roc.py``. They keep the
precision-recall curve's states; ``plot`` draws on the host.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

from torch import Tensor

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    _curve_score,
)
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from torchmetrics_tpu_torch.utilities.enums import ClassificationTask
from torchmetrics_tpu_torch.utilities.plot import plot_curve


def _plot_roc(metric: Any, curve: Any, score: Any, ax: Any, multi: bool) -> Any:
    """Shared ROC ``plot`` body (JAX ``classification/roc.py:28``)."""
    curve_computed = curve or metric.compute()
    if score is True and not curve:
        score = _curve_score(curve_computed, multi)
    elif score is True:
        score = None
    return plot_curve(
        curve_computed,
        score=score,
        ax=ax,
        label_names=("False positive rate", "True positive rate"),
        name=type(metric).__name__,
    )


class BinaryROC(BinaryPrecisionRecallCurve):
    """Binary ROC curve; returns (fpr, tpr, thresholds).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryROC
        >>> metric = BinaryROC(thresholds=5, device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> fpr, tpr, thresholds = metric.compute()
        >>> fpr.shape
        torch.Size([5])
    """

    def compute(self):
        return _binary_roc_compute(self._final_state(), self.thresholds)

    def plot(self, curve: Optional[Any] = None, score: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        """Plot the ROC curve, optionally annotated with the area under it."""
        return _plot_roc(self, curve, score, ax, multi=False)


class MulticlassROC(MulticlassPrecisionRecallCurve):
    """One-vs-rest ROC curves for multiclass tasks."""

    def compute(self):
        return _multiclass_roc_compute(self._final_state(), self.num_classes, self.thresholds, self.average)

    def plot(self, curve: Optional[Any] = None, score: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        """Plot per-class ROC curves, optionally annotated with the area under each."""
        return _plot_roc(self, curve, score, ax, multi=True)


class MultilabelROC(MultilabelPrecisionRecallCurve):
    """Per-label ROC curves."""

    def compute(self):
        return _multilabel_roc_compute(self._final_state(), self.num_labels, self.thresholds, self.ignore_index)

    def plot(self, curve: Optional[Any] = None, score: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        """Plot per-label ROC curves, optionally annotated with the area under each."""
        return _plot_roc(self, curve, score, ax, multi=True)


class ROC(_ClassificationTaskWrapper):
    """Task-dispatching ROC."""

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
            return BinaryROC(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassROC(num_classes, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelROC(num_labels, **kwargs)
        raise ValueError(f"Task {task} not supported!")
