"""Modular precision and recall metrics (port of ``torchmetrics_tpu/classification/precision_recall.py``).

Parity target: reference ``torchmetrics/classification/precision_recall.py``. Each metric is a
stat-scores metric (its tp/fp/tn/fn states) with its own ``compute``.
"""

from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores
from torchmetrics_tpu_torch.functional.classification.precision_recall import _precision_recall_reduce
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import ClassificationTask


class _PrecisionRecallMixin:
    """Adds the zero_division knob and the shared compute."""

    _stat: str = "precision"

    def __init__(self, *args: Any, zero_division: float = 0.0, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.zero_division = zero_division


class BinaryPrecision(_PrecisionRecallMixin, BinaryStatScores):
    """Binary precision ``tp / (tp + fp)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryPrecision
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> metric = BinaryPrecision(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.6667)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    _stat = "precision"

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            self._stat, tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average,
            zero_division=self.zero_division,
        )


class MulticlassPrecision(_PrecisionRecallMixin, MulticlassStatScores):
    """Multiclass precision."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Class"
    _stat = "precision"

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            self._stat, tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average,
            top_k=self.top_k, zero_division=self.zero_division,
        )


class MultilabelPrecision(_PrecisionRecallMixin, MultilabelStatScores):
    """Multilabel precision."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Label"
    _stat = "precision"

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            self._stat, tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average,
            multilabel=True, zero_division=self.zero_division,
        )


class BinaryRecall(BinaryPrecision):
    """Binary recall ``tp / (tp + fn)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryRecall
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> metric = BinaryRecall(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.6667)
    """

    _stat = "recall"


class MulticlassRecall(MulticlassPrecision):
    """Multiclass recall."""

    _stat = "recall"


class MultilabelRecall(MultilabelPrecision):
    """Multilabel recall."""

    _stat = "recall"


class Precision(_ClassificationTaskWrapper):
    """Task-dispatching Precision."""

    _binary_cls = BinaryPrecision
    _multiclass_cls = MulticlassPrecision
    _multilabel_cls = MultilabelPrecision

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({
            "multidim_average": multidim_average,
            "ignore_index": ignore_index,
            "validate_args": validate_args,
            "zero_division": zero_division,
        })
        if task == ClassificationTask.BINARY:
            return cls._binary_cls(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            if not isinstance(top_k, int):
                raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
            return cls._multiclass_cls(num_classes, top_k, average, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return cls._multilabel_cls(num_labels, threshold, average, **kwargs)
        raise ValueError(f"Not handled value: {task}")


class Recall(Precision):
    """Task-dispatching Recall."""

    _binary_cls = BinaryRecall
    _multiclass_cls = MulticlassRecall
    _multilabel_cls = MultilabelRecall
