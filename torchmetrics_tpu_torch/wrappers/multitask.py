"""MultitaskWrapper (port of ``torchmetrics_tpu/wrappers/multitask.py``).

The task metrics are an ``nn.ModuleDict``, so ``.to()`` moves them.
``to_stream_pool`` gives the homogeneous-task fast path: one pool slot per
task, every task updated in one vmapped step
(``_streams.adapters.PooledMultitask``).
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch
from torch import nn

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


def _device_of(metric: Union[Metric, MetricCollection]) -> torch.device:
    return metric.device if isinstance(metric, Metric) else next(iter(metric.values(copy_state=False))).device


class MultitaskWrapper(WrapperMetric):
    """Route per-task (preds, target) dicts to a dict of metrics.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import MultitaskWrapper
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
        >>> metric = MultitaskWrapper({"cls": BinaryAccuracy(device="cpu"), "reg": MeanSquaredError(device="cpu")})
        >>> preds = {"cls": torch.tensor([1, 0]), "reg": torch.tensor([1.0, 2.0])}
        >>> target = {"cls": torch.tensor([1, 1]), "reg": torch.tensor([1.5, 2.0])}
        >>> metric.update(preds, target)
        >>> sorted(metric.compute().keys())
        ['cls', 'reg']
    """

    is_differentiable = False

    def __init__(
        self,
        task_metrics: Dict[str, Union[Metric, MetricCollection]],
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
    ) -> None:
        if not isinstance(task_metrics, dict):
            raise TypeError(f"Expected argument `task_metrics` to be a dict. Found task_metrics = {task_metrics}")
        for metric in task_metrics.values():
            if not isinstance(metric, (Metric, MetricCollection)):
                raise TypeError(
                    "Expected each task's metric to be a Metric or a MetricCollection. "
                    f"Found a metric of type {type(metric)}"
                )
        super().__init__(device=_device_of(next(iter(task_metrics.values()))) if task_metrics else None)
        self.task_metrics = nn.ModuleDict(task_metrics)
        self._prefix = prefix or ""
        self._postfix = postfix or ""

    def _check_all_tasks_covered(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> None:
        if self.task_metrics.keys() != task_preds.keys() or self.task_metrics.keys() != task_targets.keys():
            raise ValueError(
                "Expected arguments `task_preds` and `task_targets` to have the same keys as the wrapped"
                f" `task_metrics`. Found task_preds.keys() = {task_preds.keys()},"
                f" task_targets.keys() = {task_targets.keys()}"
                f" and self.task_metrics.keys() = {self.task_metrics.keys()}"
            )

    def update(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> None:
        self._check_all_tasks_covered(task_preds, task_targets)
        for name, metric in self.task_metrics.items():
            metric.update(task_preds[name], task_targets[name])

    def compute(self) -> Dict[str, Any]:
        return {self._prefix + name + self._postfix: metric.compute() for name, metric in self.task_metrics.items()}

    def forward(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> Dict[str, Any]:
        self._check_all_tasks_covered(task_preds, task_targets)
        return {
            self._prefix + name + self._postfix: metric(task_preds[name], task_targets[name])
            for name, metric in self.task_metrics.items()
        }

    def reset(self) -> None:
        for metric in self.task_metrics.values():
            metric.reset()
        super().reset()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MultitaskWrapper":
        """A deep copy, with a new prefix or postfix where given."""
        mt = deepcopy(self)
        if prefix is not None:
            mt._prefix = prefix
        if postfix is not None:
            mt._postfix = postfix
        return mt

    def to_stream_pool(self, **kwargs: Any) -> Any:
        """Homogeneous-task fast path: one vmapped pool slot per task (JAX ``multitask.py:88``).

        Returns a :class:`~torchmetrics_tpu_torch._streams.adapters.PooledMultitask`
        that updates every task in one vmapped step instead of one Python
        dispatch per task. Every task metric must be of one class with one
        state structure (heterogeneous wrappers keep this eager path); the
        per-task batch rows must share one shape.
        """
        from torchmetrics_tpu_torch._streams.adapters import PooledMultitask

        return PooledMultitask(self, **kwargs)

    def items(self, flatten: bool = True) -> Iterator[Tuple[str, Any]]:
        """(task name, metric) pairs; with ``flatten`` a collection's members as ``{task}_{metric}``."""
        for task_name, metric in self.task_metrics.items():
            if flatten and isinstance(metric, MetricCollection):
                for sub_metric_name, sub_metric in metric.items():
                    yield f"{task_name}_{sub_metric_name}", sub_metric
            else:
                yield task_name, metric

    def keys(self, flatten: bool = True) -> Iterator[str]:
        """Task names; with ``flatten`` a collection's members as ``{task}_{metric}``."""
        for task_name, metric in self.task_metrics.items():
            if flatten and isinstance(metric, MetricCollection):
                for sub_metric_name in metric:
                    yield f"{task_name}_{sub_metric_name}"
            else:
                yield task_name

    def values(self, flatten: bool = True) -> Iterator[Any]:
        """Task metrics; with ``flatten`` a collection's members one by one."""
        for metric in self.task_metrics.values():
            if flatten and isinstance(metric, MetricCollection):
                yield from metric.values()
            else:
                yield metric
