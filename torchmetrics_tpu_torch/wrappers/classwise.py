"""ClasswiseWrapper (port of ``torchmetrics_tpu/wrappers/classwise.py``).

``to_stream_pool`` gives the multi-tenant form: N independent classwise
streams in one pool (``_streams.adapters.PooledClasswise``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from torch import Tensor

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


class ClasswiseWrapper(WrapperMetric):
    """Split a per-class tensor output into a ``{name_label: scalar}`` dict.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import ClasswiseWrapper
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> metric = ClasswiseWrapper(MulticlassAccuracy(num_classes=3, average=None, device="cpu"))
        >>> metric.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
        >>> sorted(metric.compute().keys())
        ['multiclassaccuracy_0', 'multiclassaccuracy_1', 'multiclassaccuracy_2']
    """

    def __init__(
        self,
        metric: Metric,
        labels: Optional[List[str]] = None,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
    ) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `Metric` but got {metric}")
        super().__init__(device=metric.device)
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to either be `None` or a list of strings but got {labels}")
        self.metric = metric
        self.labels = labels
        self._prefix = prefix
        self._postfix = postfix
        self._update_count = 1

    def _convert(self, x: Tensor) -> Dict[str, Tensor]:
        name = self.metric.__class__.__name__.lower()
        prefix = self._prefix if self._prefix is not None else f"{name}_"
        postfix = self._postfix or ""
        if self._prefix is None and self._postfix is not None:
            prefix = ""
        labels = self.labels if self.labels is not None else range(x.shape[-1])
        return {f"{prefix}{lab}{postfix}": x[..., i] for i, lab in enumerate(labels)}

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        return self._convert(self.metric(*args, **kwargs))

    def update(self, *args: Any, **kwargs: Any) -> None:
        self.metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        return self._convert(self.metric.compute())

    def to_stream_pool(self, *, capacity: int = 8, **kwargs: Any) -> Any:
        """Multi-tenant fast path: N independent classwise streams in one pool (JAX ``classwise.py:67``).

        Returns a :class:`~torchmetrics_tpu_torch._streams.adapters.PooledClasswise`
        whose ``compute(i)`` gives this wrapper's labelled per-class dict for
        stream ``i``, while every stream shares one vmapped update step.
        """
        from torchmetrics_tpu_torch._streams.adapters import PooledClasswise

        return PooledClasswise(self, capacity=capacity, **kwargs)

    def reset(self) -> None:
        self.metric.reset()
