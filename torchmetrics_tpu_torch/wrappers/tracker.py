"""MetricTracker (port of ``torchmetrics_tpu/wrappers/tracker.py``).

The tracked steps are an ``nn.ModuleList`` of fresh copies of the base
metric. ``best_metric`` reads the best step's index on the host once, as the
JAX package's ``np.argmax`` does. ``plot`` waits for the plotting helpers,
which are not ported yet.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, List, Tuple, Union

import torch
from torch import Tensor, nn

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric
from torchmetrics_tpu_torch.wrappers.multitask import _device_of


class MetricTracker(WrapperMetric):
    """Track a metric (or collection) over steps or epochs.

    ``increment()`` starts a new tracked step (a fresh copy); ``best_metric``
    returns the best value (and with ``return_step`` its step) according to
    ``maximize`` or the metric's ``higher_is_better``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import MetricTracker
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> tracker = MetricTracker(BinaryAccuracy(device="cpu"))
        >>> for epoch_acc in ([1, 1], [1, 0]):
        ...     tracker.increment()
        ...     _ = tracker(torch.tensor(epoch_acc), torch.tensor([1, 1]))
        >>> float(tracker.best_metric())
        1.0
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool], None] = True) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "Metric arg need to be an instance of a Metric or MetricCollection" f" but got {metric}"
            )
        super().__init__(device=_device_of(metric))
        self._base_metric = metric
        if maximize is None:
            if isinstance(metric, Metric):
                if metric.higher_is_better is None:
                    raise AttributeError("`higher_is_better` undefined; provide `maximize` explicitly")
                maximize = metric.higher_is_better
            else:
                maximize = [
                    m.higher_is_better if m.higher_is_better is not None else True for m in metric.values()
                ]
        if not isinstance(maximize, (bool, list)):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list) and not all(isinstance(m, bool) for m in maximize):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        self.maximize = maximize
        self._steps = nn.ModuleList()
        self._increment_called = False

    @property
    def n_steps(self) -> int:
        """Number of tracked steps."""
        return len(self._steps)

    def increment(self) -> None:
        """Start tracking a new step."""
        self._increment_called = True
        self._steps.append(deepcopy(self._base_metric))
        self._steps[-1].reset()

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called.")

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._check_for_increment("forward")
        return self._steps[-1](*args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_for_increment("update")
        self._steps[-1].update(*args, **kwargs)

    def compute(self) -> Any:
        self._check_for_increment("compute")
        return self._steps[-1].compute()

    def compute_all(self) -> Any:
        """Every tracked step's value, stacked (a dict of stacks for a collection)."""
        self._check_for_increment("compute_all")
        res = [step.compute() for step in self._steps]
        if isinstance(self._base_metric, MetricCollection):
            return {k: torch.stack([r[k] for r in res], dim=0) for k in res[0]}
        return torch.stack(res, dim=0)

    def best_metric(self, return_step: bool = False) -> Any:
        """Best value over the tracked steps (and with ``return_step`` its index); ``None`` where not defined."""
        res = self.compute_all()

        def _best(vals: Any, maximize: bool) -> Tuple[Any, int]:
            if not isinstance(vals, Tensor) or vals.ndim != 1:
                raise ValueError("Per-step values are not scalars; cannot determine best")
            idx = int(torch.argmax(vals) if maximize else torch.argmin(vals))
            return vals[idx], idx

        try:
            if isinstance(res, dict):
                maximize = self.maximize if isinstance(self.maximize, list) else [self.maximize] * len(res)
                value, idx = {}, {}
                for i, (k, v) in enumerate(res.items()):
                    value[k], idx[k] = _best(v, maximize[i])
                return (value, idx) if return_step else value
            value, idx = _best(res, bool(self.maximize))
            return (value, idx) if return_step else value
        except (ValueError, TypeError) as err:
            rank_zero_warn(
                f"Encountered the following error when trying to get the best metric: {err}"
                " this is probably due to the 'best' not being defined for this metric."
                " Returning `None` instead.",
                UserWarning,
            )
            return (None, None) if return_step else None

    def reset(self) -> None:
        """Reset the current step."""
        if len(self._steps):
            self._steps[-1].reset()

    def reset_all(self) -> None:
        """Forget all tracked steps."""
        self._steps = nn.ModuleList()
        self._increment_called = False
