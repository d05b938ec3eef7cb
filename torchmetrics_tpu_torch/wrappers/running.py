"""Running-window wrapper (reference ``wrappers/running.py:27``).

Port of ``torchmetrics_tpu/wrappers/running.py``. Keeps the last ``window``
batch states and computes over their merge: each slot is a copy of the base
metric's states after one update from a clean state, and ``compute`` folds
the slots into the base metric with the declared per-state reductions
(``merge_state``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


class Running(WrapperMetric):
    """Compute the base metric over only the last ``window`` updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import Running
        >>> from torchmetrics_tpu_torch.aggregation import SumMetric
        >>> metric = Running(SumMetric(device="cpu"), window=2)
        >>> for v in [1.0, 2.0, 3.0]:
        ...     metric.update(torch.tensor(v))
        >>> metric.compute()
        tensor(5.)
    """

    def __init__(self, base_metric: Metric, window: int = 5) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `Metric` but got {base_metric}")
        super().__init__(device=base_metric.device)
        if not (isinstance(window, int) and window > 0):
            raise ValueError(f"Expected argument `window` to be a positive integer but got {window}")
        self.base_metric = base_metric
        self.window = window
        if base_metric.full_state_update is not False:
            raise ValueError(
                f"Expected attribute `full_state_update` set to `False` but got {base_metric.full_state_update}"
            )
        self._num_vals_seen = 0
        self._slots: List[Tuple[Dict[str, Any], int]] = []

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Run the base update on a clean state and keep its states in the rotating window."""
        prev_state = self.base_metric._copy_state_dict()
        prev_count = self.base_metric._update_count
        self.base_metric.reset()
        self.base_metric.update(*args, **kwargs)
        snapshot = (self.base_metric._copy_state_dict(), self.base_metric._update_count)
        if len(self._slots) >= self.window:
            self._slots.pop(0)
        self._slots.append(snapshot)
        self._num_vals_seen += 1
        # restore, so that use of base_metric outside the wrapper is unaffected
        self.base_metric._restore_state(prev_state)
        self.base_metric._update_count = prev_count

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Batch value of the base metric while rotating the window."""
        self.update(*args, **kwargs)
        return self._compute_from_slots(self._slots[-1:])

    def _compute_from_slots(self, slots: List[Tuple[Dict[str, Any], int]]) -> Any:
        base = self.base_metric
        prev_state = base._copy_state_dict()
        prev_count = base._update_count
        base.reset()
        for state, count in slots:
            base.merge_state(dict(state))
            base._update_count = base._update_count - 1 + count  # merge_state counts a dict as 1 update
        val = base.compute()
        base.reset()
        base._restore_state(prev_state)
        base._update_count = prev_count
        return val

    def compute(self) -> Any:
        if not self._slots:
            return self.base_metric.compute()
        return self._compute_from_slots(self._slots)

    def reset(self) -> None:
        super().reset()
        self.base_metric.reset()
        self._slots = []
        self._num_vals_seen = 0
