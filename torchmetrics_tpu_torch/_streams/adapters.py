"""StreamPool-backed fast paths for the N-independent-copies wrappers.

Port of ``torchmetrics_tpu/_streams/adapters.py``. ``ClasswiseWrapper`` and
``MultitaskWrapper`` are both "many independent metric instances" patterns
behind a wrapper API: classwise fans one per-class metric out to a labelled
dict, multitask keeps one metric per task. Their eager forms pay one Python
dispatch per instance per batch, the cost the pool amortizes. These adapters
keep each wrapper's result shape while routing the state through one pool:

- :class:`PooledMultitask`: every task is one pool slot; a
  ``(task_preds, task_targets)`` update stacks the per-task rows
  (``torch.stack`` on the pool's device) and runs ONE vmapped step. The tasks
  must be homogeneous (one metric class and configuration); heterogeneous
  tasks keep the eager wrapper.
- :class:`PooledClasswise`: multi-tenant classwise: each attached stream owns
  an independent copy of the wrapped per-class metric, and ``compute(i)``
  returns the wrapper's labelled ``{prefix_label: value}`` dict for it.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Optional

import numpy as np
import torch

from torchmetrics_tpu_torch._streams.pool import StreamPool, StreamPoolUnsupported

__all__ = ["PooledClasswise", "PooledMultitask"]


class PooledMultitask:
    """A ``MultitaskWrapper`` backed by one vmapped StreamPool slot per task."""

    def __init__(self, wrapper: Any, **pool_kwargs: Any) -> None:
        from torchmetrics_tpu_torch.metric import Metric

        metrics = dict(wrapper.task_metrics)
        if not metrics:
            raise StreamPoolUnsupported("MultitaskWrapper has no task metrics to pool")
        classes = {type(m) for m in metrics.values()}
        if len(classes) != 1 or not all(isinstance(m, Metric) for m in metrics.values()):
            raise StreamPoolUnsupported(
                "the pooled multitask fast path needs homogeneous tasks (every task the"
                f" same Metric class); got {sorted(c.__name__ for c in classes)} — keep"
                " the eager MultitaskWrapper for heterogeneous tasks"
            )
        template = deepcopy(next(iter(metrics.values())))
        structures = {name: tuple(sorted(m._defaults)) for name, m in metrics.items()}
        if len(set(structures.values())) != 1:
            raise StreamPoolUnsupported(f"task metrics declare different state structures: {structures}")
        self._prefix = wrapper._prefix
        self._postfix = wrapper._postfix
        pool_kwargs.setdefault("capacity", max(1, len(metrics)))
        self.pool = StreamPool(template, **pool_kwargs)
        self.task_slots: Dict[str, int] = {name: self.pool.attach() for name in metrics}

    def _stack(self, task_values: Dict[str, Any]) -> torch.Tensor:
        if set(task_values) != set(self.task_slots):
            raise ValueError(
                f"expected per-task dict with keys {sorted(self.task_slots)}, got {sorted(task_values)}"
            )
        order = sorted(self.task_slots, key=self.task_slots.__getitem__)
        return torch.stack([torch.as_tensor(task_values[name], device=self.pool.device) for name in order])

    def update(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> None:
        """One vmapped step updates every task (the rows must share one shape)."""
        ids = np.asarray(sorted(self.task_slots.values()), dtype=np.int64)
        self.pool.update(ids, self._stack(task_preds), self._stack(task_targets))

    def compute(self) -> Dict[str, Any]:
        values = self.pool.compute_all()
        return {f"{self._prefix}{name}{self._postfix}": values[slot] for name, slot in self.task_slots.items()}

    def reset(self) -> None:
        for slot in self.task_slots.values():
            self.pool.reset(slot)


class PooledClasswise:
    """Multi-tenant ``ClasswiseWrapper``: one pooled per-class metric per stream."""

    def __init__(self, wrapper: Any, **pool_kwargs: Any) -> None:
        self._wrapper = wrapper
        self.pool = StreamPool(deepcopy(wrapper.metric), **pool_kwargs)

    def attach(self) -> int:
        return self.pool.attach()

    def detach(self, stream_id: int) -> None:
        self.pool.detach(stream_id)

    def reset(self, stream_id: Optional[int] = None) -> None:
        self.pool.reset(stream_id)

    def update(self, stream_ids: Any, *args: Any, **kwargs: Any) -> None:
        self.pool.update(stream_ids, *args, **kwargs)

    def compute(self, stream_id: int) -> Dict[str, Any]:
        return self._wrapper._convert(self.pool.compute(stream_id))

    def compute_all(self) -> Dict[int, Dict[str, Any]]:
        return {sid: self._wrapper._convert(value) for sid, value in self.pool.compute_all().items()}
