"""Abstract base for wrapper metrics (reference ``wrappers/abstract.py:19``)."""

from __future__ import annotations

from typing import Any

from torchmetrics_tpu_torch.metric import Metric


class WrapperMetric(Metric):
    """Base class for wrapping another metric or collection.

    Feature flags (``is_differentiable`` etc.) are NOT inherited from the
    wrapped metric; wrappers must declare their own.
    """

    def _wrap_compute(self, compute: Any) -> Any:
        # wrappers delegate caching/sync to the wrapped metric
        return compute
