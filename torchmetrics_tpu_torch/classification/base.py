"""Task-dispatch base for classification metrics (reference ``torchmetrics/classification/base.py:19``)."""

from __future__ import annotations

from typing import Any

from torchmetrics_tpu_torch.metric import Metric


class _ClassificationTaskWrapper(Metric):
    """Base for wrapper metrics that dispatch to task-specific implementations via ``__new__``."""

    def __new__(cls, *args: Any, **kwargs: Any) -> "Metric":
        if cls is _ClassificationTaskWrapper:
            raise NotImplementedError("This class should not be instantiated directly.")
        return super().__new__(cls)

    def update(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError(
            f"{self.__class__.__name__} metric does not exist for the chosen task. "
            "This wrapper should have dispatched to a task-specific class."
        )

    def compute(self) -> None:
        raise NotImplementedError(f"{self.__class__.__name__} metric does not exist for the chosen task.")
