"""Perplexity (port of ``torchmetrics_tpu/text/perplexity.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.perplexity import _perplexity_compute, _perplexity_update
from torchmetrics_tpu_torch.metric import Metric


class Perplexity(Metric):
    """Perplexity of a language model: exp of the mean negative log likelihood.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.text import Perplexity
        >>> probs = torch.tensor([0.1, 0.2, 0.3, 0.25, 0.15])
        >>> preds = torch.log(probs.repeat(2, 8, 1))  # log-probabilities
        >>> target = torch.tensor([0, 1, 2, 3, 4, 0, 1, 2]).repeat(2, 1)
        >>> perp = Perplexity(ignore_index=-100, device="cpu")
        >>> round(float(perp(preds, target)), 3)
        5.416
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError(f"Argument `ignore_index` expected to either be `None` or an `int` but got {ignore_index}")
        self.ignore_index = ignore_index
        self.add_state("total_log_probs", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("count", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        total_log_probs, count = _perplexity_update(preds, target, self.ignore_index)
        self.total_log_probs += total_log_probs
        self.count += count

    def compute(self) -> Tensor:
        return _perplexity_compute(self.total_log_probs, self.count)
