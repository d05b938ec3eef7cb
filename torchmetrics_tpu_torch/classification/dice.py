"""Modular Dice score (port of ``torchmetrics_tpu/classification/dice.py``).

The state is the legacy stat scores: int32 tp/fp/tn/fn sums (scalars under
``average="micro"``, ``(C,)`` otherwise), or ``cat`` states under
``mdmc_average="samplewise"`` or ``average="samples"``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.dice import _dice_compute, _legacy_stat_scores_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

_STATS = ("tp", "fp", "tn", "fn")


class Dice(Metric):
    """Dice score: ``2·tp / (2·tp + fp + fn)``.

    Mirrors the reference's legacy-API class (``classification/dice.py:146-253``):
    ``average`` must be micro/macro/samples, and ``mdmc_average`` picks how
    multi-dim multi-class inputs are folded.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import Dice
        >>> metric = Dice(num_classes=3, average='micro', device="cpu")
        >>> metric.update(torch.tensor([2, 0, 2, 1]), torch.tensor([1, 1, 2, 0]))
        >>> metric.compute()
        tensor(0.2500)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        zero_division: float = 0.0,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = "global",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_average = ("micro", "macro", "samples", "none", None)
        if average not in allowed_average:
            raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
        if average not in ("micro", "macro", "samples"):
            raise ValueError(f"The `reduce` {average} is not valid.")
        if mdmc_average not in (None, "samplewise", "global"):
            raise ValueError(f"The `mdmc_reduce` {mdmc_average} is not valid.")
        if average == "macro" and (not num_classes or num_classes < 1):
            raise ValueError("When you set `average` as 'macro', you have to provide the number of classes.")
        if num_classes and ignore_index is not None and (not ignore_index < num_classes or num_classes == 1):
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")
        if top_k is not None and (not isinstance(top_k, int) or top_k <= 0):
            raise ValueError(f"The `top_k` should be an integer larger than 0, got {top_k}")

        self.reduce = average
        self.mdmc_reduce = mdmc_average
        self.zero_division = zero_division
        self.num_classes = num_classes
        self.threshold = threshold
        self.average = average
        self.ignore_index = ignore_index
        self.top_k = top_k
        self.multiclass = multiclass

        self._streaming = mdmc_average != "samplewise" and average != "samples"
        shape = () if average == "micro" else (num_classes,)
        for s in _STATS:
            if self._streaming:
                self.add_state(s, torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum")
            else:
                self.add_state(s, default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        stats = _legacy_stat_scores_update(
            preds,
            target,
            reduce=self.reduce,
            mdmc_reduce=self.mdmc_reduce,
            threshold=self.threshold,
            num_classes=self.num_classes,
            top_k=self.top_k,
            multiclass=self.multiclass,
            ignore_index=self.ignore_index,
        )
        for name, value in zip(_STATS, stats):
            if self._streaming:
                getattr(self, name).add_(value)
            else:
                getattr(self, name).append(torch.atleast_1d(value))

    def _get_final_stats(self) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        if self._streaming:
            return self.tp, self.fp, self.tn, self.fn
        return tuple(dim_zero_cat(getattr(self, name)) for name in _STATS)  # type: ignore[return-value]

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _dice_compute(tp, fp, fn, self.average, self.mdmc_reduce, self.zero_division)
