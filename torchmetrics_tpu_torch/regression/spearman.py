"""SpearmanCorrCoef and KendallRankCorrCoef (port of ``torchmetrics_tpu/regression/spearman.py``).

Both keep the whole sample in ``cat`` list states and rank at ``compute``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.kendall import (
    _MetricVariant,
    _TestAlternative,
    kendall_rank_corrcoef,
)
from torchmetrics_tpu_torch.functional.regression.spearman import _spearman_corrcoef_compute, _spearman_corrcoef_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class SpearmanCorrCoef(Metric):
    """Spearman rank correlation.

    Example:
        >>> import torch
        >>> metric = SpearmanCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> metric.compute()
        tensor(1.0000)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = -1.0
    plot_upper_bound: float = 1.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected argument `num_outputs` to be an int larger than 0, but got {num_outputs}")
        self.num_outputs = num_outputs
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _spearman_corrcoef_update(preds, target, self.num_outputs)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        return _spearman_corrcoef_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target))


class KendallRankCorrCoef(Metric):
    """Kendall rank correlation (tau-a/b/c), with its p-value under ``t_test``.

    Example:
        >>> import torch
        >>> metric = KendallRankCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> metric.compute()
        tensor(1.)
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = True
    plot_lower_bound: float = -1.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        variant: str = "b",
        t_test: bool = False,
        alternative: Optional[str] = "two-sided",
        num_outputs: int = 1,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(t_test, bool):
            raise ValueError(f"Argument `t_test` is expected to be of a type `bool`, but got {t_test}.")
        _MetricVariant.from_str(str(variant))  # fail fast on an invalid variant
        if t_test and alternative is not None:
            _TestAlternative.from_str(str(alternative))
        self.variant = variant
        self.alternative = alternative if t_test else None
        self.t_test = t_test
        self.num_outputs = num_outputs
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.preds.append(torch.as_tensor(preds, dtype=torch.float32))
        self.target.append(torch.as_tensor(target, dtype=torch.float32))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        return kendall_rank_corrcoef(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.variant, self.t_test, self.alternative
        )
