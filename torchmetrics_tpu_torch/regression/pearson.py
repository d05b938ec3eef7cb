"""PearsonCorrCoef and ConcordanceCorrCoef (port of ``torchmetrics_tpu/regression/pearson.py``).

The states are one process's co-moments with ``dist_reduce_fx=None``: a
``merge_state`` or a sync stacks them into ``(k, num_outputs)`` moment sets
(``Metric._reduce_states`` and ``Metric._sync_dist``), and ``compute`` folds
those with the parallel-variance merge of ``_final_aggregation``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.concordance import _concordance_corrcoef_compute
from torchmetrics_tpu_torch.functional.regression.pearson import (
    _final_aggregation,
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
)
from torchmetrics_tpu_torch.metric import Metric

_MOMENTS = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")


class PearsonCorrCoef(Metric):
    """Pearson correlation coefficient.

    Example:
        >>> import torch
        >>> metric = PearsonCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> metric.compute()
        tensor(0.9849)
    """

    is_differentiable = True
    higher_is_better = None
    full_state_update = True
    plot_lower_bound: float = -1.0
    plot_upper_bound: float = 1.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected argument `num_outputs` to be an int larger than 0, but got {num_outputs}")
        self.num_outputs = num_outputs
        for name in _MOMENTS:  # n_total is a float32 count, as in the JAX package
            self.add_state(name, default=torch.zeros(self.num_outputs), dist_reduce_fx=None)

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total = _pearson_corrcoef_update(
            preds,
            target,
            self.mean_x,
            self.mean_y,
            self.var_x,
            self.var_y,
            self.corr_xy,
            self.n_total,
            self.num_outputs,
        )

    def _aggregate(self) -> Tuple[Tensor, ...]:
        moments = tuple(getattr(self, name) for name in _MOMENTS)
        if self.mean_x.ndim > 1:  # (k, num_outputs) moment sets from a merge or a sync
            return _final_aggregation(*moments)
        return moments

    def _fold_gathered_states(self, gathered: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Fold gathered ``(D, num_outputs)`` moment sets into one local set (``_final_aggregation``)."""
        return dict(zip(_MOMENTS, _final_aggregation(*(gathered[name] for name in _MOMENTS))))

    def compute(self) -> Tensor:
        _, _, var_x, var_y, corr_xy, n_total = self._aggregate()
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total)


class ConcordanceCorrCoef(PearsonCorrCoef):
    """Lin's concordance correlation coefficient (the moment state of Pearson).

    Example:
        >>> import torch
        >>> metric = ConcordanceCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([3.0, 5.0, 2.5, 7.0]), torch.tensor([3.0, 5.5, 3.0, 7.0]))
        >>> metric.compute()
        tensor(0.9797)
    """

    def compute(self) -> Tensor:
        return _concordance_corrcoef_compute(*self._aggregate())
