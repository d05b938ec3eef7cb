"""Modular nominal-association metrics (port of ``torchmetrics_tpu/nominal/__init__.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.nominal import (
    _confmat_from_pairs,
    _cramers_v_from_confmat,
    _drop_empty_rows_and_cols,
    _fleiss_kappa_compute,
    _fleiss_kappa_update,
    _handle_nan,
    _nominal_input_validation,
    _pearsons_contingency_from_confmat,
    _theils_u_from_confmat,
    _tschuprows_t_from_confmat,
    cramers_v,
    pearsons_contingency_coefficient,
    theils_u,
    tschuprows_t,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class _NominalPairMetric(Metric):
    """Base for categorical-pair association metrics.

    With ``num_classes`` the state is one ``(num_classes, num_classes)``
    float32 co-occurrence matrix, summed across updates and processes; a pair
    with a value outside ``[0, num_classes)`` counts nowhere. Without it, both
    series accumulate as ``cat`` states and the categories are found at
    ``compute``.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        num_classes: Optional[int] = None,
        nan_strategy: str = "replace",
        nan_replace_value: Optional[float] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _nominal_input_validation(nan_strategy, nan_replace_value)
        if num_classes is not None and not (isinstance(num_classes, int) and num_classes > 1):
            raise ValueError(f"Argument `num_classes` must be an integer larger than 1, but got {num_classes}")
        self.num_classes = num_classes
        self.nan_strategy = nan_strategy
        self.nan_replace_value = nan_replace_value
        if num_classes is not None:
            self.add_state("confmat", default=torch.zeros((num_classes, num_classes)), dist_reduce_fx="sum")
        else:
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        if self.num_classes is not None:
            p, t = _handle_nan(preds, target, self.nan_strategy, self.nan_replace_value)
            self.confmat += _confmat_from_pairs(p, t, self.num_classes)
        else:
            self.preds.append(preds.reshape(-1))
            self.target.append(target.reshape(-1))

    def _compute_fn(self, preds: Tensor, target: Tensor) -> Tensor:
        raise NotImplementedError

    def _compute_from_confmat(self, confmat: Tensor) -> Tensor:
        raise NotImplementedError

    def compute(self) -> Tensor:
        if self.num_classes is not None:
            return self._compute_from_confmat(_drop_empty_rows_and_cols(self.confmat))
        return self._compute_fn(dim_zero_cat(self.preds), dim_zero_cat(self.target))


class CramersV(_NominalPairMetric):
    """Cramér's V.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import CramersV
        >>> metric = CramersV(bias_correction=False, device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 1]))
        >>> metric.compute()
        tensor(1.)
    """

    def __init__(self, num_classes: Optional[int] = None, bias_correction: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, **kwargs)
        self.bias_correction = bias_correction

    def _compute_fn(self, preds: Tensor, target: Tensor) -> Tensor:
        return cramers_v(preds, target, self.bias_correction, self.nan_strategy, self.nan_replace_value)

    def _compute_from_confmat(self, confmat: Tensor) -> Tensor:
        return _cramers_v_from_confmat(confmat, self.bias_correction)


class TschuprowsT(_NominalPairMetric):
    """Tschuprow's T."""

    def __init__(self, num_classes: Optional[int] = None, bias_correction: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, **kwargs)
        self.bias_correction = bias_correction

    def _compute_fn(self, preds: Tensor, target: Tensor) -> Tensor:
        return tschuprows_t(preds, target, self.bias_correction, self.nan_strategy, self.nan_replace_value)

    def _compute_from_confmat(self, confmat: Tensor) -> Tensor:
        return _tschuprows_t_from_confmat(confmat, self.bias_correction)


class PearsonsContingencyCoefficient(_NominalPairMetric):
    """Pearson's contingency coefficient."""

    def _compute_fn(self, preds: Tensor, target: Tensor) -> Tensor:
        return pearsons_contingency_coefficient(preds, target, self.nan_strategy, self.nan_replace_value)

    def _compute_from_confmat(self, confmat: Tensor) -> Tensor:
        return _pearsons_contingency_from_confmat(confmat)


class TheilsU(_NominalPairMetric):
    """Theil's U (uncertainty coefficient)."""

    def _compute_fn(self, preds: Tensor, target: Tensor) -> Tensor:
        return theils_u(preds, target, self.nan_strategy, self.nan_replace_value)

    def _compute_from_confmat(self, confmat: Tensor) -> Tensor:
        return _theils_u_from_confmat(confmat)


class FleissKappa(Metric):
    """Fleiss' kappa for inter-rater agreement.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import FleissKappa
        >>> metric = FleissKappa(mode='counts', device="cpu")
        >>> metric.update(torch.tensor([[5, 0], [3, 2], [0, 5], [5, 0]]))
        >>> round(float(metric.compute()), 3)
        0.67
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, mode: str = "counts", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if mode not in ("counts", "probs"):
            raise ValueError("Argument `mode` must be one of 'counts' or 'probs'")
        self.mode = mode
        self.add_state("ratings", default=[], dist_reduce_fx="cat")

    def update(self, ratings: Tensor) -> None:
        self.ratings.append(_fleiss_kappa_update(torch.as_tensor(ratings, device=self.device), self.mode))

    def compute(self) -> Tensor:
        return _fleiss_kappa_compute(dim_zero_cat(self.ratings))


__all__ = ["CramersV", "FleissKappa", "PearsonsContingencyCoefficient", "TheilsU", "TschuprowsT"]
