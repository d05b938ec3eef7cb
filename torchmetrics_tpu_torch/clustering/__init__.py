"""Modular clustering metrics (port of ``torchmetrics_tpu/clustering/__init__.py``).

The extrinsic metrics keep ``cat`` list states of both label streams, the
intrinsic ones of the data and its labels; ``compute`` runs the functional
form on the concatenated states.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.clustering import (
    adjusted_mutual_info_score,
    adjusted_rand_score,
    calinski_harabasz_score,
    completeness_score,
    davies_bouldin_score,
    dunn_index,
    fowlkes_mallows_index,
    homogeneity_score,
    mutual_info_score,
    normalized_mutual_info_score,
    rand_score,
    v_measure_score,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class _LabelPairMetric(Metric):
    """Base for extrinsic metrics on (preds, target) label streams."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.preds.append(torch.as_tensor(preds, device=self.device).reshape(-1))
        self.target.append(torch.as_tensor(target, device=self.device).reshape(-1))

    def _compute_fn(self, preds: Tensor, target: Tensor) -> Tensor:
        raise NotImplementedError

    def compute(self) -> Tensor:
        return self._compute_fn(dim_zero_cat(self.preds), dim_zero_cat(self.target))


def _make_label_pair(name: str, fn: Callable, doc: str, **fixed: Any) -> type:
    def _compute_fn(self, preds, target):
        return fn(preds, target, **{k: getattr(self, k) for k in fixed})

    def __init__(self, **kwargs):
        init_kwargs = {k: kwargs.pop(k, v) for k, v in fixed.items()}
        _LabelPairMetric.__init__(self, **kwargs)
        for k, v in init_kwargs.items():
            setattr(self, k, v)

    cls = type(name, (_LabelPairMetric,), {"__init__": __init__, "_compute_fn": _compute_fn, "__doc__": doc})
    cls.__module__ = __name__  # the generated class pickles by this module's attribute of its name
    cls.__qualname__ = name
    return cls


MutualInfoScore = _make_label_pair(
    "MutualInfoScore", mutual_info_score,
    """Mutual information between cluster assignments.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import MutualInfoScore
        >>> metric = MutualInfoScore(device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 1]))
        >>> metric.compute()
        tensor(0.6931)
    """,
)
NormalizedMutualInfoScore = _make_label_pair(
    "NormalizedMutualInfoScore", normalized_mutual_info_score,
    "Normalized mutual information.", average_method="arithmetic",
)
AdjustedMutualInfoScore = _make_label_pair(
    "AdjustedMutualInfoScore", adjusted_mutual_info_score,
    "Adjusted (chance-corrected) mutual information.", average_method="arithmetic",
)
RandScore = _make_label_pair("RandScore", rand_score, "Rand index.")
AdjustedRandScore = _make_label_pair("AdjustedRandScore", adjusted_rand_score, "Adjusted Rand index.")
HomogeneityScore = _make_label_pair("HomogeneityScore", homogeneity_score, "Homogeneity score.")
CompletenessScore = _make_label_pair("CompletenessScore", completeness_score, "Completeness score.")
VMeasureScore = _make_label_pair("VMeasureScore", v_measure_score, "V-measure.", beta=1.0)
FowlkesMallowsIndex = _make_label_pair("FowlkesMallowsIndex", fowlkes_mallows_index, "Fowlkes-Mallows index.")


class _DataLabelMetric(Metric):
    """Base for intrinsic metrics on (data, labels) streams."""

    is_differentiable = True
    full_state_update = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("data", default=[], dist_reduce_fx="cat")
        self.add_state("labels", default=[], dist_reduce_fx="cat")

    def update(self, data: Tensor, labels: Tensor) -> None:
        self.data.append(torch.as_tensor(data, dtype=torch.float32, device=self.device))
        self.labels.append(torch.as_tensor(labels, device=self.device).reshape(-1))

    def _compute_fn(self, data: Tensor, labels: Tensor) -> Tensor:
        raise NotImplementedError

    def compute(self) -> Tensor:
        return self._compute_fn(dim_zero_cat(self.data), dim_zero_cat(self.labels))


class CalinskiHarabaszScore(_DataLabelMetric):
    """Calinski-Harabasz score (between/within dispersion ratio)."""

    higher_is_better = True

    def _compute_fn(self, data: Tensor, labels: Tensor) -> Tensor:
        return calinski_harabasz_score(data, labels)


class DaviesBouldinScore(_DataLabelMetric):
    """Davies-Bouldin score (lower is better)."""

    higher_is_better = False

    def _compute_fn(self, data: Tensor, labels: Tensor) -> Tensor:
        return davies_bouldin_score(data, labels)


class DunnIndex(_DataLabelMetric):
    """Dunn index (higher is better)."""

    higher_is_better = True

    def __init__(self, p: float = 2.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.p = p

    def _compute_fn(self, data: Tensor, labels: Tensor) -> Tensor:
        return dunn_index(data, labels, self.p)


__all__ = [
    "AdjustedMutualInfoScore",
    "AdjustedRandScore",
    "CalinskiHarabaszScore",
    "CompletenessScore",
    "DaviesBouldinScore",
    "DunnIndex",
    "FowlkesMallowsIndex",
    "HomogeneityScore",
    "MutualInfoScore",
    "NormalizedMutualInfoScore",
    "RandScore",
    "VMeasureScore",
]
