"""The retrieval metrics (port of ``torchmetrics_tpu/retrieval/metrics.py``)."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.retrieval import _masked as _mk
from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric


def _validate_top_k(top_k: Optional[int]) -> None:
    if top_k is not None and not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")


class _TopKRetrievalMetric(RetrievalMetric):
    _kernel = None

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        aggregation: Any = "mean",
        **kwargs: Any,
    ) -> None:
        # the positional order of the reference: (empty_target_action, ignore_index, top_k, aggregation)
        super().__init__(
            empty_target_action=empty_target_action, ignore_index=ignore_index, aggregation=aggregation, **kwargs
        )
        _validate_top_k(top_k)
        self.top_k = top_k

    def _metric(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return type(self)._kernel(preds, target, mask, top_k=self.top_k)


class RetrievalMAP(_TopKRetrievalMetric):
    """Mean average precision over queries.

    Example:
        >>> import torch
        >>> metric = RetrievalMAP(device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.3, 0.5, 0.1]), torch.tensor([1, 0, 1, 1]), torch.tensor([0, 0, 0, 1]))
        >>> round(float(metric.compute()), 4)
        0.9167
    """

    _kernel = staticmethod(_mk.average_precision_masked)


class RetrievalMRR(_TopKRetrievalMetric):
    """Mean reciprocal rank over queries."""

    _kernel = staticmethod(_mk.reciprocal_rank_masked)


class RetrievalRecall(_TopKRetrievalMetric):
    """Mean recall@k over queries."""

    _kernel = staticmethod(_mk.recall_masked)


class RetrievalFallOut(_TopKRetrievalMetric):
    """Mean fall-out@k over queries (lower is better).

    A query is "empty" when it has no negative target, and the default
    action for it is ``pos``.
    """

    higher_is_better = False
    _empty_query_has_no = "negatives"
    _kernel = staticmethod(_mk.fall_out_masked)

    def __init__(self, empty_target_action: str = "pos", *args: Any, **kwargs: Any) -> None:
        super().__init__(empty_target_action, *args, **kwargs)


class RetrievalHitRate(_TopKRetrievalMetric):
    """Mean hit rate@k over queries."""

    _kernel = staticmethod(_mk.hit_rate_masked)


class RetrievalNormalizedDCG(_TopKRetrievalMetric):
    """Mean nDCG over queries (graded relevance supported)."""

    _kernel = staticmethod(_mk.ndcg_masked)


class RetrievalAUROC(_TopKRetrievalMetric):
    """Mean per-query AUROC; ``max_fpr`` gives the McClish-corrected partial AUC."""

    _kernel = staticmethod(_mk.auroc_masked)

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        max_fpr: Optional[float] = None,
        aggregation: Any = "mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(
            empty_target_action=empty_target_action,
            ignore_index=ignore_index,
            top_k=top_k,
            aggregation=aggregation,
            **kwargs,
        )
        if max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
            raise ValueError(f"Arguments `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")
        self.max_fpr = max_fpr

    def _metric(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return _mk.auroc_masked(preds, target, mask, top_k=self.top_k, max_fpr=self.max_fpr)


class RetrievalPrecision(RetrievalMetric):
    """Mean precision@k over queries."""

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        adaptive_k: bool = False,
        aggregation: Any = "mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(
            empty_target_action=empty_target_action, ignore_index=ignore_index, aggregation=aggregation, **kwargs
        )
        _validate_top_k(top_k)
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.top_k = top_k
        self.adaptive_k = adaptive_k

    def _metric(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return _mk.precision_masked(preds, target, mask, top_k=self.top_k, adaptive_k=self.adaptive_k)


class RetrievalRPrecision(RetrievalMetric):
    """Mean R-precision over queries."""

    def _metric(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return _mk.r_precision_masked(preds, target, mask)


class RetrievalPrecisionRecallCurve(RetrievalMetric):
    """Mean (precision@k, recall@k) over queries for k = 1..max_k."""

    def __init__(
        self,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        if max_k is not None and not (isinstance(max_k, int) and max_k > 0):
            raise ValueError("`max_k` has to be a positive integer or None")
        self.max_k = max_k
        self.adaptive_k = adaptive_k

    def _metric(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:  # pragma: no cover
        raise NotImplementedError

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        padded = self._group_and_pad()
        if padded is None:
            return (torch.zeros(0, device=self.device), torch.zeros(0, device=self.device),
                    torch.zeros(0, dtype=torch.int64, device=self.device))
        pad_preds, pad_target, pad_mask = padded
        max_len = pad_preds.shape[1]
        max_k = min(self.max_k or max_len, max_len)
        non_empty = self._non_empty(pad_target, pad_mask)
        precisions, recalls = [], []
        for k in range(1, max_k + 1):
            p_k = _mk.precision_masked(pad_preds, pad_target, pad_mask, top_k=k, adaptive_k=self.adaptive_k)
            r_k = _mk.recall_masked(pad_preds, pad_target, pad_mask, top_k=k)
            precisions.append(torch.mean(self._apply_empty_target_action(p_k, non_empty)))
            recalls.append(torch.mean(self._apply_empty_target_action(r_k, non_empty)))
        return torch.stack(precisions), torch.stack(recalls), torch.arange(1, max_k + 1, device=pad_preds.device)


class RetrievalRecallAtFixedPrecision(RetrievalPrecisionRecallCurve):
    """The largest recall@k whose precision@k is at least ``min_precision``, and its k."""

    def __init__(
        self,
        min_precision: float = 0.0,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            max_k=max_k, adaptive_k=adaptive_k, empty_target_action=empty_target_action, ignore_index=ignore_index,
            **kwargs,
        )
        if not (isinstance(min_precision, float) and 0.0 <= min_precision <= 1.0):
            raise ValueError("`min_precision` has to be a float between 0 and 1")
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        precisions, recalls, ks = super().compute()
        ok = precisions >= self.min_precision
        any_ok = ok.any()
        best_recall = torch.where(any_ok, torch.where(ok, recalls, float("-inf")).max(), 0.0)
        best_k = torch.where(any_ok, ks[torch.argmax((ok & (recalls == best_recall)).to(torch.int32))], ks.max())
        return best_recall, best_k
