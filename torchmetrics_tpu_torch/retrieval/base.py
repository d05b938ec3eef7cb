"""Retrieval metric base (port of ``torchmetrics_tpu/retrieval/base.py``).

The states are ``indexes``, ``preds`` and ``target`` list states with
``dist_reduce_fx=None`` (gathered, not reduced). ``compute`` groups the rows
by query on the device, pads every query to the longest one and evaluates
the batched kernel on the ``(num_q, max_len)`` arrays at once.
"""

from __future__ import annotations

from abc import abstractmethod
from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class RetrievalMetric(Metric):
    """Base for the retrieval metrics, which work on (indexes, preds, target) triplets."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    # a query is "empty" when it has no positive target; FallOut turns this into "no negative target"
    _empty_query_has_no = "positives"

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        aggregation: Any = "mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        empty_target_action_options = ("error", "skip", "neg", "pos")
        if empty_target_action not in empty_target_action_options:
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index
        if not (aggregation in ("mean", "median", "min", "max") or callable(aggregation)):
            raise ValueError(
                "Argument `aggregation` must be one of `mean`, `median`, `min`, `max` or a custom callable,"
                f" but got {aggregation}"
            )
        self.aggregation = aggregation
        self.add_state("indexes", default=[], dist_reduce_fx=None)
        self.add_state("preds", default=[], dist_reduce_fx=None)
        self.add_state("target", default=[], dist_reduce_fx=None)

    def update(self, preds: Tensor, target: Tensor, indexes: Tensor) -> None:
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        preds = torch.as_tensor(preds).reshape(-1).to(torch.float32)
        target = torch.as_tensor(target).reshape(-1)
        indexes = torch.as_tensor(indexes).reshape(-1)
        if not (preds.shape == target.shape == indexes.shape):
            raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
        if self.ignore_index is not None:
            keep = target != self.ignore_index  # a boolean index: one read back to the host
            preds, target, indexes = preds[keep], target[keep], indexes[keep]
        self.indexes.append(indexes)
        self.preds.append(preds)
        self.target.append(target)

    def _group_and_pad(self) -> Optional[Tuple[Tensor, Tensor, Tensor]]:
        """The list states as ``(num_q, max_len)`` preds, target and mask arrays, on the device.

        A stable sort of the query indexes keeps each query's rows in their
        order of arrival; ``unique_consecutive`` counts the rows of each
        query, the longest count is read back once, and one scatter places
        every row at (its query, its place in the query).
        """
        indexes = dim_zero_cat(self.indexes)
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        sorted_idx, order = torch.sort(indexes, stable=True)
        counts = torch.unique_consecutive(sorted_idx, return_counts=True)[1]
        num_q = counts.numel()
        if num_q == 0:
            return None
        max_len = int(counts.max())
        starts = torch.cumsum(counts, 0) - counts
        row = torch.repeat_interleave(torch.arange(num_q, device=counts.device), counts)
        col = torch.arange(indexes.numel(), device=counts.device) - torch.repeat_interleave(starts, counts)
        pad_preds = torch.full((num_q, max_len), float("-inf"), dtype=torch.float32, device=preds.device)
        pad_target = torch.zeros((num_q, max_len), dtype=target.dtype, device=target.device)
        pad_mask = torch.zeros((num_q, max_len), dtype=torch.bool, device=preds.device)
        pad_preds[row, col] = preds[order]
        pad_target[row, col] = target[order]
        pad_mask[row, col] = True
        return pad_preds, pad_target, pad_mask

    def _non_empty(self, pad_target: Tensor, pad_mask: Tensor) -> Tensor:
        if self._empty_query_has_no == "negatives":
            return ((pad_target == 0) & pad_mask).any(dim=1)
        return (pad_target > 0).any(dim=1)

    def _apply_empty_target_action(self, res: Tensor, non_empty: Tensor) -> Tensor:
        if self.empty_target_action == "error" and bool((~non_empty).any()):
            raise ValueError("`compute` method was provided with a query without positive target.")
        if self.empty_target_action == "pos":
            return torch.where(non_empty, res, 1.0)
        if self.empty_target_action == "neg":
            return torch.where(non_empty, res, 0.0)
        if self.empty_target_action == "skip":
            return res[non_empty]  # a boolean index: one read back to the host
        return res

    def compute(self) -> Tensor:
        padded = self._group_and_pad()
        if padded is None:
            return torch.tensor(0.0, device=self.device)
        pad_preds, pad_target, pad_mask = padded
        res = self._metric(pad_preds, pad_target, pad_mask)
        res = self._apply_empty_target_action(res, self._non_empty(pad_target, pad_mask))
        return self._aggregate(res)

    def _aggregate(self, res: Tensor) -> Tensor:
        """Reduce the per-query values by ``aggregation``: a name, or a callable taking ``(values, dim)``."""
        if not res.numel():
            return torch.tensor(0.0, device=res.device)
        if self.aggregation == "mean":
            return torch.mean(res)
        if self.aggregation == "median":  # the lower middle value of an even count, as torch.median
            return torch.sort(res).values[(res.numel() - 1) // 2]
        if self.aggregation == "min":
            return torch.min(res)
        if self.aggregation == "max":
            return torch.max(res)
        return self.aggregation(res, dim=0)

    @abstractmethod
    def _metric(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        """Per-query values of padded ``(num_q, L)`` arrays with their validity mask."""
