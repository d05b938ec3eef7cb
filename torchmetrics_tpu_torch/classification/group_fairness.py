"""Modular group-fairness metrics (port of ``torchmetrics_tpu/classification/group_fairness.py``).

Both keep per-group int32 tp/fp/tn/fn states of shape ``(num_groups,)``, updated in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.group_fairness import (
    GroupStats,
    _binary_groups_stat_scores,
    _compute_binary_demographic_parity,
    _compute_binary_equal_opportunity,
    _groups_reduce,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import _binary_stat_scores_value_flags
from torchmetrics_tpu_torch.metric import Metric


class _AbstractGroupStatScores(Metric):
    """Holds the per-group tp/fp/tn/fn states."""

    def _create_states(self, num_groups: int) -> None:
        if not isinstance(num_groups, int) or num_groups < 2:
            raise ValueError(f"Expected argument `num_groups` to be an int larger than 1, but got {num_groups}")
        # literal names: the R1 certifier proves the class against its registered states
        self.add_state("tp", torch.zeros(num_groups, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("fp", torch.zeros(num_groups, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("tn", torch.zeros(num_groups, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("fn", torch.zeros(num_groups, dtype=torch.int32), dist_reduce_fx="sum")

    def _update_states(self, group_stats: GroupStats) -> None:
        for i, name in enumerate(("tp", "fp", "tn", "fn")):
            getattr(self, name).add_(torch.stack([s[i] for s in group_stats]))

    def _traced_value_flags(self, preds: Tensor, target: Tensor, groups: Tensor) -> Tuple[Tuple[str, ...], Tensor]:
        """The binary target-set check and the groups-range check on the device (JAX ``group_fairness.py:39``).

        As the eager ``_groups_validation``, only identifiers above
        ``num_groups`` are flagged.
        """
        msgs_t, flags_t = _binary_stat_scores_value_flags(preds, target, self.ignore_index)
        msgs = msgs_t + (
            f"The groups tensor contains identifiers larger than the specified number of groups {self.num_groups}.",
        )
        return msgs, torch.cat([flags_t, (groups.max() > self.num_groups).reshape(1)])


class BinaryGroupStatRates(_AbstractGroupStatScores):
    """Per-group tp/fp/tn/fn rates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryGroupStatRates
        >>> metric = BinaryGroupStatRates(num_groups=2, device="cpu")
        >>> metric.update(torch.tensor([1, 0, 1, 0]), torch.tensor([1, 0, 0, 1]), torch.tensor([0, 0, 1, 1]))
        >>> sorted(metric.compute().keys())
        ['group_0', 'group_1']
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        num_groups: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self._create_states(num_groups)
        self.num_groups = num_groups
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.validate_args = validate_args

    def update(self, preds: Tensor, target: Tensor, groups: Tensor) -> None:
        group_stats = _binary_groups_stat_scores(
            preds, target, groups, self.num_groups, self.threshold, self.ignore_index, self.validate_args
        )
        self._update_states(group_stats)

    def compute(self) -> Dict[str, Tensor]:
        return _groups_reduce([(self.tp[g], self.fp[g], self.tn[g], self.fn[g]) for g in range(self.num_groups)])


class BinaryFairness(_AbstractGroupStatScores):
    """Demographic parity and/or equal opportunity across groups.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryFairness
        >>> metric = BinaryFairness(num_groups=2, device="cpu")
        >>> metric.update(torch.tensor([1, 0, 1, 0]), torch.tensor([1, 0, 0, 1]), torch.tensor([0, 0, 1, 1]))
        >>> sorted(metric.compute().keys())
        ['DP_0_0', 'EO_1_0']
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        num_groups: int,
        task: str = "all",
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if task not in ["demographic_parity", "equal_opportunity", "all"]:
            raise ValueError(
                f"Expected argument `task` to either be ``demographic_parity``,"
                f"``equal_opportunity`` or ``all`` but got {task}."
            )
        self.task = task
        self._create_states(num_groups)
        self.num_groups = num_groups
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.validate_args = validate_args

    def update(self, preds: Tensor, target: Tensor, groups: Tensor) -> None:
        if self.task == "demographic_parity":
            target = torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)
        group_stats = _binary_groups_stat_scores(
            preds, target, groups, self.num_groups, self.threshold, self.ignore_index, self.validate_args
        )
        self._update_states(group_stats)

    def _traced_value_flags(self, preds: Tensor, target: Tensor, groups: Tensor) -> Tuple[Tuple[str, ...], Tensor]:
        # demographic parity puts a zero target in before validating (update()
        # above), so its raw target is not checked: nor is it here
        if self.task == "demographic_parity":
            target = torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)
        return super()._traced_value_flags(preds, target, groups)

    def compute(self) -> Dict[str, Tensor]:
        stats = {"tp": self.tp, "fp": self.fp, "tn": self.tn, "fn": self.fn}
        if self.task == "demographic_parity":
            return _compute_binary_demographic_parity(**stats)
        if self.task == "equal_opportunity":
            return _compute_binary_equal_opportunity(**stats)
        return {**_compute_binary_demographic_parity(**stats), **_compute_binary_equal_opportunity(**stats)}
