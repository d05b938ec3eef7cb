"""Group fairness metrics (port of ``torchmetrics_tpu/functional/classification/group_fairness.py``).

Per-group stat scores come from one-hot group masks, one reduction over the
batch, as in the JAX package (the reference sorts by group, counts and
splits). The statistics come back as a Python list per group, and the group
ids are read back to the host to be validated.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
)
from torchmetrics_tpu_torch.utilities.checks import _in_compiled_step
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import _one_hot

GroupStats = List[Tuple[Tensor, Tensor, Tensor, Tensor]]


def _groups_validation(groups: Tensor, num_groups: int) -> None:
    if not _in_compiled_step() and int(groups.max()) > num_groups:
        raise ValueError(
            f"The largest number in the groups tensor is {int(groups.max())}, which is larger than the"
            f" specified number of groups {num_groups}. The group identifiers should be"
            " ``0, 1, ..., (num_groups - 1)``."
        )
    if torch.is_floating_point(groups) or groups.dtype == torch.bool:
        raise ValueError(f"Expected dtype of argument groups to be int, not {groups.dtype}.")


def _binary_groups_stat_scores(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> GroupStats:
    """Per-group (tp, fp, tn, fn) from one-hot group masks."""
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, "global", ignore_index)
        _groups_validation(groups, num_groups)
    preds, target, valid = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    valid = valid.reshape(-1)
    groups = groups.reshape(-1)

    v = valid[:, None] & _one_hot(groups, num_groups, torch.bool)  # (N, G)
    tp = torch.sum(((preds == 1) & (target == 1))[:, None] & v, dim=0)
    fp = torch.sum(((preds == 1) & (target == 0))[:, None] & v, dim=0)
    tn = torch.sum(((preds == 0) & (target == 0))[:, None] & v, dim=0)
    fn = torch.sum(((preds == 0) & (target == 1))[:, None] & v, dim=0)
    return [(tp[g], fp[g], tn[g], fn[g]) for g in range(num_groups)]


def _groups_reduce(group_stats: GroupStats) -> Dict[str, Tensor]:
    return {f"group_{group}": torch.stack(stats) / torch.stack(stats).sum() for group, stats in enumerate(group_stats)}


def _groups_stat_transform(group_stats: GroupStats) -> Dict[str, Tensor]:
    return {
        "tp": torch.stack([s[0] for s in group_stats]),
        "fp": torch.stack([s[1] for s in group_stats]),
        "tn": torch.stack([s[2] for s in group_stats]),
        "fn": torch.stack([s[3] for s in group_stats]),
    }


def binary_groups_stat_rates(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Per-group tp/fp/tn/fn rates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_groups_stat_rates
        >>> preds = torch.tensor([1, 0, 1, 0])
        >>> target = torch.tensor([1, 0, 0, 1])
        >>> groups = torch.tensor([0, 0, 1, 1])
        >>> sorted(binary_groups_stat_rates(preds, target, groups, 2).keys())
        ['group_0', 'group_1']
    """
    stats = _binary_groups_stat_scores(preds, target, groups, num_groups, threshold, ignore_index, validate_args)
    return _groups_reduce(stats)


def _compute_binary_demographic_parity(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Dict[str, Tensor]:
    pos_rates = _safe_divide(tp + fp, tp + fp + tn + fn)
    min_pos_rate_id = int(torch.argmin(pos_rates))
    max_pos_rate_id = int(torch.argmax(pos_rates))
    return {
        f"DP_{min_pos_rate_id}_{max_pos_rate_id}": _safe_divide(
            pos_rates[min_pos_rate_id], pos_rates[max_pos_rate_id]
        )
    }


def demographic_parity(
    preds: Tensor,
    groups: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Demographic parity: ratio of the lowest to the highest per-group positive prediction rate."""
    num_groups = int(groups.max()) + 1
    target = torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)
    stats = _binary_groups_stat_scores(preds, target, groups, num_groups, threshold, ignore_index, validate_args)
    return _compute_binary_demographic_parity(**_groups_stat_transform(stats))


def _compute_binary_equal_opportunity(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Dict[str, Tensor]:
    true_pos_rates = _safe_divide(tp, tp + fn)
    min_pos_rate_id = int(torch.argmin(true_pos_rates))
    max_pos_rate_id = int(torch.argmax(true_pos_rates))
    return {
        f"EO_{min_pos_rate_id}_{max_pos_rate_id}": _safe_divide(
            true_pos_rates[min_pos_rate_id], true_pos_rates[max_pos_rate_id]
        )
    }


def equal_opportunity(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Equal opportunity: ratio of the lowest to the highest per-group true positive rate."""
    num_groups = int(groups.max()) + 1
    stats = _binary_groups_stat_scores(preds, target, groups, num_groups, threshold, ignore_index, validate_args)
    return _compute_binary_equal_opportunity(**_groups_stat_transform(stats))


def binary_fairness(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    task: str = "all",
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Demographic parity and/or equal opportunity (``task`` in demographic_parity/equal_opportunity/all)."""
    if task not in ["demographic_parity", "equal_opportunity", "all"]:
        raise ValueError(
            f"Expected argument `task` to either be ``demographic_parity``,"
            f"``equal_opportunity`` or ``all`` but got {task}."
        )
    if task == "demographic_parity":
        return demographic_parity(preds, groups, threshold, ignore_index, validate_args)
    if task == "equal_opportunity":
        return equal_opportunity(preds, target, groups, threshold, ignore_index, validate_args)
    num_groups = int(groups.max()) + 1
    stats = _binary_groups_stat_scores(preds, target, groups, num_groups, threshold, ignore_index, validate_args)
    transformed = _groups_stat_transform(stats)
    return {**_compute_binary_demographic_parity(**transformed), **_compute_binary_equal_opportunity(**transformed)}
