"""Levenshtein edit distance (port of ``torchmetrics_tpu/functional/text/edit.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.helper import _edit_distance_tokens, _validate_text_inputs


def _edit_distance_update(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    substitution_cost: int = 1,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Per-sample character-level edit distances, ``(B,)`` float32 on ``device``."""
    preds_list, target_list = _validate_text_inputs(preds, target)
    if not all(isinstance(x, str) for x in preds_list):
        raise ValueError(f"Expected all values in argument `preds` to be string type, but got {preds_list}")
    if not all(isinstance(x, str) for x in target_list):
        raise ValueError(f"Expected all values in argument `target` to be string type, but got {target_list}")
    return _edit_distance_tokens(
        [list(p) for p in preds_list], [list(t) for t in target_list], substitution_cost, device
    )


def _edit_distance_compute(
    edit_scores: Tensor,
    num_elements: Union[Tensor, int],
    reduction: Optional[str] = "mean",
) -> Tensor:
    if edit_scores.numel() == 0:
        return torch.tensor(0, dtype=torch.int32, device=edit_scores.device)
    if reduction == "mean":
        return edit_scores.sum() / num_elements
    if reduction == "sum":
        return edit_scores.sum()
    if reduction is None or reduction == "none":
        return edit_scores
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")


def edit_distance(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    substitution_cost: int = 1,
    reduction: Optional[str] = "mean",
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Character-level Levenshtein edit distance, on ``device`` (``cuda`` unless given).

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import edit_distance
        >>> float(edit_distance(["rain"], ["shine"], device="cpu"))
        3.0
    """
    distance = _edit_distance_update(preds, target, substitution_cost, device)
    return _edit_distance_compute(distance, num_elements=distance.shape[0], reduction=reduction)
