"""Match error rate (port of ``torchmetrics_tpu/functional/text/mer.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.helper import _edit_distance_tokens, _validate_text_inputs


def _mer_update(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[Tensor, Tensor]:
    """(total edits, Σ max(len(pred), len(target)) words) of the batch, float32 on ``device``."""
    preds_list, target_list = _validate_text_inputs(preds, target)
    pred_tokens = [p.split() for p in preds_list]
    tgt_tokens = [t.split() for t in target_list]
    distances = _edit_distance_tokens(pred_tokens, tgt_tokens, device=device)
    total = float(sum(max(len(p), len(t)) for p, t in zip(pred_tokens, tgt_tokens)))
    return distances.sum(), torch.tensor(total, device=distances.device)


def _mer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def match_error_rate(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Match error rate of automatic-speech-recognition output, on ``device`` (``cuda`` unless given).

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import match_error_rate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(match_error_rate(preds=preds, target=target, device="cpu")), 4)
        0.4444
    """
    errors, total = _mer_update(preds, target, device)
    return _mer_compute(errors, total)
