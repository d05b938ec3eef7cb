"""Word error rate (port of ``torchmetrics_tpu/functional/text/wer.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.helper import _edit_distance_tokens, _validate_text_inputs


def _wer_update(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[Tensor, Tensor]:
    """(total edit operations, total reference words) of the batch, float32 on ``device``."""
    preds_list, target_list = _validate_text_inputs(preds, target)
    pred_tokens = [p.split() for p in preds_list]
    tgt_tokens = [t.split() for t in target_list]
    distances = _edit_distance_tokens(pred_tokens, tgt_tokens, device=device)
    total = torch.tensor(float(sum(len(t) for t in tgt_tokens)), device=distances.device)
    return distances.sum(), total


def _wer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def word_error_rate(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Word error rate of automatic-speech-recognition output, on ``device`` (``cuda`` unless given).

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import word_error_rate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> float(word_error_rate(preds=preds, target=target, device="cpu"))
        0.5
    """
    errors, total = _wer_update(preds, target, device)
    return _wer_compute(errors, total)
