"""Character error rate (port of ``torchmetrics_tpu/functional/text/cer.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.helper import _edit_distance_tokens, _validate_text_inputs


def _cer_update(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[Tensor, Tensor]:
    """(total character edits, total reference characters) of the batch, float32 on ``device``."""
    preds_list, target_list = _validate_text_inputs(preds, target)
    pred_chars = [list(p) for p in preds_list]
    tgt_chars = [list(t) for t in target_list]
    distances = _edit_distance_tokens(pred_chars, tgt_chars, device=device)
    total = torch.tensor(float(sum(len(t) for t in tgt_chars)), device=distances.device)
    return distances.sum(), total


def _cer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def char_error_rate(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Character error rate of automatic-speech-recognition output, on ``device`` (``cuda`` unless given).

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import char_error_rate
        >>> round(float(char_error_rate(["this is the prediction"], ["this is the reference"], device="cpu")), 4)
        0.381
    """
    errors, total = _cer_update(preds, target, device)
    return _cer_compute(errors, total)
