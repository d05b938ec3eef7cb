"""Word information preserved (port of ``torchmetrics_tpu/functional/text/wip.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.wil import _word_info_lost_update

_word_info_preserved_update = _word_info_lost_update


def _word_info_preserved_compute(errors: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    return (errors / target_total) * (errors / preds_total)


def word_information_preserved(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Word information preserved of automatic-speech-recognition output, on ``device`` (``cuda`` unless given).

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import word_information_preserved
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(word_information_preserved(preds=preds, target=target, device="cpu")), 4)
        0.3472
    """
    errors, target_total, preds_total = _word_info_preserved_update(preds, target, device)
    return _word_info_preserved_compute(errors, target_total, preds_total)
