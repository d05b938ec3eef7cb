"""Word information lost (port of ``torchmetrics_tpu/functional/text/wil.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.helper import _edit_distance_tokens, _validate_text_inputs


def _word_info_lost_update(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(edits - Σ max lengths, total target words, total prediction words), float32 on ``device``.

    ``edits - Σ max lengths`` is minus the hit count H, so the compute step's
    ``(errors/N_t)·(errors/N_p)`` is ``(H/N_t)·(H/N_p)``.
    """
    preds_list, target_list = _validate_text_inputs(preds, target)
    pred_tokens = [p.split() for p in preds_list]
    tgt_tokens = [t.split() for t in target_list]
    distances = _edit_distance_tokens(pred_tokens, tgt_tokens, device=device)
    total = float(sum(max(len(p), len(t)) for p, t in zip(pred_tokens, tgt_tokens)))
    target_total = torch.tensor(float(sum(len(t) for t in tgt_tokens)), device=distances.device)
    preds_total = torch.tensor(float(sum(len(p) for p in pred_tokens)), device=distances.device)
    return distances.sum() - total, target_total, preds_total


def _word_info_lost_compute(errors: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    return 1 - ((errors / target_total) * (errors / preds_total))


def word_information_lost(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Word information lost of automatic-speech-recognition output, on ``device`` (``cuda`` unless given).

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import word_information_lost
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(word_information_lost(preds=preds, target=target, device="cpu")), 4)
        0.6528
    """
    errors, target_total, preds_total = _word_info_lost_update(preds, target, device)
    return _word_info_lost_compute(errors, target_total, preds_total)
