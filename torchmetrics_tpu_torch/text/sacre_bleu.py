"""SacreBLEUScore (port of ``torchmetrics_tpu/text/sacre_bleu.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence

from torchmetrics_tpu_torch.functional.text.sacre_bleu import _SacreBLEUTokenizer
from torchmetrics_tpu_torch.text.bleu import BLEUScore


class SacreBLEUScore(BLEUScore):
    """BLEU with a standardized sacrebleu tokenizer (``none``, ``13a``, ``zh``, ``intl``, ``char``).

    Example:
        >>> from torchmetrics_tpu_torch.text import SacreBLEUScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> sacre_bleu = SacreBLEUScore(device="cpu")
        >>> round(float(sacre_bleu(preds, target)), 4)
        0.7598
    """

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        tokenize: str = "13a",
        lowercase: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, weights=weights, **kwargs)
        self._tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)
