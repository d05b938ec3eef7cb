"""BLEUScore (port of ``torchmetrics_tpu/text/bleu.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.bleu import (
    _bleu_corpus,
    _bleu_score_compute,
    _bleu_score_update,
    _tokenize_fn,
)
from torchmetrics_tpu_torch.metric import Metric


class BLEUScore(Metric):
    """BLEU score of machine-translated text against references.

    States are the per-order (numerator, denominator) count vectors and the
    two lengths, float32 ``sum`` states on the metric's device.

    Example:
        >>> from torchmetrics_tpu_torch.text import BLEUScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> bleu = BLEUScore(device="cpu")
        >>> round(float(bleu(preds, target)), 4)
        0.7598
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    _tokenizer = staticmethod(_tokenize_fn)

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        if weights is not None and len(weights) != n_gram:
            raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
        self.weights = weights if weights is not None else [1.0 / n_gram] * n_gram

        self.add_state("preds_len", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_len", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("numerator", default=torch.zeros(self.n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", default=torch.zeros(self.n_gram), dist_reduce_fx="sum")

    def update(self, preds: Sequence[str], target: Sequence[Sequence[str]]) -> None:
        preds_, target_ = _bleu_corpus(preds, target)
        numerator, denominator, preds_len, target_len = _bleu_score_update(preds_, target_, self.n_gram, self._tokenizer)
        self.preds_len += preds_len
        self.target_len += target_len
        self.numerator += torch.as_tensor(numerator, dtype=torch.float32, device=self.device)
        self.denominator += torch.as_tensor(denominator, dtype=torch.float32, device=self.device)

    def compute(self) -> Tensor:
        return _bleu_score_compute(
            self.preds_len, self.target_len, self.numerator, self.denominator, self.n_gram, self.weights, self.smooth
        )
