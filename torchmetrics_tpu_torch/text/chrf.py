"""CHRFScore (port of ``torchmetrics_tpu/text/chrf.py``)."""

from __future__ import annotations

from typing import Any, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.chrf import (
    _chrf_args_validation,
    _chrf_score_compute,
    _chrf_score_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

_STATES = ("preds_char", "preds_word", "target_char", "target_word", "matching_char", "matching_word")


class CHRFScore(Metric):
    """chrF / chrF++ score.

    States are six per-order count vectors (pred/target/matching × char/word),
    float32 ``sum`` states on the metric's device, and, with
    ``return_sentence_level_score``, a ``cat`` list of sentence scores.

    Example:
        >>> from torchmetrics_tpu_torch.text import CHRFScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat']]
        >>> chrf = CHRFScore(device="cpu")
        >>> round(float(chrf(preds, target)), 4)
        0.4942
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _chrf_args_validation(n_char_order, n_word_order, beta)
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score
        self.n_order = float(n_char_order + n_word_order)

        for name in _STATES:
            order = n_char_order if name.endswith("char") else n_word_order
            self.add_state(f"total_{name}_n_grams", default=torch.zeros(order), dist_reduce_fx="sum")
        if self.return_sentence_level_score:
            self.add_state("sentence_chrf_score", default=[], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Union[Sequence[str], Sequence[Sequence[str]]]) -> None:
        *counts, sentence_scores = _chrf_score_update(
            preds, target, self.n_char_order, self.n_word_order, self.beta, self.lowercase, self.whitespace
        )
        for name, count in zip(_STATES, counts):
            getattr(self, f"total_{name}_n_grams").add_(torch.as_tensor(count, dtype=torch.float32, device=self.device))
        if self.return_sentence_level_score:
            self.sentence_chrf_score.append(torch.tensor(sentence_scores, dtype=torch.float32, device=self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        corpus = _chrf_score_compute(*(getattr(self, f"total_{name}_n_grams") for name in _STATES), self.n_order, self.beta)
        if self.return_sentence_level_score:
            return corpus, dim_zero_cat(self.sentence_chrf_score)
        return corpus
