"""TranslationEditRate (port of ``torchmetrics_tpu/text/ter.py``)."""

from __future__ import annotations

from typing import Any, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.ter import (
    _ter_args_validation,
    _ter_compute,
    _ter_update,
    _TercomTokenizer,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class TranslationEditRate(Metric):
    """Translation edit rate (tercom shifts + word edits over reference length).

    States: the float32 (edits, reference length) ``sum`` pair on the metric's
    device and, with ``return_sentence_level_score``, a ``cat`` list of
    sentence scores.

    Example:
        >>> from torchmetrics_tpu_torch.text import TranslationEditRate
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> ter = TranslationEditRate(device="cpu")
        >>> round(float(ter(preds, target)), 4)
        0.1538
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _ter_args_validation(normalize, no_punctuation, lowercase, asian_support)
        self.tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score

        self.add_state("total_num_edits", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total_tgt_length", default=torch.tensor(0.0), dist_reduce_fx="sum")
        if self.return_sentence_level_score:
            self.add_state("sentence_ter", default=[], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        num_edits, tgt_length, sentence_ter = _ter_update(preds, target, self.tokenizer)
        self.total_num_edits += num_edits
        self.total_tgt_length += tgt_length
        if self.return_sentence_level_score:
            self.sentence_ter.append(torch.tensor(sentence_ter, dtype=torch.float32, device=self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        ter = _ter_compute(self.total_num_edits, self.total_tgt_length)
        if self.return_sentence_level_score:
            return ter, dim_zero_cat(self.sentence_ter)
        return ter
