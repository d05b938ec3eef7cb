"""ExtendedEditDistance (port of ``torchmetrics_tpu/text/eed.py``)."""

from __future__ import annotations

from typing import Any, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.eed import _eed_args_validation, _eed_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class ExtendedEditDistance(Metric):
    """Extended edit distance (Levenshtein plus jumps and a coverage cost).

    The state is a ``cat`` list of each prediction's best score, one float32
    tensor an update on the metric's device.

    Example:
        >>> from torchmetrics_tpu_torch.text import ExtendedEditDistance
        >>> preds = ["this is the prediction", "here is an other sample"]
        >>> target = ["this is the reference", "here is another one"]
        >>> eed = ExtendedEditDistance(device="cpu")
        >>> round(float(eed(preds=preds, target=target)), 4)
        0.3078
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        language: str = "en",
        return_sentence_level_score: bool = False,
        alpha: float = 2.0,
        rho: float = 0.3,
        deletion: float = 0.2,
        insertion: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        _eed_args_validation(alpha, rho, deletion, insertion)
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion

        self.add_state("sentence_eed", default=[], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        scores = _eed_update(
            preds, target, self.language, self.alpha, self.rho, self.deletion, self.insertion, self.device
        )
        if scores.numel():
            self.sentence_eed.append(scores)

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        if len(self.sentence_eed) == 0:
            average = torch.tensor(0.0, device=self.device)
            if self.return_sentence_level_score:
                return average, torch.zeros(0, device=self.device)
            return average
        scores = dim_zero_cat(self.sentence_eed)
        average = scores.mean()
        if self.return_sentence_level_score:
            return average, scores
        return average
