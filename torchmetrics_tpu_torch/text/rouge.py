"""ROUGEScore (port of ``torchmetrics_tpu/text/rouge.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.rouge import (
    _rouge_args,
    _rouge_inputs,
    _rouge_score_compute,
    _rouge_score_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

_STATS = ("fmeasure", "precision", "recall")


class ROUGEScore(Metric):
    """ROUGE-N / ROUGE-L / ROUGE-LSum, accumulated as per-sample ``cat`` states.

    Each update appends one float32 tensor per (key, statistic) on the
    metric's device; ``compute`` takes their float32 means there.

    Example:
        >>> from torchmetrics_tpu_torch.text import ROUGEScore
        >>> rouge = ROUGEScore(rouge_keys="rouge1", device="cpu")
        >>> result = rouge(["My name is John"], ["Is your name John"])
        >>> round(float(result["rouge1_fmeasure"]), 2)
        0.75
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        use_stemmer: bool = False,
        normalizer: Optional[Callable[[str], str]] = None,
        tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
        accumulate: str = "best",
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.rouge_keys, self.rouge_keys_values = _rouge_args(use_stemmer, accumulate, rouge_keys)
        self.normalizer = normalizer
        self.tokenizer = tokenizer
        self.accumulate = accumulate
        for rouge_key in self.rouge_keys_values:
            for score in _STATS:
                self.add_state(f"rouge{rouge_key}_{score}", default=[], dist_reduce_fx="cat")

    def update(
        self,
        preds: Union[str, Sequence[str]],
        target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    ) -> None:
        preds, target = _rouge_inputs(preds, target)
        output = _rouge_score_update(
            preds, target, self.rouge_keys_values, self.accumulate, None, self.normalizer, self.tokenizer, self.device
        )
        # per-sample scores arrive as host floats: one tensor per (key, score) an update
        for rouge_key, metrics in output.items():
            if not metrics:
                continue
            for score_name in _STATS:
                vals = torch.tensor([metric[score_name] for metric in metrics], dtype=torch.float32, device=self.device)
                getattr(self, f"rouge{rouge_key}_{score_name}").append(vals)

    def compute(self) -> Dict[str, Tensor]:
        update_output = {}
        for rouge_key in self.rouge_keys_values:
            for score in _STATS:
                state = getattr(self, f"rouge{rouge_key}_{score}")
                update_output[f"rouge{rouge_key}_{score}"] = (
                    dim_zero_cat(state) if len(state) else torch.zeros(0, device=self.device)
                )
        return _rouge_score_compute(update_output)
