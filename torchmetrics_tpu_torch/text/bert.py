"""BERTScore (port of ``torchmetrics_tpu/text/bert.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.bert import (
    _DEFAULT_MAX_LENGTH,
    _HashTokenizer,
    _pad_encoding,
    bert_score,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


def _host(state: List[Tensor]) -> np.ndarray:
    return dim_zero_cat(state).cpu().numpy()


class BERTScore(Metric):
    """BERTScore: greedy cosine matching of contextual token embeddings.

    States are padded token-id/attention-mask matrices of width
    ``max_length`` (four ``cat`` list states on the metric's device);
    ``compute`` encodes the whole corpus and matches it on the device.
    ``weights_path`` (a converted BERT ``.npz``) builds a
    :class:`~torchmetrics_tpu_torch.text._bert_encoder.BertEncoderExtractor`
    on the metric's device; otherwise ``model`` or ``user_forward_fn`` is the
    encoder, and without either the JAX package's hash embedding is.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        num_layers: Optional[int] = None,
        all_layers: bool = False,
        model: Optional[Any] = None,
        user_tokenizer: Optional[Any] = None,
        user_forward_fn: Optional[Callable[..., Tensor]] = None,
        verbose: bool = False,
        idf: bool = False,
        device: Optional[Union[str, torch.device]] = None,
        max_length: int = _DEFAULT_MAX_LENGTH,
        batch_size: int = 64,
        num_threads: int = 0,
        return_hash: bool = False,
        lang: str = "en",
        rescale_with_baseline: bool = False,
        baseline_path: Optional[str] = None,
        baseline_url: Optional[str] = None,
        weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(device=device, **kwargs)
        self.model_name_or_path = model_name_or_path
        self._converted_weights = bool(model is None and weights_path)
        if self._converted_weights:
            from torchmetrics_tpu_torch.text._bert_encoder import BertEncoderExtractor

            model = BertEncoderExtractor(weights_path, num_layers=num_layers, device=self.device)
        self.model = model
        self.user_tokenizer = user_tokenizer
        self.user_forward_fn = user_forward_fn
        self.idf = idf
        self.max_length = max_length
        if self._converted_weights:
            # never pad past the checkpoint's positional capacity
            self.max_length = min(self.max_length, self.model.config.max_position)
        self.batch_size = batch_size
        self.return_hash = return_hash
        self.rescale_with_baseline = rescale_with_baseline
        self._tokenizer = user_tokenizer if user_tokenizer is not None else _HashTokenizer(max_length)

        self.add_state("preds_input_ids", default=[], dist_reduce_fx="cat")
        self.add_state("preds_attention_mask", default=[], dist_reduce_fx="cat")
        self.add_state("target_input_ids", default=[], dist_reduce_fx="cat")
        self.add_state("target_attention_mask", default=[], dist_reduce_fx="cat")

    def _encode(self, texts: Union[List[str], Dict]) -> Dict[str, np.ndarray]:
        if isinstance(texts, dict):
            return _pad_encoding(texts, self.max_length)
        if self._converted_weights and self.user_tokenizer is None:
            raise ValueError(
                "BERTScore was built from converted BERT weights, whose token ids only make sense with"
                " the checkpoint's own tokenizer. Pass `user_tokenizer=` (any callable producing"
                " {'input_ids', 'attention_mask'}) or update with pre-tokenized dicts."
            )
        return self._tokenizer(list(texts), self.max_length)

    def update(self, preds: Union[str, List[str], Dict], target: Union[str, List[str], Dict]) -> None:
        """Accepts sentences (tokenized with the configured tokenizer) or
        pre-tokenized ``{"input_ids", "attention_mask"}`` dicts."""
        if isinstance(preds, str):
            preds = [preds]
        if isinstance(target, str):
            target = [target]
        pred_enc = self._encode(preds)
        tgt_enc = self._encode(target)
        if np.asarray(pred_enc["input_ids"]).shape[0] != np.asarray(tgt_enc["input_ids"]).shape[0]:
            raise ValueError("Number of predicted and reference sententes must be the same!")
        for prefix, enc in (("preds", pred_enc), ("target", tgt_enc)):
            for key in ("input_ids", "attention_mask"):
                getattr(self, f"{prefix}_{key}").append(torch.as_tensor(np.asarray(enc[key]), device=self.device))

    def compute(self) -> Dict[str, Union[Tensor, List[float], str]]:
        return bert_score(
            preds={"input_ids": _host(self.preds_input_ids), "attention_mask": _host(self.preds_attention_mask)},
            target={"input_ids": _host(self.target_input_ids), "attention_mask": _host(self.target_attention_mask)},
            model_name_or_path=self.model_name_or_path,
            model=self.model,
            user_tokenizer=self.user_tokenizer,
            user_forward_fn=self.user_forward_fn,
            idf=self.idf,
            device=self.device,
            max_length=self.max_length,
            batch_size=self.batch_size,
            return_hash=self.return_hash,
            rescale_with_baseline=self.rescale_with_baseline,
        )
