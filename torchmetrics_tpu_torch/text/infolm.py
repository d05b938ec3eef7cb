"""InfoLM (port of ``torchmetrics_tpu/text/infolm.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.bert import _HashTokenizer, _pad_encoding
from torchmetrics_tpu_torch.functional.text.infolm import infolm as _infolm_fn
from torchmetrics_tpu_torch.text.bert import _host
from torchmetrics_tpu_torch.metric import Metric


class InfoLM(Metric):
    """InfoLM: information measures between masked-LM token distributions.

    Tokenization happens at ``update`` time and the padded token-id/
    attention-mask matrices are four ``cat`` list states on the metric's
    device; the distributions and the measure are computed on the device at
    ``compute`` time. ``weights_path`` (a converted ``BertForMaskedLM``
    ``.npz``) builds a
    :class:`~torchmetrics_tpu_torch.text._bert_encoder.BertMLMExtractor` on the
    metric's device; otherwise ``model`` is the masked LM, and without one the
    JAX package's hash logits are.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        temperature: float = 0.25,
        information_measure: str = "kl_divergence",
        idf: bool = True,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        device: Optional[Union[str, torch.device]] = None,
        max_length: Optional[int] = None,
        batch_size: int = 64,
        num_threads: int = 0,
        verbose: bool = True,
        return_sentence_level_score: bool = False,
        model: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
        tokenizer: Optional[Any] = None,
        weights_path: Optional[str] = None,
        special_tokens_map: Optional[Dict[str, int]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(device=device, **kwargs)
        self._converted_weights = bool(model is None and weights_path)
        if self._converted_weights:
            from torchmetrics_tpu_torch.text._bert_encoder import BertMLMExtractor

            model = BertMLMExtractor(weights_path, device=self.device)
        self.model_name_or_path = model_name_or_path
        self.temperature = temperature
        self.information_measure = information_measure
        self.idf = idf
        self.alpha = alpha
        self.beta = beta
        self.max_length = max_length
        if self._converted_weights:
            # never pad past the checkpoint's positional capacity
            self.max_length = min(self.max_length or 64, model.config.max_position)
        self.batch_size = batch_size
        self.return_sentence_level_score = return_sentence_level_score
        self._model = model
        self._user_tokenizer = tokenizer
        self._special_tokens_map = special_tokens_map
        self._tokenizer_fn = tokenizer if tokenizer is not None else _HashTokenizer(max_length or 64)

        self.add_state("preds_input_ids", default=[], dist_reduce_fx="cat")
        self.add_state("preds_attention_mask", default=[], dist_reduce_fx="cat")
        self.add_state("target_input_ids", default=[], dist_reduce_fx="cat")
        self.add_state("target_attention_mask", default=[], dist_reduce_fx="cat")

    def _encode(self, texts: Union[List[str], Dict], width: int) -> Dict[str, np.ndarray]:
        if isinstance(texts, dict):
            return _pad_encoding(texts, width)
        if self._converted_weights and self._user_tokenizer is None:
            raise ValueError(
                "InfoLM was built from converted BERT weights, whose token ids only make sense with"
                " the checkpoint's own tokenizer. Pass `tokenizer=` (any callable producing"
                " {'input_ids', 'attention_mask'}) or update with pre-tokenized dicts."
            )
        return self._tokenizer_fn(list(texts), width)

    def update(self, preds: Union[str, List[str], Dict], target: Union[str, List[str], Dict]) -> None:
        """Accepts sentences (tokenized with the configured tokenizer) or
        pre-tokenized ``{"input_ids", "attention_mask"}`` dicts."""
        if isinstance(preds, str):
            preds = [preds]
        if isinstance(target, str):
            target = [target]
        width = self.max_length or 64
        pred_enc = self._encode(preds, width)
        tgt_enc = self._encode(target, width)
        if np.asarray(pred_enc["input_ids"]).shape[0] != np.asarray(tgt_enc["input_ids"]).shape[0]:
            raise ValueError("Number of predicted and reference sententes must be the same!")
        self.preds_input_ids.append(torch.as_tensor(np.asarray(pred_enc["input_ids"]), device=self.device))
        self.preds_attention_mask.append(torch.as_tensor(np.asarray(pred_enc["attention_mask"]), device=self.device))
        self.target_input_ids.append(torch.as_tensor(np.asarray(tgt_enc["input_ids"]), device=self.device))
        self.target_attention_mask.append(torch.as_tensor(np.asarray(tgt_enc["attention_mask"]), device=self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:  # lint: eager-helper — host transformer scoring
        return _infolm_fn(
            {"input_ids": _host(self.preds_input_ids), "attention_mask": _host(self.preds_attention_mask)},
            {"input_ids": _host(self.target_input_ids), "attention_mask": _host(self.target_attention_mask)},
            model_name_or_path=self.model_name_or_path,
            temperature=self.temperature,
            information_measure=self.information_measure,
            idf=self.idf,
            alpha=self.alpha,
            beta=self.beta,
            device=self.device,
            max_length=self.max_length,
            return_sentence_level_score=self.return_sentence_level_score,
            model=self._model,
            tokenizer=self._user_tokenizer,
            special_tokens_map=self._special_tokens_map,
        )
