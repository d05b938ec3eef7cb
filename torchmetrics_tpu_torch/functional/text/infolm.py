"""InfoLM (port of ``torchmetrics_tpu/functional/text/infolm.py``).

Information measures between masked-LM token distributions of prediction and
reference sentences. Each position of every sentence is masked in turn and
the model's softmaxed logits there are averaged over the sentence's
non-special tokens. The JAX package's ``lax.map`` over positions is a Python
loop here; a model with a ``logits_at(ids, mask, index)`` method (such as
:class:`~torchmetrics_tpu_torch.text._bert_encoder.BertMLMExtractor`) runs its
head at the masked position only.

Without a model, the JAX package's hash logits are the masked LM
(``_default_hash_model``): a row of ``jax.random`` normals under
``fold_in(PRNGKey(7), id % 2048)`` per token, plus the mean row of the
sentence, drawn by :mod:`~torchmetrics_tpu_torch.utilities._threefry`.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.bert import _HashTokenizer
from torchmetrics_tpu_torch.metric import _resolve_device
from torchmetrics_tpu_torch.utilities._threefry import normal_rows
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

_ALLOWED_INFORMATION_MEASURE = (
    "kl_divergence",
    "alpha_divergence",
    "beta_divergence",
    "ab_divergence",
    "renyi_divergence",
    "l1_distance",
    "l2_distance",
    "l_infinity_distance",
    "fisher_rao_distance",
)

_DEFAULT_SPECIAL_TOKENS = {"pad_token_id": 0, "cls_token_id": 101, "sep_token_id": 102, "mask_token_id": 103}
_DEFAULT_VOCAB = 2048


class _InformationMeasure:
    """Vectorized information measures between discrete distributions.

    ``alpha``/``beta`` validation matches the reference (``infolm.py:104-139``).
    """

    def __init__(self, information_measure: str, alpha: Optional[float] = None, beta: Optional[float] = None) -> None:
        if information_measure not in _ALLOWED_INFORMATION_MEASURE:
            raise ValueError(
                f"Argument `information_measure` expected to be one of {_ALLOWED_INFORMATION_MEASURE}"
                f" but got {information_measure!r}."
            )
        self.information_measure = information_measure
        if information_measure in ("alpha_divergence", "ab_divergence", "renyi_divergence"):
            if not isinstance(alpha, float) or alpha in (0, 1):
                raise ValueError(f"Parameter `alpha` is expected to be a float differing from 0 and 1 but got {alpha}.")
        if information_measure in ("beta_divergence", "ab_divergence"):
            if not isinstance(beta, float) or beta == 0:
                raise ValueError(f"Parameter `beta` is expected to be a non-zero float but got {beta}.")
        if information_measure == "ab_divergence" and (alpha is None or beta is None or (alpha + beta) == 0):
            raise ValueError("Parameters `alpha` and `beta` cannot sum to 0 for AB divergence.")
        self.alpha = alpha
        self.beta = beta

    def __call__(self, preds_distribution: Tensor, target_distribution: Tensor) -> Tensor:
        fn = getattr(self, f"_calculate_{self.information_measure}")
        return torch.nan_to_num(fn(preds_distribution, target_distribution))

    @staticmethod
    def _calculate_kl_divergence(p: Tensor, t: Tensor) -> Tensor:
        return torch.sum(t * torch.log(p / t), dim=-1)

    def _calculate_alpha_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        denom = self.alpha * (self.alpha - 1)
        return (1 - torch.sum(t**self.alpha * p ** (1 - self.alpha), dim=-1)) / denom

    def _calculate_ab_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        a = torch.log(torch.sum(t ** (self.beta + self.alpha), dim=-1)) / (self.beta * (self.beta + self.alpha))
        b = torch.log(torch.sum(p ** (self.beta + self.alpha), dim=-1)) / (self.alpha * (self.beta + self.alpha))
        c = torch.log(torch.sum(t**self.alpha * p**self.beta, dim=-1)) / (self.alpha * self.beta)
        return a + b - c

    def _calculate_beta_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        self.alpha = 1.0
        return self._calculate_ab_divergence(p, t)

    def _calculate_renyi_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        return torch.log(torch.sum(t**self.alpha * p ** (1 - self.alpha), dim=-1)) / (self.alpha - 1)

    @staticmethod
    def _calculate_l1_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.sum(torch.abs(t - p), dim=-1)

    @staticmethod
    def _calculate_l2_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.sqrt(torch.sum((t - p) ** 2, dim=-1))

    @staticmethod
    def _calculate_l_infinity_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.amax(torch.abs(t - p), dim=-1)

    @staticmethod
    def _calculate_fisher_rao_distance(p: Tensor, t: Tensor) -> Tensor:
        return 2 * torch.arccos(torch.clamp(torch.sum(torch.sqrt(p * t), dim=-1), 0, 1))


@functools.cache
def _hash_logit_table(device: torch.device) -> Tensor:
    """Every id's row of hash logits, ``(2048, 2048)`` float32 (16 MB), drawn once per device."""
    return normal_rows(7, torch.arange(_DEFAULT_VOCAB, device=device), _DEFAULT_VOCAB)


def _default_hash_model(input_ids: Tensor, attention_mask: Tensor) -> Tensor:
    """Deterministic pseudo-logits that are *context-sensitive*: each position
    gets its own random row plus the mean row of every valid token in the
    sentence, so the distribution read at a masked position still depends on
    the surrounding words. The rows are gathered from the table of all 2048 ids."""
    rows = _hash_logit_table(input_ids.device)[torch.remainder(input_ids, _DEFAULT_VOCAB)]
    mask = attention_mask.to(torch.float32)
    context = torch.sum(rows * mask[..., None], dim=1, keepdim=True) / torch.clamp_min(
        torch.sum(mask, dim=1)[:, None, None], 1.0
    )
    return rows + context


def _get_token_mask(input_ids: Tensor, pad_token_id: int, sep_token_id: int, cls_token_id: int) -> Tensor:
    special = torch.tensor([pad_token_id, sep_token_id, cls_token_id], device=input_ids.device)
    return (~torch.isin(input_ids, special)).to(torch.float32)


def _get_sentence_distribution(
    model_fn: Callable[[Tensor, Tensor], Tensor],
    input_ids: Tensor,
    attention_mask: Tensor,
    temperature: float,
    idf_weights: Optional[Tensor],
    special_tokens_map: Dict[str, int],
) -> Tensor:
    """Per-sentence token distribution: mask each position, softmax the MLM
    logits there, average over non-special positions (``infolm.py:367-421``)."""
    token_mask = _get_token_mask(
        input_ids,
        special_tokens_map["pad_token_id"],
        special_tokens_map["sep_token_id"],
        special_tokens_map["cls_token_id"],
    )
    logits_at = getattr(model_fn, "logits_at", None)
    total = None
    for mask_idx in range(input_ids.shape[1]):
        masked_ids = input_ids.clone()
        masked_ids[:, mask_idx] = special_tokens_map["mask_token_id"]
        if logits_at is not None:
            logits = logits_at(masked_ids, attention_mask, mask_idx)
        else:
            logits = model_fn(masked_ids, attention_mask)[:, mask_idx, :]
        prob = torch.softmax(logits.float() / temperature, dim=-1)
        if idf_weights is not None:
            prob = prob * idf_weights[:, mask_idx][:, None]
        prob = prob * token_mask[:, mask_idx][:, None]
        total = prob if total is None else total + prob
    if idf_weights is not None:
        denom = torch.sum(token_mask * idf_weights, dim=1)[:, None]
    else:
        denom = torch.sum(token_mask, dim=1)[:, None]
    return total / torch.clamp_min(denom, 1e-12)


def _compute_idf_array(input_ids: np.ndarray, attention_mask: np.ndarray) -> np.ndarray:
    """Token-level IDF weights over the given corpus."""
    num_docs = max(input_ids.shape[0], 1)
    doc_freq: Dict[int, int] = {}
    for i in range(input_ids.shape[0]):
        for tok in set(input_ids[i][attention_mask[i] != 0].tolist()):
            doc_freq[tok] = doc_freq.get(tok, 0) + 1
    out = np.zeros(input_ids.shape, dtype=np.float32)
    for (i, j) in zip(*np.nonzero(attention_mask)):
        out[i, j] = np.log((num_docs + 1) / (doc_freq.get(int(input_ids[i, j]), 0) + 1))
    return out


def infolm(
    preds: Union[str, Sequence[str], Dict[str, np.ndarray]],
    target: Union[str, Sequence[str], Dict[str, np.ndarray]],
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
    special_tokens_map: Optional[Dict[str, int]] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """InfoLM: information measure between masked-LM token distributions.

    ``model(input_ids, attention_mask) -> (B, L, vocab)`` logits is the masked
    LM, and without one the JAX package's hash logits are, on ids remapped
    into their 2048-token vocabulary; ``tokenizer(text, max_length)`` tokenizes
    strings (pre-tokenized dicts need none). Token ids go to ``device``, else
    the model's ``device``, else ``cuda``.
    """
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]

    max_length = max_length or 64
    measure = _InformationMeasure(information_measure, alpha, beta)
    special = dict(_DEFAULT_SPECIAL_TOKENS)
    if special_tokens_map:
        special.update(special_tokens_map)
    tok = tokenizer if tokenizer is not None else _HashTokenizer(max_length)
    if tokenizer is None and model_name_or_path is not None:
        rank_zero_warn(
            "Pretrained checkpoints cannot be downloaded in this environment; `model_name_or_path`"
            f" ({model_name_or_path!r}) is ignored and a hash-logit model is used. Scores are"
            " self-consistent but do not match published InfoLM values."
        )
    model_fn = model if model is not None else _default_hash_model
    vocab_size = getattr(getattr(model_fn, "config", None), "vocab_size", None)
    if vocab_size is not None:
        oov = {k: v for k, v in special.items() if v >= vocab_size}
        if oov:
            # out-of-vocab ids make the embedding lookup fail or read garbage,
            # which nan_to_num would wash out to a meaningless score
            raise ValueError(
                f"special_tokens_map ids {oov} fall outside the model vocab ({vocab_size});"
                " pass `special_tokens_map=` matching the checkpoint's tokenizer."
            )

    def encode(data) -> Tuple[np.ndarray, np.ndarray]:
        if isinstance(data, dict):
            return np.asarray(data["input_ids"]), np.asarray(data["attention_mask"])
        enc = tok(list(data), max_length)
        return np.asarray(enc["input_ids"]), np.asarray(enc["attention_mask"])

    pred_ids, pred_mask = encode(preds)
    tgt_ids, tgt_mask = encode(target)
    if pred_ids.shape[0] != tgt_ids.shape[0]:
        raise ValueError("Number of predicted and reference sententes must be the same!")
    if model is None:
        # keep hash ids inside the toy vocab, away from special ids
        remap = lambda ids: np.where(ids > 0, (ids % (_DEFAULT_VOCAB - 200)) + 200, ids)  # noqa: E731
        pred_ids = remap(pred_ids)
        tgt_ids = remap(tgt_ids)

    dev = _resolve_device(device if device is not None else getattr(model, "device", None))
    on_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    if idf:
        pred_idf = on_dev(_compute_idf_array(pred_ids, pred_mask))
        tgt_idf = on_dev(_compute_idf_array(tgt_ids, tgt_mask))
    else:
        pred_idf = tgt_idf = None

    preds_distribution = _get_sentence_distribution(
        model_fn, on_dev(pred_ids), on_dev(pred_mask), temperature, pred_idf, special
    )
    target_distribution = _get_sentence_distribution(
        model_fn, on_dev(tgt_ids), on_dev(tgt_mask), temperature, tgt_idf, special
    )
    sentence_scores = measure(preds_distribution, target_distribution)
    corpus = torch.mean(sentence_scores)
    if return_sentence_level_score:
        return corpus, sentence_scores
    return corpus
