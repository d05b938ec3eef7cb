"""BERTScore (port of ``torchmetrics_tpu/functional/text/bert.py``).

Every sentence is embedded by a pluggable encoder, such as
:class:`~torchmetrics_tpu_torch.text._bert_encoder.BertEncoderExtractor` on a
converted BERT checkpoint, and scored by greedy cosine matching as one
batched product and masked max on the device. The whole corpus is encoded in
one call, as in the JAX package (``batch_size`` is accepted and unused), and
scored untrimmed.

Without a model, each token id gets the JAX package's hash embedding: a unit
vector of ``jax.random`` normals under ``fold_in(PRNGKey(0), id)``, drawn by
:mod:`~torchmetrics_tpu_torch.utilities._threefry` once per distinct id.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import _resolve_device
from torchmetrics_tpu_torch.utilities._threefry import normal_rows
from torchmetrics_tpu_torch.utilities.compute import full_fp32
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

_DEFAULT_MAX_LENGTH = 128
_EMBED_DIM = 128

# token -> stable hash id memo shared by every tokenizer instance, bounded so a
# streaming corpus with unbounded vocabulary cannot grow host memory
_TOKEN_HASH_MEMO: Dict[str, int] = {}
_TOKEN_HASH_MEMO_CAP = 1 << 16


def _stable_token_hash(tok: str) -> int:
    """Stable across processes (unlike built-in hash with PYTHONHASHSEED)."""
    h = 0
    for ch in tok:
        h = (h * 1000003 + ord(ch)) & 0x7FFFFFFF
    return h


class _HashTokenizer:
    """Whitespace tokenizer with stable hash ids (no external vocab files)."""

    def __init__(self, max_length: int = _DEFAULT_MAX_LENGTH) -> None:
        self.max_length = max_length

    def __call__(self, text: Sequence[str], max_length: Optional[int] = None) -> Dict[str, np.ndarray]:
        max_length = max_length or self.max_length
        ids = np.zeros((len(text), max_length), dtype=np.int64)
        mask = np.zeros((len(text), max_length), dtype=np.int64)
        memo = _TOKEN_HASH_MEMO
        for i, sentence in enumerate(text):
            row = []
            for tok in sentence.lower().split()[:max_length]:
                h = memo.get(tok)
                if h is None:
                    h = _stable_token_hash(tok)
                    if len(memo) < _TOKEN_HASH_MEMO_CAP:
                        memo[tok] = h
                row.append(h)
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def _hash_embedding(input_ids: Tensor, attention_mask: Tensor) -> Tensor:
    """Deterministic pseudo-random unit embedding per token id, zero where the mask is 0: ``(B, L, 128)``.

    The JAX package's ``_hash_embedding``: each id's vector is a pure function
    of the id, so it is drawn once per distinct id and gathered back.
    """
    uniq, inverse = torch.unique(input_ids, return_inverse=True)
    table = normal_rows(0, uniq, _EMBED_DIM)
    table = table / torch.linalg.vector_norm(table, dim=-1, keepdim=True)
    return table[inverse] * attention_mask[..., None]


def _pad_encoding(enc, max_length: int) -> Dict[str, np.ndarray]:
    """Pad/truncate a pre-tokenized {'input_ids','attention_mask'} batch."""
    out = {}
    for key in ("input_ids", "attention_mask"):
        arr = np.asarray(enc[key])[:, :max_length]
        if arr.shape[1] < max_length:
            arr = np.pad(arr, ((0, 0), (0, max_length - arr.shape[1])))
        out[key] = arr
    return out


def _compute_idf(input_ids: np.ndarray, attention_mask: np.ndarray) -> Dict[int, float]:
    """Inverse-document-frequency weights over the reference corpus."""
    num_docs = input_ids.shape[0]
    doc_freq: Counter = Counter()
    for i in range(num_docs):
        doc_freq.update(set(input_ids[i][attention_mask[i] != 0].tolist()))
    return {tok: math.log((num_docs + 1) / (freq + 1)) for tok, freq in doc_freq.items()}


def _idf_weights(input_ids: np.ndarray, attention_mask: np.ndarray, idf_map: Dict[int, float]) -> np.ndarray:
    """Per-token idf (``log(N + 1)`` for a token unseen in the references), 0 where the mask is 0."""
    unseen = math.log((input_ids.shape[0] + 1) / 1)
    uniq, inverse = np.unique(input_ids, return_inverse=True)
    table = np.asarray([idf_map.get(int(t), unseen) for t in uniq], dtype=np.float32)
    weights = table[inverse.reshape(input_ids.shape)] if uniq.size else np.zeros(input_ids.shape, np.float32)
    return np.where(attention_mask != 0, weights, np.float32(0.0)).astype(np.float32)


def _best_matches(pred_emb: Tensor, pred_mask: Tensor, tgt_emb: Tensor, tgt_mask: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-token best cosine match: each token pairs with its best partner."""
    norm = lambda e: e / torch.clamp_min(torch.linalg.vector_norm(e, dim=-1, keepdim=True), 1e-12)  # noqa: E731
    with full_fp32():
        sim = torch.bmm(norm(pred_emb), norm(tgt_emb).transpose(1, 2))
    neg = torch.tensor(-1e9, dtype=sim.dtype, device=sim.device)
    sim_p = torch.where(tgt_mask[:, None, :] > 0, sim, neg)
    sim_t = torch.where(pred_mask[:, :, None] > 0, sim, neg)
    return sim_p.amax(dim=2), sim_t.amax(dim=1)  # (B, Lp), (B, Lt)


def _weighted_scores(
    best_for_pred: Tensor, best_for_tgt: Tensor, pred_w: Tensor, tgt_w: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    precision = torch.sum(best_for_pred * pred_w, dim=1) / torch.clamp_min(torch.sum(pred_w, dim=1), 1e-12)
    recall = torch.sum(best_for_tgt * tgt_w, dim=1) / torch.clamp_min(torch.sum(tgt_w, dim=1), 1e-12)
    f1 = 2 * precision * recall / torch.clamp_min(precision + recall, 1e-12)
    return precision, recall, f1


def _greedy_cosine_matching(
    pred_emb: Tensor, pred_mask: Tensor, tgt_emb: Tensor, tgt_mask: Tensor, pred_w: Tensor, tgt_w: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Weighted greedy matching: each token pairs with its best cosine match."""
    best_for_pred, best_for_tgt = _best_matches(pred_emb.float(), pred_mask, tgt_emb.float(), tgt_mask)
    return _weighted_scores(best_for_pred, best_for_tgt, pred_w, tgt_w)


def _encode(data, tokenizer, max_length: int) -> Dict[str, np.ndarray]:
    if isinstance(data, dict):
        return {k: np.asarray(v) for k, v in data.items()}
    return {k: np.asarray(v) for k, v in tokenizer(list(data), max_length).items()}


def bert_score(
    preds: Union[str, Sequence[str], Dict[str, np.ndarray]],
    target: Union[str, Sequence[str], Dict[str, np.ndarray]],
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
) -> Dict[str, Union[Tensor, List[float], str]]:
    """BERTScore: greedy cosine matching of contextual embeddings.

    ``model(input_ids, attention_mask) -> (B, L, D)`` embeddings, or
    ``user_forward_fn(model, input_ids, attention_mask)``, is the encoder;
    ``user_tokenizer(text, max_length) -> {"input_ids", "attention_mask"}``
    tokenizes strings (pre-tokenized dicts need none). Without either, the
    JAX package's hash embedding is the encoder. Token ids go to ``device``,
    else the model's ``device``, else ``cuda``.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import bert_score
        >>> enc = {"input_ids": [[101, 7592, 102]], "attention_mask": [[1, 1, 1]]}
        >>> one_hot = lambda ids, mask: torch.nn.functional.one_hot(ids, 8000).float()
        >>> score = bert_score(enc, enc, model=one_hot, device="cpu")
        >>> round(float(score["f1"][0]), 2)
        1.0
    """
    if rescale_with_baseline:
        raise ValueError("`rescale_with_baseline` requires downloadable baseline files, unavailable in this build.")
    tokenizer = user_tokenizer if user_tokenizer is not None else _HashTokenizer(max_length)
    if user_tokenizer is None and model_name_or_path is not None:
        rank_zero_warn(
            "Pretrained checkpoints cannot be downloaded in this environment; `model_name_or_path`"
            f" ({model_name_or_path!r}) is ignored and a hash-embedding encoder is used. Scores will be"
            " self-consistent but will not match published BERTScore values."
        )
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    pred_enc = _encode(preds, tokenizer, max_length)
    tgt_enc = _encode(target, tokenizer, max_length)
    if pred_enc["input_ids"].shape[0] != tgt_enc["input_ids"].shape[0]:
        raise ValueError("Number of predicted and reference sententes must be the same!")

    if idf:
        idf_map = _compute_idf(tgt_enc["input_ids"], tgt_enc["attention_mask"])
        pred_w = _idf_weights(pred_enc["input_ids"], pred_enc["attention_mask"], idf_map)
        tgt_w = _idf_weights(tgt_enc["input_ids"], tgt_enc["attention_mask"], idf_map)
    else:
        pred_w = pred_enc["attention_mask"].astype(np.float32)
        tgt_w = tgt_enc["attention_mask"].astype(np.float32)

    dev = _resolve_device(device if device is not None else getattr(model, "device", None))
    on_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    pred_ids, pred_mask = on_dev(pred_enc["input_ids"]), on_dev(pred_enc["attention_mask"])
    tgt_ids, tgt_mask = on_dev(tgt_enc["input_ids"]), on_dev(tgt_enc["attention_mask"])
    if user_forward_fn is not None:
        pred_emb = user_forward_fn(model, pred_ids, pred_mask)
        tgt_emb = user_forward_fn(model, tgt_ids, tgt_mask)
    elif model is not None and callable(model):
        pred_emb = model(pred_ids, pred_mask)
        tgt_emb = model(tgt_ids, tgt_mask)
    else:
        pred_emb = _hash_embedding(pred_ids, pred_mask)
        tgt_emb = _hash_embedding(tgt_ids, tgt_mask)
    precision, recall, f1 = _greedy_cosine_matching(
        pred_emb, pred_mask, tgt_emb, tgt_mask, on_dev(pred_w), on_dev(tgt_w)
    )
    output: Dict[str, Union[Tensor, List[float], str]] = {"precision": precision, "recall": recall, "f1": f1}
    if return_hash:
        output["hash"] = f"tpu_hash_embed_dim{_EMBED_DIM}_len{max_length}"
    return output
