"""BLEU score (port of ``torchmetrics_tpu/functional/text/bleu.py``).

N-gram counting is host work on strings. The per-order count vectors and
lengths are float32 state on the device, where the geometric mean and the
brevity penalty are computed, in float32 as in the JAX package.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import _resolve_device


def _count_ngram(tokens: Sequence[str], n_gram: int) -> Counter:
    """Count all n-grams of order 1..n_gram in a token sequence."""
    counter: Counter = Counter()
    for n in range(1, n_gram + 1):
        for j in range(len(tokens) - n + 1):
            counter[tuple(tokens[j : j + n])] += 1
    return counter


def _tokenize_fn(sentence: str) -> Sequence[str]:
    return sentence.split()


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """Batch (numerator, denominator, preds_len, target_len) statistics on the host.

    Prediction n-gram counts are clipped against the elementwise max over the
    references; the reference length is the one closest to the prediction's
    (ties go to the shorter).
    """
    target_tok = [[tokenizer(line) if line else [] for line in refs] for refs in target]
    preds_tok = [tokenizer(line) if line else [] for line in preds]
    numerator = np.zeros(n_gram)
    denominator = np.zeros(n_gram)
    preds_len = 0.0
    target_len = 0.0

    for pred, refs in zip(preds_tok, target_tok):
        preds_len += len(pred)
        ref_lens = [len(ref) for ref in refs]
        diffs = [abs(len(pred) - x) for x in ref_lens]
        target_len += ref_lens[diffs.index(min(diffs))]
        preds_counter = _count_ngram(pred, n_gram)
        target_counter: Counter = Counter()
        for ref in refs:
            target_counter |= _count_ngram(ref, n_gram)
        clipped = preds_counter & target_counter
        for ngram, cnt in clipped.items():
            numerator[len(ngram) - 1] += cnt
        for ngram, cnt in preds_counter.items():
            denominator[len(ngram) - 1] += cnt

    return numerator, denominator, preds_len, target_len


def _bleu_score_compute(
    preds_len: Tensor,
    target_len: Tensor,
    numerator: Tensor,
    denominator: Tensor,
    n_gram: int,
    weights: Sequence[float],
    smooth: bool,
) -> Tensor:
    """Corpus BLEU from the accumulated float32 statistics, on their device."""
    if float(numerator.min()) == 0.0:
        return torch.tensor(0.0, device=numerator.device)
    if smooth:
        precision = (numerator + 1.0) / (denominator + 1.0)
        precision[0] = numerator[0] / denominator[0]
    else:
        precision = numerator / denominator
    log_precision = torch.tensor(weights, dtype=torch.float32, device=numerator.device) * torch.log(precision)
    geometric_mean = torch.exp(log_precision.sum())
    brevity = torch.where(preds_len > target_len, 1.0, torch.exp(1 - target_len / preds_len))
    return brevity * geometric_mean


def _bleu_corpus(
    preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]
) -> Tuple[list, list]:
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    return preds_, target_


def _bleu_functional(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int,
    smooth: bool,
    weights: Optional[Sequence[float]],
    tokenizer: Callable[[str], Sequence[str]],
    device: Optional[Union[str, torch.device]],
) -> Tensor:
    """One corpus through :func:`_bleu_score_update` and :func:`_bleu_score_compute` on ``device``."""
    preds_, target_ = _bleu_corpus(preds, target)
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    if weights is None:
        weights = [1.0 / n_gram] * n_gram
    dev = _resolve_device(device)
    numerator, denominator, preds_len, target_len = _bleu_score_update(preds_, target_, n_gram, tokenizer)
    on_dev = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    return _bleu_score_compute(
        on_dev(preds_len), on_dev(target_len), on_dev(numerator), on_dev(denominator), n_gram, weights, smooth
    )


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    weights: Optional[Sequence[float]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """BLEU score of machine-translated text against one or more references, on ``device`` (``cuda`` unless given).

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import bleu_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(bleu_score(preds, target, device="cpu")), 4)
        0.7598
    """
    return _bleu_functional(preds, target, n_gram, smooth, weights, _tokenize_fn, device)
