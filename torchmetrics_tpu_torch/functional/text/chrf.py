"""chrF / chrF++ score (port of ``torchmetrics_tpu/functional/text/chrf.py``).

Character and word n-gram counting is host work. The per-order count vectors
(``(n_char_order,)`` and ``(n_word_order,)``, pred/target/matching) are
float32 state on the device, each reduced by one sum; the final F-score fold
reads them back and runs on the host in numpy, as in the JAX package.
"""

from __future__ import annotations

from collections import Counter
from itertools import chain
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import _resolve_device

_EPS_SMOOTHING = 1e-16
_PUNCTUATIONS = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def _get_characters(sentence: str, whitespace: bool) -> List[str]:
    if whitespace:
        return list(sentence)
    return list(sentence.strip().replace(" ", ""))


def _separate_word_and_punctuation(word: str) -> List[str]:
    if len(word) == 1:
        return [word]
    if word[-1] in _PUNCTUATIONS:
        return [word[:-1], word[-1]]
    if word[0] in _PUNCTUATIONS:
        return [word[0], word[1:]]
    return [word]


def _get_words_and_punctuation(sentence: str) -> List[str]:
    return list(chain.from_iterable(_separate_word_and_punctuation(w) for w in sentence.strip().split()))


def _ngram_counts(items: List[str], n_order: int) -> List[Counter]:
    """Per-order n-gram counters, index 0 ↔ order 1."""
    out = []
    for n in range(1, n_order + 1):
        counter: Counter = Counter(tuple(items[i : i + n]) for i in range(len(items) - n + 1))
        out.append(counter)
    return out


def _sentence_counts(
    sentence: str, n_char_order: int, n_word_order: int, lowercase: bool, whitespace: bool
) -> Tuple[List[Counter], List[Counter], np.ndarray, np.ndarray]:
    if lowercase:
        sentence = sentence.lower()
    char_counts = _ngram_counts(_get_characters(sentence, whitespace), n_char_order)
    word_counts = _ngram_counts(_get_words_and_punctuation(sentence), n_word_order)
    char_totals = np.asarray([float(sum(c.values())) for c in char_counts])
    word_totals = np.asarray([float(sum(c.values())) for c in word_counts])
    return char_counts, word_counts, char_totals, word_totals


def _matches(hyp_counts: List[Counter], ref_counts: List[Counter]) -> np.ndarray:
    return np.asarray(
        [float(sum(min(ref[ng], hyp[ng]) for ng in hyp)) for hyp, ref in zip(hyp_counts, ref_counts)]
    )


def _fscore_from_counts(
    matching_char: np.ndarray,
    matching_word: np.ndarray,
    hyp_char: np.ndarray,
    hyp_word: np.ndarray,
    ref_char: np.ndarray,
    ref_word: np.ndarray,
    n_order: float,
    beta: float,
) -> float:
    """chrF/chrF++ from per-order count vectors (sentence or corpus level)."""

    def per_order(matching, ref, hyp):
        precision = np.where(hyp > 0, matching / np.maximum(hyp, 1e-38), 0.0)
        recall = np.where(ref > 0, matching / np.maximum(ref, 1e-38), 0.0)
        denom = np.maximum(beta**2 * precision + recall, _EPS_SMOOTHING)
        return (1 + beta**2) * precision * recall / denom

    char_f = per_order(matching_char, ref_char, hyp_char)
    word_f = per_order(matching_word, ref_word, hyp_word)
    return float((char_f.sum() + word_f.sum()) / n_order)


def _chrf_score_update(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int,
    n_word_order: int,
    beta: float,
    lowercase: bool,
    whitespace: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[float]]:
    """Accumulate corpus statistics; per-sample, the best-matching reference
    (highest sentence chrF) contributes its counts (ref ``chrf.py:390-470``).
    """
    preds_list = [preds] if isinstance(preds, str) else list(preds)
    target_list = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_list) != len(target_list):
        raise ValueError(
            f"Arguments `preds` and `target` must have the same length, but got {len(preds_list)} and {len(target_list)}"
        )
    n_order = float(n_char_order + n_word_order)

    tot_p_char = np.zeros(n_char_order)
    tot_p_word = np.zeros(n_word_order)
    tot_t_char = np.zeros(n_char_order)
    tot_t_word = np.zeros(n_word_order)
    tot_m_char = np.zeros(n_char_order)
    tot_m_word = np.zeros(n_word_order)
    sentence_scores: List[float] = []

    for pred, refs in zip(preds_list, target_list):
        p_char_counts, p_word_counts, p_char_tot, p_word_tot = _sentence_counts(
            pred, n_char_order, n_word_order, lowercase, whitespace
        )
        best_f = 0.0
        best_m_char = np.zeros(n_char_order)
        best_m_word = np.zeros(n_word_order)
        best_t_char = np.zeros(n_char_order)
        best_t_word = np.zeros(n_word_order)
        for ref in refs:
            r_char_counts, r_word_counts, r_char_tot, r_word_tot = _sentence_counts(
                ref, n_char_order, n_word_order, lowercase, whitespace
            )
            m_char = _matches(p_char_counts, r_char_counts)
            m_word = _matches(p_word_counts, r_word_counts)
            f = _fscore_from_counts(m_char, m_word, p_char_tot, p_word_tot, r_char_tot, r_word_tot, n_order, beta)
            if f > best_f:
                best_f, best_m_char, best_m_word = f, m_char, m_word
                best_t_char, best_t_word = r_char_tot, r_word_tot
        tot_p_char += p_char_tot
        tot_p_word += p_word_tot
        tot_t_char += best_t_char
        tot_t_word += best_t_word
        tot_m_char += best_m_char
        tot_m_word += best_m_word
        sentence_scores.append(best_f)

    return tot_p_char, tot_p_word, tot_t_char, tot_t_word, tot_m_char, tot_m_word, sentence_scores


def _chrf_score_compute(
    total_preds_char: Tensor,
    total_preds_word: Tensor,
    total_target_char: Tensor,
    total_target_word: Tensor,
    total_matching_char: Tensor,
    total_matching_word: Tensor,
    n_order: float,
    beta: float,
) -> Tensor:
    """Corpus chrF from the float32 count states: one read-back, the fold in numpy, a float32 result on their device."""
    host = lambda t: t.cpu().numpy()  # noqa: E731
    score = _fscore_from_counts(
        host(total_matching_char),
        host(total_matching_word),
        host(total_preds_char),
        host(total_preds_word),
        host(total_target_char),
        host(total_target_word),
        n_order,
        beta,
    )
    return torch.tensor(score, dtype=torch.float32, device=total_preds_char.device)


def _chrf_args_validation(n_char_order: int, n_word_order: int, beta: float) -> None:
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """chrF (``n_word_order=0``) / chrF++ (default) score, on ``device`` (``cuda`` unless given).

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import chrf_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat']]
        >>> round(float(chrf_score(preds, target, device="cpu")), 4)
        0.4942
    """
    _chrf_args_validation(n_char_order, n_word_order, beta)
    dev = _resolve_device(device)
    stats = _chrf_score_update(preds, target, n_char_order, n_word_order, beta, lowercase, whitespace)
    states = [torch.as_tensor(s, dtype=torch.float32, device=dev) for s in stats[:6]]
    score = _chrf_score_compute(*states, n_char_order + n_word_order, beta)
    if return_sentence_level_score:
        return score, torch.tensor(stats[6], dtype=torch.float32, device=dev)
    return score
