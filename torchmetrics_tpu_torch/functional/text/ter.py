"""Translation edit rate (port of ``torchmetrics_tpu/functional/text/ter.py``).

Tercom's greedy shift search is sequential host work: each iteration rewrites
the hypothesis word list and re-scores candidate shifts. It stays on the
host, as in the JAX package. The state on the device is the float32
(edits, reference length) pair; a batch's per-sentence statistics are folded
on the host in float32, in sentence order as the JAX package adds them, and
added to the state once.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import _resolve_device

_MAX_SHIFT_SIZE = 10
_MAX_SHIFT_DIST = 50
_MAX_SHIFT_CANDIDATES = 1000

# Edit-op codes used in DP traces
_OP_NOTHING, _OP_SUB, _OP_INS, _OP_DEL = 0, 1, 2, 3


class _TercomTokenizer:
    """Tercom-style normalization: XML unescape, punctuation split, optional
    lowercase / punctuation removal / asian character splitting."""

    _ASIAN_PUNCTUATION = r"([、。〈-】〔-〟｡-･・])"
    _FULL_WIDTH_PUNCTUATION = r"([．，？：；！＂（）])"

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
    ) -> None:
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support

    def __call__(self, sentence: str) -> str:
        if not sentence:
            return ""
        if self.lowercase:
            sentence = sentence.lower()
        if self.normalize:
            sentence = self._normalize_general_and_western(sentence)
            if self.asian_support:
                sentence = self._normalize_asian(sentence)
        if self.no_punctuation:
            sentence = self._remove_punct(sentence)
            if self.asian_support:
                sentence = self._remove_asian_punct(sentence)
        return " ".join(sentence.split())

    @staticmethod
    def _normalize_general_and_western(sentence: str) -> str:
        sentence = f" {sentence} "
        rules = [
            (r"\n-", ""),
            (r"\n", " "),
            (r"&quot;", '"'),
            (r"&amp;", "&"),
            (r"&lt;", "<"),
            (r"&gt;", ">"),
            (r"([{-~[-` -&(-+:-@/])", r" \1 "),
            (r"'s ", r" 's "),
            (r"'s$", r" 's"),
            (r"([^0-9])([\.,])", r"\1 \2 "),
            (r"([\.,])([^0-9])", r" \1 \2"),
            (r"([0-9])(-)", r"\1 \2 "),
        ]
        for pattern, replacement in rules:
            sentence = re.sub(pattern, replacement, sentence)
        return sentence

    @classmethod
    def _normalize_asian(cls, sentence: str) -> str:
        sentence = re.sub(r"([一-鿿㐀-䶿])", r" \1 ", sentence)
        sentence = re.sub(r"([㇀-㇯⺀-⻿])", r" \1 ", sentence)
        sentence = re.sub(r"([㌀-㏿豈-﫿︰-﹏])", r" \1 ", sentence)
        sentence = re.sub(r"([㈀-㼢])", r" \1 ", sentence)
        sentence = re.sub(r"(^|^[぀-ゟ])([぀-ゟ]+)(?=$|^[぀-ゟ])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[゠-ヿ])([゠-ヿ]+)(?=$|^[゠-ヿ])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[ㇰ-ㇿ])([ㇰ-ㇿ]+)(?=$|^[ㇰ-ㇿ])", r"\1 \2 ", sentence)
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r" \1 ", sentence)
        return re.sub(cls._FULL_WIDTH_PUNCTUATION, r" \1 ", sentence)

    @staticmethod
    def _remove_punct(sentence: str) -> str:
        return re.sub(r"[\.,\?:;!\"\(\)]", "", sentence)

    @classmethod
    def _remove_asian_punct(cls, sentence: str) -> str:
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r"", sentence)
        return re.sub(cls._FULL_WIDTH_PUNCTUATION, r"", sentence)


def _preprocess_sentence(sentence: str, tokenizer: _TercomTokenizer) -> str:
    return tokenizer(sentence.rstrip())


def _lev_trace(pred_words: Sequence[str], ref_words: Sequence[str]) -> Tuple[int, List[int]]:
    """Levenshtein distance plus op trace rewriting ``pred`` into ``ref``.

    Tercom's tie-break preference per cell: match/substitute, then delete,
    then insert (the order matters for which alignment the shift heuristics
    see).
    """
    n_p, n_r = len(pred_words), len(ref_words)
    inf = 10**15
    cost = [[0] * (n_r + 1) for _ in range(n_p + 1)]
    op = [[_OP_NOTHING] * (n_r + 1) for _ in range(n_p + 1)]
    for j in range(1, n_r + 1):
        cost[0][j] = j
        op[0][j] = _OP_INS
    for i in range(1, n_p + 1):
        cost[i][0] = i
        op[i][0] = _OP_DEL
    for i in range(1, n_p + 1):
        row_p = pred_words[i - 1]
        for j in range(1, n_r + 1):
            if row_p == ref_words[j - 1]:
                sub_cost, sub_op = cost[i - 1][j - 1], _OP_NOTHING
            else:
                sub_cost, sub_op = cost[i - 1][j - 1] + 1, _OP_SUB
            best_cost, best_op = inf, _OP_NOTHING
            for c, o in ((sub_cost, sub_op), (cost[i - 1][j] + 1, _OP_DEL), (cost[i][j - 1] + 1, _OP_INS)):
                if best_cost > c:
                    best_cost, best_op = c, o
            cost[i][j] = best_cost
            op[i][j] = best_op
    # backtrack
    trace: List[int] = []
    i, j = n_p, n_r
    while i > 0 or j > 0:
        o = op[i][j]
        trace.append(o)
        if o in (_OP_NOTHING, _OP_SUB):
            i -= 1
            j -= 1
        elif o == _OP_INS:
            j -= 1
        else:
            i -= 1
    trace.reverse()
    return cost[n_p][n_r], trace


def _flip_trace(trace: List[int]) -> List[int]:
    """Swap insertions and deletions: a recipe for rewriting b→a from a→b."""
    flip = {_OP_INS: _OP_DEL, _OP_DEL: _OP_INS}
    return [flip.get(o, o) for o in trace]


def _trace_to_alignment(trace: List[int]) -> Tuple[Dict[int, int], List[int], List[int]]:
    """Alignment dict (ref position → hyp position) plus per-side error flags."""
    ref_pos = hyp_pos = -1
    ref_errors: List[int] = []
    hyp_errors: List[int] = []
    alignments: Dict[int, int] = {}
    for o in trace:
        if o == _OP_NOTHING:
            hyp_pos += 1
            ref_pos += 1
            alignments[ref_pos] = hyp_pos
            ref_errors.append(0)
            hyp_errors.append(0)
        elif o == _OP_SUB:
            hyp_pos += 1
            ref_pos += 1
            alignments[ref_pos] = hyp_pos
            ref_errors.append(1)
            hyp_errors.append(1)
        elif o == _OP_INS:
            hyp_pos += 1
            hyp_errors.append(1)
        else:  # _OP_DEL
            ref_pos += 1
            alignments[ref_pos] = hyp_pos
            ref_errors.append(1)
    return alignments, ref_errors, hyp_errors


def _find_shifted_pairs(pred_words: List[str], target_words: List[str]) -> Iterator[Tuple[int, int, int]]:
    """Yield (pred_start, target_start, length) of matching word sub-sequences."""
    for pred_start in range(len(pred_words)):
        for target_start in range(len(target_words)):
            if abs(target_start - pred_start) > _MAX_SHIFT_DIST:
                continue
            for length in range(1, _MAX_SHIFT_SIZE):
                if (
                    pred_start + length > len(pred_words)
                    or target_start + length > len(target_words)
                    or pred_words[pred_start + length - 1] != target_words[target_start + length - 1]
                ):
                    break
                yield pred_start, target_start, length
                if len(pred_words) == pred_start + length or len(target_words) == target_start + length:
                    break


def _shift_is_vetoed(
    alignments: Dict[int, int],
    pred_errors: List[int],
    target_errors: List[int],
    pred_start: int,
    target_start: int,
    length: int,
) -> bool:
    """Tercom corner cases: skip shifts of already-correct spans, spans whose
    target side already matches, and shifts landing inside the moved span."""
    if sum(pred_errors[pred_start : pred_start + length]) == 0:
        return True
    if sum(target_errors[target_start : target_start + length]) == 0:
        return True
    if pred_start <= alignments[target_start] < pred_start + length:
        return True
    return False


def _perform_shift(words: List[str], start: int, length: int, target: int) -> List[str]:
    if target < start:
        return words[:target] + words[start : start + length] + words[target:start] + words[start + length :]
    if target > start + length:
        return words[:start] + words[start + length : target] + words[start : start + length] + words[target:]
    return (
        words[:start] + words[start + length : length + target] + words[start : start + length] + words[length + target :]
    )


def _shift_words(
    pred_words: List[str],
    target_words: List[str],
    checked_candidates: int,
) -> Tuple[int, List[str], int]:
    """Pick tercom's best single shift: highest edit-distance gain, then
    longest span, then earliest pred position, then earliest target slot."""
    edit_distance, inverted_trace = _lev_trace(pred_words, target_words)
    trace = _flip_trace(inverted_trace)
    alignments, target_errors, pred_errors = _trace_to_alignment(trace)

    best: Optional[Tuple[int, int, int, int, List[str]]] = None
    for pred_start, target_start, length in _find_shifted_pairs(pred_words, target_words):
        if _shift_is_vetoed(alignments, pred_errors, target_errors, pred_start, target_start, length):
            continue
        prev_idx = -1
        for offset in range(-1, length):
            if target_start + offset == -1:
                idx = 0
            elif target_start + offset in alignments:
                idx = alignments[target_start + offset] + 1
            else:
                break
            if idx == prev_idx:
                continue
            prev_idx = idx
            shifted_words = _perform_shift(pred_words, pred_start, length, idx)
            candidate = (
                edit_distance - _lev_trace(shifted_words, target_words)[0],
                length,
                -pred_start,
                -idx,
                shifted_words,
            )
            checked_candidates += 1
            if not best or candidate > best:
                best = candidate
        if checked_candidates >= _MAX_SHIFT_CANDIDATES:
            break

    if not best:
        return 0, pred_words, checked_candidates
    best_score, _, _, _, shifted_words = best
    return best_score, shifted_words, checked_candidates


def _translation_edit_rate(pred_words: List[str], target_words: List[str]) -> float:
    """Number of edits (shifts + word edits) to turn ``pred`` into ``target``."""
    if len(target_words) == 0:
        return 0.0
    num_shifts = 0
    checked_candidates = 0
    input_words = list(pred_words)
    while True:
        delta, new_input_words, checked_candidates = _shift_words(input_words, target_words, checked_candidates)
        if checked_candidates >= _MAX_SHIFT_CANDIDATES or delta <= 0:
            break
        num_shifts += 1
        input_words = new_input_words
    edit_distance, _ = _lev_trace(input_words, target_words)
    return float(num_shifts + edit_distance)


def _compute_sentence_statistics(pred_words: List[str], target_words: List[List[str]]) -> Tuple[float, float]:
    """Best (lowest) edit count over references, plus average reference length.

    Mirrors the reference's argument order, which evaluates with the roles of
    hypothesis and reference swapped inside ``_translation_edit_rate``
    (``ter.py:446``).
    """
    tgt_lengths = 0.0
    best_num_edits = 2e16
    for tgt_words in target_words:
        num_edits = _translation_edit_rate(tgt_words, pred_words)
        tgt_lengths += len(tgt_words)
        if num_edits < best_num_edits:
            best_num_edits = num_edits
    avg_tgt_len = tgt_lengths / max(len(target_words), 1)
    return best_num_edits, avg_tgt_len


def _compute_ter_score_from_statistics(num_edits: float, tgt_length: float) -> float:
    if tgt_length > 0 and num_edits > 0:
        return num_edits / tgt_length
    if tgt_length == 0 and num_edits > 0:
        return 1.0
    return 0.0


def _ter_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    tokenizer: _TercomTokenizer,
) -> Tuple[float, float, List[float]]:
    """(edits, reference length) of the batch, each a float32 sum in sentence order, and each sentence's TER."""
    preds_list = [preds] if isinstance(preds, str) else list(preds)
    target_list = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_list) != len(target_list):
        raise ValueError(f"Corpus has different size {len(preds_list)} != {len(target_list)}")

    total_num_edits = total_tgt_length = np.float32(0.0)
    sentence_ter: List[float] = []
    for pred, tgt in zip(preds_list, target_list):
        tgt_words_ = [_preprocess_sentence(t, tokenizer).split() for t in tgt]
        pred_words_ = _preprocess_sentence(pred, tokenizer).split()
        num_edits, tgt_length = _compute_sentence_statistics(pred_words_, tgt_words_)
        total_num_edits = total_num_edits + np.float32(num_edits)
        total_tgt_length = total_tgt_length + np.float32(tgt_length)
        sentence_ter.append(_compute_ter_score_from_statistics(num_edits, tgt_length))
    return float(total_num_edits), float(total_tgt_length), sentence_ter


def _ter_compute(total_num_edits: Tensor, total_tgt_length: Tensor) -> Tensor:
    score = _compute_ter_score_from_statistics(float(total_num_edits), float(total_tgt_length))  # lint-ok: R2 scalar fold of host edit statistics; TER compute is eager by design
    return torch.tensor(score, dtype=torch.float32, device=total_num_edits.device)


def _ter_args_validation(normalize: bool, no_punctuation: bool, lowercase: bool, asian_support: bool) -> None:
    if not isinstance(normalize, bool):
        raise ValueError(f"Expected argument `normalize` to be of type boolean but got {normalize}.")
    if not isinstance(no_punctuation, bool):
        raise ValueError(f"Expected argument `no_punctuation` to be of type boolean but got {no_punctuation}.")
    if not isinstance(lowercase, bool):
        raise ValueError(f"Expected argument `lowercase` to be of type boolean but got {lowercase}.")
    if not isinstance(asian_support, bool):
        raise ValueError(f"Expected argument `asian_support` to be of type boolean but got {asian_support}.")


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Translation edit rate (tercom): shifts plus word edits over reference length, on ``device`` (``cuda`` unless given).

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import translation_edit_rate
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(translation_edit_rate(preds, target, device="cpu")), 4)
        0.1538
    """
    _ter_args_validation(normalize, no_punctuation, lowercase, asian_support)
    dev = _resolve_device(device)
    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    num_edits, tgt_length, sentence_ter = _ter_update(preds, target, tokenizer)
    on_dev = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    total_ter = _ter_compute(on_dev(num_edits), on_dev(tgt_length))
    if return_sentence_level_score:
        return total_ter, on_dev(sentence_ter)
    return total_ter
