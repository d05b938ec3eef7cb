"""ROUGE score (port of ``torchmetrics_tpu/functional/text/rouge.py``).

Tokenizing and the n-gram counts are host work. ROUGE-L's LCS lengths come
from :func:`~torchmetrics_tpu_torch.functional.text.helper._lcs_tokens`: one
batched DP for all (prediction, reference) pairs of an update, on the host
below the dispatch size and on the device above it, read back once.
ROUGE-Lsum splits sentences with a rule-based model of nltk punkt's English
behaviour (:func:`_split_sentence`) and takes union LCSs on the host.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.helper import _lcs_tokens
from torchmetrics_tpu_torch.metric import _resolve_device

ALLOWED_ROUGE_KEYS: Dict[str, Union[int, str]] = {
    "rouge1": 1,
    "rouge2": 2,
    "rouge3": 3,
    "rouge4": 4,
    "rouge5": 5,
    "rouge6": 6,
    "rouge7": 7,
    "rouge8": 8,
    "rouge9": 9,
    "rougeL": "L",
    "rougeLsum": "Lsum",
}
ALLOWED_ACCUMULATE_VALUES = ("avg", "best")

# Common English abbreviations that the pretrained punkt model treats as
# non-terminal (a period after them does not end the sentence). Lowercased,
# trailing period stripped; internal periods kept ("e.g", "u.s").
_PUNKT_ABBREVIATIONS = frozenset(
    (
        "dr mr mrs ms prof rev fr sr jr st vs etc inc ltd co corp dept univ est fig al gen rep sen gov "
        "lt col maj sgt capt cmdr adm hon messrs mme mlle no nos vol pp approx appt min sec mt ave blvd rd apt "
        "jan feb mar apr jun jul aug sep sept oct nov dec mon tue tues wed thu thurs fri sat sun "
        "e.g i.e a.m p.m ph.d b.a m.a b.sc m.sc d.c u.s u.k u.n cf ca viz resp"
    ).split()
)

# candidate boundary: terminal punctuation, optional closing quotes/brackets,
# then whitespace — the capture keeps the token to the left for inspection
_SENTENCE_BOUNDARY = re.compile(r"(\S*[.!?]+[\"'”’)\]]*)(\s+)")


def _split_sentence(x: str) -> Sequence[str]:
    """Sentence splitter modeling nltk punkt's English behavior.

    The reference calls ``nltk.sent_tokenize`` (pretrained punkt,
    ``reference functional/text/rouge.py:62-71``); punkt data cannot be
    downloaded in an offline environment, so this is a rule-based port of
    its observable behavior: breaks at ``.!?`` (plus trailing close
    quotes/brackets) before whitespace, EXCEPT after known abbreviations
    ("Dr.", "e.g."), single-letter initials ("J. Smith"), and when the next
    word starts lowercase or with a digit (punkt's orthographic heuristic).
    Newlines always split. Approximation boundary (covered by
    ``tests/unittests/text/test_rouge_sentence_split.py``): punkt's
    corpus-learned rare abbreviations and its collocation/frequent-
    sentence-starter reclassification are not modeled, so e.g. "No. 7" or a
    sentence break directly after an unlisted abbreviation can differ.
    """
    sentences: List[str] = []
    for paragraph in x.splitlines():
        paragraph = paragraph.strip()
        if not paragraph:
            continue
        start = 0
        for m in _SENTENCE_BOUNDARY.finditer(paragraph):
            token, end = m.group(1), m.end()
            nxt = paragraph[end : end + 1]
            if token[-1] not in ".!?\"'”’)]":
                continue
            # strip close-punct; keep the word carrying the terminal mark
            word = token.rstrip("\"'”’)]")
            if word.endswith("."):
                core = word[:-1].strip("\"'“‘([").lower()
                bare = core.rstrip(".")
                if bare in _PUNKT_ABBREVIATIONS or core in _PUNKT_ABBREVIATIONS:
                    continue  # "Dr. Smith", "etc. and"
                if len(bare) == 1 and bare.isalpha():
                    continue  # initials: "J. Smith"
                if nxt.islower() or nxt.isdigit():
                    continue  # punkt ortho heuristic: next word not a starter
            sentence = paragraph[start : m.end(1)].strip()
            if sentence:
                sentences.append(sentence)
            start = end
        tail = paragraph[start:].strip()
        if tail:
            sentences.append(tail)
    return sentences


def _compute_metrics(hits_or_lcs: float, pred_len: int, target_len: int) -> Dict[str, float]:
    """Per-sample P/R/F as host floats.

    Per-sample scalars stay on the host: moving thousands of 0-d tensors to
    the device (3 values x keys x samples) would cost a transfer each. Only
    the corpus aggregation touches the device.
    """
    precision = hits_or_lcs / pred_len
    recall = hits_or_lcs / target_len
    if precision == recall == 0.0:
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    fmeasure = 2 * precision * recall / (precision + recall)
    return {"precision": precision, "recall": recall, "fmeasure": fmeasure}


_LATTICE_CELLS = 1 << 22  # int32 cells of the padded lattices built at once (16 MiB)


def _lcs_members(
    pred_sentences: Sequence[Sequence[str]], target_sentences: Sequence[Sequence[str]]
) -> List[List[List[int]]]:
    """``members[k][i]``: target-side token indices of one canonical LCS of prediction sentence ``i`` against
    target sentence ``k``.

    ROUGE-Lsum's union-LCS depends on WHICH maximal subsequence is selected,
    so the walk's tie preference (shrink the target side when both lattice
    neighbors tie) is part of the spec the reference inherited from the
    google-research rouge scorer. The ``(P+1, T+1)`` LCS lattices of all the
    sentence pairs are built at once, in the prefix-max form of
    ``M[i][j] = max(M[i-1][j], M[i][j-1], M[i-1][j-1] + eq)`` (the row update
    of ``helper._lcs_batch``): one vectorized numpy pass a prediction
    position over every pair, padded to the longest sentence on each side. A
    pair's lattice is the top-left corner of its slice: padded target
    positions lie to the right and never match, and the walk reads nothing
    past the pair's own lengths. Target sentences are taken a few at a time,
    so that about ``_LATTICE_CELLS`` padded cells are held at once.
    """
    vocab: Dict[str, int] = {}
    pids = [[vocab.setdefault(tok, len(vocab)) for tok in s] for s in pred_sentences]
    tids = [[vocab.setdefault(tok, len(vocab)) for tok in s] for s in target_sentences]
    n_p, n_t = max(map(len, pids), default=0), max(map(len, tids), default=0)
    p_ids = np.full((len(pids), n_p), -1, np.int64)
    t_ids = np.full((len(tids), n_t), -2, np.int64)
    for row, ids in zip(p_ids, pids):
        row[: len(ids)] = ids
    for row, ids in zip(t_ids, tids):
        row[: len(ids)] = ids
    per_chunk = max(1, _LATTICE_CELLS // (max(1, len(pids)) * (n_p + 1) * (n_t + 1)))
    members: List[List[List[int]]] = []
    for lo in range(0, len(tids), per_chunk):
        eq = t_ids[lo : lo + per_chunk, None, None, :] == p_ids[None, :, :, None]
        lattice = np.zeros((eq.shape[0], len(pids), n_p + 1, n_t + 1), np.int32)
        for i in range(1, n_p + 1):
            cand = lattice[:, :, i - 1].copy()
            cand[..., 1:] = np.maximum(cand[..., 1:], lattice[:, :, i - 1, :-1] + eq[:, :, i - 1])
            lattice[:, :, i] = np.maximum.accumulate(cand, axis=-1)
        for tid, per_pred in zip(tids[lo : lo + per_chunk], lattice.tolist()):
            members.append([_lcs_walk(pid, tid, rows) for pid, rows in zip(pids, per_pred)])
    return members


def _lcs_walk(pid: List[int], tid: List[int], rows: List[List[int]]) -> List[int]:
    """The target-side indices of the LCS read back from the lattice ``rows``, preferring to shrink the target side."""
    keep: List[int] = []
    i, j = len(pid), len(tid)
    while i and j:
        if pid[i - 1] == tid[j - 1]:
            keep.append(j - 1)
            i -= 1
            j -= 1
        elif rows[i - 1][j] > rows[i][j - 1]:
            i -= 1
        else:
            j -= 1
    return keep[::-1]


# corpus scoring calls this twice per sample: a precompiled pattern and a
# C-level whitespace split (str.split drops empties, so the default path
# skips the per-token filter entirely)
_NON_ALNUM = re.compile(r"[^a-z0-9]+")


def _normalize_and_tokenize_text(
    text: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Sequence[str]:
    if normalizer is None and tokenizer is None and stemmer is None:
        return _NON_ALNUM.sub(" ", text.lower()).split()
    text = normalizer(text) if callable(normalizer) else _NON_ALNUM.sub(" ", text.lower())
    tokens = tokenizer(text) if callable(tokenizer) else text.split()
    if stemmer:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if (isinstance(x, str) and len(x) > 0)]


def _create_ngrams(tokens: Sequence[str], n: int) -> Counter:
    if n == 1:
        return Counter(tokens)
    # zip of shifted views beats per-position tuple slicing by ~2x host-side
    return Counter(zip(*(tokens[k:] for k in range(n))))


def _rouge_n_score(pred: Sequence[str], target: Sequence[str], n_gram: int) -> Dict[str, float]:
    # ngram counts are exactly len - n + 1 (clamped), so the totals need no
    # Counter pass at all
    pred_len = max(0, len(pred) - n_gram + 1)
    target_len = max(0, len(target) - n_gram + 1)
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    pred_ngrams, target_ngrams = _create_ngrams(pred, n_gram), _create_ngrams(target, n_gram)
    # clipped hits = multiset intersection; summing min-counts over the
    # smaller counter beats Counter.__and__ (which allocates a third Counter)
    if len(target_ngrams) < len(pred_ngrams):
        pred_ngrams, target_ngrams = target_ngrams, pred_ngrams
    get = target_ngrams.get
    hits = 0
    for gram, count in pred_ngrams.items():
        other = get(gram, 0)
        if other:
            hits += count if count < other else other
    return _compute_metrics(hits, pred_len, target_len)


def _rouge_l_score(pred: Sequence[str], target: Sequence[str], lcs: Optional[float]) -> Dict[str, float]:
    """ROUGE-L from the pair's LCS length, computed for the whole update (``None`` only for an empty side)."""
    pred_len, target_len = len(pred), len(target)
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    return _compute_metrics(lcs, pred_len, target_len)


def _rouge_lsum_score(pred: Sequence[Sequence[str]], target: Sequence[Sequence[str]]) -> Dict[str, float]:
    pred_len = sum(map(len, pred))
    target_len = sum(map(len, target))
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}

    def _get_token_counts(sentences: Sequence[Sequence[str]]) -> Counter:
        counts: Counter = Counter()
        for sentence in sentences:
            counts.update(sentence)
        return counts

    pred_tokens_count = _get_token_counts(pred)
    target_tokens_count = _get_token_counts(target)
    hits = 0
    # every (prediction sentence, target sentence) pair's LCS in one batch, then each target sentence's union
    for tgt, per_pred in zip(target, _lcs_members(pred, target)):
        for token in (tgt[i] for i in sorted(set().union(*per_pred))):
            if pred_tokens_count[token] > 0 and target_tokens_count[token] > 0:
                hits += 1
                pred_tokens_count[token] -= 1
                target_tokens_count[token] -= 1
    return _compute_metrics(hits, pred_len, target_len)


def _rouge_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys_values: List[Union[int, str]],
    accumulate: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    device: Optional[torch.device] = None,
) -> Dict[Union[int, str], List[Dict[str, float]]]:
    """Per-sample P/R/F (host floats) for every requested ROUGE variant; multi-reference
    handling via ``accumulate='best'`` (highest first-key fmeasure) or
    ``'avg'`` (mean over references), matching ``rouge.py:373-399``.
    """
    results: Dict[Union[int, str], List[Dict[str, float]]] = {key: [] for key in rouge_keys_values}

    # tokenize each text exactly once
    pred_toks = [_normalize_and_tokenize_text(p, stemmer, normalizer, tokenizer) for p in preds]
    tgt_toks = [
        [_normalize_and_tokenize_text(t, stemmer, normalizer, tokenizer) for t in refs] for refs in target
    ]

    # every (pred, ref) ROUGE-L pair of the update in one batched DP up front
    lcs_cache: Dict[Tuple[int, int], float] = {}
    if "L" in rouge_keys_values:
        pair_index: List[Tuple[int, int]] = []
        pair_preds: List[Sequence[str]] = []
        pair_tgts: List[Sequence[str]] = []
        # zip: mismatched pred/target lengths truncate (matching the main loop)
        for i, (pred_tok, refs) in enumerate(zip(pred_toks, tgt_toks)):
            for j, tgt_tok in enumerate(refs):
                if len(pred_tok) and len(tgt_tok):
                    pair_index.append((i, j))
                    pair_preds.append(pred_tok)
                    pair_tgts.append(tgt_tok)
        if pair_preds:
            # one host read-back for the whole update, not one a pair
            lengths: np.ndarray = _lcs_tokens(pair_preds, pair_tgts, device)
            lcs_cache = {key: float(val) for key, val in zip(pair_index, lengths)}

    for i_sample, (pred_raw, target_raw) in enumerate(zip(preds, target)):
        result_inner: Dict[Union[int, str], Dict[str, float]] = {}
        result_avg: Dict[Union[int, str], List[Dict[str, float]]] = {key: [] for key in rouge_keys_values}
        list_results = []
        pred = pred_toks[i_sample]
        pred_lsum = (
            [_normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer) for s in _split_sentence(pred_raw)]
            if "Lsum" in rouge_keys_values
            else None
        )

        for j_ref, target_raw_inner in enumerate(target_raw):
            tgt = tgt_toks[i_sample][j_ref]
            tgt_lsum = (
                [_normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer) for s in _split_sentence(target_raw_inner)]
                if "Lsum" in rouge_keys_values
                else None
            )
            for rouge_key in rouge_keys_values:
                if isinstance(rouge_key, int):
                    score = _rouge_n_score(pred, tgt, rouge_key)
                elif rouge_key == "L":
                    score = _rouge_l_score(pred, tgt, lcs_cache.get((i_sample, j_ref)))
                else:  # "Lsum"
                    score = _rouge_lsum_score(pred_lsum, tgt_lsum)
                result_inner[rouge_key] = score
                result_avg[rouge_key].append(score)
            list_results.append(result_inner.copy())

        if accumulate == "best":
            key_curr = rouge_keys_values[0]
            all_fmeasure = [float(v[key_curr]["fmeasure"]) for v in list_results]
            highest_idx = int(max(range(len(all_fmeasure)), key=all_fmeasure.__getitem__))
            for rouge_key in rouge_keys_values:
                results[rouge_key].append(list_results[highest_idx][rouge_key])
        else:  # "avg": a host-float mean
            for rouge_key in rouge_keys_values:
                scores = result_avg[rouge_key]
                mean_score = {
                    stat: sum(float(s[stat]) for s in scores) / len(scores)
                    for stat in ("precision", "recall", "fmeasure")
                }
                results[rouge_key].append(mean_score)

    return results


def _rouge_score_compute(sentence_results: Dict[str, Any], device: Optional[torch.device] = None) -> Dict[str, Tensor]:
    """The mean of each score.

    Lists of host floats (the functional's route) get a float64 numpy mean,
    returned as a float32 tensor on ``device``; a concatenated float32 state
    (the class's route) gets a float32 mean on its own device.
    """
    output: Dict[str, Tensor] = {}
    for rouge_key, scores in sentence_results.items():
        if isinstance(scores, list):
            mean = float(np.mean([float(v) for v in scores])) if scores else 0.0  # lint-ok: R2, R3 host aggregation of per-sentence scores; ROUGE compute is eager by design
            output[rouge_key] = torch.tensor(mean, dtype=torch.float32, device=device)
        else:
            output[rouge_key] = scores.mean() if scores.numel() else torch.tensor(0.0, device=scores.device)
    return output


def _rouge_args(
    use_stemmer: bool, accumulate: str, rouge_keys: Union[str, Tuple[str, ...]]
) -> Tuple[Tuple[str, ...], List[Union[int, str]]]:
    """Validated ``rouge_keys`` as a tuple, and their values."""
    if use_stemmer:
        raise ValueError("`use_stemmer=True` requires nltk's PorterStemmer, which is unavailable in this build.")
    if accumulate not in ALLOWED_ACCUMULATE_VALUES:
        raise ValueError(
            f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
        )
    if not isinstance(rouge_keys, tuple):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS.keys())}")
    return rouge_keys, [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]


def _rouge_inputs(
    preds: Union[str, Sequence[str]], target: Union[str, Sequence[str], Sequence[Sequence[str]]]
) -> Tuple[Sequence[str], Sequence[Sequence[str]]]:
    """``preds`` as a list of strings and ``target`` as a list of reference lists."""
    if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
        target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [[target]]
    return preds, target


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, Tensor]:
    """ROUGE-N / ROUGE-L / ROUGE-LSum scores, on ``device`` (``cuda`` unless given).

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import rouge_score
        >>> preds = "My name is John"
        >>> target = "Is your name John"
        >>> res = rouge_score(preds, target, rouge_keys="rouge1", device="cpu")
        >>> round(float(res["rouge1_fmeasure"]), 4)
        0.75
    """
    _, rouge_keys_values = _rouge_args(use_stemmer, accumulate, rouge_keys)
    dev = _resolve_device(device)
    preds, target = _rouge_inputs(preds, target)
    sentence_results = _rouge_score_update(
        preds, target, rouge_keys_values, accumulate, None, normalizer, tokenizer, dev
    )
    output: Dict[str, List[float]] = {
        f"rouge{key}_{stat}": [] for key in rouge_keys_values for stat in ("fmeasure", "precision", "recall")
    }
    for rouge_key, scores in sentence_results.items():
        for score in scores:
            for stat in ("fmeasure", "precision", "recall"):
                output[f"rouge{rouge_key}_{stat}"].append(score[stat])
    return _rouge_score_compute(output, dev)
