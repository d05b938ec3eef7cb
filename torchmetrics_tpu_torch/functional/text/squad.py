"""SQuAD exact match and F1 (port of ``torchmetrics_tpu/functional/text/squad.py``).

The official SQuAD v1.1 evaluation: answers are normalized (lowercase, no
punctuation, no articles, collapsed whitespace); exact match and
bag-of-tokens F1 take the max over the ground-truth answers; the corpus score
is the percentage mean. The string work is on the host; the accumulated
(f1_sum, em_sum, count) triple is on the device. Each batch is flattened to
``(prediction, answers)`` pairs keyed by question id.
"""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import _resolve_device
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

SINGLE_PRED_TYPE = Dict[str, str]
PREDS_TYPE = Union[SINGLE_PRED_TYPE, List[SINGLE_PRED_TYPE]]
SINGLE_TARGET_TYPE = Dict[str, Any]
TARGETS_TYPE = Union[SINGLE_TARGET_TYPE, List[SINGLE_TARGET_TYPE]]

_ARTICLE_RE = re.compile(r"\b(a|an|the)\b")
_PUNCT = frozenset(string.punctuation)

_EXAMPLE_TARGET = {
    "answers": {"answer_start": [1], "text": ["This is a test text"]},
    "context": "This is a test context.",
    "id": "1",
    "question": "Is this a test?",
    "title": "train test",
}


def _normalize_text(text: str) -> str:
    """Official SQuAD answer normalization."""
    text = "".join(ch for ch in text.lower() if ch not in _PUNCT)
    return " ".join(_ARTICLE_RE.sub(" ", text).split())


def _answer_tokens(text: str) -> List[str]:
    return _normalize_text(text).split() if text else []


def _em_score(prediction: str, answer: str) -> float:
    return float(_normalize_text(prediction) == _normalize_text(answer))


def _f1_score(prediction: str, answer: str) -> float:
    """Bag-of-tokens F1; no-answer cases score 1 only on exact agreement."""
    pred_toks, ans_toks = _answer_tokens(prediction), _answer_tokens(answer)
    if not pred_toks or not ans_toks:
        return float(pred_toks == ans_toks)
    overlap = sum((Counter(pred_toks) & Counter(ans_toks)).values())
    if overlap == 0:
        return 0.0
    precision, recall = overlap / len(pred_toks), overlap / len(ans_toks)
    return 2 * precision * recall / (precision + recall)


def _flatten_inputs(preds: PREDS_TYPE, targets: TARGETS_TYPE) -> Tuple[Dict[str, str], List[Tuple[str, List[str]]]]:
    """Validate and flatten to {id: prediction} and [(id, [answer, ...]), ...].

    Targets stay a list: every target entry is scored and counted even when
    question ids repeat, as the reference's qas walk does.
    """
    pred_list = [preds] if isinstance(preds, dict) else list(preds)
    target_list = [targets] if isinstance(targets, dict) else list(targets)

    for pred in pred_list:
        if "prediction_text" not in pred or "id" not in pred:
            raise KeyError(
                "Expected keys in a single prediction are 'prediction_text' and 'id'."
                "Please make sure that 'prediction_text' maps to the answer string and 'id' maps to the key string."
            )
    for target in target_list:
        if "answers" not in target or "id" not in target:
            raise KeyError(
                "Expected keys in a single target are 'answers' and 'id'."
                "Please make sure that 'answers' maps to a `SQuAD` format dictionary and 'id' maps to the key string.\n"
                f"SQuAD Format: {_EXAMPLE_TARGET}"
            )
        if "text" not in target["answers"]:
            raise KeyError(
                "Expected keys in a 'answers' are 'text'."
                "Please make sure that 'answer' maps to a `SQuAD` format dictionary.\n"
                f"SQuAD Format: {_EXAMPLE_TARGET}"
            )

    predictions = {p["id"]: p["prediction_text"] for p in pred_list}
    answers = [(t["id"], list(t["answers"]["text"])) for t in target_list]
    return predictions, answers


def _squad_update(
    predictions: Dict[str, str], answers: List[Tuple[str, List[str]]], device: Optional[torch.device] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """(f1_sum, em_sum) float32 and the question count int32 of one flattened batch, on ``device``."""
    f1_sum = em_sum = 0.0
    for qid, truths in answers:
        if qid not in predictions:
            rank_zero_warn(f"Unanswered question {qid} will receive score 0.")
            continue
        guess = predictions[qid]
        em_sum += max(_em_score(guess, truth) for truth in truths)
        f1_sum += max(_f1_score(guess, truth) for truth in truths)
    return (
        torch.tensor(f1_sum, dtype=torch.float32, device=device),
        torch.tensor(em_sum, dtype=torch.float32, device=device),
        torch.tensor(len(answers), dtype=torch.int32, device=device),
    )


def _squad_compute(f1_sum: Tensor, em_sum: Tensor, total: Tensor) -> Dict[str, Tensor]:
    return {"exact_match": 100.0 * em_sum / total, "f1": 100.0 * f1_sum / total}


def squad(
    preds: PREDS_TYPE, target: TARGETS_TYPE, device: Optional[Union[str, torch.device]] = None
) -> Dict[str, Tensor]:
    """SQuAD exact-match and F1 scores, on ``device`` (``cuda`` unless given).

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import squad
        >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
        >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
        >>> {k: float(v) for k, v in squad(preds, target, device="cpu").items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """
    predictions, answers = _flatten_inputs(preds, target)
    return _squad_compute(*_squad_update(predictions, answers, _resolve_device(device)))
