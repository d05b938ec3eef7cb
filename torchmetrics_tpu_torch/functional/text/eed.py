"""Extended edit distance (port of ``torchmetrics_tpu/functional/text/eed.py``).

The EED dynamic program (Stanchev, Wang, Ney, WMT 2019) runs as batched
PyTorch ops on the device, one loop step a reference character with every
pair of the batch in it: the deletion chain ``next_row[i-1] + deletion`` is
``cummin(candidate - i·deletion) + i·deletion``, the visit counter adds a
one-hot of each step's first minimum, and the jump at a space is a
row-wide minimum. Min, add and subtract are the JAX package's, in its order,
so a row's values equal its; the tie rule (the first index within 1e-5 of the
row minimum) is kept exactly.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import _resolve_device


def _eed_batch(
    hyp_ids: Tensor,
    hyp_len: Tensor,
    ref_ids: Tensor,
    ref_len: Tensor,
    ref_is_space: Tensor,
    steps: int,
    alpha: float,
    rho: float,
    deletion: float,
    insertion: float,
) -> Tensor:
    """Batched EED scores, ``(B,)`` float32. ``*_ids`` are padded character codes; ``steps`` the longest reference."""
    n_batch, n_h = hyp_ids.shape
    dev = hyp_ids.device
    pos = torch.arange(n_h + 1, device=dev)
    del_steps = pos.to(torch.float32) * deletion
    valid = pos[None, :] <= hyp_len[:, None]  # CDER grid columns beyond the hypothesis end are dead
    row = torch.where(pos == 0, 0.0, 1.0).expand(n_batch, n_h + 1)
    visits = torch.where(valid, -1.0, 0.0)
    inf = torch.tensor(float("inf"), device=dev)
    for i in range(steps):
        sub = torch.where(hyp_ids == ref_ids[:, i : i + 1], 0.0, 1.0)
        candidate = torch.cat([row[:, :1] + 1.0, torch.minimum(row[:, :-1] + sub, row[:, 1:] + insertion)], dim=1)
        next_row = torch.cummin(candidate - del_steps, dim=1).values + del_steps
        masked_next = torch.where(valid, next_row, inf)
        # the first index within 1e-5 of the row minimum, as the JAX package picks it
        min_value = masked_next.min(dim=1, keepdim=True).values
        min_index = (masked_next <= min_value + 1e-5).to(torch.uint8).argmax(dim=1, keepdim=True)
        new_visits = visits + (valid & (pos[None, :] == min_index)).to(torch.float32)
        # long jump at whitespace: teleport from the cheapest cell
        next_row = torch.where(ref_is_space[:, i : i + 1], torch.minimum(next_row, alpha + min_value), next_row)
        active = (ref_len > i)[:, None]
        row = torch.where(active, next_row, row)
        visits = torch.where(active, new_visits, visits)
    visit_cost = torch.where(valid, torch.where(visits >= 0, visits, 1.0), 0.0)
    coverage = rho * visit_cost.sum(dim=1)
    score = (row.gather(1, hyp_len.long()[:, None])[:, 0] + coverage) / (ref_len.to(torch.float32) + coverage)
    return torch.clamp(score, max=1.0)


def _eed_pairs(
    hyps: Sequence[str],
    refs: Sequence[str],
    alpha: float,
    rho: float,
    deletion: float,
    insertion: float,
    device: torch.device,
) -> Tensor:
    hyp_len = np.asarray([len(h) for h in hyps], dtype=np.int32)
    ref_len = np.asarray([len(r) for r in refs], dtype=np.int32)
    hyp_ids = np.zeros((len(hyps), int(hyp_len.max(initial=0))), dtype=np.int32)
    ref_ids = np.full((len(refs), int(ref_len.max(initial=0))), -1, dtype=np.int32)
    for i, h in enumerate(hyps):
        hyp_ids[i, : len(h)] = [ord(c) for c in h]
    for i, r in enumerate(refs):
        ref_ids[i, : len(r)] = [ord(c) for c in r]
    on_dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    ref_ids_dev = on_dev(ref_ids)
    return _eed_batch(
        on_dev(hyp_ids), on_dev(hyp_len), ref_ids_dev, on_dev(ref_len), ref_ids_dev == ord(" "),
        int(ref_len.max(initial=0)), alpha, rho, deletion, insertion,
    )


def _eed_function(
    hyp: str,
    ref: str,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    device: Optional[Union[str, torch.device]] = None,
) -> float:
    """Single-pair EED score."""
    return float(_eed_pairs([hyp], [ref], alpha, rho, deletion, insertion, _resolve_device(device))[0])


def _preprocess_en(sentence: str) -> str:
    """English preprocessing per the original EED tooling: punctuation split,
    whitespace collapse, number/abbreviation re-joins, sentinel spaces."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()
    for pattern, replacement in ((".", " ."), ("!", " !"), ("?", " ?"), (",", " ,")):
        sentence = sentence.replace(pattern, replacement)
    rules_re = [
        (r"\s+", r" "),
        (r"(\d) ([.,]) (\d)", r"\1\2\3"),
        (r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .", r"\1."),
    ]
    for pattern, replacement in rules_re:
        sentence = re.sub(pattern, replacement, sentence)
    for pattern, replacement in (("e . g .", "e.g."), ("i . e .", "i.e."), ("U . S .", "U.S.")):
        sentence = sentence.replace(pattern, replacement)
    return " " + sentence + " "


def _preprocess_ja(sentence: str) -> str:
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    return unicodedata.normalize("NFKC", sentence.rstrip())


def _eed_compute(sentence_level_scores: Tensor) -> Tensor:
    if sentence_level_scores.numel() == 0:
        return torch.tensor(0.0, device=sentence_level_scores.device)
    return sentence_level_scores.sum() / sentence_level_scores.numel()


def _preprocess_sentences(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str,
) -> Tuple[Sequence[str], Sequence[Sequence[str]]]:
    preds = [preds] if isinstance(preds, str) else list(preds)
    target = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    if language == "en":
        fn = _preprocess_en
    elif language == "ja":
        fn = _preprocess_ja
    else:
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
    return [fn(p) for p in preds], [[fn(r) for r in refs] for refs in target]


def _eed_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Each prediction's best (lowest) EED over its references, ``(N,)`` float32 on ``device``.

    Every (prediction, reference) pair goes into one batched DP; the minimum
    over each prediction's references is taken on the device.
    """
    dev = _resolve_device(device)
    preds, target = _preprocess_sentences(preds, target, language)
    if 0 in (len(preds), len(target[0]) if target else 0):
        return torch.zeros((0,), dtype=torch.float32, device=dev)
    pair_hyps = [hyp for hyp, refs in zip(preds, target) for _ in refs]
    pair_refs = [ref for refs in target for ref in refs]
    owners = torch.as_tensor([i for i, refs in enumerate(target) for _ in refs], device=dev)
    scores = _eed_pairs(pair_hyps, pair_refs, alpha, rho, deletion, insertion, dev)
    best = torch.full((len(preds),), float("inf"), dtype=torch.float32, device=dev)
    return best.scatter_reduce_(0, owners, scores, reduce="amin")


def _eed_args_validation(alpha: float, rho: float, deletion: float, insertion: float) -> None:
    for name, param in (("alpha", alpha), ("rho", rho), ("deletion", deletion), ("insertion", insertion)):
        if not isinstance(param, float) or param < 0:
            raise ValueError(f"Expected argument {name} to be a non-negative float but got {param}")


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Extended edit distance: Levenshtein plus a jump and a coverage cost, on ``device`` (``cuda`` unless given).

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import extended_edit_distance
        >>> preds = ["this is the prediction", "here is an other sample"]
        >>> target = ["this is the reference", "here is another one"]
        >>> round(float(extended_edit_distance(preds=preds, target=target, device="cpu")), 4)
        0.3078
    """
    _eed_args_validation(alpha, rho, deletion, insertion)
    sentence_level_scores = _eed_update(preds, target, language, alpha, rho, deletion, insertion, device)
    average = _eed_compute(sentence_level_scores)
    if return_sentence_level_score:
        return average, sentence_level_scores
    return average
