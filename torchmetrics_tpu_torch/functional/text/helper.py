"""Shared text-metric machinery (port of ``torchmetrics_tpu/functional/text/helper.py``).

Tokenizing is host work. The O(L1·L2) dynamic programs of the edit-distance
family and ROUGE-L run either on the host (one small pair at a time, or one
numpy pass a row) or as batched PyTorch ops on the metric's device: one loop
step a prediction position, with the whole batch in every step. A row update
of the Levenshtein table is

    candidate[j] = min(row[j] + 1, row[j-1] + c·[a_i != t[j-1]])
    new_row[j]   = min_{k<=j} candidate[k] + (j - k)

and the second line is ``cummin(candidate - j) + j``; the LCS row is a
``cummax``. Min, max, add and subtract of small integers in float32 are
exact, so both routes give the JAX package's distances and lengths exactly.
The loop stops at the batch's longest prediction: positions past a row's own
length pass the row through.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import _resolve_device

_PAD_ID = -1

# At most this many DP cells, the host DP runs; above it the batched device loop does. Set from
# `chip_smoke.py`'s `edit_dispatch` phase on an NVIDIA H100 80GB HBM3, 700.00 W: the host DP was faster
# up to 27,130 cells (4 character-level pairs), the device loop from 150,784 cells (256 word-level
# pairs) on, and 64,000 is about their geometric mean; a second run put 9 of its 10 cases on their
# faster route (the tenth a 3% tie). The device loop costs ~0.17 ms a step (about a dozen launches), a
# step a prediction position; the host DP ~0.25 us a cell.
_HOST_DISPATCH_MAX_CELLS = 64_000


def _validate_text_inputs(
    preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]
) -> Tuple[List[str], List[str]]:
    """Normalize ``(preds, target)`` to equal-length lists of strings."""
    preds_list = [preds] if isinstance(preds, str) else list(preds)
    target_list = [target] if isinstance(target, str) else list(target)
    if len(preds_list) != len(target_list):
        raise ValueError(
            f"Arguments `preds` and `target` must have the same length, but got {len(preds_list)} and {len(target_list)}"
        )
    return preds_list, target_list


def _encode_batch(
    preds_tokens: Sequence[Sequence[str]], target_tokens: Sequence[Sequence[str]]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Token sequences as padded int32 id matrices (pad ``-1``) and length vectors.

    One vocabulary a batch: the DP consumes equality only. Widths are the
    longest sequence on each side; nothing is rounded up.
    """
    vocab: dict = {}

    def ids(tokens: Sequence[str]) -> List[int]:
        return [vocab.setdefault(tok, len(vocab)) for tok in tokens]

    pred_ids = [ids(t) for t in preds_tokens]
    tgt_ids = [ids(t) for t in target_tokens]

    def pad(seqs: List[List[int]]) -> Tuple[np.ndarray, np.ndarray]:
        lengths = np.asarray([len(s) for s in seqs], dtype=np.int32)
        out = np.full((len(seqs), int(lengths.max(initial=0))), _PAD_ID, dtype=np.int32)
        for i, s in enumerate(seqs):
            out[i, : len(s)] = s
        return out, lengths

    return (*pad(pred_ids), *pad(tgt_ids))


def _on(device: torch.device, *arrays: np.ndarray) -> List[Tensor]:
    return [torch.as_tensor(a, device=device) for a in arrays]


def _levenshtein_batch(
    pred_ids: Tensor, pred_len: Tensor, tgt_ids: Tensor, tgt_len: Tensor, steps: int, substitution_cost: int = 1
) -> Tensor:
    """Batched Levenshtein distances, ``(B,)`` float32 on the inputs' device.

    ``steps`` is the longest prediction (known on the host): the loop runs
    that many row updates over the ``(B, T+1)`` table row. Padded target
    positions lie right of ``tgt_len`` and never reach ``row[tgt_len]``.
    """
    n_batch, n_t = tgt_ids.shape
    offsets = torch.arange(n_t + 1, dtype=torch.float32, device=tgt_ids.device)
    row = offsets.expand(n_batch, n_t + 1)
    cost = float(substitution_cost)
    for i in range(steps):
        sub_cost = torch.where(tgt_ids == pred_ids[:, i : i + 1], 0.0, cost)
        candidate = torch.cat([row[:, :1] + 1.0, torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + sub_cost)], dim=1)
        new_row = torch.cummin(candidate - offsets, dim=1).values + offsets
        row = torch.where((pred_len > i)[:, None], new_row, row)
    return row.gather(1, tgt_len.long()[:, None])[:, 0]


def _lcs_batch(pred_ids: Tensor, pred_len: Tensor, tgt_ids: Tensor, tgt_len: Tensor, steps: int) -> Tensor:
    """Batched longest-common-subsequence lengths, ``(B,)`` float32, one ``cummax`` a row update."""
    n_batch, n_t = tgt_ids.shape
    valid_t = torch.arange(n_t, device=tgt_ids.device)[None, :] < tgt_len[:, None]
    row = torch.zeros((n_batch, n_t + 1), dtype=torch.float32, device=tgt_ids.device)
    for i in range(steps):
        eq = ((tgt_ids == pred_ids[:, i : i + 1]) & valid_t).to(torch.float32)
        candidate = torch.cat([row[:, :1], torch.maximum(row[:, 1:], row[:, :-1] + eq)], dim=1)
        row = torch.where((pred_len > i)[:, None], torch.cummax(candidate, dim=1).values, row)
    return row.gather(1, tgt_len.long()[:, None])[:, 0]


def _edit_distance_tokens(
    preds_tokens: Sequence[Sequence[str]],
    target_tokens: Sequence[Sequence[str]],
    substitution_cost: int = 1,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Per-sample Levenshtein distances of tokenized pairs, ``(B,)`` float32 on ``device``.

    The route is chosen by size alone: at most ``_HOST_DISPATCH_MAX_CELLS``
    cells (Σ len(p)·len(t)) run the host DP, more run the batched device loop.
    """
    dev = _resolve_device(device)
    if not preds_tokens:
        return torch.zeros((0,), dtype=torch.float32, device=dev)
    total_cells = sum(len(p) * len(t) for p, t in zip(preds_tokens, target_tokens))
    if total_cells <= _HOST_DISPATCH_MAX_CELLS:
        distances = [float(_edit_distance_host(p, t, substitution_cost)) for p, t in zip(preds_tokens, target_tokens)]
        return torch.tensor(distances, dtype=torch.float32, device=dev)
    p_ids, p_len, t_ids, t_len = _encode_batch(preds_tokens, target_tokens)
    return _levenshtein_batch(*_on(dev, p_ids, p_len, t_ids, t_len), int(p_len.max()), substitution_cost)


def _lcs_host_batch(p_ids: np.ndarray, p_len: np.ndarray, t_ids: np.ndarray, t_len: np.ndarray) -> np.ndarray:
    """Numpy form of :func:`_lcs_batch`: one pass a prediction position, all pairs at once."""
    n_batch, n_p = p_ids.shape
    n_t = t_ids.shape[1]
    valid_t = np.arange(n_t)[None, :] < t_len[:, None]
    row = np.zeros((n_batch, n_t + 1), dtype=np.float32)
    for i in range(n_p):
        eq = ((t_ids == p_ids[:, i : i + 1]) & valid_t).astype(np.float32)
        candidate = np.concatenate([row[:, :1], np.maximum(row[:, 1:], row[:, :-1] + eq)], axis=1)
        np.maximum.accumulate(candidate, axis=1, out=candidate)
        row = np.where((i < p_len)[:, None], candidate, row)
    return row[np.arange(n_batch), t_len]


def _lcs_tokens(
    preds_tokens: Sequence[Sequence[str]],
    target_tokens: Sequence[Sequence[str]],
    device: Optional[Union[str, torch.device]] = None,
) -> np.ndarray:
    """Per-sample LCS lengths of tokenized pairs, float32 on the host (callers fold them there).

    Dispatched like :func:`_edit_distance_tokens`, on the padded cell count
    B·P·T: the host route is the numpy DP; the device route runs
    :func:`_lcs_batch` on ``device`` and reads all lengths back at once.
    """
    if not preds_tokens:
        return np.zeros((0,), dtype=np.float32)
    p_ids, p_len, t_ids, t_len = _encode_batch(preds_tokens, target_tokens)
    if p_ids.shape[0] * p_ids.shape[1] * t_ids.shape[1] <= _HOST_DISPATCH_MAX_CELLS:
        return _lcs_host_batch(p_ids, p_len, t_ids, t_len)
    dev = _resolve_device(device)
    return _lcs_batch(*_on(dev, p_ids, p_len, t_ids, t_len), int(p_len.max())).cpu().numpy()


def _edit_distance_host(
    prediction_tokens: Sequence[str], reference_tokens: Sequence[str], substitution_cost: int = 1
) -> int:
    """Single-pair host Levenshtein (small inputs, and host-only algorithms)."""
    prev = list(range(len(reference_tokens) + 1))
    for i, p_tok in enumerate(prediction_tokens, start=1):
        cur = [i] + [0] * len(reference_tokens)
        for j, r_tok in enumerate(reference_tokens, start=1):
            cur[j] = min(
                prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (substitution_cost if p_tok != r_tok else 0)
            )
        prev = cur
    return prev[-1]
