"""Perplexity (port of ``torchmetrics_tpu/functional/text/perplexity.py``).

Device math: the float32 log-softmax of each position's logits, the target's
entry gathered, and one masked sum. ``ignore_index`` is a mask, not a
boolean filter. The log-softmax runs over row chunks of at most
``_CHUNK_BYTES`` of float32 output, so a bf16 batch at a GPT-2 vocabulary is
never upcast whole; each row's value does not depend on the chunking, and the
gathered values are summed once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

_CHUNK_BYTES = 1 << 28


def _check_shape_and_type_consistency(preds: Tensor, target: Tensor) -> None:
    if preds.ndim != 3:
        raise ValueError(
            "Input tensor `preds` is expected to have 3 dimensions, [batch_size, seq_len, vocab_size],"
            f" but got {preds.ndim}."
        )
    if target.ndim != 2:
        raise ValueError(
            f"Input tensor `target` is expected to have 2 dimensions, [batch_size, seq_len], but got {target.ndim}."
        )
    if preds.shape[:2] != target.shape:
        raise ValueError(
            "Input tensors `preds` and `target` are expected to have equaling first two dimensions,"
            f" [batch_size, seq_len], but got {preds.shape[:2]} and {target.shape}."
        )
    if not torch.is_floating_point(preds):
        raise TypeError(f"Input tensor `preds` is expected to be of floating point type but got {preds.dtype}.")
    if torch.is_floating_point(target) or torch.is_complex(target) or target.dtype == torch.bool:
        raise TypeError(f"Input tensor `target` is expected to be of integer type but got {target.dtype}.")


def _perplexity_update(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """(negative sum of the targets' log-probabilities, count of counted positions)."""
    _check_shape_and_type_consistency(preds, target)
    logits = preds.reshape(-1, preds.shape[-1])
    target = target.reshape(-1)
    mask = target != ignore_index if ignore_index is not None else torch.ones_like(target, dtype=torch.bool)
    # as the JAX package's `take_along_axis`: a target in [-V, 0) counts from the end, one outside
    # [-V, V) gives NaN; the gather index is clamped, so no target raises and nothing is read back
    vocab = logits.shape[1]
    safe_target = torch.where(mask, target, 0)
    safe_target = torch.where(safe_target < 0, safe_target + vocab, safe_target)
    out_of_range = mask & ((safe_target < 0) | (safe_target >= vocab))
    safe_target = safe_target.clamp(0, vocab - 1)[:, None]
    rows = max(1, _CHUNK_BYTES // (4 * vocab))
    picked = torch.empty(logits.shape[0], dtype=torch.float32, device=logits.device)
    for start in range(0, logits.shape[0], rows):
        log_probs = torch.log_softmax(logits[start : start + rows], dim=-1, dtype=torch.float32)
        picked[start : start + rows] = log_probs.gather(1, safe_target[start : start + rows])[:, 0]
    picked = torch.where(out_of_range, float("nan"), picked)
    return -torch.where(mask, picked, 0.0).sum(), mask.sum(dtype=torch.int32)


def _perplexity_compute(total: Tensor, count: Tensor) -> Tensor:
    return torch.exp(total / count)


def perplexity(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tensor:
    """Perplexity of a language model's predictions, on the inputs' device.

    Example:
        >>> import torch
        >>> probs = torch.tensor([0.1, 0.2, 0.3, 0.25, 0.15])
        >>> preds = torch.log(probs.repeat(2, 8, 1))  # log-probabilities
        >>> target = torch.tensor([0, 1, 2, 3, 4, 0, 1, 2]).repeat(2, 1)
        >>> round(float(perplexity(preds, target, ignore_index=-100)), 3)
        5.416
    """
    total, count = _perplexity_update(preds, target, ignore_index)
    return _perplexity_compute(total, count)
