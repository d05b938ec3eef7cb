"""Data-movement helpers: concatenation, one-hot, top-k.

Parity target: reference ``torchmetrics/utilities/data.py:28-170``.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.ringbuffer import RingBuffer


def dim_zero_cat(x: Union[Tensor, List[Tensor], RingBuffer]) -> Tensor:
    """Concatenate a (possibly list- or ring-buffer-valued) state along dim 0."""
    if isinstance(x, Tensor):
        return x
    if isinstance(x, RingBuffer):
        if not len(x):
            raise ValueError("No samples to concatenate")
        return x.values().clone()
    if not x:  # empty list state
        raise ValueError("No samples to concatenate")
    return torch.cat([torch.atleast_1d(el) for el in x], dim=0)


def dim_zero_sum(x: Tensor) -> Tensor:
    """The sum over the leading axis; an int32 or int64 sum keeps its dtype, as the JAX package's ``jnp.sum`` does.

    ``torch.sum`` alone widens int32 to int64, so an int32 state (a confusion
    matrix) synced over processes came out int64 where one process's is int32.
    """
    return torch.sum(x, dim=0, dtype=x.dtype if x.dtype in (torch.int32, torch.int64) else None)


def dim_zero_mean(x: Tensor) -> Tensor:
    return torch.mean(x if torch.is_floating_point(x) else x.to(torch.float32), dim=0)


def dim_zero_max(x: Tensor) -> Tensor:
    return torch.max(x, dim=0).values


def dim_zero_min(x: Tensor) -> Tensor:
    return torch.min(x, dim=0).values


def _one_hot(labels: Tensor, num_classes: int, dtype: torch.dtype = torch.int32) -> Tensor:
    """One-hot along a new last axis; a label outside ``[0, num_classes)`` gives a zero row.

    Mirrors ``jax.nn.one_hot``. ``torch.nn.functional.one_hot`` raises on such
    a label instead, so it is not used here.
    """
    classes = torch.arange(num_classes, device=labels.device, dtype=labels.dtype)
    return (labels.unsqueeze(-1) == classes).to(dtype)


def to_onehot(label_tensor: Tensor, num_classes: Optional[int] = None) -> Tensor:
    """Convert ``(N, ...)`` integer labels into one-hot ``(N, C, ...)`` (reference ``data.py:79-120``)."""
    if num_classes is None:
        num_classes = int(label_tensor.max()) + 1
    return torch.movedim(_one_hot(label_tensor, num_classes), -1, 1)


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """Int32 mask of the top-k entries along ``dim`` (reference ``data.py:123-149``).

    ``torch.topk`` and ``jax.lax.top_k`` may break ties between equal scores
    differently, so the two packages agree on the mask only where the k-th
    and (k+1)-th scores differ. ``argmax`` (``topk == 1``) takes the first
    maximum in both.
    """
    mask = torch.zeros(prob_tensor.shape, dtype=torch.int32, device=prob_tensor.device)
    if topk == 1:  # cheap argmax path
        idx = torch.argmax(prob_tensor, dim=dim, keepdim=True)
    else:
        idx = torch.topk(prob_tensor, topk, dim=dim).indices
    return mask.scatter_(dim, idx, 1)


def _bucket_size(n: int, minimum: int = 8) -> int:
    """Round ``n`` up to the next power of two (>= ``minimum``).

    The JAX package pads dynamic extents to these buckets to bound its
    compiled shapes; the port pads the same way so both packages evaluate
    identically shaped, identically padded arrays.
    """
    b = minimum
    while b < n:
        b *= 2
    return b


def to_categorical(x: Tensor, argmax_dim: int = 1) -> Tensor:
    """Probabilities to class indices by argmax along ``argmax_dim`` (reference ``data.py:152-170``)."""
    return torch.argmax(x, dim=argmax_dim)
