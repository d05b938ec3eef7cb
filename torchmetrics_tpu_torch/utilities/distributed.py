"""Distributed synchronization over ``torch.distributed``.

Parity target: reference ``torchmetrics/utilities/distributed.py:97-147``.
Tensors whose shapes differ between processes are padded to the per-dim
maximum, gathered, then trimmed back.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import Tensor


def distributed_available() -> bool:
    """True when a ``torch.distributed`` process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def gather_all_tensors(result: Tensor, group: Optional[Any] = None) -> List[Tensor]:
    """Gather ``result`` from every process of ``group``; ``[result]`` without a process group."""
    if not distributed_available():
        return [result]
    if group is None:
        group = dist.group.WORLD
    result = result.contiguous()
    world_size = dist.get_world_size(group)
    local_size = torch.tensor(result.shape, dtype=torch.int64, device=result.device)
    local_sizes = [torch.zeros_like(local_size) for _ in range(world_size)]
    dist.all_gather(local_sizes, local_size, group=group)
    max_size = torch.stack(local_sizes).max(dim=0).values if result.ndim else local_size
    if all(bool((size == max_size).all()) for size in local_sizes):
        gathered = [torch.zeros_like(result) for _ in range(world_size)]
        dist.all_gather(gathered, result, group=group)
        return gathered
    pad: List[int] = []
    for missing in reversed((max_size - local_size).tolist()):
        pad.extend((0, int(missing)))
    padded = F.pad(result, pad)
    gathered = [torch.zeros_like(padded) for _ in range(world_size)]
    dist.all_gather(gathered, padded, group=group)
    return [g[tuple(slice(int(d)) for d in size.tolist())] for g, size in zip(gathered, local_sizes)]


def reduce(x: Tensor, reduction: Optional[str]) -> Tensor:
    """Reduce a tensor: ``elementwise_mean``, ``sum`` or ``none`` (reference ``distributed.py:22``)."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction in ("none", None):
        return x
    raise ValueError("Reduction parameter unknown.")


def class_reduce(num: Tensor, denom: Tensor, weights: Tensor, class_reduction: str = "none") -> Tensor:
    """Per-class fraction with a ``micro``, ``macro``, ``weighted`` or no reduction (reference ``distributed.py:45``)."""
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    fraction = torch.sum(num) / torch.sum(denom) if class_reduction == "micro" else num / denom
    fraction = torch.where(torch.isnan(fraction), torch.zeros_like(fraction), fraction)
    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights.to(torch.float32) / torch.sum(weights)))
    if class_reduction in ("none", None):
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction} unknown. Choose between one of these: {valid_reduction}")
