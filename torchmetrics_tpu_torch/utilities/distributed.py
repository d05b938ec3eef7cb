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
