"""Distributed synchronization over ``torch.distributed``.

Parity target: reference ``torchmetrics/utilities/distributed.py:97-147``.
Tensors whose shapes differ between processes are padded to the per-dim
maximum, gathered, then trimmed back.

Every eager collective of the guarded sync flows through
:func:`process_allgather`, whose two module globals, ``_world_override`` and
``_transport``, are the seam the fault injectors patch (JAX
``utilities/distributed.py:176-300``): a simulated world, failing or stalling
transports. With neither set and a real process group, :func:`gather_all_tensors`
keeps its padded ``dist.all_gather``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import Tensor

_world_override: Optional[int] = None  # simulated world size (None: the real one)
_transport: Optional[Callable[[Any], Any]] = None  # transport override (None: the real collective)


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _allgather_leaf(x: Any, group: Optional[Any] = None) -> Any:
    """All-gather one tensor (or numpy array) over ``group``; a leading world axis, on ``x``'s side.

    NCCL gathers on ``x``'s own card when it is a CUDA tensor, else on the
    calling thread's current card; gloo gathers on the host. Returns once the
    collective has finished, not when it is enqueued: an NCCL ``all_gather``
    only orders the current stream after itself, so the stream is
    synchronized here, on the calling (watchdog) thread.
    """
    host = isinstance(x, np.ndarray)
    t = torch.as_tensor(x)
    if dist.get_backend(group) == "nccl":
        dev = t.device if t.is_cuda else torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    src = t.to(dev).contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group, async_op=True).wait()
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    stacked = torch.stack(out)
    return stacked.numpy() if host else stacked.to(t.device)


def _default_transport(x: Any, group: Optional[Any] = None) -> Any:
    """The real collective: ``dist.all_gather`` of every leaf of ``x`` over ``group`` (None: the world)."""
    return _tree_map(lambda leaf: _allgather_leaf(leaf, group), x)


def _seam_active() -> bool:
    return _transport is not None or _world_override is not None


def process_allgather(x: Any, group: Optional[Any] = None) -> Any:
    """All-gather ``x`` across the processes of ``group`` (a leading world axis on every leaf).

    A transport override takes ``x`` alone, as the JAX package's does: it
    models the whole (simulated) world.
    """
    if _transport is not None:
        return _transport(x)
    return _default_transport(x, group)


def world_size() -> int:
    """Number of participating processes (honours the simulated-world override)."""
    if _world_override is not None:
        return _world_override
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def distributed_available() -> bool:
    """True when a ``torch.distributed`` process group is initialised, or a simulated world of 2+ is active."""
    if _world_override is not None:
        return _world_override > 1
    return dist.is_available() and dist.is_initialized()


def _allgather_list(t: Tensor, group: Optional[Any]) -> List[Tensor]:
    """One all-gather of ``t``, one tensor per process on ``t``'s device.

    The only collective of :func:`gather_all_tensors`: :func:`process_allgather`
    while a transport override or a simulated world is active, else
    ``dist.all_gather`` over ``group``.
    """
    if _seam_active():
        stacked = torch.as_tensor(process_allgather(t))
        return [stacked[i].to(t.device) for i in range(stacked.shape[0])]
    out = [torch.zeros_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def gather_all_tensors(result: Tensor, group: Optional[Any] = None) -> List[Tensor]:
    """Gather ``result`` from every process of ``group``; ``[result]`` without a process group.

    Shapes are gathered first; tensors whose shapes differ are padded to the
    per-dim maximum, gathered, then trimmed back. Under a simulated world,
    ``group`` may name a subset of process indices (a sequence of ints), as
    the JAX package's does.
    """
    if not distributed_available():
        return [result]
    members: Optional[List[int]] = None
    if _seam_active():
        if isinstance(group, (list, tuple)):
            members = [int(i) for i in group]
        group = None
    elif group is None:
        group = dist.group.WORLD
    result = result.contiguous()
    local_size = torch.tensor(result.shape, dtype=torch.int64, device=result.device)
    local_sizes = _allgather_list(local_size, group)
    if members is not None:
        if len(set(members)) != len(members):
            raise ValueError(f"`group` must not contain duplicate process indices, got {members}")
        if any(i < 0 or i >= len(local_sizes) for i in members):
            raise ValueError(f"`group` indices {members} out of range for world size {len(local_sizes)}")
    max_size = torch.stack(local_sizes).max(dim=0).values if result.ndim else local_size
    if all(bool((size == max_size).all()) for size in local_sizes):
        gathered = _allgather_list(result, group)
    else:
        pad: List[int] = []
        for missing in reversed((max_size - local_size).tolist()):
            pad.extend((0, int(missing)))
        gathered = _allgather_list(F.pad(result, pad), group)
        gathered = [g[tuple(slice(int(d)) for d in size.tolist())] for g, size in zip(gathered, local_sizes)]
    return gathered if members is None else [gathered[i] for i in members]


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
