"""The kernels' vmap rules: every lane of a ``torch.func.vmap`` in one call of the wrapper.

A stream pool's step (:mod:`torchmetrics_tpu_torch._streams.pool`) runs a
metric's update under ``torch.func.vmap`` with the per-lane fallback off. A
lane has no data pointer, so a wrapper that launches its kernel through
``ctypes`` cannot take one. Each wrapper of :mod:`torchmetrics_tpu_torch._kernels`
therefore sends a vmapped lane through a ``torch.library.custom_op`` of its own
(:func:`lane_op`), on either device, whose vmap rule folds the lanes into the
rows or the batch the wrapper already takes and calls it once: one launch of
the existing kernel a micro-batch on the card, the plain version on the CPU.

The activations may be batched or shared by every lane (an unbatched one is
broadcast); the weights must be unbatched, since a pool's streams share one
trunk. The channels_last helpers keep a trunk's layout as a lane: PyTorch
cannot query a memory format inside ``vmap``, but a permute, a contiguous copy
and the inverse permute give the same values in the same memory.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
from torch import Tensor

__all__ = ["cat_channels", "channels_last", "fold", "lane_op", "lanes_first", "shared_only", "unfold"]


def lanes_first(x: Optional[Tensor], dim: Optional[int], lanes: int) -> Optional[Tensor]:
    """``x``'s physical tensor with its lanes on dim 0; an unbatched ``x`` is shared by every lane (an expanded view)."""
    if x is None:
        return None
    return x.movedim(dim, 0) if dim is not None else x.expand(lanes, *x.shape)


def fold(x: Optional[Tensor], dim: Optional[int], lanes: int) -> Optional[Tensor]:
    """``(L, B, ...)`` lanes folded into one ``(L * B, ...)`` batch (a copy only where the strides need one)."""
    x = lanes_first(x, dim, lanes)
    return None if x is None else x.flatten(0, 1)


def unfold(out: Tensor, lanes: int) -> tuple:
    """The vmap rule's answer for an ``(L * B, ...)`` result: ``((L, B, ...), 0)``."""
    return out.unflatten(0, (lanes, -1)), 0


def shared_only(op: str, in_dims: Sequence[Optional[int]], names: Sequence[str], weights: Sequence[str]) -> None:
    """Raise where an argument named in ``weights`` is batched: the lanes share one trunk's weights."""
    for name, dim in zip(names, in_dims):
        if name in weights and dim is not None:
            raise ValueError(
                f"{op} under vmap: `{name}` is batched; the weights must be shared by every lane (one trunk a pool)"
            )


def lane_op(name: str, fn: Callable, rule: Callable) -> Any:
    """The custom op ``torchmetrics_tpu_torch::<name>``: ``fn`` itself outside ``vmap``, ``rule`` under it.

    ``fn`` carries the op's schema in its annotations. Call it once, at first
    use (``functools.cache``), so that importing a kernel module registers nothing.
    """
    op = torch.library.custom_op(f"torchmetrics_tpu_torch::{name}", mutates_args=())(fn)
    torch.library.register_vmap(op, rule)
    return op


def channels_last(x: Tensor) -> Tensor:
    """``x.contiguous(memory_format=torch.channels_last)``, also for a lane of ``vmap`` (no copy where it already is)."""
    return x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


def cat_channels(tensors: Sequence[Tensor]) -> Tensor:
    """``torch.cat(tensors, dim=1)`` of channels_last maps, channels_last out, also for a lane of ``vmap``.

    Under ``vmap`` a ``cat`` along the channels of lanes whose maps are
    channels_last writes a plain contiguous result, which every consumer would
    copy back; concatenating the ``(N, H, W, C)`` views writes the layout at once.
    """
    return torch.cat([t.permute(0, 2, 3, 1) for t in tensors], dim=3).permute(0, 3, 1, 2)

