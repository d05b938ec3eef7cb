"""Launch counts of the hand-written kernels, the one place they are kept.

Every kernel wrapper of the port holds a :class:`LaunchCounter` in its
``launches`` attribute and calls :meth:`LaunchCounter.hit` right after it
launches its kernel, and nowhere else.

A launch made while a CUDA graph is being captured does not run then: the
kernel runs at each replay of the graph, with no Python running. So there
:meth:`~LaunchCounter.hit` is itself captured: one ``add_`` on a device
counter, recorded into the graph beside the kernel, which adds one at every
replay. A count is the host's eager launches plus the device counters, so
reading it waits for the card once a kernel has run there.

Each counter names the source of its kernel's library. :func:`eager_launches`
sums the eager launches by source without touching the card: the AOT cache
reads it around a step's warm-up, whose launches are all eager, to record
which libraries the step needs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch import Tensor

__all__ = ["LaunchCounter", "eager_launches"]

_COUNTERS: List["LaunchCounter"] = []


class LaunchCounter:
    """How many times one kernel was launched: ``int(counter)``; ``reset()`` sets it to 0."""

    def __init__(self, source: Optional[Path] = None) -> None:
        self.source = None if source is None else Path(source).name  # the kernel library's source under csrc/
        self._host = 0
        self._eager = 0  # every eager launch of the process: reset() leaves it
        self._device: Dict[int, Tensor] = {}  # by device index; made at the first eager launch there
        _COUNTERS.append(self)

    def hit(self, device: torch.device) -> None:
        """Count one launch of the kernel on ``device``; called by the wrapper where it launches."""
        if torch.cuda.is_current_stream_capturing():
            counter = self._device.get(device.index)
            if counter is None:
                raise RuntimeError("a kernel's first launch on a device must come before a CUDA graph captures it")
            counter.add_(1)  # recorded into the graph: runs with each replay
            return
        self._host += 1
        self._eager += 1
        if device.index not in self._device:
            self._device[device.index] = torch.zeros((), dtype=torch.int64, device=device)

    def __int__(self) -> int:
        total = self._host
        for index, c in self._device.items():
            torch.cuda.synchronize(index)  # replays on any stream have added
            total += int(c.item())
        return total

    def reset(self) -> None:
        self._host = 0
        for c in self._device.values():
            c.zero_()

    def __repr__(self) -> str:
        return f"LaunchCounter({int(self)})"


def eager_launches() -> Dict[str, int]:
    """Eager launches so far in this process, summed by library source; reads no device counter."""
    out: Dict[str, int] = {}
    for counter in _COUNTERS:
        if counter.source is not None:
            out[counter.source] = out.get(counter.source, 0) + counter._eager
    return out
