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
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import Tensor

__all__ = ["LaunchCounter"]


class LaunchCounter:
    """How many times one kernel was launched: ``int(counter)``; ``reset()`` sets it to 0."""

    def __init__(self) -> None:
        self._host = 0
        self._device: Dict[int, Tensor] = {}  # by device index; made at the first eager launch there

    def hit(self, device: torch.device) -> None:
        """Count one launch of the kernel on ``device``; called by the wrapper where it launches."""
        if torch.cuda.is_current_stream_capturing():
            counter = self._device.get(device.index)
            if counter is None:
                raise RuntimeError("a kernel's first launch on a device must come before a CUDA graph captures it")
            counter.add_(1)  # recorded into the graph: runs with each replay
            return
        self._host += 1
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
