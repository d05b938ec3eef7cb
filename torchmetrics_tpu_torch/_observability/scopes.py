"""Trace-attribution scopes for the PyTorch profiler and Nsight.

Port of ``torchmetrics_tpu/_observability/scopes.py``, where
:func:`named_scope` is ``jax.named_scope`` and :func:`annotation` is
``jax.profiler.TraceAnnotation``. Here:

- :func:`annotation` is a ``torch.profiler.record_function`` range, plus a
  ``torch.cuda.nvtx`` range when the work is on CUDA, around eager update
  bodies, compiled replays and sync: a host profile (``torch.profiler``,
  Nsight Systems) groups time under ``ClassName.method``. A
  ``record_function`` is a dispatcher call even when no profiler runs, so
  the hot path opens it only under ``OBS.profile_scopes``, with telemetry on
  (:func:`profiling_scopes_active`), as the JAX package gates its
  annotation.
- :func:`named_scope` names a compiled step's body while its CUDA graph is
  being captured. A JAX name scope lives in the executable's metadata and
  costs nothing after compilation; a graph's replay runs no Python at all,
  so the port opens the range only during a capture, where the body's
  Python runs once, and nowhere else (a null context then).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Any

import torch

from torchmetrics_tpu_torch._observability.state import OBS

__all__ = ["named_scope", "annotation", "profiling_scopes_active", "set_profile_scopes"]


class _Range:
    """A ``record_function`` range, with an NVTX range inside it where ``cuda``."""

    __slots__ = ("_name", "_cuda", "_record")

    def __init__(self, name: str, cuda: bool) -> None:
        self._name = name
        self._cuda = cuda
        self._record = torch.profiler.record_function(name)

    def __enter__(self) -> "_Range":
        self._record.__enter__()
        if self._cuda:
            torch.cuda.nvtx.range_push(self._name)
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._cuda:
            torch.cuda.nvtx.range_pop()
        self._record.__exit__(*exc)


def named_scope(name: str) -> Any:
    """A profiler range around a step's body while its graph is captured; a null context otherwise."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return _Range(name, cuda=True)
    return nullcontext()


def annotation(name: str, cuda: bool = False) -> Any:
    """Host profiler range (an NVTX range too where ``cuda``); callers gate on :func:`profiling_scopes_active`."""
    return _Range(name, cuda)


def profiling_scopes_active() -> bool:
    return OBS.enabled and OBS.profile_scopes


def set_profile_scopes(flag: bool) -> None:
    """Enable/disable host profiler annotations independently of counters."""
    OBS.profile_scopes = bool(flag)
