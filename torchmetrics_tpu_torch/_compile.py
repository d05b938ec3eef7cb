"""The compiled update path: one CUDA graph per argument signature, replayed on every later batch.

Port of the JAX package's compiled paths (``torchmetrics_tpu/metric.py``:
auto-compile, ``jit_update``, ``scan_update``, ``precompile``). There every
repeat argument signature of ``update``/``forward`` runs one XLA executable.
Here a metric builds a *step function* from its raw update (states, the
violation-flag vector and the batch in; states and flags out) and runs it:

- on a CUDA metric, captured once per signature into a ``torch.cuda.CUDAGraph``
  after a warm-up on a side stream, on static buffers the graph owns (the
  inputs, the states, the flag vector, the update count), from one memory
  pool per metric; a replay copies the batch into the static inputs, calls
  ``graph.replay()`` on the current stream and binds the metric's state
  attributes to the graph's state buffers;
- on a CPU metric, eagerly: the same function on the same branches, the
  plain version of the graph.

Why CUDA Graphs and not ``torch.compile``: kernel B1 is launched through
``ctypes`` (``functional/classification/_confmat_kernel.py``), which Dynamo
cannot trace; Inductor would swap the port's own kernels for generated ones;
and a graph is exactly one executable per argument signature, the JAX
contract. No part of this path is ``torch.compile``.

The first call of a signature on the card is that batch's own update: the
step runs once on the graph's buffers on a side stream (the warm-up, which
makes every kernel's first launch outside the capture), and is then captured
on the same buffers, which runs nothing. Later calls replay. So each batch
reaches the states once and every kernel launch really runs; the kernel
wrappers count their launches themselves, replays included
(``_kernels/launch_counter.py``).
"""

from __future__ import annotations

import ctypes
import functools
import gc
import json
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import Tensor

__all__ = ["CapturedStep", "eligibility_verdict", "layout_key", "overlapping", "static_like", "stats", "warm_up"]

_ELIGIBILITY_PATH = Path(__file__).with_name("_eligibility.json")

_STATS = {"captured": 0, "replayed": 0, "capture_seconds": 0.0}


def stats() -> Dict[str, Any]:
    """Graphs captured and replayed in this process, and the host seconds their captures took."""
    return dict(_STATS)


@functools.lru_cache(maxsize=1)
def _verdicts() -> Dict[str, str]:
    return json.loads(_ELIGIBILITY_PATH.read_text(encoding="utf-8"))["classes"]


def eligibility_verdict(cls: type) -> Optional[str]:
    """The class's verdict, keyed by its exact qualname: ``metadata_only``, ``value_flags`` or ``host_bound``.

    The port's copy of the JAX package's ``_analysis/eligibility.json``. A
    class the copy does not name (a user subclass among them) gets None.
    """
    return _verdicts().get(f"{cls.__module__}.{cls.__qualname__}")


@functools.lru_cache(maxsize=None)
def _side_stream(device_index: int) -> "torch.cuda.Stream":
    """The device's stream for warm-ups and captures (a capture cannot use the default stream).

    Made with ``cuStreamCreate`` from ``libcuda``: the first ``torch.cuda.Stream()``
    of a process first fills PyTorch's pool of 128 streams, which took
    16-384 ms on an H100 (``chip_smoke.py --phase compiled_stream``).
    """
    libcuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p()
    with torch.cuda.device(device_index):
        torch.cuda.current_stream()  # the device's context is current
        err = libcuda.cuStreamCreate(ctypes.byref(handle), ctypes.c_uint(1))  # CU_STREAM_NON_BLOCKING
    if err != 0:
        raise RuntimeError(f"cuStreamCreate failed with CUresult {err}")
    return torch.cuda.ExternalStream(handle.value, device=torch.device("cuda", device_index))


def warm_up(step: Callable, bufs: Dict[str, Any], dyn: List[Tensor], device: torch.device) -> Any:
    """Run ``step`` on the batch ``dyn`` and the graph's buffers ``bufs`` on a side stream: the batch's own update.

    The first launch of every kernel happens here, outside the capture: its
    ``nvcc`` build, its block count and its ``cudaFuncSetAttribute``.
    Returns the step's output.
    """
    side, current = _side_stream(device.index), torch.cuda.current_stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = step(bufs, dyn)
    current.wait_stream(side)
    return out


def static_like(x: Tensor) -> Tensor:
    """An uninitialised buffer with ``x``'s shape, dtype, strides and 16-byte alignment.

    A graph reads its batch from such a copy, so its kernels see the layout
    the eager update saw: PyTorch picks vectorized loads, and with them the
    order of a reduction's sums, by strides and alignment.
    """
    offset = (x.data_ptr() % 16) // x.element_size()
    span = 1 + sum((n - 1) * s for n, s in zip(x.shape, x.stride())) if x.numel() else 0
    base = torch.empty(offset + span, dtype=x.dtype, device=x.device)
    return base.as_strided(x.shape, x.stride(), offset)


def layout_key(x: Tensor) -> tuple:
    """What of a batch tensor's layout a graph's input copy keeps: its strides and its alignment."""
    return tuple(x.stride()), x.data_ptr() % 16


def overlapping(x: Tensor) -> bool:
    """True for a tensor whose elements share memory (an expanded view): no buffer can be copied into its layout."""
    return any(s == 0 and n > 1 for n, s in zip(x.shape, x.stride()))


class CapturedStep:
    """One step captured into a CUDA graph, with its static buffers.

    ``bufs`` are the graph's state buffers (tensors, or ring buffers whose
    ``data`` and ``_cursor`` are); the step writes its results back into
    them. ``dyn`` are example inputs of the signature; the graph reads
    private buffers of their layout, into which each replay copies its
    batch. The capture runs nothing, so the buffers keep their values.
    """

    def __init__(self, step: Callable, bufs: Dict[str, Any], dyn: List[Tensor], pool: Any, device: torch.device) -> None:
        self.bufs = bufs
        self.inputs = [static_like(d) for d in dyn]
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # `torch.cuda.graph` without its `gc.collect()` and `empty_cache()`,
        # which cost tens of milliseconds a capture in a large process
        side, current = _side_stream(device.index), torch.cuda.current_stream(device)
        torch.cuda.synchronize(device)
        # the collector must not free another metric's graph during the
        # capture: destroying a graph then invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        # the step's Python repeats its warnings while it is captured: the
        # warm-up gave them for this batch, and each replay's host side does
        try:
            with torch.cuda.stream(side), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                self.graph.capture_begin(pool)
                try:
                    self.outputs = step(bufs, self.inputs)
                except BaseException:
                    try:
                        self.graph.capture_end()
                    except RuntimeError:
                        pass  # the capture was invalidated: the step's own error is the one to report
                    raise
                self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        current.wait_stream(side)
        _STATS["captured"] += 1
        _STATS["capture_seconds"] += time.perf_counter() - t0

    def replay(self, dyn: List[Tensor]) -> Any:
        for static, x in zip(self.inputs, dyn):
            static.copy_(x, non_blocking=True)
        self.graph.replay()
        _STATS["replayed"] += 1
        return self.outputs
