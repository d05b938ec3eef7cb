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

A trunk's forward (InceptionV3, LPIPS, the BERT encoder and MLM head, the
CLIP towers) is compiled on its own as well, as the JAX package compiles
each trunk with ``jax.jit`` whether or not the metric's update is compiled:
:class:`CapturedForward` captures a trunk's input signature with the same
:class:`CapturedStep` when it sees it a second time, within a bound on the
trunk's pool, and runs the trunk inline where a metric's graph will hold it
(graphs do not nest).

The first call of a signature on the card is that batch's own update: the
step runs once on the graph's buffers on a side stream (the warm-up, which
makes every kernel's first launch outside the capture), and is then captured
on the same buffers, which runs nothing. Later calls replay. So each batch
reaches the states once and every kernel launch really runs; the kernel
wrappers count their launches themselves, replays included
(``_kernels/launch_counter.py``).

Telemetry (``_observability``) is recorded on the host side of a graph, never
inside one: a replay runs no Python. With profiling on, a replay is timed
on the card by a CUDA event pair (:meth:`CapturedStep.replay`), and a
step's flops and bytes are counted during its warm-up. A trunk's capture
reports a ``trunk_forward`` compile event, its seconds and its cost.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import hashlib
import json
import threading
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch import Tensor, nn

from torchmetrics_tpu_torch._observability import costs as _obs_costs
from torchmetrics_tpu_torch._observability.profiling import LEDGER as _PROF_LEDGER
from torchmetrics_tpu_torch._observability.state import OBS as _OBS
from torchmetrics_tpu_torch._observability.telemetry import telemetry_for as _telemetry_for
from torchmetrics_tpu_torch.utilities.checks import _vmapped

__all__ = [
    "CapturedForward",
    "CapturedStep",
    "device_constant",
    "eligibility_verdict",
    "layout_key",
    "overlapping",
    "pool_bytes",
    "static_like",
    "stats",
    "trunks_inline",
    "warm_up",
]

_ELIGIBILITY_PATH = Path(__file__).with_name("_eligibility.json")

# a metric's steps under the plain keys, the trunks' forwards under `forward_`
_STATS = {
    "captured": 0, "replayed": 0, "capture_seconds": 0.0,
    "forward_captured": 0, "forward_replayed": 0, "forward_capture_seconds": 0.0,
}


def stats() -> Dict[str, Any]:
    """Graphs captured and replayed in this process, and the host seconds their captures took.

    ``captured``/``replayed``/``capture_seconds`` count the metrics' update
    and forward steps; the ``forward_`` keys count the trunks' forwards
    (:class:`CapturedForward`).
    """
    return dict(_STATS)


# on this thread: the constant stores of the warm-ups and captures running, innermost last (`stack`),
# and how many `trunks_inline` blocks are open (`inline`)
_GRAPH_WORK = threading.local()


@contextlib.contextmanager
def _graph_work(constants: Dict[tuple, Tensor]) -> Iterator[None]:
    """Mark a warm-up or a capture; the host data it copies to the card is kept in ``constants``."""
    stack = _GRAPH_WORK.__dict__.setdefault("stack", [])
    stack.append(constants)
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def trunks_inline(on: bool = True) -> Iterator[None]:
    """Where ``on``, the trunks' forwards in the block run plainly: no graph of their own is captured or replayed.

    A metric wraps the eager update of a signature it may capture on its next
    call in this: its graph will hold the trunk, so a graph of the trunk's
    own beside it would only hold a second pool.
    """
    _GRAPH_WORK.inline = getattr(_GRAPH_WORK, "inline", 0) + on
    try:
        yield
    finally:
        _GRAPH_WORK.inline -= on


def device_constant(value: Any, device: torch.device, dtype: Optional[torch.dtype] = None) -> Tensor:
    """``torch.as_tensor(value, dtype=dtype, device=device)`` for host data a step reads (filter taps, token ids).

    A graph cannot copy from the host while it is captured, and its replays
    read what the capture saw: the JAX package's ``jit`` bakes such data into
    its executable as constants. So on the card, inside a warm-up or a
    capture, the copy is made once for each content (value, dtype, device)
    and kept in the graph's own store (``CapturedStep.constants``), which
    lives as long as the graph: the warm-up that precedes every capture
    makes it, the capture finds it. Elsewhere this is ``torch.as_tensor``.
    """
    device = torch.device(device)
    stack = getattr(_GRAPH_WORK, "stack", None)
    if device.type != "cuda" or not stack:
        return torch.as_tensor(value, dtype=dtype, device=device)
    host = np.ascontiguousarray(value.detach().cpu().numpy() if isinstance(value, Tensor) else np.asarray(value))
    key = (host.tobytes(), host.shape, host.dtype.str, dtype, device)
    for store in reversed(stack):
        if key in store:
            return store[key]
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("device_constant: host data first met during a capture; the warm-up before it made no copy")
    out = stack[-1][key] = torch.as_tensor(host, dtype=dtype, device=device)
    return out


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


def warm_up(step: Callable, bufs: Dict[str, Any], dyn: List[Tensor], device: torch.device, constants: Dict) -> Any:
    """Run ``step`` on the batch ``dyn`` and the graph's buffers ``bufs`` on a side stream: the batch's own update.

    The first launch of every kernel happens here, outside the capture: its
    ``nvcc`` build, its block count and its ``cudaFuncSetAttribute``; so
    does the copy of the host data the step reads (into ``constants``, the
    graph's store). Returns the step's output.
    """
    side, current = _side_stream(device.index), torch.cuda.current_stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side), _graph_work(constants):
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


def pool_bytes(pool: Any) -> int:
    """Bytes the card holds in a graph memory pool (a metric's ``_graph_pool``, a trunk's ``captured.pool``).

    The pool's segments in the allocator's snapshot; 0 for no pool.
    """
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


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
    ``constants`` holds the host data the graph reads (:func:`device_constant`),
    as its warm-up copied it. ``stat`` prefixes the :func:`stats` keys it
    counts under. ``seam`` and ``owner`` name the ledger bucket its replays
    are timed into while profiling is on (None: not profiled).
    """

    seam: Optional[str] = None
    owner: str = ""

    def __init__(
        self, step: Callable, bufs: Dict[str, Any], dyn: List[Tensor], pool: Any, device: torch.device,
        constants: Dict, stat: str = "",
    ) -> None:
        self.stat = stat
        self.bufs = bufs
        self.constants = constants
        self.inputs = [static_like(d) for d in dyn]
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # `torch.cuda.graph` without its `gc.collect()` and `empty_cache()`,
        # which cost tens of milliseconds a capture in a large process
        side, current = _side_stream(device.index), torch.cuda.current_stream(device)
        torch.cuda.synchronize(device)
        # a capture cannot free the allocator's idle cached blocks (the warm-up's, a trunk's gigabytes of
        # activations) when its pool runs short: where they exceed what the card has free, give them back now
        if torch.cuda.mem_get_info(device)[0] < torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device):
            torch.cuda.empty_cache()
        # the collector must not free another metric's graph during the
        # capture: destroying a graph then invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        # the step's Python repeats its warnings while it is captured: the
        # warm-up gave them for this batch, and each replay's host side does
        try:
            with torch.cuda.stream(side), warnings.catch_warnings(), _graph_work(constants):
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
        _STATS[stat + "captured"] += 1
        _STATS[stat + "capture_seconds"] += time.perf_counter() - t0

    def replay(self, dyn: List[Tensor], then: Optional[Callable[[float], None]] = None) -> Any:
        """Copy the batch ``dyn`` into the graph's inputs and replay; with profiling on, timed on the card.

        ``then`` (profiling on) gets the replay's seconds once the ledger
        resolves its event pair.
        """
        if _OBS.profiling and self.seam is not None:
            # timed on the card; the ledger resolves the pair on a later step or when it is read
            start, end = _PROF_LEDGER.event_pair()
            start.record()
            self._replay(dyn)
            end.record()
            _PROF_LEDGER.record_event_pair(self.seam, self.owner, start, end, then)
        else:
            self._replay(dyn)
        _STATS[self.stat + "replayed"] += 1
        return self.outputs

    def _replay(self, dyn: List[Tensor]) -> None:
        for static, x in zip(self.inputs, dyn):
            static.copy_(x, non_blocking=True)
        self.graph.replay()


def _pool_bound(device: torch.device) -> int:
    """The most a trunk's graphs may hold: an eighth of the card's memory."""
    return torch.cuda.get_device_properties(device).total_memory // 8


def _numerics() -> tuple:
    """The settings outside a trunk that choose its kernels' arithmetic; a capture bakes them into its graph."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    return (
        torch.is_autocast_enabled("cuda"), torch.get_autocast_dtype("cuda"),
        matmul.allow_tf32, matmul.allow_fp16_reduced_precision_reduction, matmul.allow_bf16_reduced_precision_reduction,
        cudnn.enabled, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
    )


class CapturedForward(nn.Module):
    """A trunk's forward as one CUDA graph per input signature (the JAX package's ``jax.jit`` of the trunk).

    ``captured(fn, *inputs, statics=...)`` runs ``fn(*inputs)``, a tensor. The
    signature is the inputs' shapes, dtypes, devices and layouts, the
    ``statics`` that choose what ``fn`` computes (a feature tap, a tower, a
    layer count), as the values a ``jit`` closes over, and the autocast, TF32
    and cuDNN settings of the call (:func:`_numerics`):

    - on CUDA tensors, the first call of a signature runs ``fn`` eagerly, as
      a metric runs a signature's first update: a shape met once holds no
      memory. The second runs ``fn`` on a side stream (the warm-up: this
      call's result, and every kernel's first launch) and captures it with
      :class:`CapturedStep`, in one memory pool for all the owner's graphs;
      later calls copy their inputs into the graph's static inputs and
      replay it;
    - the pool holds at most an eighth of the card's memory
      (:func:`_pool_bound`, about 10.6 GB on an H100 80GB). A graph keeps its
      activations' memory between calls, where a ``jit`` executable frees
      its temporaries, and a capture cannot give memory back midway, so it
      can need far more than an eager call. A capture that leaves the pool
      larger, or runs out of memory, drops every graph of the trunk (they
      share the pool, which only that gives back; the others are captured
      again at their next call), and its signature runs eagerly from then
      on (``eager``);
    - inside a metric's warm-up or capture, or a :func:`trunks_inline`
      block, and on a vmapped lane (a stream pool's step, whose graph is the
      pool's), ``fn`` runs inline, uncounted: the metric's graph holds the
      trunk (graphs do not nest);
    - on CPU tensors (and with an expanded view, or an input that needs a
      gradient) ``fn`` runs eagerly: the plain version.

    A replay writes the graph's own output buffers, which the next replay
    overwrites, so a replayed call returns copies. Held as a submodule of
    the trunk: moving or recasting the trunk drops its graphs, which read
    the old parameters' memory; a pickle or a deep copy holds none.
    ``pool`` is the graphs' memory pool (:func:`pool_bytes`).
    """

    def __init__(self) -> None:
        super().__init__()
        self.clear()

    def forward(self, fn: Callable[..., Tensor], *inputs: Tensor, statics: tuple = ()) -> Tensor:
        if not inputs or not all(isinstance(x, Tensor) and x.is_cuda and x.device == inputs[0].device for x in inputs):
            return fn(*inputs)
        if getattr(_GRAPH_WORK, "stack", None) or getattr(_GRAPH_WORK, "inline", 0) or torch.cuda.is_current_stream_capturing():
            return fn(*inputs)
        if _vmapped(*inputs):  # a lane has the lanes' shapes behind it: no graph of its own can replay it
            return fn(*inputs)
        if any(overlapping(x) for x in inputs) or (torch.is_grad_enabled() and any(x.requires_grad for x in inputs)):
            return fn(*inputs)
        key = (statics, _numerics(), tuple((tuple(x.shape), x.dtype, x.device, *layout_key(x)) for x in inputs))
        entry = self.graphs.get(key)
        if entry is not None:
            return entry.replay(list(inputs)).clone()
        if key in self.eager or key not in self.seen:
            self.seen.add(key)
            return fn(*inputs)
        device = inputs[0].device
        step = lambda _bufs, dyn: fn(*dyn)  # noqa: E731
        t0 = time.perf_counter()
        with _obs_costs.count_costs(inputs) if _OBS.profiling else contextlib.nullcontext() as tally:
            out = warm_up(step, {}, list(inputs), device, self.constants)
            if tally is not None:
                _obs_costs.add_output_bytes(tally, out)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        try:
            self.graphs[key] = CapturedStep(step, {}, list(inputs), self.pool, device, self.constants, stat="forward_")
        except torch.cuda.OutOfMemoryError:
            pass  # the warm-up gave this call's result
        if key not in self.graphs or pool_bytes(self.pool) > _pool_bound(device):
            self.graphs, self.pool, self.constants = {}, None, {}
            self.eager.add(key)
        else:
            entry = self.graphs[key]
            # a trunk passes one of its own methods: the owner is the trunk's class
            entry.seam, entry.owner = "trunk_forward", type(getattr(fn, "__self__", fn)).__name__
            if _OBS.enabled or _OBS.profiling:
                self._obs_captured(key, entry.owner, time.perf_counter() - t0, tally)
        return out

    def _obs_captured(self, key: tuple, owner: str, seconds: float, tally: Any) -> None:
        """Report one captured signature: a ``trunk_forward`` compile event and its seconds, and its counted cost.

        The JAX package compiles a trunk inside ``jax.jit`` and reports no
        event for it; here the trunk's own graph is the compiled thing, and it
        is captured at a signature's second call.
        """
        statics, numerics, inputs = key
        if _OBS.enabled:
            telem = self.__dict__.get("_telem")
            if telem is None:
                telem = _telemetry_for(self)
                telem.name = f"CapturedForward[{owner}]"
            telem.compile_event("trunk_forward", {
                "static_args": repr(statics),
                "numerics": repr(numerics),
                "shapes": repr(tuple(x[0] for x in inputs)),
                "dtypes": repr(tuple(str(x[1]).replace("torch.", "") for x in inputs)),
                "devices": repr(tuple(str(x[2]) for x in inputs)),
                "layouts": repr(tuple(x[3:] for x in inputs)),
            })
            telem.inc("trace_seconds", seconds)
            telem.observe("trace", seconds)
        if _OBS.profiling:
            _PROF_LEDGER.note_executable(
                owner=f"CapturedForward[{owner}]",
                kind="trunk_forward",
                digest=hashlib.sha256(repr(key).encode()).hexdigest(),
                cost=None if tally is None else tally.cost(),
                compile_seconds=seconds,
                source="captured",
            )

    def clear(self) -> None:
        """Drop the graphs, their pool and constants, and the signatures seen or kept eager."""
        self.graphs: Dict[Any, CapturedStep] = {}
        self.pool: Any = None
        # the host data the trunk's graphs read, one store for all of them
        self.constants: Dict[tuple, Tensor] = {}
        self.seen: set = set()
        self.eager: set = set()

    def _apply(self, fn: Callable, *args: Any, **kwargs: Any) -> "CapturedForward":
        self.clear()
        return super()._apply(fn, *args, **kwargs)

    def __getstate__(self) -> Dict[str, Any]:
        state = self.__dict__.copy()
        state.update(graphs={}, pool=None, constants={}, seen=set(), eager=set())
        state.pop("_telem", None)  # a copy is a new stream of captures
        return state
