"""StreamPool: N independent metric streams behind one vmapped step.

Port of ``torchmetrics_tpu/_streams/pool.py``. Serving metric traffic for
many users means thousands of independent streams (per user, per slice, per
model variant), not one big accumulator. Driving N ``Metric`` objects costs
N dispatches per batch; the pool makes it one batched step instead:

- **Stacked states.** Every registered state of one metric (or of each
  ``MetricCollection`` compute-group head) lives stacked along a leading
  slot axis: a per-stream value of shape ``(*s,)`` becomes one ``(P, *s)``
  tensor on the template's device (``P`` = capacity + 1; the last row is a
  scratch slot that masked writes land in). A ring-buffer state stacks as
  ``data (P, cap, *row)``, ``valid (P, cap)`` and an int64 ``count (P,)``.
- **One vmapped step.** ``pool.update(stream_ids, *args)`` updates a
  micro-batch of tenants: the slots' rows are gathered (``index_select``),
  ``torch.func.vmap`` runs the metric's real update body
  (``Metric._traced_update``) once per lane, and an ``index_copy_`` writes
  the lanes back. Padding (``stream_id == -1``), NaN-quarantined rows and
  error-severity violations are written to the scratch row instead, so one
  step serves every mask pattern of a shape. The vmap runs with PyTorch's
  per-lane fallback switched off: an op with no batching rule raises, as an
  untraceable body fails at trace time in the JAX package; nothing loops
  over the lanes unseen. Kernel B1 has a batching rule that counts the whole
  micro-batch in one launch (``_confmat_kernel.confusion_matrix_lanes``), and
  the trunk kernels (B2a/B2b, B3, B4, B5, S1) have rules that fold the lanes
  into one launch (``_kernels/lanes.py``): a trunk metric's forward runs
  inline in the step, its kernels once a micro-batch.
- **On the card, one CUDA graph per key.** The key is the JAX package's:
  the argument signature, the physical capacity and the dtype policy. The
  key's first call runs the step on a side stream (the batch's own update,
  and each kernel's first launch), then captures it with
  ``_compile.CapturedStep``, whose buffers are the stacked states
  themselves: the counterpart of donation. Later calls copy the ids and the
  batch into the graph's inputs and replay. A capture that fails leaves
  that key eager: ``capture_failures`` says why, a warning names the key,
  and with telemetry on an ``auto_path_disabled`` counter and bus event
  carry it. On the CPU the step runs eagerly, op by op.
- **O(1) lifecycle.** ``attach()`` pops the lowest free slot from a
  min-heap; when none is free the capacity doubles (the stacked states are
  re-padded, the graphs of the old capacity dropped, and the next update
  captures again and reports a ``stream_step`` compile event with its
  ``capacity`` component). ``detach(i)``/``reset(i)`` write the defaults
  into one row in place.
- **Per-stream compute with a value cache.** ``compute(i)`` runs the raw
  compute on slot ``i``'s rows; ``compute_all()`` runs it under
  ``torch.func.vmap`` across the pool. Both fill a per-stream value cache
  that only that stream's updates invalidate.
- **Admission.** Construction is gated on the eligibility copy
  (``_streams.manifest.stream_pool_eligible``) and a memory ceiling over
  the predicted stacked-state bytes (``set_memory_ceiling``,
  ``TM_TPU_MEM_CEILING``).

Durability (per-stream journal shards) lives in
:mod:`~torchmetrics_tpu_torch._streams.durability`; the bounded per-stream
telemetry labels in :mod:`~torchmetrics_tpu_torch._streams.telemetry`.
"""

from __future__ import annotations

import functools
import hashlib
import heapq
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch import _compile
from torchmetrics_tpu_torch._aot.state import AOT as _AOT
from torchmetrics_tpu_torch._observability import costs as _obs_costs
from torchmetrics_tpu_torch._observability import tracing as _obs_trace
from torchmetrics_tpu_torch._observability.events import BUS as _BUS
from torchmetrics_tpu_torch._observability.profiling import LEDGER as _PROF_LEDGER
from torchmetrics_tpu_torch._observability.state import OBS as _OBS
from torchmetrics_tpu_torch._observability.telemetry import telemetry_for as _telemetry_for
from torchmetrics_tpu_torch._resilience import integrity as _integrity
from torchmetrics_tpu_torch._resilience.snapshot import _to_device
from torchmetrics_tpu_torch._streams.manifest import predicted_state_bytes, stream_pool_eligible
from torchmetrics_tpu_torch._streams.telemetry import StreamLabeler
from torchmetrics_tpu_torch.metric import _tree_map
from torchmetrics_tpu_torch.utilities.checks import _compiled_step, _no_vmap_fallback
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn
from torchmetrics_tpu_torch.utilities.ringbuffer import RingBuffer

__all__ = [
    "StreamPool",
    "StreamPoolAdmissionError",
    "StreamPoolUnsupported",
    "memory_ceiling",
    "set_memory_ceiling",
]


class StreamPoolUnsupported(TorchMetricsUserError):
    """The metric cannot take the vmapped batched-instance path.

    Raised at pool construction, never mid-stream, so callers keep the plain
    per-instance eager path with no state committed.
    """


class StreamPoolAdmissionError(TorchMetricsUserError):
    """Admission refused: the pool's predicted footprint exceeds the ceiling.

    Raised at construction or at the ``attach()`` that would double the
    capacity, never mid-update, with no state committed.
    """


# process-wide predicted-footprint ceiling in bytes (None = unlimited),
# seeded from TM_TPU_MEM_CEILING at import; checked only at construction and
# at capacity growth, never on the per-batch path
_MEM_CEILING_ENV = "TM_TPU_MEM_CEILING"
_memory_ceiling: Optional[float] = (
    float(os.environ[_MEM_CEILING_ENV]) if os.environ.get(_MEM_CEILING_ENV) else None
)

class _PoolBoundExceeded(RuntimeError):
    """A capture left the pool's graph memory above ``_compile._pool_bound``."""


def set_memory_ceiling(limit_bytes: Optional[float]) -> None:
    """Set (or clear, with ``None``) the pool admission ceiling in bytes.

    The ceiling bounds each pool's predicted stacked-state footprint
    ``(capacity + 1) * F``, where ``F`` is the template's closed-form
    per-stream bytes (``_memory.json``, in the port's dtypes). Templates the
    model cannot price exactly are admitted unchecked.
    """
    global _memory_ceiling
    _memory_ceiling = None if limit_bytes is None else float(limit_bytes)


def memory_ceiling() -> Optional[float]:
    """The active admission ceiling in bytes, or ``None`` when unlimited."""
    return _memory_ceiling


def stack_default(default: Tensor, n: int) -> Tensor:
    """``(n, *shape)`` copies of one default state (JAX ``_spmd/specs.py:82``)."""
    return default.unsqueeze(0).expand(n, *default.shape).clone()


def _as_tensors(tree: Any, device: torch.device) -> Any:
    """Numpy leaves as tensors and every tensor on ``device`` (a stream's batch goes to the pool's device)."""
    return _tree_map(lambda t: t.to(device), _to_device(tree, device))


def _host_ids(stream_ids: Any) -> np.ndarray:
    if isinstance(stream_ids, Tensor):
        stream_ids = stream_ids.detach().cpu().numpy()
    return np.asarray(stream_ids, dtype=np.int64).reshape(-1)


def _leaves(tree: Any) -> List[Tensor]:
    if isinstance(tree, Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


@dataclass
class _Unit:
    """One pooled participant: a metric (or compute-group head + members)."""

    key: str  # "" for a bare metric; the head's collection key otherwise
    metric: Any  # the head: its update runs, its states carry
    members: List[Tuple[str, Any]] = field(default_factory=list)  # (name, metric), the head included
    names: List[str] = field(default_factory=list)
    rings: Dict[str, int] = field(default_factory=dict)  # ring states -> capacity
    ring_rows: Dict[str, Tuple[tuple, Any]] = field(default_factory=dict)
    nan_exempt: frozenset = frozenset()  # states with non-finite defaults (min/max)


_RING_PARTS = ("data", "valid", "count")


class _CostMeter:
    """One profiled step's seconds, apportioned to its applied rows' labels once both are known.

    On the card the seconds come when the ledger resolves the replay's
    event pair, before or after the update has read which rows landed.
    """

    __slots__ = ("pool", "labels", "rows", "seconds")

    def __init__(self, pool: "StreamPool") -> None:
        self.pool, self.labels, self.rows, self.seconds = pool, None, None, None

    def timed(self, seconds: float) -> None:
        self.seconds = seconds
        self._flush()

    def applied(self, labels: Dict[str, int], rows: int) -> None:
        self.labels, self.rows = labels, rows
        self._flush()

    def _flush(self) -> None:
        if self.seconds is not None and self.rows is not None:
            self.pool._meter_costs(self.labels, self.seconds, self.rows)


class StreamPool:
    """Drive N independent copies of one metric as stacked states and one step.

    The target must be fresh (``update_count == 0``): it is the template
    whose class, configuration and (for collections) compute groups define
    every stream; it never accumulates itself. ``capacity`` is the initial
    slot count; :meth:`attach` doubles it on demand. The pool lives on the
    template's device (``cuda`` unless the template was built with
    ``device="cpu"``); stream ids and batches go there.

    The JAX package's ``donate`` has no counterpart: the stacked states are
    always updated in place (they are the step's graph buffers).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
        >>> pool = MeanSquaredError(device="cpu").to_stream_pool(capacity=2)
        >>> a, b = pool.attach(), pool.attach()
        >>> pool.update([a, b], torch.tensor([[1.0, 2.0], [0.0, 0.0]]), torch.zeros(2, 2))
        >>> pool.compute(a)
        tensor(2.5000)
    """

    def __init__(
        self,
        target: Any,
        *,
        capacity: int = 8,
        enforce_manifest: bool = True,
        telemetry_streams: int = 8,
    ) -> None:
        from torchmetrics_tpu_torch.collections import MetricCollection
        from torchmetrics_tpu_torch.metric import Metric

        self._collection = target if isinstance(target, MetricCollection) else None
        if self._collection is None and not isinstance(target, Metric):
            raise StreamPoolUnsupported(
                f"StreamPool target must be a Metric or MetricCollection, got {type(target).__name__}"
            )
        if not (isinstance(capacity, int) and capacity >= 1):
            raise StreamPoolUnsupported(f"`capacity` must be a positive int, got {capacity!r}")
        self.target = target
        metrics = list(target._modules.values()) if self._collection is not None else [target]
        for m in metrics:
            facet = stream_pool_eligible(type(m))
            if facet in ("host_bound", "unsupported") and enforce_manifest:
                raise StreamPoolUnsupported(
                    f"{type(m).__name__} is `{facet}` for the vmapped batched-instance path"
                    " (the eligibility manifest proves its update or compute body does not"
                    " trace); drive independent eager instances instead. Pass"
                    " enforce_manifest=False only if you know the full update+compute"
                    " body traces."
                )
            if facet == "unknown" and enforce_manifest:
                raise StreamPoolUnsupported(
                    f"{type(m).__name__} is absent from the eligibility manifest (user"
                    " subclass?); the vmapped path is certified per-class. Pass"
                    " enforce_manifest=False to opt in without certification."
                )
            if m._update_count != 0:
                raise StreamPoolUnsupported(
                    f"{type(m).__name__} has already accumulated {m._update_count} update(s);"
                    " the pool target is a fresh template, not a live stream"
                )
            if m.nan_policy not in (None, "quarantine"):
                raise StreamPoolUnsupported(
                    f"{type(m).__name__} has nan_policy={m.nan_policy!r}: the vmapped step"
                    " can quarantine per-row (masked write + per-stream counter) but cannot"
                    " warn/raise from inside the step; construct the template with"
                    " nan_policy='quarantine' or None"
                )
        self.device: torch.device = metrics[0].device
        self.capacity = int(capacity)
        self._check_memory_ceiling(self.capacity, at="construction")
        # slot bookkeeping: a min-heap free-list gives a deterministic attach
        # (lowest slot first, which the journal's replay relies on)
        self._free: List[int] = list(range(self.capacity))
        heapq.heapify(self._free)
        self._active: set = set()
        self._counts = np.zeros(self.capacity, dtype=np.int64)
        self._dirty = np.zeros(self.capacity, dtype=bool)
        self._value_cache: Dict[int, Any] = {}
        self._violations = np.zeros(self.capacity, dtype=np.int64)
        self._quarantined = np.zeros(self.capacity, dtype=np.int64)
        self.labeler = StreamLabeler(k=telemetry_streams)
        # built at the first update (it learns ring shapes and compute groups)
        self._units: Optional[List[_Unit]] = None
        self._states: Optional[Dict[str, Dict[str, Any]]] = None
        self._stacked_defaults: Optional[Dict[str, Dict[str, Any]]] = None
        self._row_defaults: Optional[Dict[str, Dict[str, Any]]] = None
        # key -> the step: a CapturedStep on the card, the step function on the CPU
        self._step_fns: Dict[Any, Any] = {}
        self._graph_pool: Any = None
        self._graph_constants: Dict[tuple, Tensor] = {}
        self.capture_failures: Dict[Any, str] = {}
        # how the last key each thread built was resolved (compiled, hit: the AOT cache, or ready), by thread id:
        # two threads warming one key at once each read their own answer
        self._built_as: Dict[int, str] = {}
        self.growths = 0
        self.total_row_updates = 0
        self._row_guards = False
        # durability surface (StreamSnapshotManager binds here)
        self._defaults: Dict[str, Any] = {}
        self._snapshot_hook: Optional[Any] = None

    # ------------------------------------------------------------- properties
    @property
    def physical(self) -> int:
        """Stacked leading-axis length: ``capacity`` slots + 1 scratch row."""
        return self.capacity + 1

    @property
    def active_streams(self) -> List[int]:
        return sorted(self._active)

    @property
    def num_active(self) -> int:
        return len(self._active)

    def stream_update_count(self, stream_id: int) -> int:
        self._check_slot(stream_id)
        return int(self._counts[stream_id])

    # -------------------------------------------------------------- lifecycle
    def attach(self) -> int:
        """Hand out a fresh stream slot (amortized O(1); doubles the capacity when full)."""
        if not self._free:
            self._grow()
        slot = heapq.heappop(self._free)
        self._active.add(slot)
        self._counts[slot] = 0
        self._dirty[slot] = True
        self._value_cache.pop(slot, None)
        if _OBS.enabled:
            _telemetry_for(self).inc("pool_attach")
        hook = self.__dict__.get("_snapshot_hook")
        if hook is not None:
            hook.record_lifecycle("attach", slot)
        return slot

    def detach(self, stream_id: int) -> None:
        """Return a slot to the free-list; its row resets to the defaults."""
        self._check_slot(stream_id, attached=True)
        self._zero_row(stream_id)
        self._active.remove(stream_id)
        heapq.heappush(self._free, int(stream_id))
        self._counts[stream_id] = 0
        self._violations[stream_id] = 0
        self._quarantined[stream_id] = 0
        self._dirty[stream_id] = True
        self._value_cache.pop(int(stream_id), None)
        self.labeler.retire(stream_id)
        if _OBS.enabled:
            _telemetry_for(self).inc("pool_detach")
        hook = self.__dict__.get("_snapshot_hook")
        if hook is not None:
            hook.record_lifecycle("detach", int(stream_id))

    def reset(self, stream_id: Optional[int] = None) -> None:
        """Reset one stream's accumulation (or, with ``None``, every slot)."""
        if stream_id is None:
            if self._states is not None:
                for state, default in zip(_leaves(self._states), _leaves(self._stacked_defaults)):
                    state.copy_(default)
            self._counts[:] = 0
            self._dirty[:] = True
            self._value_cache.clear()
            hook = self.__dict__.get("_snapshot_hook")
            if hook is not None:
                hook.record_lifecycle("reset_all", -1)
            return
        self._check_slot(stream_id, attached=True)
        self._zero_row(stream_id)
        self._counts[stream_id] = 0
        self._dirty[stream_id] = True
        self._value_cache.pop(int(stream_id), None)
        hook = self.__dict__.get("_snapshot_hook")
        if hook is not None:
            hook.record_lifecycle("reset", int(stream_id))

    def _check_slot(self, stream_id: Any, attached: bool = False) -> None:
        sid = int(stream_id)
        if not 0 <= sid < self.capacity:
            raise TorchMetricsUserError(f"stream id {sid} out of range for pool capacity {self.capacity}")
        if attached and sid not in self._active:
            raise TorchMetricsUserError(f"stream {sid} is not attached")

    # ------------------------------------------------------------- admission
    def predicted_stream_bytes(self) -> Optional[float]:
        """Closed-form predicted bytes of ONE stream's rows, or ``None``.

        ``None`` means the memory model makes no exact finite claim for this
        template (absent from ``_memory.json``, opaque, or an unbounded
        cat-list without ``cat_state_capacity``): admission control and the
        telemetry gauge both stand down for such pools.
        """
        if self._units is None:
            metrics = list(self.target._modules.values()) if self._collection is not None else [self.target]
            priced = [(m, None) for m in metrics]
        else:
            # a compute group's members share the head's rows: only the heads hold state, and
            # the rows of rings the template never filled are the ones the pool learned
            priced = [
                (u.metric, {
                    n: float(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
                    for n, (shape, dtype) in u.ring_rows.items()
                })
                for u in self._units
            ]
        total = 0.0
        for m, rows in priced:
            pred = predicted_state_bytes(m, rows)
            if pred is None or not pred.exact or pred.bytes == float("inf"):
                return None
            total += pred.bytes
        return total

    def _profiled_stream_bytes(self) -> float:
        """``predicted_stream_bytes()`` as a cached float for metering (no claim: 0.0)."""
        cached = self.__dict__.get("_prof_stream_bytes")
        if cached is None:
            pred = self.predicted_stream_bytes()
            cached = 0.0 if pred is None else float(pred)
            self.__dict__["_prof_stream_bytes"] = cached
        return cached

    def _check_memory_ceiling(self, new_capacity: int, at: str) -> None:
        """Refuse admission when ``(capacity + 1) * F`` would exceed the ceiling (construction and growth only)."""
        ceiling = _memory_ceiling
        if ceiling is None:
            return
        per_stream = self.predicted_stream_bytes()
        if per_stream is None:
            return
        predicted = (new_capacity + 1) * per_stream
        if predicted <= ceiling:
            return
        cls_name = type(self.target).__name__
        raise StreamPoolAdmissionError(
            f"StreamPool admission refused at {at}: `{cls_name}` is predicted to occupy"
            f" {predicted:.0f} bytes of stacked state at capacity {new_capacity}"
            f" ((capacity + 1) x {per_stream:.0f} bytes/stream from the static memory"
            f" cost model), over the configured ceiling of {ceiling:.0f} bytes"
            f" (set via set_memory_ceiling() or {_MEM_CEILING_ENV}). Raise the ceiling,"
            " lower the pool capacity, or shrink the template's state"
            " (e.g. a smaller cat_state_capacity)."
        )

    def _drop_steps(self) -> None:
        """Forget every step and graph (the stacked tensors were replaced); the next update builds afresh."""
        self._step_fns.clear()
        self._graph_pool = None
        self._graph_constants = {}

    def _grow(self) -> None:
        """Double the capacity: re-pad every stacked tensor; the next update builds its step again."""
        old_cap = self.capacity
        new_cap = old_cap * 2
        self._check_memory_ceiling(new_cap, at="attach-time capacity growth")
        self._free.extend(range(old_cap, new_cap))
        heapq.heapify(self._free)
        self.capacity = new_cap
        self._counts = np.concatenate([self._counts, np.zeros(new_cap - old_cap, np.int64)])
        self._dirty = np.concatenate([self._dirty, np.ones(new_cap - old_cap, bool)])
        self._violations = np.concatenate([self._violations, np.zeros(new_cap - old_cap, np.int64)])
        self._quarantined = np.concatenate([self._quarantined, np.zeros(new_cap - old_cap, np.int64)])
        self.growths += 1
        if self._units is not None:
            old_states = self._states
            self._install_stacked_defaults(self._units)
            grown: Dict[str, Dict[str, Any]] = {}
            for unit in self._units:
                ust: Dict[str, Any] = {}
                for n in unit.names:
                    old, fresh = old_states[unit.key][n], self._stacked_defaults[unit.key][n]
                    if n in unit.rings:
                        ust[n] = {part: torch.cat([old[part][:old_cap], fresh[part][old_cap:]]) for part in _RING_PARTS}
                    else:
                        ust[n] = torch.cat([old[:old_cap], fresh[old_cap:]])
                grown[unit.key] = ust
            self._states = grown
            # the shapes changed: every graph goes; the next update's compile
            # event carries the new `capacity` component, so the churn
            # detector names the growth instead of counting a mystery
            self._drop_steps()
        if _OBS.enabled:
            telem = _telemetry_for(self)
            telem.inc("pool_growths")
            per_stream = self.predicted_stream_bytes()
            if per_stream is not None:
                telem.set_gauge("predicted_state_bytes|scope=pool", (new_cap + 1) * per_stream)
            _BUS.publish(
                "stream_pool_growth",
                type(self).__name__,
                f"capacity {old_cap} -> {new_cap} (stacked states re-padded; one named"
                " recompile on the next update)",
                data={"old": old_cap, "new": new_cap},
            )

    def _zero_row(self, stream_id: int) -> None:
        """Write the defaults into slot ``stream_id``'s rows, in place (a graph's buffers stay its own)."""
        if self._states is None:
            return
        for state, row in zip(_leaves(self._states), _leaves(self._row_defaults)):
            state[int(stream_id)] = row

    # ------------------------------------------------------------------ update
    def update(self, stream_ids: Any, *args: Any, **kwargs: Any) -> None:
        """One vmapped update over a micro-batch of streams.

        ``stream_ids`` is a length-B sequence (or tensor) of attached slot
        ids; ``-1`` entries are padding, whose rows are masked into the
        scratch slot. Every tensor argument must carry a leading axis of
        length B: row ``b`` is stream ``stream_ids[b]``'s batch.
        """
        _sp = _obs_trace.begin_span("update", "StreamPool") if _OBS.tracing else None
        _sp_err: Optional[BaseException] = None
        try:
            return self._update_impl(_sp, stream_ids, args, kwargs)
        except BaseException as err:
            _sp_err = err
            raise
        finally:
            if _sp is not None:
                _obs_trace.end_span(_sp, _sp_err)

    def _signature(self, ids: np.ndarray, args: tuple, kwargs: Dict[str, Any], what: str) -> Tuple[Any, ...]:
        """Check a micro-batch; return ``(key, treedef, dynamic, statics)`` (prepares the pool at its first batch)."""
        from torchmetrics_tpu_torch.metric import Metric

        if ids.size == 0:
            raise TorchMetricsUserError(f"`{what}` needs at least one stream id")
        live = ids[ids >= 0]
        if np.unique(live).size != live.size:
            raise TorchMetricsUserError(
                "duplicate stream ids in one micro-batch: the masked scatter would apply"
                " only one of the duplicate rows (split the call instead)"
            )
        for sid in live.tolist():
            self._check_slot(sid, attached=True)
        treedef, dynamic, statics = Metric._split_batch_args("stream_update", args, kwargs)
        if not dynamic:
            raise TorchMetricsUserError(f"`{what}` needs at least one array argument")
        for leaf in dynamic:
            if leaf.ndim < 1 or leaf.shape[0] != ids.size:
                raise TorchMetricsUserError(
                    f"every array argument must carry a leading stream axis of length"
                    f" {ids.size} (one row per stream id); got shape {tuple(leaf.shape)}"
                )
        if self._units is None:
            self._prepare(args, kwargs)
        layouts = self.device.type == "cuda"
        sig = (
            treedef,
            statics,
            tuple((tuple(d.shape), d.dtype, *(_compile.layout_key(d) if layouts else ())) for d in dynamic),
        )
        key = (
            sig,
            self.physical,
            tuple(None if u.metric._dtype_policy is None else str(u.metric._dtype_policy) for u in self._units),
        )
        return key, treedef, dynamic, statics

    def _compile_event(self, key: Any, treedef: Any, statics: Any) -> None:
        _telemetry_for(self).compile_event("stream_step", self._components(key, treedef, statics))

    def _components(self, key: Any, treedef: Any, statics: Any) -> Dict[str, str]:
        """The step key's printable components: the churn detector's, which also key its AOT record."""
        sig = key[0]
        return {
            "arg_structure": str(treedef),
            "static_args": repr(statics),
            "shapes": repr(tuple(s[0] for s in sig[2])),
            "dtypes": repr(tuple(str(s[1]).replace("torch.", "") for s in sig[2])),
            "capacity": str(self.physical),
        }

    def _update_impl(self, _sp: Any, stream_ids: Any, args: tuple, kwargs: Dict[str, Any]) -> None:
        """The micro-batch body (``_sp``: the seam's open span, or None)."""
        ids = _host_ids(stream_ids)
        if ids.size == 0:
            raise TorchMetricsUserError("`update` needs at least one stream id")
        live = ids[ids >= 0]
        if live.size == 0:
            return
        if _sp is not None:
            _sp.attrs["rows"] = int(ids.size)
        args, kwargs = _as_tensors(args, self.device), _as_tensors(kwargs, self.device)
        key, treedef, dynamic, statics = self._signature(ids, args, kwargs, "update")
        entry = self._step_fns.get(key)
        built = entry is None
        obs_sample = False
        t0 = 0.0
        if _OBS.enabled:
            telem = _telemetry_for(self)
            if built:
                # the churn detector's cache-key components plus `capacity`:
                # a growth's new step is named ("capacity: '3' -> '5'")
                self._compile_event(key, treedef, statics)
            obs_sample = telem.sample_due("stream_step")
            if obs_sample:
                t0 = time.perf_counter()
        dyn = [torch.as_tensor(ids, device=self.device), *dynamic]
        # a built (first) call pays its capture or first run: the ledger keeps
        # its seconds apart, so it stays out of the cost buckets
        meter = _CostMeter(self) if _OBS.profiling and not built else None
        step_sp = _obs_trace.begin_span("stream_step", "StreamPool", built=built) if _sp is not None else None
        try:
            flags = self._run_step(key, treedef, statics, dyn, built, meter)
        except BaseException as err:
            if step_sp is not None:
                _obs_trace.end_span(step_sp, err)
            raise
        if step_sp is not None:
            _obs_trace.end_span(step_sp)
        applied = ids >= 0
        if self._row_guards:
            # the quarantine and violation masks decide which rows landed;
            # pools without guards skip this read back entirely
            quarantined, violated = (f.cpu().numpy() for f in flags)
            applied = applied & ~quarantined & ~violated
            for b, sid in enumerate(ids.tolist()):
                if sid < 0:
                    continue
                if quarantined[b]:
                    self._quarantined[sid] += 1
                    if _OBS.enabled:
                        _telemetry_for(self).inc(f"pool_quarantined|stream={self.labeler.label(sid)}")
                if violated[b]:
                    self._violations[sid] += 1
                    if _OBS.enabled:
                        _telemetry_for(self).inc(f"pool_violations|stream={self.labeler.label(sid)}")
        applied_ids = ids[applied]
        self._counts[applied_ids] += 1
        self._dirty[applied_ids] = True
        label_rows: Dict[str, int] = {}
        for sid in applied_ids.tolist():
            self._value_cache.pop(sid, None)
            label = self.labeler.note(sid)
            label_rows[label] = label_rows.get(label, 0) + 1
            if _OBS.enabled:
                _telemetry_for(self).inc(f"pool_stream_updates|stream={label}")
        if meter is not None:
            # equal shares: a vmapped micro-batch runs every live lane for the same time
            meter.applied(label_rows, int(applied_ids.size))
        if _sp is not None:
            # bounded `stream=` attribution, read after this batch's note()
            # calls so the span agrees with the per-row counter labels
            labels = sorted({self.labeler.label(sid) for sid in live.tolist()})
            _sp.attrs["streams"] = ",".join(labels[:16]) + (",…" if len(labels) > 16 else "")
        self.total_row_updates += int(applied_ids.size)
        if _OBS.enabled:
            telem = _telemetry_for(self)
            telem.inc("update_calls|path=stream_pool")
            if obs_sample:
                telem.observe("stream_step", time.perf_counter() - t0)
        hook = self.__dict__.get("_snapshot_hook")
        if hook is not None:
            hook.record_streams(ids, args, kwargs)

    def _meter_costs(self, label_rows: Dict[str, int], seconds: float, rows: int) -> None:
        """Apportion one step's device seconds, flops and state bytes to its applied rows' labels, equally."""
        if not rows:
            return
        cls_name = type(self.target).__name__
        cost = _PROF_LEDGER.cost_for("stream_step", cls_name)
        flops_per_row = (cost.flops / rows) if cost is not None else 0.0
        bytes_per_row = self._profiled_stream_bytes()
        share = seconds / rows
        telem = _telemetry_for(self)
        for label, n in label_rows.items():
            telem.inc(f"pool_cost_device_seconds|stream={label}", share * n)
            if flops_per_row:
                telem.inc(f"pool_cost_flops|stream={label}", flops_per_row * n)
            if bytes_per_row:
                telem.inc(f"pool_cost_state_byte_updates|stream={label}", bytes_per_row * n)

    def _run_step(
        self, key: Any, treedef: Any, statics: Any, dyn: List[Tensor], built: bool, meter: Optional[_CostMeter]
    ) -> Tuple[Tensor, Tensor]:
        """Run the key's step on the stacked states: eagerly on the CPU, as a CUDA graph's replay on the card.

        The first call of a key on the card runs the step on a side stream
        (this batch's update) and captures it on the same states. With
        profiling on, the first call counts the step's cost and a later call
        is timed (a CUDA event pair on the card, the host clock on the CPU)
        into the ledger's ``stream_step`` seam and ``meter``. With the AOT
        cache set, the build runs under its resolution lock and asks for the
        key's record first; ``_built_as`` then says how the key was resolved.
        """
        cls_name = type(self.target).__name__
        if built and _AOT.active:
            from torchmetrics_tpu_torch._aot import cache as _aot_cache

            with _aot_cache.RESOLVE_LOCK:
                if key in self._step_fns:  # built by another thread while this one waited for the lock
                    self._built_as[threading.get_ident()] = "ready"
                    return self._run_step(key, treedef, statics, dyn, False, meter)
                res = _aot_cache.wrap_executable(
                    owner=f"StreamPool[{cls_name}]", kind="stream_step", components=self._components(key, treedef, statics),
                    extra=repr((key[0][2], key[1:], [(tuple(t.shape), str(t.dtype)) for t in _leaves(self._states)])),
                    telem_obj=self,
                )
                return self._build(key, treedef, statics, dyn, res)
        if built:
            return self._build(key, treedef, statics, dyn, None)
        entry = self._step_fns[key]
        if isinstance(entry, _compile.CapturedStep):
            return entry.replay(dyn, then=None if meter is None else meter.timed)
        t0 = time.perf_counter() if meter is not None else 0.0
        out = entry(self._states, dyn)
        if meter is not None:
            seconds = time.perf_counter() - t0
            _PROF_LEDGER.record_step("stream_step", cls_name, seconds)
            meter.timed(seconds)
        return out

    def _build(self, key: Any, treedef: Any, statics: Any, dyn: List[Tensor], res: Any) -> Tuple[Tensor, Tensor]:
        """Build the key's step, run it once (on the card, the warm-up before its capture); ``res``: the AOT cache's word."""
        cls_name = type(self.target).__name__
        step = self._build_step(treedef, statics)
        t0 = time.perf_counter()
        on_card = self.device.type == "cuda"
        if on_card:  # the warm-up before the capture: this batch's update
            first = functools.partial(_compile.warm_up, step, self._states, dyn, self.device, self._graph_constants)
        else:
            first = functools.partial(step, self._states, dyn)
        tally = None
        if _OBS.profiling and (res is None or res.counting):
            with _obs_costs.count_costs(dyn, self._states) as tally:
                out = first()
                _obs_costs.add_output_bytes(tally, out)
        else:
            out = first()
        self._step_fns[key] = entry = self._capture(key, step, dyn) if on_card else step
        seconds = time.perf_counter() - t0
        if _OBS.enabled:
            telem = _telemetry_for(self)
            telem.inc("trace_seconds", seconds)
            telem.observe("trace", seconds)
        if _OBS.profiling:
            _PROF_LEDGER.note_executable(
                owner=f"StreamPool[{cls_name}]",
                kind="stream_step",
                digest=hashlib.sha256(repr(key).encode()).hexdigest(),
                cost=tally.cost() if tally is not None else None if res is None else res.cost,
                compile_seconds=seconds,
                source="captured" if on_card else "compiled",
            )
        if res is not None:
            res.done(_compile.capture_outcome(entry, on_card, self.capture_failures.get(key)), tally)
        self._built_as[threading.get_ident()] = "compiled" if res is None else res.outcome
        return out

    def _capture(self, key: Any, step: Callable, dyn: List[Tensor]) -> Any:
        """The key's step captured into a CUDA graph; the step itself where the capture fails (the key stays eager).

        The warm-up already applied this batch, so a failure loses nothing
        but the replay's speed: it is recorded in ``capture_failures``,
        warned of once (a key fails once), and with telemetry on published
        as the compiled path publishes a switch-off, an ``auto_path_disabled``
        counter and bus event naming the seam and the key.

        The pool's graphs share one memory pool, which keeps each step's
        temporaries between replays: a trunk metric's step holds its forward's
        activations for every lane of the micro-batch. A capture that leaves
        the pool above an eighth of the card (``_compile._pool_bound``, as a
        trunk's own graphs are held) or runs out of memory counts as a failed
        capture, and drops every graph of the pool, which only that gives back
        (the other keys capture again at their next call).
        """
        try:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            entry = _compile.CapturedStep(step, self._states, dyn, self._graph_pool, self.device, self._graph_constants)
            held, bound = _compile.pool_bytes(self._graph_pool), _compile._pool_bound(self.device)
            if held > bound:
                del entry
                raise _PoolBoundExceeded(f"the pool's graphs hold {held} bytes of the card, over the bound of {bound}")
        except Exception as err:  # noqa: BLE001 - any capture fault leaves the key eager, reported below
            if isinstance(err, (_PoolBoundExceeded, torch.cuda.OutOfMemoryError)):
                self._drop_steps()
            reason = f"{type(err).__name__}: {err}"
            self.capture_failures[key] = reason
            cls_name = type(self.target).__name__
            rank_zero_warn(
                f"StreamPool[{cls_name}]: the step of key {key!r} did not capture into a CUDA graph ({reason});"
                " that key runs eagerly from now on (see `capture_failures`)."
            )
            if _OBS.enabled:
                _telemetry_for(self).inc("auto_path_disabled")
                _BUS.publish(
                    "auto_path_disabled", f"StreamPool[{cls_name}]", reason,
                    data={"seam": "stream_step", "key": repr(key)},
                )
            return step
        entry.seam, entry.owner = "stream_step", type(self.target).__name__
        return entry

    # ----------------------------------------------------------------- compute
    def compute(self, stream_id: int) -> Any:
        """One stream's metric value: the raw compute on its slot's rows (cached until its next update)."""
        self._check_slot(stream_id, attached=True)
        sid = int(stream_id)
        if not self._dirty[sid] and sid in self._value_cache:
            return self._value_cache[sid]
        if self._units is None:
            raise TorchMetricsUserError(
                "the pool has no states yet (no update() has run); stream values are"
                " undefined before the first batch"
            )
        _sp = None
        if _OBS.tracing:
            _sp = _obs_trace.begin_span("compute", "StreamPool", kind="one", stream=self.labeler.label(sid))
        _sp_err: Optional[BaseException] = None
        try:
            with torch.no_grad():
                rows = _tree_map(lambda s: s[sid], self._states)
                ring_counts = self._ring_counts(rows)
                value = self._shape_value(self._own(self._lane_compute(rows, ring_counts)))
        except BaseException as err:
            _sp_err = err
            raise
        finally:
            if _sp is not None:
                _obs_trace.end_span(_sp, _sp_err)
        self._value_cache[sid] = value
        self._dirty[sid] = False
        if _OBS.enabled:
            _telemetry_for(self).inc("pool_computes|kind=one")
        return value

    def compute_all(self) -> Dict[int, Any]:
        """Every attached stream's value from one vmapped compute over the stacked states.

        A pool with ring states vmaps each group of streams whose rings hold
        the same number of rows (a ring's live rows are a slice of host
        length), one vmap a group.
        """
        if self._units is None:
            return {}
        _sp = _obs_trace.begin_span("compute", "StreamPool", kind="all") if _OBS.tracing else None
        _sp_err: Optional[BaseException] = None
        out: Dict[int, Any] = {}
        try:
            with torch.no_grad(), _no_vmap_fallback():
                if not any(u.rings for u in self._units):
                    groups = {None: list(range(self.physical))}
                else:
                    groups = {}
                    for sid in sorted(self._active):
                        rows = _tree_map(lambda s, _i=sid: s[_i], self._states)
                        groups.setdefault(self._ring_counts(rows), []).append(sid)
                for ring_counts, slots in groups.items():
                    if ring_counts is None:
                        lanes = self._states
                    else:
                        idx = torch.as_tensor(slots, device=self.device)
                        lanes = _tree_map(lambda s: s.index_select(0, idx), self._states)
                    stacked = self._own(torch.func.vmap(functools.partial(self._lane_compute, ring_counts=ring_counts))(lanes))
                    for j, sid in enumerate(slots):
                        if sid in self._active:
                            out[sid] = self._shape_value(_tree_map(lambda v, _j=j: v[_j], stacked))
        except BaseException as err:
            _sp_err = err
            raise
        finally:
            if _sp is not None:
                _obs_trace.end_span(_sp, _sp_err)
        out = dict(sorted(out.items()))
        for sid, value in out.items():
            self._value_cache[sid] = value
            self._dirty[sid] = False
        if _OBS.enabled:
            _telemetry_for(self).inc("pool_computes|kind=all")
        return out

    def _own(self, value: Any) -> Any:
        """``value`` with every tensor that shares storage with a stacked state copied (later updates write there)."""
        held = {s.untyped_storage().data_ptr() for s in _leaves(self._states)}
        return _tree_map(lambda v: v.clone() if v.untyped_storage().data_ptr() in held else v, value)

    def _shape_value(self, value: Any) -> Any:
        if self._collection is not None:
            return self._collection._flatten_results(value)
        return value

    def pending_violations(self, stream_id: int) -> int:
        """Error-severity validation violations dropped for this stream."""
        self._check_slot(stream_id)
        return int(self._violations[stream_id])

    def quarantined_updates(self, stream_id: int) -> int:
        """Rows rolled back by the per-row NaN quarantine for this stream."""
        self._check_slot(stream_id)
        return int(self._quarantined[stream_id])

    # ------------------------------------------------------------- preparation
    def _prepare(self, args: tuple, kwargs: Dict[str, Any]) -> None:
        """Build the units from one single-stream eager probe on a throwaway copy of the template.

        The probe learns ring row shapes, and for a collection forms the
        compute groups the vmapped step shares (group detection needs
        post-update states).
        """
        from copy import deepcopy

        probe = deepcopy(self.target)
        row_args, row_kwargs = _tree_map(lambda x: x[0], (args, kwargs))
        probe.update(*row_args, **row_kwargs)
        units: List[_Unit] = []
        if self._collection is not None:
            groups = probe._groups
            self._collection._groups = {i: list(g) for i, g in groups.items()}
            self._collection._groups_checked = True
            for g in groups.values():
                head_key = g[0]
                head = self.target._modules[head_key]
                members = [(name, self.target._modules[name]) for name in g]
                units.append(self._make_unit(head_key, head, members, probe._modules[head_key]))
        else:
            units.append(self._make_unit("", self.target, [("", self.target)], probe))
        self._units = units
        self._row_guards = any(u.metric.nan_policy == "quarantine" or self._unit_flags(u) for u in units)
        self._install_stacked_defaults(units)
        self._states = self._place_defaults()

    @staticmethod
    def _unit_flags(unit: _Unit) -> bool:
        """True when the unit's head runs a traced validator per lane."""
        m = unit.metric
        return bool(getattr(m, "validate_args", False)) and m._supports_traced_validation()

    def _make_unit(self, key: str, metric: Any, members: List[Tuple[str, Any]], probe: Any) -> _Unit:
        names = list(metric._defaults)
        rings: Dict[str, int] = {}
        ring_rows: Dict[str, Tuple[tuple, Any]] = {}
        for n in names:
            state = getattr(metric, n)
            if isinstance(state, list):
                raise StreamPoolUnsupported(
                    f"state `{n}` is an append-mode list state; its stacked shape would"
                    " grow per batch. Construct the template with `cat_state_capacity=N`"
                    " to bound it into a ring buffer."
                )
            if isinstance(state, RingBuffer):
                rings[n] = state.capacity
                warmed = getattr(probe, n) if probe is not None else None
                if not isinstance(warmed, RingBuffer) or not warmed.initialized:
                    raise TorchMetricsUserError(f"ring state `{n}` row shape could not be learned from the first batch")
                ring_rows[n] = (tuple(int(s) for s in warmed.data.shape[1:]), warmed.data.dtype)
        exempt = frozenset(
            n for n in names if n not in rings and not bool(torch.isfinite(metric._defaults[n].float()).all())
        )
        return _Unit(key=key, metric=metric, members=members, names=names, rings=rings, ring_rows=ring_rows,
                     nan_exempt=exempt)

    def _install_stacked_defaults(self, units: List[_Unit]) -> None:
        """Stacked ``(P, *s)`` defaults, per-row defaults and the flat mirror ``_defaults``."""
        self._stacked_defaults, self._row_defaults, self._defaults = {}, {}, {}
        P, dev = self.physical, self.device
        for unit in units:
            defaults: Dict[str, Any] = {}
            rows: Dict[str, Any] = {}
            for n in unit.names:
                if n in unit.rings:
                    row_shape, row_dtype = unit.ring_rows[n]
                    cap = unit.rings[n]
                    rows[n] = {
                        "data": torch.zeros((cap, *row_shape), dtype=row_dtype, device=dev),
                        "valid": torch.zeros((cap,), dtype=torch.bool, device=dev),
                        "count": torch.zeros((), dtype=torch.int64, device=dev),
                    }
                    defaults[n] = {part: stack_default(rows[n][part], P) for part in _RING_PARTS}
                else:
                    rows[n] = unit.metric._defaults[n].to(dev)
                    defaults[n] = stack_default(rows[n], P)
            self._stacked_defaults[unit.key] = defaults
            self._row_defaults[unit.key] = rows
            pre = f"{unit.key}." if unit.key else ""
            for n in unit.names:
                if n in unit.rings:
                    for part in _RING_PARTS:
                        self._defaults[f"{pre}{n}#{part}"] = defaults[n][part]
                else:
                    self._defaults[f"{pre}{n}"] = defaults[n]

    def _place_defaults(self) -> Dict[str, Dict[str, Any]]:
        return _tree_map(torch.clone, self._stacked_defaults)

    # ------------------------------------------------------------------ steps
    def _ring_counts(self, rows: Dict[str, Dict[str, Any]]) -> Optional[tuple]:
        """One slot's ring counts, read to the host (a ring's live rows are a slice of host length)."""
        counts = [int(rows[u.key][n]["count"]) for u in self._units for n in sorted(u.rings)]
        return tuple(counts) if counts else None

    def _lane_states(self, unit: _Unit, lane: Dict[str, Any], ring_counts: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
        """A lane's states as the metric holds them: each ring state rebuilt into a :class:`RingBuffer`.

        In an update the lane's count is the ring's device cursor, where its
        appends write (``ring_push``); in a compute the ring's host count is
        the slot's (``ring_counts``).
        """
        local = {}
        for n in unit.names:
            if n in unit.rings:
                s = lane[n]
                ring = RingBuffer(unit.rings[n], self.device)
                ring.data = s["data"]
                ring._cursor = s["count"]
                ring.count = 0 if ring_counts is None else ring_counts[n]
                ring._warned_overflow = True  # a lane cannot warn for its own stream
                local[n] = ring
            else:
                local[n] = lane[n]
        return local

    @staticmethod
    def _lane_leaves(unit: _Unit, states: Dict[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for n in unit.names:
            v = states[n]
            if isinstance(v, RingBuffer):
                cap = v.capacity
                valid = torch.arange(cap, device=v.data.device) < torch.clamp(v._cursor, max=cap)
                out[n] = {"data": v.data, "valid": valid, "count": v._cursor}
            else:
                out[n] = v
        return out

    def _lane_compute(self, lane_states: Dict[str, Dict[str, Any]], ring_counts: Optional[tuple] = None) -> Any:
        """One stream's value from its rows (members of a compute group read their head's rows)."""
        from torchmetrics_tpu_torch.metric import _squeeze_if_scalar

        counts = iter(ring_counts or ())
        values: Dict[str, Any] = {}
        for unit in self._units:
            rc = {n: next(counts) for n in sorted(unit.rings)} if unit.rings else None
            local = self._lane_states(unit, lane_states[unit.key], rc)
            for name, member in unit.members:
                values[name] = _squeeze_if_scalar(member._traced_compute(unit.names, local))
        return values[""] if self._collection is None else values

    def _build_step(self, treedef: Any, statics: Any) -> Callable:
        """The step of one key: ``step(states, [ids, *batch]) -> (quarantined, violated)``.

        It gathers the lanes' rows, vmaps each lane's real update (with the
        NaN quarantine and the traced value flags) with the per-lane
        fallback off, and writes the lanes back in place, the rejected ones
        to the scratch row, where two of them colliding is harmless by
        construction (JAX ``pool.py:891-898``).
        """
        from torchmetrics_tpu_torch.metric import Metric

        units = self._units
        row_guards = self._row_guards
        scratch = self.physical - 1

        def lane_step(lane_states: Dict[str, Dict[str, Any]], dyn: Tuple[Tensor, ...]):
            a, kw = Metric._merge_batch_args(treedef, list(dyn), statics)
            new_lane: Dict[str, Dict[str, Any]] = {}
            quarantined = dyn[0].new_zeros((), dtype=torch.bool)
            violated = dyn[0].new_zeros((), dtype=torch.bool)
            for unit in units:
                m = unit.metric
                kw_m = m._filter_kwargs(**kw) if kw else kw
                local = self._lane_states(unit, lane_states[unit.key])
                validate = self._unit_flags(unit)
                with m._fused_flags(validate):
                    new_local = m._traced_update(unit.names, local, a, kw_m)
                leaves = new_lane[unit.key] = self._lane_leaves(unit, new_local)
                if m.nan_policy == "quarantine":
                    for n in unit.names:
                        v = leaves[n]
                        if n in unit.rings:
                            # only the rows a ring holds count
                            live = v["valid"].reshape(-1, *([1] * (v["data"].ndim - 1)))
                            quarantined = quarantined | ~torch.where(live, torch.isfinite(v["data"]), True).all()
                        elif n not in unit.nan_exempt and (v.is_floating_point() or v.is_complex()):
                            quarantined = quarantined | ~torch.isfinite(v).all()
                if validate:
                    msgs, flags, sevs = Metric._split_value_flags(m._traced_value_flags(*a, **kw_m))
                    err = [i for i, s in enumerate(sevs) if s == "error"]
                    if err:
                        violated = violated | torch.stack([flags[i] for i in err]).any()
            return new_lane, quarantined, violated

        def step(states: Dict[str, Dict[str, Any]], dyn: List[Tensor]) -> Tuple[Tensor, Tensor]:
            ids, batch = dyn[0], tuple(dyn[1:])
            with torch.no_grad(), _compiled_step():
                valid = ids >= 0
                safe = torch.where(valid, ids, scratch)
                lanes = _tree_map(lambda s: s.index_select(0, safe), states)
                with _no_vmap_fallback():
                    new_lanes, quarantined, violated = torch.func.vmap(lane_step)(lanes, batch)
                keep = valid & ~quarantined & ~violated if row_guards else valid
                write = torch.where(keep, safe, scratch)
                for s, nl in zip(_leaves(states), _leaves(new_lanes)):
                    s.index_copy_(0, write, nl.to(s.dtype))
                return quarantined & valid, violated & valid

        return step

    # -------------------------------------------------------------- warm start
    def warm_start(self, stream_ids: Any, *args: Any, **kwargs: Any) -> Dict[str, str]:
        """Build the step for this micro-batch signature without consuming a batch.

        The step runs once with every row masked as padding, so the example
        batch lands in the scratch row only; on the card that run is the
        warm-up before the step's CUDA graph is captured on the stacked
        states, and the first real :meth:`update` of the signature replays.
        No stream's state or count changes. ``stream_ids``/``args`` are an
        example micro-batch shaped like real traffic (the ids must be
        attached slots).

        Returns ``{"stream_step": "compiled"}`` when the step was built now,
        ``"hit"`` when it was built now on a verified AOT cache record (the
        record was found, and every kernel library it names was loaded from
        ``_build/`` or the cache with no ``nvcc``; the warm-up and the capture
        still run here, see ``_aot/cache.py``), ``"ready"`` when this pool
        had built it already (where the JAX package answers ``"hit"``).
        ``stream_compute_one`` and ``stream_compute_all`` read ``"ready"``:
        they run eagerly, where the JAX package's are executables.
        """
        ids = _host_ids(stream_ids)
        args, kwargs = _as_tensors(args, self.device), _as_tensors(kwargs, self.device)
        key, treedef, dynamic, statics = self._signature(ids, args, kwargs, "warm_start")
        outcomes = {"stream_step": "ready", "stream_compute_one": "ready", "stream_compute_all": "ready"}
        if key in self._step_fns:
            return outcomes
        if _OBS.enabled:
            self._compile_event(key, treedef, statics)
        padding = torch.full((ids.size,), -1, dtype=torch.int64, device=self.device)
        self._run_step(key, treedef, statics, [padding, *dynamic], True, None)
        outcomes["stream_step"] = self._built_as.pop(threading.get_ident(), "compiled")
        return outcomes

    # -------------------------------------------------- snapshot/restore surface
    def state_dict(
        self,
        destination: Optional[Dict] = None,
        prefix: str = "",
        keep_vars: bool = False,
        integrity: bool = False,
        all_states: bool = False,
        _host: bool = True,
    ) -> Dict:
        """Host numpy copies of the stacked states, plus the ``#streams`` skeleton."""
        if self._units is None or self._states is None:
            raise TorchMetricsUserError("StreamPool has no states yet (no update() has run)")
        destination = {} if destination is None else destination
        keys: List[str] = []
        for unit in self._units:
            pre = f"{unit.key}." if unit.key else ""
            states = self._states[unit.key]
            for n in unit.names:
                if n in unit.rings:
                    for part in _RING_PARTS:
                        k = f"{pre}{n}#{part}"
                        destination[prefix + k] = _integrity.to_host(states[n][part])
                        keys.append(k)
                else:
                    k = f"{pre}{n}"
                    destination[prefix + k] = _integrity.to_host(states[n])
                    keys.append(k)
        destination[prefix + "#streams"] = {
            "capacity": self.capacity,
            "active": sorted(int(i) for i in self._active),
            "counts": self._counts.copy(),
            "units": [
                {"key": u.key, "members": [name for name, _ in u.members], "names": list(u.names), "rings": dict(u.rings)}
                for u in self._units
            ],
        }
        if integrity:
            _integrity.attach_integrity(destination, keys, prefix, type(self).__name__)
        return destination

    def load_state_dict(self, state_dict: Dict, strict: Any = True, prefix: str = "") -> None:
        """Restore the whole pool (the capacity becomes the snapshot's)."""
        meta = state_dict.get(_integrity.integrity_key(prefix))
        if meta is not None:
            corrupted = _integrity.verify_states(
                state_dict, prefix, meta, type(self).__name__, include_missing=strict is not False
            )
            if corrupted:
                _integrity.raise_corrupted(type(self).__name__, corrupted)
        blk = state_dict.get(prefix + "#streams")
        if blk is None:
            raise TorchMetricsUserError("checkpoint lacks the `#streams` block (not a StreamPool snapshot)")
        cap = int(blk["capacity"])
        if self._units is None:
            self._adopt_skeleton(blk)
        self.capacity = cap
        self._counts = np.asarray(blk["counts"], dtype=np.int64).copy()
        self._active = set(int(i) for i in blk["active"])
        self._free = [i for i in range(cap) if i not in self._active]
        heapq.heapify(self._free)
        self._dirty = np.ones(cap, bool)
        self._violations = np.zeros(cap, np.int64)
        self._quarantined = np.zeros(cap, np.int64)
        self._value_cache.clear()
        states: Dict[str, Dict[str, Any]] = {}
        for unit in self._units:
            pre = f"{unit.key}." if unit.key else ""
            ustates: Dict[str, Any] = {}
            for n in unit.names:
                if n in unit.rings:
                    ustates[n] = {
                        part: _integrity.from_host(state_dict[f"{prefix}{pre}{n}#{part}"], self.device)
                        for part in _RING_PARTS
                    }
                else:
                    ustates[n] = _integrity.from_host(state_dict[f"{prefix}{pre}{n}"], self.device)
            states[unit.key] = ustates
        same = self._states is not None and all(
            a.shape == b.shape and a.dtype == b.dtype for a, b in zip(_leaves(self._states), _leaves(states))
        )
        if same and any(isinstance(e, _compile.CapturedStep) for e in self._step_fns.values()):
            # the graphs read and write the stacked tensors' memory: the snapshot is copied in
            for live, new in zip(_leaves(self._states), _leaves(states)):
                live.copy_(new)
        else:
            self._states = states
            if not same:
                self._drop_steps()
        self._rebuild_defaults_from_states()
        hook = self.__dict__.get("_snapshot_hook")
        if hook is not None:
            hook.record_lifecycle("external", -1)

    def load_stream_state(self, stream_id: int, rows: Dict[str, Any], count: int) -> None:
        """Bind ONE stream's state rows (sliced from a snapshot) into its slot, in place."""
        self._check_slot(stream_id, attached=True)
        if self._units is None or self._states is None:
            raise TorchMetricsUserError(
                "the pool has no stacked states to restore into; run load_state_dict()"
                " (or one update) first, or restore through StreamSnapshotManager"
            )
        sid = int(stream_id)
        for unit in self._units:
            pre = f"{unit.key}." if unit.key else ""
            ust = self._states[unit.key]
            for n in unit.names:
                if n in unit.rings:
                    for part in _RING_PARTS:
                        ust[n][part][sid] = _integrity.from_host(rows[f"{pre}{n}#{part}"], self.device)
                else:
                    ust[n][sid] = _integrity.from_host(rows[f"{pre}{n}"], self.device)
        self._counts[sid] = int(count)
        self._dirty[sid] = True
        self._value_cache.pop(sid, None)

    def ensure_ready_from_snapshot(self, blk: Dict[str, Any], state_dict: Dict[str, Any], prefix: str = "") -> None:
        """Build the units and default stacked states from a snapshot skeleton.

        Used by a per-stream restore into a pool that has never seen a
        batch: the unit layout comes from the checkpoint's ``#streams``
        block, ring row shapes from the checkpointed leaves, and every slot
        starts at its defaults (the restore then binds the one stream's rows).
        """
        if self._units is None:
            self._adopt_skeleton(blk)
        if self._states is None:
            for unit in self._units:
                pre = f"{unit.key}." if unit.key else ""
                for n in unit.rings:
                    data = _integrity.from_host(state_dict[f"{prefix}{pre}{n}#data"])
                    unit.ring_rows[n] = (tuple(int(s) for s in data.shape[2:]), data.dtype)
            self._install_stacked_defaults(self._units)
            self._states = self._place_defaults()

    def _adopt_skeleton(self, blk: Dict[str, Any]) -> None:
        """The unit skeleton from a checkpoint's ``#streams`` block (before the first update)."""
        units: List[_Unit] = []
        for u in blk["units"]:
            key = u["key"]
            metric = self.target._modules[key] if self._collection is not None else self.target
            members = (
                [(name, self.target._modules[name]) for name in u["members"]]
                if self._collection is not None
                else [("", self.target)]
            )
            names = list(u["names"])
            exempt = frozenset(
                n for n in names
                if n not in u["rings"] and not bool(torch.isfinite(metric._defaults[n].float()).all())
            )
            units.append(_Unit(key=key, metric=metric, members=members, names=names, rings=dict(u["rings"]),
                               nan_exempt=exempt))
        if self._collection is not None:
            self._collection._groups = {i: list(u["members"]) for i, u in enumerate(blk["units"])}
            self._collection._groups_checked = True
        self._units = units
        self._row_guards = any(u.metric.nan_policy == "quarantine" or self._unit_flags(u) for u in units)

    def _rebuild_defaults_from_states(self) -> None:
        """Derive the stacked and row defaults after a restore (ring row shapes from the leaves)."""
        for unit in self._units:
            for n in unit.rings:
                data = self._states[unit.key][n]["data"]
                unit.ring_rows[n] = (tuple(int(s) for s in data.shape[2:]), data.dtype)
        self._install_stacked_defaults(self._units)
