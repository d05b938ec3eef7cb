"""SpmdEngine: update, sync over the mesh rows and compute in one step, one CUDA graph a key on the card.

Port of ``torchmetrics_tpu/_spmd/engine.py``. The eager runtime streams
``update()`` per process and syncs after accumulating. This engine runs the
data-parallel stream over a named 1-D mesh as one step a batch:

- **Stacked states.** Every registered state lives stacked: a per-device
  value of shape ``(*s,)`` becomes one ``(D, *s)`` tensor on the mesh's
  device (``specs.py``), one row per mesh position, each row that position's
  local accumulator. A ring-buffer state stacks its ``data``/``valid``/
  ``count`` leaves the same way. Rows may share a device: a world of 8 on
  one card is one ``(8, *s)`` tensor.
- **One step.** ``step(batch)`` views the global batch's leading axis as
  ``(D, B/D)``, runs each row's update on its shard with ``torch.func.vmap``
  over the stacked states (the per-lane fallback off: an op with no batching
  rule raises, as an untraceable body fails at trace time in the JAX
  package), writes the rows in place, syncs them with ``sync_in_jit`` (each
  state's ``dist_reduce_fx`` over the rows) and runs every compute-group
  member's compute on the synced states, vmapped over the groups' head rows
  (one row without groups). The carried rows stay local (unsynced): the
  sync only feeds the returned value, as in the JAX package. Kernel B1's
  batched launch adds straight into the stacked rows through its vmap rule,
  and B3's folds the rows into one launch a tap.
- **On the card, one CUDA graph per key.** The key is the JAX package's:
  the argument signature and each unit's dtype policy. The key's first call
  runs the step on a side stream (this batch's update and each kernel's
  first launch), then captures it with ``_compile.CapturedStep``, whose
  buffers are the stacked states themselves: the counterpart of donation.
  Later calls copy the batch into the graph's inputs and replay; the value a
  replay returns is copied out of the graph's buffers. A capture that fails
  leaves that key eager (``capture_failures``, a warning, and with
  telemetry on an ``auto_path_disabled`` event naming the ``spmd_step``
  seam). On the CPU the step runs eagerly, op by op.
- **Eligibility-gated.** The ``in_graph_sync`` facet of the eligibility
  copy gates which classes may take this path (host-bound classes keep the
  eager gather); ``"runtime"`` classes are checked against the live
  instance's ``_reductions``.
- **Resilience-wrapped.** The structure digest is checked once, before the
  first step (``_resilience.guard.handshake_at_trace``). Any degradable
  failure of a step (an injected or real fault, or a compute that reads a
  host value, which ``vmap`` refuses) folds the rows into the host metric
  by each state's own reduction, and the stream carries on eagerly
  (``target.update(); target.compute()``), recording a
  ``DegradationEvent``. A fault after the step began writing the rows in
  place cannot be folded: the stream restarts from the defaults.
- **Observable and durable.** ``update_calls|path=spmd`` counters, sampled
  ``spmd_step`` latencies, the ``spmd.step`` span and the ledger's
  ``spmd_step`` seam (CUDA events on the card); a
  :class:`~torchmetrics_tpu_torch._resilience.snapshot.SnapshotManager`
  attached to the engine snapshots the rows through host copies at snapshot
  boundaries (``note_update``).

A ``MetricCollection``'s compute groups share the step: each group's head
updates and syncs once, its members compute from the head's synced states.

**Across processes** (a mesh built with ``process_group=``: one process a
card, as DDP runs): each process holds its own rows, steps on its own share
of the global batch, and the sync adds collectives over the group
(``utilities.distributed.sync_in_process_group``): an integer sum, max or
min reduces the local rows and then takes one all-reduce a (dtype,
reduction); every other state gathers the global rows, over which
``sync_in_jit`` runs as on one process, so every value is bit for bit with a
one-process mesh of the same global rows. On the card the collectives are
NCCL's, issued by the warm-up and captured into the key's graph (a CUDA mesh
needs an NCCL group, a CPU mesh runs eagerly over gloo). Before a key's
first build the processes agree on it: one all-gather of a digest of the
key and of the units, and a mismatch raises
``StateStructureMismatchError`` on every process in place of a hang.

The JAX package's ``donate=`` has no counterpart: the rows are the graph's
own buffers, always updated in place. One process whose rows span more than
one card is refused: one CUDA graph holds one card's work.
"""

from __future__ import annotations

import functools
import hashlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
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
from torchmetrics_tpu_torch._spmd import faultinject as _faultinject
from torchmetrics_tpu_torch._spmd.specs import (
    InGraphSyncUnsupported,
    _normal,
    build_mesh,
    in_graph_sync_eligible,
    stack_default,
    validate_reductions,
)
from torchmetrics_tpu_torch._streams.manifest import predicted_state_bytes
from torchmetrics_tpu_torch._streams.pool import (
    _RING_PARTS,
    StreamPool,
    _as_tensors,
    _leaves,
    _PoolBoundExceeded,
    _Unit,
)
from torchmetrics_tpu_torch.metric import _squeeze_if_scalar, _tree_map
from torchmetrics_tpu_torch.utilities.checks import _compiled_step, _no_vmap_fallback
from torchmetrics_tpu_torch.utilities.distributed import (
    _all_gather_into,
    sync_in_jit,
    sync_in_process_group,
    validate_axis_groups,
)
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn
from torchmetrics_tpu_torch.utilities.ringbuffer import RingBuffer

__all__ = ["SpmdEngine"]

# deterministic programming errors re-raise instead of degrading (degrading
# would reduce a bug to a warning with silently diverged results)
_FATAL = (TorchMetricsUserError, TypeError, AttributeError, NameError, KeyError, IndexError)


def _how(err: BaseException) -> str:
    """``"does not trace"`` for what ``vmap`` raises on a body it cannot batch (a host read, a data-dependent shape,
    an op without a rule: the port's counterpart of the JAX package's trace-time ``JAXTypeError``), else ``"failed"``.
    """
    text = str(err)
    untraceable = isinstance(err, RuntimeError) and ("vmap" in text or "Batching rule" in text)
    return "does not trace" if untraceable else "failed"


class _GatheredRing(RingBuffer):
    """A ring state as a compute sees it after the sync: the rows' storage concatenated, with their masks.

    Each row's ring fills its own slice, so the live rows are no longer a
    prefix of the storage: :meth:`masked` returns the gathered mask, as the
    JAX package's gathered ``RingBuffer`` does. :meth:`values` and
    ``num_valid`` have a data-dependent length, which a vmapped compute
    cannot take (the JAX compute cannot under ``jit`` either): the step then
    degrades.
    """

    def __init__(self, data: Tensor, valid: Tensor, count: Tensor) -> None:
        super().__init__(int(data.shape[0]), data.device)
        self.data, self.valid, self._cursor = data, valid, count
        self._warned_overflow = True

    @property
    def num_valid(self) -> int:
        return int(self.valid.sum())

    def values(self) -> Tensor:
        return self.data[self.valid]

    def masked(self) -> Tuple[Tensor, Tensor]:
        return self.data, self.valid


class SpmdEngine:
    """Drive a Metric or MetricCollection as row-stacked states and one fused step.

    The target must be fresh (``update_count == 0``): the engine owns the
    stream from the first batch. ``step(*batch)`` takes this process's share
    of the global batch (the whole batch on a one-process mesh), whose
    tensor arguments carry a leading axis divisible by the process's rows,
    and returns the globally synced value of the stream so far, the same on
    every process of the mesh. The mesh (``specs.build_mesh``; default: one
    row over the default process group where ``torch.distributed`` is
    initialized, else every visible card) must put this process's rows on
    the target's device. ``world`` is the mesh's global row count, ``rows``
    this process's, ``rank`` its rank in the mesh's group.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch._spmd import build_mesh
        >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
        >>> eng = MeanSquaredError(device="cpu").to_spmd(mesh=build_mesh(devices=["cpu"] * 2))
        >>> eng.step(torch.tensor([1.0, 2.0, 3.0, 4.0]), torch.zeros(4))
        tensor(7.5000)
    """

    def __init__(
        self,
        target: Any,
        *,
        mesh: Any = None,
        axis_name: str = "dp",
        enforce_manifest: bool = True,
        groups: Optional[Any] = None,
    ) -> None:
        from torchmetrics_tpu_torch.collections import MetricCollection
        from torchmetrics_tpu_torch.metric import Metric

        self._collection = target if isinstance(target, MetricCollection) else None
        if self._collection is None and not isinstance(target, Metric):
            raise InGraphSyncUnsupported(
                f"SpmdEngine target must be a Metric or MetricCollection, got {type(target).__name__}"
            )
        self.target = target
        self.axis_name = axis_name
        self.mesh = mesh if mesh is not None else build_mesh(axis_name)
        if self.axis_name not in self.mesh.axis_names:
            raise InGraphSyncUnsupported(f"axis {axis_name!r} not in mesh axes {self.mesh.axis_names}")
        if len(self.mesh.axis_names) != 1:
            raise InGraphSyncUnsupported(
                "SpmdEngine shards states over a 1-D data-parallel mesh; build sub-meshes for"
                " multi-axis layouts (tp/pp state sharding composes at the model level)"
            )
        distinct = sorted({str(d) for d in self.mesh.devices})
        if len(distinct) != 1:
            raise InGraphSyncUnsupported(
                f"this process's rows of the mesh span {len(distinct)} devices ({', '.join(distinct)}); one CUDA"
                f" graph holds one card's work. Run one process a card and give each process its card's rows:"
                f" build_mesh(devices=[...], process_group=...), the collectives then run over the group."
            )
        self.device: torch.device = self.mesh.devices[0]
        self.process_group = self.mesh.process_group
        self._backend = None if self.process_group is None else dist.get_backend(self.process_group)
        if self._backend is not None and (self.device.type == "cuda") != (self._backend == "nccl"):
            raise InGraphSyncUnsupported(
                f"a mesh on {self.device} over a {self._backend!r} process group: a mesh on the card syncs over an"
                " NCCL group (its collectives are captured in the step's CUDA graph), a mesh on the CPU over"
                " a gloo group"
            )
        # the global row count, this process's rows and its rank: global row g is row g % rows of rank g // rows
        self.world = int(self.mesh.shape[self.axis_name])
        self.rows, self.rank, self.processes = self.mesh.local_rows, self.mesh.rank, self.mesh.processes
        # axis_index_groups: the in-graph process_group, disjoint equal-sized
        # groups of rows syncing independently, two data-parallel replicas in
        # ONE step; step() then returns a {group_index: value} dict
        self.groups: Optional[Tuple[Tuple[int, ...], ...]] = None
        if groups is not None:
            parsed = tuple(tuple(int(i) for i in g) for g in groups)
            try:
                validate_axis_groups(parsed, self.world)
            except ValueError as err:
                raise InGraphSyncUnsupported(
                    f"`groups` must be equal-sized disjoint subgroups partitioning the"
                    f" {self.world}-device `{axis_name}` axis: {err}"
                ) from None
            self.groups = parsed
            self._home_group = next(g for g in parsed if 0 in g)
        metrics = list(target._modules.values()) if self._collection is not None else [target]
        for m in metrics:
            facet = in_graph_sync_eligible(type(m))
            if facet in ("host_bound", "unsupported") and enforce_manifest:
                raise InGraphSyncUnsupported(
                    f"{type(m).__name__} is certified `{facet}` by the eligibility manifest's"
                    " in_graph_sync facet: it keeps the eager gather path"
                    " (`Metric.sync`). Pass enforce_manifest=False only if you know the"
                    " class traces and its reductions map onto in-graph collectives."
                )
            if facet == "unknown" and enforce_manifest:
                raise InGraphSyncUnsupported(
                    f"{type(m).__name__} is absent from the eligibility manifest (user"
                    " subclass?); the in-graph path is certified per-class. Pass"
                    " enforce_manifest=False to opt in without certification."
                )
            # the "runtime" facet (and defense in depth for "safe"): the live
            # instance's declared reductions must map onto in-graph collectives
            validate_reductions(m)
            if m._update_count != 0:
                raise InGraphSyncUnsupported(
                    f"{type(m).__name__} has already accumulated {m._update_count} update(s);"
                    " attach the SPMD engine to a fresh metric (the engine owns the stream)"
                )
            if _normal(m.device) != self.device:
                raise InGraphSyncUnsupported(
                    f"{type(m).__name__} lives on {m.device}, the mesh's rows on {self.device}: build the metric"
                    " on the mesh's device (the engine has no CPU fallback)"
                )
        # built at the first step (it learns ring shapes and compute groups)
        self._units: Optional[List[_Unit]] = None
        self._states: Optional[Dict[str, Dict[str, Any]]] = None
        self._stacked_defaults: Optional[Dict[str, Dict[str, Any]]] = None
        self._head_rows: List[int] = [0] if self.groups is None else [g[0] for g in self.groups]
        self._steps = 0
        self._degraded = False
        # key -> the step: a CapturedStep on the card, the step function on the CPU
        self._step_fns: Dict[Any, Any] = {}
        self._graph_pool: Any = None
        self._graph_constants: Dict[tuple, Tensor] = {}
        self.capture_failures: Dict[Any, str] = {}
        # key -> the collectives its step issues over the mesh's group ({"all_reduce": n, "all_gather": n}): on the
        # card those its graph captured, on the CPU those its first run issued; and the keys the processes agreed on
        self.collectives: Dict[Any, Dict[str, int]] = {}
        self._tally: Optional[Dict[str, int]] = None
        self._agreed: set = set()
        # how the last key each thread built was resolved (compiled, hit: the AOT cache, or ready), by thread id:
        # two threads warming one key at once each read their own answer
        self._built_as: Dict[int, str] = {}
        # the running step has written rows in place: a fault now cannot fold
        self._writing = False
        # SnapshotManager target surface (filled at the first step)
        self._defaults: Dict[str, Any] = {}
        self._snapshot_hook: Optional[Any] = None

    # ------------------------------------------------------------- properties
    @property
    def degraded(self) -> bool:
        """True once the engine fell back to the eager guarded-sync path."""
        return self._degraded

    @property
    def steps(self) -> int:
        return self._steps

    @property
    def _update_count(self) -> int:  # SnapshotManager count-capture surface
        return self._steps

    @_update_count.setter
    def _update_count(self, value: int) -> None:
        self._steps = int(value)

    # ------------------------------------------------------------------ step
    def step(self, *args: Any, **kwargs: Any) -> Any:
        """One fused update, sync and compute over the sharded batch.

        Returns the globally synced value (a dict keyed like
        ``MetricCollection.compute()`` for collections; with ``groups``, one
        such value a group). In degraded mode this is ``target.update(batch);
        target.compute()``, the eager path the engine replaced.
        """
        _sp = None
        if _OBS.tracing:
            # ONE span for the fused update+sync+compute; a degraded step's
            # eager fallback opens the ordinary seam spans as children
            _sp = _obs_trace.begin_span("spmd.step", type(self.target).__name__, degraded=self._degraded)
        _sp_err: Optional[BaseException] = None
        try:
            return self._step_impl(args, kwargs)
        except BaseException as err:
            _sp_err = err
            raise
        finally:
            if _sp is not None:
                _obs_trace.end_span(_sp, _sp_err)

    def _signature(self, args: tuple, kwargs: Dict[str, Any], what: str) -> Tuple[Any, ...]:
        """Check a global batch; return ``(key, treedef, dynamic, statics, sig_inputs)``."""
        from torchmetrics_tpu_torch.metric import Metric

        treedef, dynamic, statics = Metric._split_batch_args("spmd_step", args, kwargs)
        if not dynamic:
            raise TorchMetricsUserError(f"`{what}` needs at least one array argument to shard")
        for leaf in dynamic:
            if leaf.ndim < 1 or leaf.shape[0] % self.rows:
                where = "mesh size" if self.processes == 1 else "number of this process's rows of the mesh"
                raise TorchMetricsUserError(
                    f"every array argument must carry a leading batch axis divisible by the"
                    f" {where} ({self.rows}); got shape {tuple(leaf.shape)}"
                )
        on_card = self.device.type == "cuda"
        sig_inputs = tuple(
            (tuple(d.shape), d.dtype, d.device, *(_compile.layout_key(d) if on_card else ())) for d in dynamic
        )
        key = ((treedef, statics, sig_inputs), self._policies())
        return key, treedef, dynamic, statics, sig_inputs

    def _policies(self) -> tuple:
        # the step bakes in each unit's dtype policy (states cast inside
        # _traced_update), so a set_dtype between calls must build again
        return tuple(None if u.metric._dtype_policy is None else str(u.metric._dtype_policy) for u in self._units)

    def _step_impl(self, args: tuple, kwargs: Dict[str, Any]) -> Any:
        args, kwargs = _as_tensors(args, self.device), _as_tensors(kwargs, self.device)
        if self._degraded:
            return self._eager_step(args, kwargs)
        if self._units is None:
            self._prepare(args, kwargs)
            if self._degraded:  # the structure handshake degraded the transport
                return self._eager_step(args, kwargs)
        key, treedef, dynamic, statics, sig_inputs = self._signature(args, kwargs, "step")
        built = key not in self._step_fns
        obs_sample = False
        t0 = 0.0
        if _OBS.enabled:
            telem = _telemetry_for(self.target)
            if built:
                self._units[0].metric._obs_compile_event("spmd_step", treedef, statics, sig_inputs)
            obs_sample = telem.sample_due("spmd_step")
            if obs_sample:
                t0 = time.perf_counter()
        self._writing = False
        try:
            value = _faultinject.dispatch(self._run_step, key, treedef, statics, dynamic, built)
        except _FATAL:
            raise
        except Exception as err:  # noqa: BLE001 - collective/backend faults degrade
            self._degrade(f"fused step {_how(err)}: {type(err).__name__}: {err}")
            return self._eager_step(args, kwargs)
        self._writing = False
        self._steps += 1
        if _OBS.enabled:
            telem = _telemetry_for(self.target)
            telem.inc("update_calls|path=spmd")
            if obs_sample:
                telem.observe("spmd_step", time.perf_counter() - t0)
        hook = self.__dict__.get("_snapshot_hook")
        if hook is not None:
            hook.note_update()
        return self._shape_value(value)

    def _run_step(self, key: Any, treedef: Any, statics: Any, dynamic: List[Tensor], built: bool) -> Any:
        """Run the key's step on the rows: eagerly on the CPU, as a CUDA graph's replay on the card; the value, owned.

        A key's first call builds the step and runs it (on the card: on a
        side stream, then captures it); should it fail, the rows are put back
        as they were, so the fault folds. With profiling on, the first call
        counts the step's cost and later calls are timed into the ledger's
        ``spmd_step`` seam (a CUDA event pair on the card, the host clock on
        the CPU). With the AOT cache set, the build runs under its resolution
        lock and asks for the key's record first; ``_built_as`` then says how
        the key was resolved.
        """
        dyn = list(dynamic)
        cls_name = type(self.target).__name__
        if built and self.process_group is not None and key not in self._agreed:
            self._agree(key)
        if built and _AOT.active:
            from torchmetrics_tpu_torch._aot import cache as _aot_cache

            with _aot_cache.RESOLVE_LOCK:
                if key in self._step_fns:  # built by another thread while this one waited for the lock
                    self._built_as[threading.get_ident()] = "ready"
                    return self._run_step(key, treedef, statics, dyn, False)
                res = _aot_cache.wrap_executable(
                    owner=f"SpmdEngine[{cls_name}]", kind="spmd_step",
                    components=self._units[0].metric._compile_components(treedef, statics, key[0][2]),
                    extra=repr((key[1:], self.world, self.processes, self.rows, self._backend, self.axis_name,
                                [(tuple(t.shape), str(t.dtype)) for t in _leaves(self._states)])),
                    telem_obj=self.target,
                )
                return self._build(key, treedef, statics, dyn, res)
        if built:
            return self._build(key, treedef, statics, dyn, None)
        entry = self._step_fns[key]
        if isinstance(entry, _compile.CapturedStep):
            self._writing = True  # a replay writes the rows from its first kernel on
            # the replay's outputs are the graph's own buffers, which the next replay overwrites
            return _tree_map(torch.clone, entry.replay(dyn))
        t0 = time.perf_counter() if _OBS.profiling else 0.0
        out = entry(self._states, dyn)
        if _OBS.profiling:
            _PROF_LEDGER.record_step("spmd_step", cls_name, time.perf_counter() - t0)
        return self._own(out)

    def _build(self, key: Any, treedef: Any, statics: Any, dyn: List[Tensor], res: Any) -> Any:
        """Build the key's step, run it once (on the card, the warm-up before its capture); ``res``: the AOT cache's word."""
        cls_name = type(self.target).__name__
        step = self._build_step(treedef, statics)
        on_card = self.device.type == "cuda"
        saved = _tree_map(torch.clone, self._states)
        t0 = time.perf_counter()
        self._tally = {}
        if on_card:  # the warm-up before the capture: this batch's update
            first = functools.partial(_compile.warm_up, step, self._states, dyn, self.device, self._graph_constants)
        else:
            first = functools.partial(step, self._states, dyn)
        tally = None
        try:
            if _OBS.profiling and (res is None or res.counting):
                with _obs_costs.count_costs(dyn, self._states) as tally:
                    out = first()
                    _obs_costs.add_output_bytes(tally, out)
            else:
                out = first()
        except BaseException:
            # a key's first run is undone: the rows go back to what the last step left
            if on_card:
                torch.cuda.synchronize(self.device)
            for live, old in zip(_leaves(self._states), _leaves(saved)):
                live.copy_(old)
            self._writing = False
            self._tally = None
            raise
        del saved
        out = self._own(out)
        warm, self._tally = self._tally, {}
        self._step_fns[key] = entry = self._capture(key, step, dyn) if on_card else step
        self.collectives[key] = self._tally if isinstance(entry, _compile.CapturedStep) else warm
        self._tally = None
        self._writing = False  # the capture ran the step's Python, and wrote nothing
        seconds = time.perf_counter() - t0
        if _OBS.enabled:
            telem = _telemetry_for(self.target)
            telem.inc("trace_seconds", seconds)
            telem.observe("trace", seconds)
        if _OBS.profiling:
            _PROF_LEDGER.note_executable(
                owner=f"SpmdEngine[{cls_name}]",
                kind="spmd_step",
                digest=hashlib.sha256(
                    repr((key, self.world, self.processes, self.rows, self.axis_name)).encode()
                ).hexdigest(),
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

        The warm-up already applied this batch, so a failure loses only the
        replay's speed, as in the stream pool: ``capture_failures`` records
        it, a warning names the key, and with telemetry on an
        ``auto_path_disabled`` counter and bus event name the ``spmd_step``
        seam. The engine's graphs share one memory pool; a capture that
        leaves it above ``_compile._pool_bound`` or runs out of memory drops
        every graph of the engine (the other keys capture again at their next
        call).
        """
        try:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            entry = _compile.CapturedStep(step, self._states, dyn, self._graph_pool, self.device, self._graph_constants)
            held, bound = _compile.pool_bytes(self._graph_pool), _compile._pool_bound(self.device)
            if held > bound:
                del entry
                raise _PoolBoundExceeded(f"the engine's graphs hold {held} bytes of the card, over the bound of {bound}")
        except Exception as err:  # noqa: BLE001 - any capture fault leaves the key eager, reported below
            if isinstance(err, (_PoolBoundExceeded, torch.cuda.OutOfMemoryError)):
                self._drop_steps()
            reason = f"{type(err).__name__}: {err}"
            self.capture_failures[key] = reason
            cls_name = type(self.target).__name__
            rank_zero_warn(
                f"SpmdEngine[{cls_name}]: the step of key {key!r} did not capture into a CUDA graph ({reason});"
                " that key runs eagerly from now on (see `capture_failures`)."
            )
            if _OBS.enabled:
                _telemetry_for(self.target).inc("auto_path_disabled")
                _BUS.publish(
                    "auto_path_disabled", f"SpmdEngine[{cls_name}]", reason,
                    data={"seam": "spmd_step", "key": repr(key)},
                )
            return step
        entry.seam, entry.owner = "spmd_step", type(self.target).__name__
        return entry

    def _drop_steps(self) -> None:
        """Forget every step and graph; the next step of each key builds afresh."""
        self._step_fns.clear()
        self._graph_pool = None
        self._graph_constants = {}

    def _own(self, value: Any) -> Any:
        """``value`` with every tensor that shares storage with a row copied (later steps write there)."""
        held = {s.untyped_storage().data_ptr() for s in _leaves(self._states)}
        return _tree_map(lambda v: v.clone() if v.untyped_storage().data_ptr() in held else v, value)

    def compute(self) -> Any:
        """Sync and compute on the current rows (no update), eagerly; across processes, on every process together."""
        if self._degraded or self._units is None:
            return self.target.compute()
        try:
            with torch.no_grad():
                value = self._own(_faultinject.dispatch(self._sync_compute, self._states))
        except _FATAL:
            raise
        except Exception as err:  # noqa: BLE001
            # a restore before any step can meet a host-reading compute here first: the
            # class's problem, not the caller's, so it degrades as step() does
            self._degrade(f"fused compute {_how(err)}: {type(err).__name__}: {err}")
            return self.target.compute()
        return self._shape_value(value)

    def warm_start(self, *args: Any, **kwargs: Any) -> Dict[str, str]:
        """Build the step for this example-batch signature without consuming a batch.

        The example batch must be shaped like real traffic (leading axis
        divisible by this process's rows; across processes, every process
        warms the same signature together). The step runs once on it and the rows
        are put back as they were (on the card that run is the warm-up before
        the key's CUDA graph is captured, and the first real :meth:`step` of
        the signature replays); the step count does not advance. Returns
        ``{"spmd_step": "compiled"}`` when the step was built now, ``"hit"``
        when it was built now on a verified AOT cache record (the record was
        found, and every kernel library it names was loaded from ``_build/``
        or the cache with no ``nvcc``; the warm-up and the capture still run
        here, see ``_aot/cache.py``), ``"ready"`` when this engine had built
        it already (where the JAX package answers ``"hit"``). ``spmd_compute``
        reads ``"ready"``: it runs eagerly, where the JAX package's is an
        executable. Both read ``"degraded"`` on a degraded engine.
        """
        degraded = {"spmd_step": "degraded", "spmd_compute": "degraded"}
        if self._degraded:
            return degraded
        args, kwargs = _as_tensors(args, self.device), _as_tensors(kwargs, self.device)
        if self._units is None:
            self._prepare(args, kwargs)
            if self._degraded:
                return degraded
        key, treedef, dynamic, statics, sig_inputs = self._signature(args, kwargs, "warm_start")
        outcomes = {"spmd_step": "ready", "spmd_compute": "ready"}
        if key in self._step_fns:
            return outcomes
        if _OBS.enabled:
            self._units[0].metric._obs_compile_event("spmd_step", treedef, statics, sig_inputs)
        saved = _tree_map(torch.clone, self._states)
        self._writing = False
        try:
            self._run_step(key, treedef, statics, dynamic, True)
        except _FATAL:
            raise
        except Exception as err:  # noqa: BLE001 - as step() degrades
            self._degrade(f"fused step {_how(err)}: {type(err).__name__}: {err}")
            return degraded
        finally:
            for live, old in zip(_leaves(self._states or {}), _leaves(saved)):
                live.copy_(old)  # the example batch is not part of the stream
        outcomes["spmd_step"] = self._built_as.pop(threading.get_ident(), "compiled")
        return outcomes

    def _shape_value(self, value: Dict[str, Any]) -> Any:
        """Host-facing result: each member's value of the head rows, flattened for collections; per group with groups.

        ``value`` maps member names to values with a leading axis of one
        entry a head row (one without groups).
        """

        def shaped(i: int) -> Any:
            v = _tree_map(lambda x, _i=i: x[_i], value)
            return v[""] if self._collection is None else self._collection._flatten_results(v)

        if self.groups is None:
            return shaped(0)
        return {gi: shaped(gi) for gi in range(len(self.groups))}

    def reset(self) -> None:
        """Reset the rows (in place: a graph's buffers stay its own) and the host target to the defaults."""
        self._steps = 0
        if self._states is not None and self._stacked_defaults is not None:
            for state, default in zip(_leaves(self._states), _leaves(self._stacked_defaults)):
                state.copy_(default)
        self.target.reset()

    # ------------------------------------------------------------ degradation
    def _degrade(self, detail: str) -> None:
        """Fold the rows into the host target; future steps go eager.

        The fold merges each state's rows with its own declared reduction,
        what a successful sync would have produced, so the eager stream
        resumes without losing a batch. One fault cannot fold: a step that
        had begun writing the rows in place when it failed (a replay, whose
        kernels write from the first on; the JAX package's counterpart is a
        failed execution that consumed its donated buffers). The stream then
        restarts from the defaults, says so in the degradation event, and
        points at the SnapshotManager, whose boundary snapshots bound this
        loss.
        """
        folded = False
        if self._units is not None and self._states is not None:
            if self._writing:
                detail += (
                    f"; the failed step had already begun writing the rows in place (the counterpart of"
                    f" consumed donated state buffers) — {self._steps} fused step(s) of accumulation are lost"
                    " and the eager stream restarts from defaults (an attached SnapshotManager bounds this:"
                    " restore_latest() returns to the newest snapshot boundary)"
                )
                self._steps = 0
                self.target.reset()
            else:
                try:
                    for unit in self._units:
                        self._fold_unit_to_host(unit)
                    if self._collection is not None:
                        self._collection._sync_compute_groups()
                    folded = True
                    if self.groups is not None:
                        detail += (
                            f"; axis_index_groups were active — the host target can carry"
                            f" only one stream, so the fold merged the home replica group"
                            f" (devices {list(self._home_group)}) and the other groups'"
                            " accumulation stays on their processes"
                        )
                    if self.process_group is not None:
                        detail += (
                            f"; the mesh spans a group of {self.processes} process(es): this one folded its own"
                            " rows, and the eager continuation's compute() syncs over the mesh's process group"
                        )
                except Exception as fold_err:  # noqa: BLE001 - degrade must never crash
                    detail += (
                        f"; folding device states back failed too"
                        f" ({type(fold_err).__name__}: {fold_err}) — the eager stream"
                        " restarts from defaults"
                    )
                    self._steps = 0
                    self.target.reset()
        hook = self.__dict__.get("_snapshot_hook")
        if hook is not None:
            # the manager snapshots THROUGH the engine's state_dict, which
            # needs live rows: capture one final boundary while they exist,
            # then pause (the eager continuation is outside the reach of a
            # manager targeting the engine, and that must be said, not
            # discovered at restore time)
            if folded:
                try:
                    hook.snapshot_now(_inline=True)
                except Exception:  # noqa: BLE001 - durability must not break the degrade
                    pass
            hook.pause()
            detail += (
                "; the attached SnapshotManager captured a final boundary snapshot and"
                " was PAUSED (it snapshots the fused device states, which no longer"
                " exist) — attach a manager to the target metric for eager-path"
                " durability"
                if folded
                else "; the attached SnapshotManager was PAUSED (no device states left"
                " to snapshot) — attach a manager to the target metric for eager-path"
                " durability"
            )
        if self.process_group is not None:
            for m in list(self.target._modules.values()) if self._collection is not None else [self.target]:
                m.process_group = self.process_group
        self._degraded = True
        self._writing = False
        self._states = None
        self._drop_steps()
        primary = self._units[0].metric if self._units else (
            next(iter(self.target._modules.values())) if self._collection is not None else self.target
        )
        primary._record_degradation("spmd_degraded", detail=f"{detail}; falling back to the eager guarded sync path")

    def _eager_step(self, args: tuple, kwargs: Dict[str, Any]) -> Any:
        self.target.update(*args, **kwargs)
        self._steps += 1
        return self.target.compute()

    def _fold_unit_to_host(self, unit: _Unit) -> None:
        m = unit.metric
        states = self._states[unit.key]
        # this process's rows; under axis_index_groups each group is an
        # independent replica, and the host target can carry only one stream,
        # so the fold merges this process's rows of the HOME group (the one
        # holding global row 0) and says so in the event detail
        lo = self.rank * self.rows
        if self.groups is None:
            devs = list(range(self.rows))
        else:
            devs = [g - lo for g in self._home_group if lo <= g < lo + self.rows]
        if not devs:  # none of the home group's rows lie on this process
            m.reset()
            return
        gathered: Dict[str, Tensor] = {}  # dist_reduce_fx=None states fold together
        for n in unit.names:
            red = m._reductions[n]
            if n in unit.rings:
                st = states[n]
                # a group-capacity buffer, as the sync's gather gives: folding
                # len(devs) * cap rows into a cap-sized ring would drop rows
                rb = RingBuffer(unit.rings[n] * len(devs), m.device)
                for d in devs:
                    rows = st["data"][d][st["valid"][d]]
                    if rows.shape[0]:
                        rb.append(rows)
                object.__setattr__(m, n, rb)
                continue
            stacked = torch.stack([states[n][d] for d in devs])
            if red == "sum":
                merged = stacked.sum(0, dtype=stacked.dtype)
            elif red == "mean":
                merged = stacked.sum(0, dtype=stacked.dtype) / len(devs)
            elif red == "max":
                merged = stacked.amax(0)
            elif red == "min":
                merged = stacked.amin(0)
            else:  # None: gather-stack; validate_reductions admitted nothing else
                gathered[n] = stacked
                continue
            object.__setattr__(m, n, merged)
        if gathered:
            # gather states have no per-state reduction: the class folds its
            # gathered moment sets back into local form (PearsonCorrCoef's
            # `_fold_gathered_states`), or the stacked (D, *s) form binds as
            # it is, the eager post-sync shape its compute already takes
            fold = getattr(m, "_fold_gathered_states", None)
            if callable(fold):
                gathered = fold(gathered)
            for n, v in gathered.items():
                object.__setattr__(m, n, v)
        m._update_count = self._steps * len(devs)
        m._computed = None

    def sync_to_target(self) -> Any:
        """Fill the host target from this process's rows (reduction-merged), a read: the engine keeps streaming.

        After it, ``target.compute()``/``state_dict()`` observe this
        process's share of the stream so far (on a one-process mesh: all of
        it).
        """
        if self._units is not None and self._states is not None:
            for unit in self._units:
                self._fold_unit_to_host(unit)
            if self._collection is not None:
                self._collection._sync_compute_groups()
        return self.target

    # ----------------------------------------------------------- preparation
    def _prepare(self, args: tuple, kwargs: Dict[str, Any]) -> None:
        from copy import deepcopy

        probe = None
        if self._collection is not None or any(
            isinstance(getattr(m, n), RingBuffer)
            for m in ([self.target] if self._collection is None else self.target._modules.values())
            for n in m._defaults
        ):
            # one shard-sized eager probe on a throwaway copy: learns ring row
            # shapes, and for collections forms the compute groups the step
            # shares (group detection needs post-update states)
            probe = deepcopy(self.target)
            # 0-d leaves pass through unsliced: the signature check right
            # after this probe rejects them with the leading-axis message
            shard_args, shard_kwargs = _tree_map(
                lambda x: x[: max(1, x.shape[0] // self.rows)] if x.ndim >= 1 else x, (args, kwargs)
            )
            probe.update(*shard_args, **shard_kwargs)

        units: List[_Unit] = []
        if self._collection is not None:
            groups = probe._groups  # formed by the probe update
            # adopt the probe's grouping: heads drive the step, members
            # rebind from their head at fold boundaries
            self._collection._groups = {i: list(g) for i, g in groups.items()}
            self._collection._groups_checked = True
            for g in groups.values():
                head_key = g[0]
                head = self.target._modules[head_key]
                members = [(name, self.target._modules[name]) for name in g]
                units.append(self._make_unit(head_key, head, members, probe._modules[head_key]))
        else:
            units.append(self._make_unit("", self.target, [("", self.target)], probe))

        # resilience: the structure digest checked once, before the first step
        self._handshake_at_trace(units)
        if self._degraded:
            return
        self._units = units
        self._install_stacked_defaults(units)
        self._states = _tree_map(torch.clone, self._stacked_defaults)
        if _OBS.enabled:
            per_device = self.predicted_device_bytes()
            if per_device is not None:
                _telemetry_for(self.target).set_gauge("predicted_state_bytes|scope=spmd_device", per_device)

    def predicted_device_bytes(self) -> Optional[float]:
        """Closed-form predicted state bytes this process's device holds (its rows), or ``None``.

        Each row holds ONE replica of every registered state, the class's
        closed-form F (read from the memory model, ``_memory.json``, in the
        port's dtypes, on the template instances), and the device holds this
        process's rows of the mesh: ``rows * F``, whatever the number of
        processes. ``None`` when the model makes no exact finite claim
        (absent entry, opaque verdict, or an unbounded cat list without
        ``cat_state_capacity``): the telemetry gauge stands down rather than
        publish a guess.
        """
        metrics = list(self.target._modules.values()) if self._collection is not None else [self.target]
        total = 0.0
        for m in metrics:
            pred = predicted_state_bytes(m)
            if pred is None or not pred.exact or pred.bytes == float("inf"):
                return None
            total += pred.bytes
        return total * self.rows

    def _install_stacked_defaults(self, units: List[_Unit]) -> None:
        """Build ``_stacked_defaults`` and the flat ``_defaults`` mirror (ring row shapes from ``unit.ring_rows``).

        The fresh path learns ring rows from the probe, the restore path from
        the restored leaves; everything else is identical and must STAY
        identical (a layout change in one path would make a restore diverge
        from the fresh stream).
        """
        self._stacked_defaults, self._defaults = {}, {}
        dev, rows = self.device, self.rows
        for unit in units:
            defaults: Dict[str, Any] = {}
            for n in unit.names:
                if n in unit.rings:
                    row_shape, row_dtype = unit.ring_rows[n]
                    cap = unit.rings[n]
                    defaults[n] = {
                        "data": torch.zeros((rows, cap, *row_shape), dtype=row_dtype, device=dev),
                        "valid": torch.zeros((rows, cap), dtype=torch.bool, device=dev),
                        "count": torch.zeros((rows,), dtype=torch.int64, device=dev),
                    }
                else:
                    defaults[n] = stack_default(unit.metric._defaults[n].to(dev), rows)
            self._stacked_defaults[unit.key] = defaults
            pre = f"{unit.key}." if unit.key else ""
            for n in unit.names:
                if n in unit.rings:
                    for part in _RING_PARTS:
                        self._defaults[f"{pre}{n}#{part}"] = defaults[n][part]
                else:
                    self._defaults[f"{pre}{n}"] = defaults[n]

    def _make_unit(self, key: str, metric: Any, members: List[Tuple[str, Any]], probe: Any) -> _Unit:
        names = list(metric._defaults)
        rings: Dict[str, int] = {}
        ring_rows: Dict[str, Tuple[tuple, Any]] = {}
        for n in names:
            state = getattr(metric, n)
            if isinstance(state, RingBuffer):
                rings[n] = state.capacity
                warmed = getattr(probe, n) if probe is not None else None
                if not isinstance(warmed, RingBuffer) or not warmed.initialized:
                    raise TorchMetricsUserError(f"ring state `{n}` row shape could not be learned from the first batch")
                ring_rows[n] = (tuple(int(s) for s in warmed.data.shape[1:]), warmed.data.dtype)
        return _Unit(key=key, metric=metric, members=members, names=names, rings=rings, ring_rows=ring_rows)

    def _handshake_at_trace(self, units: List[_Unit]) -> None:
        from torchmetrics_tpu_torch._resilience.guard import handshake_at_trace

        for unit in units:
            if not handshake_at_trace(unit.metric):
                # the transport degraded during the handshake: never build a
                # step, the eager guarded path owns the stream from the start
                self._degrade("trace-time structure handshake degraded")
                return

    def _agree(self, key: Any) -> None:
        """Before a key's first build, the processes of the mesh's group agree on it, or every one of them raises.

        A collective that one process enters and another does not is a hang,
        and two different steps issue different collectives. So one small
        all-gather over the group, outside any graph, carries a digest of what
        fixes the step's collectives: the key's batch (argument structure,
        statics, shapes and dtypes), the units' dtype policies, and the units
        (heads, members, state names, dtypes, shapes and ring capacities; each
        process forms its compute groups from its own probe batch). Where the
        digests differ, every process gathers the descriptions and raises
        :class:`StateStructureMismatchError` naming what differs, before
        anything is built. Once a key: a key rebuilt after its graph was
        dropped issues the same collectives as the other processes' replays.
        """
        from torchmetrics_tpu_torch._resilience.errors import StateStructureMismatchError

        (treedef, statics, sig_inputs), policies = key
        parts = {
            "batch": repr((treedef, statics, [(shape, str(dtype)) for shape, dtype, *_ in sig_inputs])),
            "dtype policies": repr(policies),
            "units": repr([
                (u.key, [name for name, _ in u.members], dict(u.rings),
                 [(n, [(tuple(t.shape[1:]), str(t.dtype)) for t in _leaves(self._stacked_defaults[u.key][n])])
                  for n in u.names])
                for u in self._units
            ]),
        }
        mine = torch.frombuffer(bytearray(hashlib.sha256(repr(parts).encode()).digest()), dtype=torch.uint8)
        mine = mine.to(self.device)
        everyone = mine.new_empty((self.processes * mine.numel(),))
        _all_gather_into(everyone, mine, self.process_group)
        if bool((everyone.view(self.processes, -1) == mine).all()):
            self._agreed.add(key)
            return
        described: List[Any] = [None] * self.processes
        dist.all_gather_object(described, parts, group=self.process_group)
        differ = [k for k in parts if len({d[k] for d in described}) > 1]
        raise StateStructureMismatchError(
            f"SpmdEngine[{type(self.target).__name__}]: the {self.processes} processes of the mesh would build"
            f" different steps for this batch, whose collectives would not match; "
            + "; ".join(
                f"the {k} differ: " + ", ".join(f"rank {r} {d[k][:200]}" for r, d in enumerate(described))
                for k in differ
            )
        )

    # ------------------------------------------------------------------ steps
    def _row_states(self, unit: _Unit, row: Dict[str, Any]) -> Dict[str, Any]:
        """One row's states as the metric holds them: each ring state rebuilt into a :class:`RingBuffer`.

        The row's ring count is the ring's device cursor, where its appends
        write (``ring_push``).
        """
        local = {}
        for n in unit.names:
            if n in unit.rings:
                s = row[n]
                ring = RingBuffer(unit.rings[n], self.device)
                ring.data = s["data"]
                ring._cursor = s["count"]
                ring._warned_overflow = True  # a row cannot warn for its own stream
                local[n] = ring
            else:
                local[n] = row[n]
        return local

    def _build_step(self, treedef: Any, statics: Any) -> Callable:
        """The step of one key: ``step(states, batch) -> values``.

        Views each batch tensor's leading axis as ``(R, B/R)`` for this
        process's ``R`` rows, vmaps each row's real update over the stacked
        states with the per-lane fallback off, writes the rows in place, then
        syncs and computes (:meth:`_sync_compute`).
        """
        from torchmetrics_tpu_torch.metric import Metric

        units, rows_n = self._units, self.rows

        def row_update(row_states: Dict[str, Dict[str, Any]], dyn: Tuple[Tensor, ...]) -> Dict[str, Dict[str, Any]]:
            a, kw = Metric._merge_batch_args(treedef, list(dyn), statics)
            new: Dict[str, Dict[str, Any]] = {}
            for unit in units:
                m = unit.metric
                kw_m = m._filter_kwargs(**kw) if kw else kw
                local = self._row_states(unit, row_states[unit.key])
                new[unit.key] = StreamPool._lane_leaves(unit, m._traced_update(unit.names, local, a, kw_m))
            return new

        def step(states: Dict[str, Dict[str, Any]], dyn: List[Tensor]) -> Dict[str, Any]:
            with torch.no_grad(), _compiled_step():
                rows = tuple(d.reshape(rows_n, d.shape[0] // rows_n, *d.shape[1:]) for d in dyn)
                with _no_vmap_fallback():
                    new = torch.func.vmap(row_update)(states, rows)
                self._writing = True
                for s, v in zip(_leaves(states), _leaves(new)):
                    if v.data_ptr() != s.data_ptr() or v.stride() != s.stride():  # B1's rule added in place
                        s.copy_(v)
                return self._sync_compute(states)

        return step

    def _sync_compute(self, states: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        """Each member's value from the synced rows: ``{name: value}`` with one leading entry a head row.

        Across processes the sync's collectives cover every unit at once
        (``sync_in_process_group``), and the synced rows are the global ones.
        """
        reductions = [{n: u.metric._reductions[n] for n in u.names} for u in self._units]
        if self.process_group is None:
            synced_units = [
                sync_in_jit(states[u.key], r, self.axis_name, axis_index_groups=self.groups)
                for u, r in zip(self._units, reductions)
            ]
        else:
            synced_units = sync_in_process_group(
                [states[u.key] for u in self._units], reductions, self.process_group, self.axis_name,
                axis_index_groups=self.groups, tally=self._tally,
            )
        values: Dict[str, Any] = {}
        for unit, synced in zip(self._units, synced_units):
            # the head rows by integer index (a view, or a stack): no index tensor comes from the host
            if self.groups is None:
                heads = _tree_map(lambda s: s[:1], synced)
            else:
                heads = _tree_map(lambda s: torch.stack([s[i] for i in self._head_rows]), synced)
            with _no_vmap_fallback():
                values.update(torch.func.vmap(functools.partial(self._member_values, unit))(heads))
        return values

    def _member_values(self, unit: _Unit, synced: Dict[str, Any]) -> Dict[str, Any]:
        """One head row's member values from its synced states (members read their head's states)."""
        local = {}
        for n in unit.names:
            s = synced[n]
            local[n] = _GatheredRing(s["data"], s["valid"], s["count"]) if n in unit.rings else s
        return {name: _squeeze_if_scalar(member._traced_compute(unit.names, local)) for name, member in unit.members}

    # ----------------------------------------------- snapshot/restore surface
    def state_dict(
        self,
        destination: Optional[Dict] = None,
        prefix: str = "",
        keep_vars: bool = False,
        integrity: bool = False,
        all_states: bool = False,
        _host: bool = True,
    ) -> Dict:
        """Host numpy copies of this process's rows, plus the ``#spmd`` skeleton.

        The SnapshotManager calls this at snapshot boundaries; between
        boundaries the rows never leave the device. The reserved
        ``{prefix}#spmd`` block records the mesh's layout (global rows, this
        process's rows, the number of processes and this one's rank) and the
        unit skeleton, so a fresh engine of the same layout can restore
        without having seen a batch.
        """
        if self._units is None or self._states is None:
            raise TorchMetricsUserError("SpmdEngine has no device states yet (no step() has run)")
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
        destination[prefix + "#spmd"] = {
            "world": self.world,
            "rows": self.rows,
            "processes": self.processes,
            "rank": self.rank,
            "axis": self.axis_name,
            "groups": None if self.groups is None else [list(g) for g in self.groups],
            "units": [
                {"key": u.key, "members": [name for name, _ in u.members], "names": list(u.names), "rings": dict(u.rings)}
                for u in self._units
            ],
        }
        if integrity:
            _integrity.attach_integrity(destination, keys, prefix, type(self).__name__)
        return destination

    def load_state_dict(self, state_dict: Dict, strict: Any = True, prefix: str = "") -> None:
        """Put checkpointed rows back on the mesh's device (same layout: rows, processes, rank and axis)."""
        meta = state_dict.get(_integrity.integrity_key(prefix))
        if meta is not None:
            corrupted = _integrity.verify_states(
                state_dict, prefix, meta, type(self).__name__, include_missing=strict is not False
            )
            if corrupted:
                _integrity.raise_corrupted(type(self).__name__, corrupted)
        blk = state_dict.get(prefix + "#spmd")
        if blk is None:
            raise TorchMetricsUserError("checkpoint lacks the `#spmd` block (not an SpmdEngine snapshot)")
        taken = self._layout(
            int(blk["world"]), int(blk.get("rows", blk["world"])), int(blk.get("processes", 1)),
            int(blk.get("rank", 0)), blk["axis"],
        )
        live = self._layout(self.world, self.rows, self.processes, self.rank, self.axis_name)
        if taken != live:
            raise TorchMetricsUserError(
                f"snapshot was taken on {taken}; this engine runs {live} — donated states restore only onto"
                " an identical mesh layout"
            )
        snap_groups = blk.get("groups")
        live_groups = None if self.groups is None else [list(g) for g in self.groups]
        if snap_groups != live_groups:
            raise TorchMetricsUserError(
                f"snapshot was taken with axis_index_groups={snap_groups!r}; this engine runs"
                f" {live_groups!r} — per-group replica accumulation only restores onto the"
                " same group partition"
            )
        if self._units is None:
            self._rebuild_units(blk)
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
        if same:
            # a captured graph reads and writes the rows' memory: the snapshot is copied in
            for live, new in zip(_leaves(self._states), _leaves(states)):
                live.copy_(new)
        else:
            self._states = states
            self._drop_steps()
        if self._stacked_defaults is None:
            # a restore before the first step skipped _prepare: derive the
            # stacked defaults now (plain states from the metric's registered
            # defaults, ring rows from the restored leaves) so reset() has
            # something to reset TO
            for unit in self._units:
                for n in unit.rings:
                    data = self._states[unit.key][n]["data"]
                    unit.ring_rows[n] = (tuple(int(s) for s in data.shape[2:]), data.dtype)
            self._install_stacked_defaults(self._units)

    @staticmethod
    def _layout(world: int, rows: int, processes: int, rank: int, axis: str) -> str:
        """A mesh layout as a restore names it."""
        return f"a {world}-device `{axis}` mesh ({processes} process(es) x {rows} rows, rank {rank})"

    def _rebuild_units(self, blk: Dict[str, Any]) -> None:
        """The unit skeleton from a checkpoint's ``#spmd`` block (a restore before the first step)."""
        units: List[_Unit] = []
        for u in blk["units"]:
            key = u["key"]
            metric = self.target._modules[key] if self._collection is not None else self.target
            members = (
                [(name, self.target._modules[name]) for name in u["members"]]
                if self._collection is not None
                else [("", self.target)]
            )
            units.append(_Unit(key=key, metric=metric, members=members, names=list(u["names"]), rings=dict(u["rings"])))
        if self._collection is not None:
            self._collection._groups = {i: list(u["members"]) for i, u in enumerate(blk["units"])}
            self._collection._groups_checked = True
        self._units = units
        # the stacked defaults are derived by load_state_dict once the
        # restored leaves are in hand (ring row shapes come from them)
        self._stacked_defaults = None
