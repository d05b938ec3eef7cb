"""Core metric runtime.

Port of ``torchmetrics_tpu/metric.py`` (parity target: reference
``torchmetrics/metric.py``). A metric is a ``torch.nn.Module`` whose states
are plain tensor attributes (or Python lists of tensors for append-mode "cat"
states) registered with :meth:`Metric.add_state` on an explicit device:

- ``update`` accumulates into the states; tensor states are updated in place
  (``state += batch``), where the JAX package rebinds immutable arrays, so a
  stream holds one copy of each state and no per-update allocation for it;
- ``_reduce_states`` (cross-batch merge in ``forward`` and ``merge_state``)
  and ``sync`` (cross-process merge over ``torch.distributed``) apply the same
  per-state ``dist_reduce_fx``;
- with ``cat_state_capacity=N`` every list state declared with ``"cat"`` or
  ``None`` is a :class:`RingBuffer` of ``N`` rows instead of an unbounded list;
- a ``MetricCollection`` lets the members of a compute group hold the group
  head's state tensors; such a metric copies its states before its next own
  ``update`` writes into them (copy on write), so an in-place write never
  reaches another metric.

A metric built without ``device=`` keeps its states on ``cuda`` and raises
where no GPU is present; it never falls back to the CPU on its own.

With ``auto_compile=True`` (the default, JAX ``metric.py:182``) every
``update``/``forward`` whose argument signature was seen before runs one
compiled step (``_compile.py``): a CUDA graph captured once per signature
and replayed on a CUDA metric, the same step run eagerly on a CPU metric.
The first call with each signature runs the plain update with its eager
checks; ``validate_args=True`` value checks then run fused in the step as a
device flag vector that is read back at the next eager update, ``compute()``
or ``reset()`` (:meth:`Metric._check_pending_violations`).
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import inspect
import itertools
import time
import warnings
from abc import ABC, abstractmethod
from copy import deepcopy
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor, nn

from torchmetrics_tpu_torch import _compile
# module scope (not inside `_fingerprint_exempt`): the exemption check sits on
# the eager per-update hot path; manifest.py imports the standard library only
from torchmetrics_tpu_torch._analysis.manifest import fingerprint_skip_allowed
from torchmetrics_tpu_torch._aot.state import AOT as _AOT

# telemetry hot switches (``_observability/state.py``): `_OBS.enabled`,
# `_OBS.tracing` and `_OBS.profiling` are the one check each seam pays while
# its switch is off, a slot load and a branch; everything else lives behind it
from torchmetrics_tpu_torch._observability import costs as _obs_costs
from torchmetrics_tpu_torch._observability import scopes as _obs_scopes
from torchmetrics_tpu_torch._observability import tracing as _obs_trace
from torchmetrics_tpu_torch._observability.events import BUS as _BUS
from torchmetrics_tpu_torch._observability.profiling import LEDGER as _PROF_LEDGER
from torchmetrics_tpu_torch._observability.state import OBS as _OBS
from torchmetrics_tpu_torch._observability.telemetry import telemetry_for as _telemetry_for
from torchmetrics_tpu_torch._resilience import integrity as _integrity
from torchmetrics_tpu_torch._resilience import policy as _res_policy
from torchmetrics_tpu_torch.utilities.checks import _compiled_step
from torchmetrics_tpu_torch.utilities.data import (
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
)
from torchmetrics_tpu_torch.utilities.distributed import distributed_available as _default_distributed_available
from torchmetrics_tpu_torch.utilities.distributed import gather_all_tensors, sync_in_jit
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError, TorchMetricsUserWarning
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn
from torchmetrics_tpu_torch.utilities.ringbuffer import RingBuffer

State = Union[Tensor, List[Tensor], RingBuffer]

_UNSET = object()  # `set_resilience_policy`: an argument not passed

_STR_REDUCTIONS = {
    "sum": dim_zero_sum,
    "mean": dim_zero_mean,
    "max": dim_zero_max,
    "min": dim_zero_min,
    "cat": dim_zero_cat,
}


def _resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    if device is not None:
        device = torch.device(device)
        # `cuda` names the current card: give it its index, as a tensor's device has one (the compiled
        # path takes a batch whose device equals the metric's)
        if device.type == "cuda" and device.index is None and torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device is available, and metric states live on `cuda` unless a device is given."
            ' Pass `device="cpu"` to keep them on the CPU.'
        )
    return torch.device("cuda", torch.cuda.current_device())


_MEMORY_FORMATS = {4: torch.channels_last, 5: torch.channels_last_3d}


def _device_move(fn: Callable[[Tensor], Tensor], device: torch.device) -> Tuple[Callable[[Tensor], Tensor], torch.device]:
    """The device-only part of a ``Module._apply`` function, and its destination device.

    ``fn`` runs once on small probes from ``device``: its output's device is
    the destination, and the layout it gives a contiguous and a channels-last
    probe of 4 or 5 dimensions is the layout (kept, channels-last or
    contiguous) the move gives every tensor of that rank. The move applies
    those and no dtype, so no value goes through a cast.
    """
    dst = fn(torch.zeros(1, device=device)).device
    formats = {}
    for ndim, fmt in _MEMORY_FORMATS.items():
        probe = torch.zeros((1, 2, 3, 4, 5)[:ndim], device=device)
        try:
            from_plain, from_fmt = fn(probe), fn(probe.contiguous(memory_format=fmt))
        except RuntimeError:  # a layout of the other rank (channels_last asked of a 5-D tensor)
            continue
        if from_plain.is_contiguous(memory_format=fmt) and not from_plain.is_contiguous():
            formats[ndim] = fmt
        elif from_fmt.is_contiguous() and not from_fmt.is_contiguous(memory_format=fmt):
            formats[ndim] = torch.contiguous_format

    def move(t: Tensor) -> Tensor:
        fmt = formats.get(t.dim())
        return t.to(dst) if fmt is None else t.to(dst, memory_format=fmt)

    return move, dst


def _squeeze_if_scalar(data: Any) -> Any:
    """Squeeze 1-element tensors to 0-d (reference ``utilities/data.py`` helper)."""
    if isinstance(data, Tensor) and data.numel() == 1 and data.ndim > 0:
        return data.squeeze()
    return data


def _flatten_args(tree: Any, leaves: List[Any]) -> Any:
    """Hashable structure of nested tuples, lists and dicts; the leaves are appended to ``leaves``."""
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_flatten_args(x, leaves) for x in tree))
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return ("dict", keys, tuple(_flatten_args(tree[k], leaves) for k in keys))
    leaves.append(tree)
    return None


def _unflatten_args(treedef: Any, leaves: Any) -> Any:
    if treedef is None:
        return next(leaves)
    if treedef[0] == "dict":
        return {k: _unflatten_args(t, leaves) for k, t in zip(treedef[1], treedef[2])}
    items = [_unflatten_args(t, leaves) for t in treedef[1]]
    return tuple(items) if treedef[0] == "tuple" else items


def _tree_map(fn: Callable[[Tensor], Any], tree: Any) -> Any:
    """Apply ``fn`` to every tensor of a nested tuple/list/dict value."""
    if isinstance(tree, Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _poison(bad: Tensor, value: Tensor) -> Tensor:
    """A violating batch's value: NaN for floats, the type's least value for integers (JAX ``metric.py:1890``)."""
    if value.is_floating_point() or value.is_complex():
        return torch.where(bad, float("nan"), value)
    if value.dtype != torch.bool:
        return torch.where(bad, torch.iinfo(value.dtype).min, value)
    return value


def _flatten_maybe(seq: Sequence) -> list:
    out = []
    for el in seq:
        if isinstance(el, (list, tuple)):
            out.extend(el)
        else:
            out.append(el)
    return out


# a step's buffers hold the states under their names (identifiers) and these two
_VIOL, _COUNT = "#violations", "#update_count"


def _ring_clone(ring: RingBuffer) -> RingBuffer:
    """A ring buffer with its own copy of ``ring``'s storage and the same count."""
    shared = ring._shared
    out = ring.copy()
    if out.data is not None:
        out.data = out.data.clone()
        out._shared, ring._shared = False, shared
    return out


def _hold(states: Dict[str, Any]) -> Dict[str, Tuple]:
    """The tensors a step must leave its results in: each state tensor, each ring's storage and cursor."""
    return {
        n: (v, v.data, v._cursor) if isinstance(v, RingBuffer) else (v,) for n, v in states.items()
    }


def _snapshot(states: Dict[str, Any]) -> Dict[str, Tensor]:
    return {n: (v.data if isinstance(v, RingBuffer) else v).clone() for n, v in states.items()}


def _keep_unless(bad: Tensor, old: Dict[str, Tensor], new: Dict[str, Any], held: Dict[str, Tuple]) -> Dict[str, Any]:
    """The pre-step states where ``bad`` (a violating batch adds nothing), else the new ones.

    A tensor state of unchanged dtype and shape is chosen straight into its held buffer.
    """
    out = {}
    for n, v in new.items():
        if isinstance(v, RingBuffer):
            v.data = torch.where(bad, old[n], v.data)
            out[n] = v
        elif v.dtype == held[n][0].dtype and v.shape == held[n][0].shape:
            out[n] = torch.where(bad, old[n], v, out=held[n][0])
        else:
            out[n] = torch.where(bad, old[n], v)
    return out


def _write_back(held: Dict[str, Tuple], new: Dict[str, Any]) -> None:
    """Leave a step's results in the buffers it was given (an in-place update already has)."""
    for n, h in held.items():
        v = new[n]
        if len(h) == 1:
            if v is not h[0]:
                h[0].copy_(v)
            continue
        ring, data, cursor = h
        if ring.data is not data:
            data.copy_(ring.data)
            ring.data = data
        if cursor is not None and ring._cursor is not cursor:
            cursor.copy_(ring._cursor)
            ring._cursor = cursor


class Metric(nn.Module, ABC):
    """Base class for all metrics.

    Subclasses implement ``update(*args)`` (accumulating into the states
    registered with :meth:`add_state`) and ``compute()``. The base class
    provides streaming ``forward``, cross-batch merging, distributed sync over
    ``torch.distributed``, (de)serialization, cloning, device moves and an
    operator algebra producing :class:`CompositionalMetric`.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = None

    plot_lower_bound: Optional[float] = None
    plot_upper_bound: Optional[float] = None
    plot_legend_name: Optional[str] = None

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._device = _resolve_device(kwargs.pop("device", None))
        # config kwargs (reference metric.py:100-148), each type-validated
        self.compute_on_cpu = kwargs.pop("compute_on_cpu", False)
        if not isinstance(self.compute_on_cpu, bool):
            raise ValueError(f"Expected keyword argument `compute_on_cpu` to be a `bool` but got {self.compute_on_cpu}")
        self.dist_sync_on_step = kwargs.pop("dist_sync_on_step", False)
        if not isinstance(self.dist_sync_on_step, bool):
            raise ValueError(
                f"Expected keyword argument `dist_sync_on_step` to be a `bool` but got {self.dist_sync_on_step}"
            )
        # a torch.distributed group handle; None means the world group
        self.process_group = kwargs.pop("process_group", None)
        self.dist_sync_fn = kwargs.pop("dist_sync_fn", None)
        if self.dist_sync_fn is not None and not callable(self.dist_sync_fn):
            raise ValueError(
                f"Expected keyword argument `dist_sync_fn` to be a callable function but got {self.dist_sync_fn}"
            )
        self.distributed_available_fn = kwargs.pop("distributed_available_fn", None) or _default_distributed_available
        self.sync_on_compute = kwargs.pop("sync_on_compute", True)
        if not isinstance(self.sync_on_compute, bool):
            raise ValueError(
                f"Expected keyword argument `sync_on_compute` to be a `bool` but got {self.sync_on_compute}"
            )
        self.compute_with_cache = kwargs.pop("compute_with_cache", True)
        if not isinstance(self.compute_with_cache, bool):
            raise ValueError(
                f"Expected keyword argument `compute_with_cache` to be a `bool` but got {self.compute_with_cache}"
            )
        # repeat argument signatures run one compiled step (a CUDA graph on the card)
        self.auto_compile = kwargs.pop("auto_compile", True)
        if not isinstance(self.auto_compile, bool):
            raise ValueError(f"Expected keyword argument `auto_compile` to be a `bool` but got {self.auto_compile}")
        # bound append-mode ("cat") states to a fixed-capacity ring buffer instead of an unbounded list
        self.cat_state_capacity = kwargs.pop("cat_state_capacity", None)
        if self.cat_state_capacity is not None and not (
            isinstance(self.cat_state_capacity, int) and self.cat_state_capacity > 0
        ):
            raise ValueError(
                "Expected keyword argument `cat_state_capacity` to be `None` or a positive integer"
                f" but got {self.cat_state_capacity}"
            )
        # resilience knobs (`_resilience/`): `sync_policy` opts the eager
        # multi-process sync into the guarded path (handshake, timeout/retry/
        # backoff, graceful degradation); `nan_policy` arms the NaN/Inf state
        # sentinel after every eager update. An EXPLICIT `sync_policy=None`
        # opts out of the process-wide default policy; omitting it inherits it.
        self._sync_policy_explicit = "sync_policy" in kwargs
        self.sync_policy = kwargs.pop("sync_policy", None)
        self.nan_policy = kwargs.pop("nan_policy", None)
        self._validate_resilience_knobs()
        self._resilience_events: List[Any] = []
        self._quarantined_updates: int = 0
        # update-journal hook: a SnapshotManager binds itself here; every
        # completed update/forward then journals its batch for restore and
        # replay. None (the default) costs one dict probe per update.
        self._snapshot_hook: Optional[Any] = None
        if kwargs:
            kwargs_ = [f"`{a}`" for a in sorted(kwargs)]
            raise ValueError(f"Unexpected keyword arguments: {', '.join(kwargs_)}")

        self._update_signature = inspect.signature(self.update)
        self.update: Callable = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute: Callable = self._wrap_compute(self.compute)  # type: ignore[method-assign]
        self._computed: Any = None
        self._forward_cache: Any = None
        self._update_count: int = 0
        self._to_sync = self.sync_on_compute
        self._should_unsync = True

        self._defaults: Dict[str, State] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Union[str, Callable, None]] = {}

        self._is_synced = False
        self._cache: Optional[Dict[str, State]] = None
        # set by a MetricCollection while other metrics hold these state tensors
        self._states_aliased = False
        self._dtype_policy: Optional[torch.dtype] = None

        # compiled-path bookkeeping: seen argument signatures, cached state
        # names, and per-path disable flags (flipped on the first failure)
        self._auto_sigs: Dict[Any, int] = {}
        self._auto_fwd_sigs: Dict[Any, int] = {}
        self._auto_names: Optional[List[str]] = None
        self._auto_disabled = False
        self._auto_forward_disabled = False
        self._auto_disabled_reason: Optional[str] = None
        # fused validation: messages, severities and the device flag vector
        # the compiled steps OR into, read back at the next sync point
        self._viol_msgs: Optional[Tuple[str, ...]] = None
        self._viol_sevs: Optional[Tuple[str, ...]] = None
        self._viol_flags: Optional[Tensor] = None
        self._traced_validation_supported: Optional[bool] = None

    # ------------------------------------------------------------------ state
    @property
    def update_called(self) -> bool:
        """True if ``update``/``forward`` has been called since construction/reset."""
        return self._update_count > 0

    @property
    def update_count(self) -> int:
        return self._update_count

    @property
    def device(self) -> torch.device:
        """Device that holds the metric's states."""
        return self._device

    @property
    def metric_state(self) -> Dict[str, State]:
        """Current value of all registered states."""
        return {attr: getattr(self, attr) for attr in self._defaults}

    def add_state(
        self,
        name: str,
        default: Union[Tensor, List],
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
    ) -> None:
        """Register a metric state (reference ``metric.py:195-272``).

        ``default`` is a tensor (accumulator mode, moved to the metric's
        device), an empty list (append/"cat" mode) or an empty
        :class:`RingBuffer`. ``dist_reduce_fx`` declares the merge used by
        both cross-batch accumulation and distributed sync:
        ``"sum" | "mean" | "max" | "min" | "cat" | None | callable``.
        With ``cat_state_capacity`` set, a list state reduced by ``"cat"`` or
        ``None`` becomes a ring buffer of that capacity (JAX ``metric.py:285-301``).
        """
        if not name.isidentifier():
            raise ValueError(f"Argument `name` must be a valid python attribute name, but got {name}")
        is_list = isinstance(default, list)
        is_ring = isinstance(default, RingBuffer)
        if not (isinstance(default, Tensor) or (is_list and len(default) == 0) or is_ring):
            raise ValueError("state variable must be a tensor or any empty list (where you can append tensors)")
        if dist_reduce_fx is not None and not (dist_reduce_fx in _STR_REDUCTIONS or callable(dist_reduce_fx)):
            raise ValueError(
                "`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]"
            )
        if is_ring:
            if dist_reduce_fx != "cat":
                raise ValueError(
                    f"RingBuffer states require `dist_reduce_fx='cat'`, but state {name!r} declared {dist_reduce_fx!r}"
                )
            if len(default):
                raise ValueError(f"RingBuffer default for state {name!r} must be empty")
            default = RingBuffer(default.capacity, self._device)
        elif is_list and self.cat_state_capacity is not None and dist_reduce_fx in ("cat", None):
            default, is_ring = RingBuffer(self.cat_state_capacity, self._device), True
        if is_ring:
            setattr(self, name, default.copy_empty())
            self._defaults[name] = default
        elif is_list:
            setattr(self, name, [])
            self._defaults[name] = []
        else:
            default = default.detach().to(self._device)
            setattr(self, name, default.clone())  # the live state is updated in place
            self._defaults[name] = default
        self._persistent[name] = persistent
        self._reductions[name] = dist_reduce_fx
        # registering a state changes the cross-process structure contract:
        # the next guarded sync must run the handshake again
        self.__dict__.pop("_handshake_ok_digest", None)

    # --------------------------------------------------------------- forward
    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Update global state AND return the metric on just this batch.

        Reference dual-mode (``metric.py:275-306``): metrics with
        ``full_state_update=False`` use the single-update path where the batch
        state is merged into the global state via the declared reductions;
        otherwise the conservative double-update path runs.
        """
        if self._is_synced:
            raise TorchMetricsUserError(
                "The Metric shouldn't be synced when performing ``forward``. "
                "HINT: Did you forget to call ``unsync``?"
            )
        # the stash/reset/update/compute/merge dance runs update() on
        # batch-local state: suspend the snapshot journal for its duration
        # and record the batch ONCE below, when the global state is final
        suspended = "_journal_suspend" in self.__dict__
        if not suspended:
            self.__dict__["_journal_suspend"] = True
        # the forward span parents the inner update/compute spans, so one
        # forward call reads as ONE causally ordered request
        _sp = _obs_trace.begin_span("forward", type(self).__name__) if _OBS.tracing else None
        _sp_err: Optional[BaseException] = None
        try:
            if self.full_state_update or self.full_state_update is None or self.dist_sync_on_step:
                self._forward_cache = self._forward_full_state_update(*args, **kwargs)
            else:
                handled, batch_val = self._try_auto_forward(args, kwargs)
                self._forward_cache = batch_val if handled else self._forward_reduce_state_update(*args, **kwargs)
        except BaseException as err:
            _sp_err = err
            raise
        finally:
            if _sp is not None:
                _obs_trace.end_span(_sp, _sp_err)
            if not suspended:
                self.__dict__.pop("_journal_suspend", None)
        # replay re-runs a forward entry through plain update(): the state
        # transition is the same, so the journal tags it "update"
        self._journal_record("update", args, kwargs)
        return self._forward_cache

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Double-update path (reference ``metric.py:308-351``)."""
        self.update(*args, **kwargs)
        if self.nan_policy == "quarantine" and self.__dict__.get("_nan_last_quarantined"):
            # the NaN sentinel dropped this batch from the global state; the
            # batch-value replay would re-update (and re-record the quarantine)
            # and then compute on an empty state
            return None
        self._to_sync = self.dist_sync_on_step
        # reset() rebinds every state to a fresh default, so the accumulated
        # states can be stashed by reference (a graph's buffers are copied:
        # the batch replay writes into them)
        cache = self._stash_states()
        update_count = self._update_count
        try:
            self.reset()
            # the batch-only replay must not advance the NaN sentinel's stream
            # ordinal a second time (the first update above already did)
            self.__dict__["_nan_replay"] = True
            try:
                self.update(*args, **kwargs)
            finally:
                self.__dict__.pop("_nan_replay", None)
            return self.compute()
        finally:
            # success or a failed batch replay: the accumulated state lives
            # only in `cache` and goes back either way
            self._update_count = update_count
            self._restore_state(cache)
            self._computed = None
            self._is_synced = False
            self._should_unsync = True
            self._to_sync = self.sync_on_compute

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Single-update path (reference ``metric.py:353-391``)."""
        global_state = self._stash_states()  # as in the double-update path
        update_count = self._update_count
        try:
            self.reset()
        except Exception:
            # reset() raises a pending deferred violation after resetting:
            # the accumulation lives only in the stash
            self._update_count = update_count
            self._restore_state(global_state)
            raise
        self._to_sync = self.dist_sync_on_step
        self._should_unsync = False
        try:
            self.update(*args, **kwargs)
            quarantined = self.nan_policy == "quarantine" and self.__dict__.get("_nan_last_quarantined")
            # a quarantined batch's state was rolled back to reset-empty:
            # computing on it would crash cat-state metrics, so the dropped
            # batch yields no batch value
            batch_val = None if quarantined else self.compute()
        except Exception:
            # one bad batch must not destroy the whole accumulation
            self._update_count = update_count
            self._restore_state(global_state)
            raise
        else:
            if quarantined:
                # the global state stays untouched: merging the rolled-back
                # defaults would contaminate mean-reduced states
                self._update_count = update_count
                self._restore_state(global_state)
            else:
                self._update_count = update_count + 1
                self._reduce_states(global_state)
        finally:
            self._should_unsync = True
            self._to_sync = self.sync_on_compute
            self._computed = None
            self._is_synced = False
        return batch_val

    def _reduce_states(
        self,
        incoming_state: Dict[str, Any],
        incoming_weight: Optional[float] = None,
        local_weight: float = 1.0,
    ) -> None:
        """Merge ``incoming_state`` into the current state per-reduction.

        Reference ``metric.py:393-425``. For ``mean`` states the merge is a
        weighted average: in the forward path the incoming (previous global)
        state carries ``n-1`` updates and the local batch one;
        ``merge_state`` passes explicit update counts.
        """
        for attr in self._defaults:
            local_state = getattr(self, attr)
            global_state = incoming_state[attr]
            reduce_fn = self._reductions[attr]
            if reduce_fn == "sum":
                reduced = global_state + local_state
            elif reduce_fn == "mean":
                gw = float(self._update_count - local_weight) if incoming_weight is None else float(incoming_weight)
                lw = float(local_weight)
                reduced = (gw * global_state + lw * local_state) / (gw + lw)
            elif reduce_fn == "max":
                reduced = torch.maximum(global_state, local_state)
            elif reduce_fn == "min":
                reduced = torch.minimum(global_state, local_state)
            elif reduce_fn in ("cat", None) and isinstance(global_state, RingBuffer):
                reduced = global_state.copy().extend(local_state)
            elif reduce_fn in ("cat", None) and isinstance(global_state, list):
                if isinstance(local_state, RingBuffer):  # merged in from a metric built with a capacity
                    local_state = [local_state.values()] if len(local_state) else []
                reduced = global_state + list(local_state)
            elif reduce_fn is None and isinstance(global_state, Tensor):
                default = self._defaults[attr]

                def _stacked(v: Tensor) -> bool:
                    # a (k, *default_shape) collection produced by earlier merges
                    return v.ndim == default.ndim + 1 and tuple(v.shape[1:]) == tuple(default.shape)

                if _stacked(global_state) or _stacked(local_state):
                    g = global_state if _stacked(global_state) else global_state[None]
                    loc = local_state if _stacked(local_state) else local_state[None]
                    reduced = torch.cat([g, loc])
                else:
                    reduced = torch.stack([global_state, local_state])
            elif reduce_fn == "cat" and isinstance(global_state, Tensor):
                reduced = torch.cat([torch.atleast_1d(global_state), torch.atleast_1d(local_state)])
            elif callable(reduce_fn):
                reduced = reduce_fn(torch.stack([global_state, local_state]))
            else:
                raise TorchMetricsUserError(f"Cannot reduce state {attr} with reduction {reduce_fn}")
            setattr(self, attr, reduced)

    # ---------------------------------------------------------------- update
    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> None:
            # request tracing rides its own slot bool: off, this seam pays one
            # branch and a None store; on, the span joins the ambient trace
            _sp = _obs_trace.begin_span("update", type(self).__name__) if _OBS.tracing else None
            _sp_err: Optional[BaseException] = None
            try:
                return self._update_impl(update, _sp, args, kwargs)
            except BaseException as err:
                _sp_err = err
                raise
            finally:
                if _sp is not None:
                    _obs_trace.end_span(_sp, _sp_err)

        return wrapped_func

    def _update_impl(self, update: Callable, _sp: Any, args: tuple, kwargs: Dict[str, Any]) -> None:
        """The body of every wrapped ``update`` (``_sp``: the seam's open span, or None)."""
        if self._try_auto_update(args, kwargs):
            if _sp is not None:
                _sp.attrs["path"] = "auto"
            self._journal_record("update", args, kwargs)
            return
        if _sp is not None:
            _sp.attrs["path"] = "eager"
        # the first call of a signature the next call captures: that graph will hold the trunk
        capture_next = self.__dict__.pop("_auto_capture_next", False)
        self._check_pending_violations()
        self._computed = None
        if self._states_aliased:
            self._unshare_states()
        self._update_count += 1
        # where a compiled path could engage, an update that rebinds or
        # mutates a plain attribute turns it off: a replay would not. The
        # fingerprint is only paid where the static analyzer has not already
        # proven the whole class chain free of such mutation (R1
        # certification, see torchmetrics_tpu_torch/_analysis)
        eligible = self._auto_eligible()
        guard = eligible and not self._fingerprint_exempt()
        if _OBS.enabled:
            _telemetry_for(self).inc(
                "fingerprint|outcome=check" if guard
                else "fingerprint|outcome=skip" if eligible
                else "fingerprint|outcome=ineligible"
            )
        if guard:
            before, _keepalive = self._host_attr_snapshot()
        # quarantine is the only nan_policy needing a rollback point; the
        # pre-update list lengths let the sentinel scan only the elements
        # THIS batch appended (cat-state streams stay O(batch), not O(n))
        pre_state = pre_lens = None
        if self.nan_policy is not None:
            # stream-position ordinal for the sentinel's events: forward()'s
            # stash/reset dance makes `_update_count` batch-local (the
            # full-state forward's batch-only replay does not count)
            if not self.__dict__.get("_nan_replay"):
                self.__dict__["_nan_seen_batches"] = self.__dict__.get("_nan_seen_batches", 0) + 1
            pre_lens = {n: len(v) for n in self._defaults if isinstance(v := getattr(self, n), list)}
            if self.nan_policy == "quarantine":
                pre_state = self._quarantine_snapshot()
                self.__dict__["_nan_last_quarantined"] = False
        with _compile.trunks_inline(capture_next):
            if _OBS.enabled:
                self._obs_call("update_calls|path=eager", "update_eager", "update", lambda: update(*args, **kwargs))
            else:
                update(*args, **kwargs)
        if guard and self._host_attr_snapshot()[0] != before:
            self._disable_auto("update mutated unregistered host attributes")
        if self.nan_policy is not None:
            self._guard_nonfinite_states(pre_state, pre_lens)
        if self._dtype_policy is not None:
            self._apply_dtype_policy()
        if self.compute_on_cpu:
            self._move_list_states_to_cpu()
        self._journal_record("update", args, kwargs)

    def _journal_record(self, method: str, args: tuple, kwargs: Dict[str, Any]) -> None:
        """Feed one *completed* state transition to the attached SnapshotManager (JAX ``metric.py:607``).

        Runs only after the update committed (and after quarantine rollback,
        dtype policy and CPU offload), so the journal never records a batch
        whose effects replaying it would not reproduce. The inner updates of
        forward's stash/reset dance are suppressed by ``_journal_suspend``:
        mid-dance state is batch-local. One dict probe when no manager is
        attached.
        """
        hook = self.__dict__.get("_snapshot_hook")
        if hook is not None and "_journal_suspend" not in self.__dict__:
            hook.record(self, method, args, kwargs)

    # ------------------------------------------------------------- telemetry
    # The helpers below run only with telemetry ENABLED (callers guard on
    # `_OBS.enabled`); they may allocate, probe dicts and read the clock. All
    # of it is host side, at eager boundaries: never inside a captured graph.

    def _obs_call(self, counter_key: Optional[str], op: str, method: str, fn: Callable) -> Any:
        """Run ``fn`` counted, latency-sampled and profiler-annotated (JAX ``metric.py:635``)."""
        telem = _telemetry_for(self)
        if counter_key:
            telem.inc(counter_key)
        sample = telem.sample_due(op)
        t0 = time.perf_counter() if sample else 0.0
        if _OBS.profile_scopes:
            with _obs_scopes.annotation(f"{type(self).__name__}.{method}", self._device.type == "cuda"):
                out = fn()
        else:
            out = fn()
        if sample:
            telem.observe(op, time.perf_counter() - t0)
        return out

    def _obs_compile_event(self, kind: str, treedef: Any, statics: Tuple, sig_inputs: Tuple, built: bool = True) -> None:
        """Report one compiled-path cache key for recompile-churn tracking (JAX ``metric.py:656``).

        The components are the signature's: the JAX package's structure,
        statics, shapes, dtypes and dtype policy, and the port's devices and
        layouts (a graph per device and input layout). Deduplicated on the
        hashable signature before any string is built.
        """
        seen = self.__dict__.setdefault("_obs_seen_sigs", set())
        sig_key = (kind, treedef, statics, sig_inputs, self._dtype_policy)
        if sig_key in seen:
            return
        if len(seen) < 512:  # churn streams must not grow host memory without bound
            seen.add(sig_key)
        _telemetry_for(self).compile_event(kind, self._compile_components(treedef, statics, sig_inputs), built=built)

    def _compile_components(self, treedef: Any, statics: Tuple, sig_inputs: Tuple) -> Dict[str, str]:
        """A compiled key's printable components: what the churn detector diffs and the AOT cache keys records by."""
        return {
            "arg_structure": str(treedef),
            "static_args": repr(statics),
            "shapes": repr(tuple(s[0] for s in sig_inputs)),
            "dtypes": repr(tuple(str(s[1]).replace("torch.", "") for s in sig_inputs)),
            "devices": repr(tuple(str(s[2]) for s in sig_inputs)),
            "layouts": repr(tuple(s[3:] for s in sig_inputs)),
            "dtype_policy": "none" if self._dtype_policy is None else str(self._dtype_policy).replace("torch.", ""),
        }

    def telemetry_report(self) -> Any:
        """Runtime telemetry snapshot for this metric (JAX ``metric.py:689``).

        A :class:`~torchmetrics_tpu_torch._observability.telemetry.TelemetryReport`
        with per-path update counters, fingerprint and deferred-violation
        counts, compile and recompile-churn statistics, sync calls, and
        sampled latency reservoirs. With telemetry disabled (the default) the
        report is empty with ``enabled=False``; enable collection with
        ``TM_TPU_TELEMETRY=1`` or
        :func:`torchmetrics_tpu_torch._observability.set_telemetry_enabled`.
        """
        from torchmetrics_tpu_torch._observability.telemetry import report_for

        return report_for(self)

    def _unshare_states(self) -> None:
        """Take private copies of the tensor states other metrics of a compute group hold (copy on write).

        Lists get a list of their own (their tensors are never written in
        place); a ring buffer from the group is already a copy on write.
        """
        self._release_graph_buffers()
        for attr in self._defaults:
            cur = getattr(self, attr)
            if isinstance(cur, Tensor):
                setattr(self, attr, cur.clone())
            elif isinstance(cur, list):
                setattr(self, attr, list(cur))
        self._states_aliased = False

    # ------------------------------------------------------------ resilience
    def _validate_resilience_knobs(self) -> None:
        if self.sync_policy is not None and not isinstance(self.sync_policy, _res_policy.SyncPolicy):
            raise ValueError(
                f"Expected keyword argument `sync_policy` to be a `SyncPolicy` or None but got {self.sync_policy}"
            )
        if self.nan_policy not in _res_policy.NAN_POLICIES:
            raise ValueError(
                f"Expected keyword argument `nan_policy` to be one of {_res_policy.NAN_POLICIES} but got {self.nan_policy}"
            )

    def set_resilience_policy(self, sync_policy: Any = _UNSET, nan_policy: Any = _UNSET) -> "Metric":
        """Attach/replace resilience policies after construction (chainable; JAX ``metric.py:1138``).

        Only the arguments actually passed change; ``None`` explicitly
        disables a policy. Replacing the sync policy invalidates the cached
        handshake digest so the next guarded sync re-verifies structure.
        """
        old_sync, old_nan = self.sync_policy, self.nan_policy
        if sync_policy is not _UNSET:
            self.sync_policy = sync_policy
        if nan_policy is not _UNSET:
            self.nan_policy = nan_policy
        try:
            self._validate_resilience_knobs()
        except ValueError:
            # a rejected call must not leave the invalid value attached
            self.sync_policy, self.nan_policy = old_sync, old_nan
            raise
        if sync_policy is not _UNSET:
            # an explicit None here is an opt-out from the process default
            self._sync_policy_explicit = True
            self.__dict__.pop("_handshake_ok_digest", None)
        return self

    def resilience_report(self) -> Any:
        """Degradation record of this metric (JAX ``metric.py:1165``).

        A :class:`~torchmetrics_tpu_torch._resilience.policy.ResilienceReport`
        with every recorded ``DegradationEvent`` (degraded syncs, quarantined
        batches, repaired restores). Events survive ``reset()``: they describe
        the stream, not the metric's state.
        """
        return _res_policy.ResilienceReport(
            metric=type(self).__name__,
            events=tuple(self.__dict__.get("_resilience_events", ())),
            quarantined_updates=self.__dict__.get("_quarantined_updates", 0),
            dropped_events=self.__dict__.get("_resilience_events_dropped", 0),
        )

    def _record_degradation(self, kind: str, detail: str, attempts: int = 0) -> None:
        event = _res_policy.DegradationEvent(kind=kind, metric=type(self).__name__, detail=detail, attempts=attempts)
        if _OBS.enabled:
            # one bus for degradations, restores, churn and heartbeats
            _telemetry_for(self).inc(f"degradations|kind={kind}")
            _BUS.publish(
                "degradation", type(self).__name__, f"{kind}: {detail}",
                data={"kind": kind, "attempts": attempts},
            )
        events = self.__dict__.setdefault("_resilience_events", [])
        events.append(event)
        if len(events) > _res_policy.MAX_EVENTS:
            # a permanently degraded long-running job records one event per
            # sync: cap the log, keep the eviction count in the report
            evict = len(events) - _res_policy.MAX_EVENTS
            del events[:evict]
            self.__dict__["_resilience_events_dropped"] = self.__dict__.get("_resilience_events_dropped", 0) + evict
        rank_zero_warn(
            f"{type(self).__name__} degraded ({kind}): {detail} — see `Metric.resilience_report()`.",
            TorchMetricsUserWarning,
        )

    def _quarantine_snapshot(self) -> Dict[str, Any]:
        """Rollback point for the NaN quarantine (JAX ``metric.py:1207``).

        The JAX package keeps its immutable array states by reference. Here
        updates write into the state tensors (``state += batch``, kernel B1's
        ``out=``), so a reference would "roll back" to the poisoned tensor:
        every tensor state is cloned on its device. A list gets a shallow
        copy (its tensors are appended, never written); a ring buffer a copy
        whose storage is copied before either side writes.
        """
        snap: Dict[str, Any] = {}
        for attr in self._defaults:
            v = getattr(self, attr)
            if isinstance(v, RingBuffer):
                snap[attr] = v.copy()
            elif isinstance(v, list):
                snap[attr] = list(v)
            else:
                snap[attr] = v.clone()
        return snap

    def _guard_nonfinite_states(self, pre_state: Optional[Dict[str, Any]], pre_lens: Optional[Dict[str, int]] = None) -> None:
        """NaN/Inf sentinel after an eager update (the ``nan_policy`` knob; JAX ``metric.py:1226``).

        ``raise`` surfaces the poisoned state at once (left as is, so it can
        be inspected; ``reset()`` clears it); ``warn`` only warns;
        ``quarantine`` rolls the whole update back, so one bad batch adds
        nothing. The scan is one device reduction an array and one host read
        (``nonfinite_state_report``). ``pre_lens`` (the pre-update list
        lengths) limits it to the chunks this batch appended.
        """
        if not self._defaults:
            # wrappers and compositions hold their accumulators in child
            # metrics: the sentinel has nothing to guard, and silence here
            # would read as protection, so say so once
            if not self.__dict__.get("_nan_policy_noop_warned"):
                self.__dict__["_nan_policy_noop_warned"] = True
                rank_zero_warn(
                    f"`nan_policy={self.nan_policy!r}` on {type(self).__name__} guards nothing:"
                    " this metric registers no states of its own (wrappers and compositions hold"
                    " their accumulators in child metrics). Set `nan_policy` on the wrapped"
                    " metric(s) instead.",
                    TorchMetricsUserWarning,
                )
            return
        bad = _integrity.nonfinite_state_report(self, list_scan_from=pre_lens)
        if not bad:
            return
        desc = ", ".join(f"`{k}` ({v})" for k, v in sorted(bad.items()))
        batch = self.__dict__.get("_nan_seen_batches", self._update_count)
        policy = self.nan_policy
        if policy == "raise":
            raise RuntimeError(
                f"Non-finite values detected in state(s) {desc} of {type(self).__name__} after"
                f" guarded batch {batch} (`nan_policy='raise'`). The state is poisoned:"
                " every downstream `compute()` would silently return garbage. Call `reset()`,"
                " or use `nan_policy='quarantine'` to drop bad batches automatically."
            )
        if policy == "warn":
            rank_zero_warn(
                f"Non-finite values detected in state(s) {desc} of {type(self).__name__} after"
                f" guarded batch {batch} (`nan_policy='warn'`): downstream `compute()`"
                " results are now suspect.",
                TorchMetricsUserWarning,
            )
            return
        # quarantine: roll back this batch's contribution
        if pre_state is None:
            return
        self._restore_state(pre_state)
        if _integrity.nonfinite_state_report(self, list_scan_from=pre_lens):
            # the poison predates this batch (policy enabled mid-stream):
            # rollback cannot recover, so surface it instead of looping
            rank_zero_warn(
                f"State(s) {desc} of {type(self).__name__} were already non-finite before this"
                " update; `nan_policy='quarantine'` cannot recover a pre-poisoned metric —"
                " call `reset()`.",
                TorchMetricsUserWarning,
            )
            return
        self._update_count -= 1
        self._computed = None
        # `forward`'s reduce-state path reads this flag, so a dropped batch
        # is not merged into the stashed global state either
        self.__dict__["_nan_last_quarantined"] = True
        self.__dict__["_quarantined_updates"] = self.__dict__.get("_quarantined_updates", 0) + 1
        if _OBS.enabled:
            _telemetry_for(self).inc("quarantined_batches")
        self._record_degradation(
            "nan_quarantine",
            detail=f"guarded batch {batch} produced non-finite state(s) {desc}; batch dropped",
        )

    # ------------------------------------------------------- compiled update
    # The compiled paths (JAX ``metric.py:1310-2175``). A *step* is the raw
    # update as a function of buffers (the states under their names, the
    # flag vector under `_VIOL`, the update count under `_COUNT`) and the
    # batch's tensors: it writes its results back into the buffers it was
    # given. It runs eagerly on a CPU metric and is captured into a CUDA
    # graph (`_compile`) on a CUDA metric.
    _AUTO_MAX_SIGNATURES = 8
    _COMPILED_CACHES = ("_auto_update_fn", "_auto_forward_fn", "_jit_update_fn", "_scan_update_fn")

    def _disable_auto(self, reason: str, forward_only: bool = False, observe: bool = True) -> None:
        """Turn the compiled update and forward (or the forward alone) off for this instance, recording why.

        With telemetry on, the cause also goes out as an ``auto_path_disabled``
        counter and bus event (JAX ``metric.py:684``), where the JAX package
        sends one; ``observe=False`` where it does not.
        """
        self._auto_forward_disabled = True
        if not forward_only:
            self._auto_disabled = True
        if self._auto_disabled_reason is None:
            self._auto_disabled_reason = reason
        if _OBS.enabled and observe:
            self._obs_auto_disabled(reason, "metric.forward" if forward_only else "metric.update")

    def _obs_auto_disabled(self, reason: str, seam: str = "metric.update") -> None:
        """Record why a compiled path switched off: a counter and a bus event (telemetry on).

        The event names its seam (``data["seam"]``), so a flight dump of it
        names the seam too; the JAX package's event carries no data.
        """
        _telemetry_for(self).inc("auto_path_disabled")
        _BUS.publish("auto_path_disabled", type(self).__name__, reason, data={"seam": seam})

    def _auto_eligible(self) -> bool:
        """Base gate for the compiled ``update``/``forward`` (JAX ``metric.py:1501``).

        ``validate_args=True`` metrics compile where they carry a traced
        validator (:meth:`_traced_value_flags`) or where the eligibility
        verdict copied from the JAX package certifies their checks
        metadata-only (``_eligibility.json``). ``compute_on_cpu`` keeps
        growing states on the host, which no step can hold.
        """
        return (
            self.auto_compile
            and not self._auto_disabled
            and not self.compute_on_cpu
            # the NaN sentinel reads the states back after every update: it
            # must observe every one, so it pins the eager path
            and self.nan_policy is None
            and (
                getattr(self, "validate_args", None) is not True
                or self._supports_traced_validation()
                or _compile.eligibility_verdict(type(self)) == "metadata_only"
            )
        )

    def _traced_value_flags(self, *args: Any, **kwargs: Any) -> Optional[Tuple]:
        """Device-side value checks: ``(messages, flags[, severities])`` (JAX ``metric.py:1538``).

        ``flags[i]`` is True where the batch violates check ``i``; the
        message tuple must not depend on the argument values. Severity
        ``"error"`` (the default) drops the batch and raises at the next sync
        point; ``"warn"`` keeps it and warns. The base returns None: such a
        metric keeps the eager path when ``validate_args=True``, unless its
        checks are certified metadata-only.
        """
        return None

    def _supports_traced_validation(self) -> bool:
        sup = self._traced_validation_supported
        if sup is None:
            sup = type(self)._traced_value_flags is not Metric._traced_value_flags
            self._traced_validation_supported = sup
        return sup

    def _auto_validate(self) -> bool:
        """True when compiled steps must carry the fused value checks."""
        return getattr(self, "validate_args", None) is True and self._supports_traced_validation()

    @staticmethod
    def _split_value_flags(res: Tuple) -> Tuple[Tuple[str, ...], Tensor, Tuple[str, ...]]:
        """Normalize a ``_traced_value_flags`` result to ``(msgs, flags, sevs)``."""
        msgs, flags = res[0], res[1]
        sevs = tuple(res[2]) if len(res) > 2 else tuple("error" for _ in msgs)
        if [s for s in sevs if s not in ("error", "warn")] or len(sevs) != len(msgs):
            raise TorchMetricsUserError(
                "`_traced_value_flags` severities must be 'error' or 'warn', one per message;"
                f" got {sevs!r} for {len(tuple(msgs))} message(s)"
            )
        return tuple(msgs), flags, sevs

    def _prime_violation_state(self, treedef: Any, dynamic: List[Tensor], statics: Tuple) -> bool:
        """Learn the message vector once, before the first compile; False when there is nothing to fuse."""
        if self._viol_msgs is None:
            a, kw = self._merge_batch_args(treedef, dynamic, statics)
            msgs, _, sevs = self._split_value_flags(self._traced_value_flags(*a, **kw))
            self._viol_msgs, self._viol_sevs = msgs, sevs
        if self._viol_flags is None and self._viol_msgs:
            self._viol_flags = torch.zeros(len(self._viol_msgs), dtype=torch.bool, device=self._device)
        return bool(self._viol_msgs)

    def _check_pending_violations(self) -> None:
        """Surface value-check violations recorded by compiled steps (JAX ``metric.py:1605``).

        The flag vector stays on the device while the compiled steps stream;
        this read at the next eager update, ``compute()`` or ``reset()`` is
        its only read back, as a CUDA device-side assert surfaces at the
        next sync. The first call with each argument signature validates
        eagerly, so a single bad batch still raises at once with the
        reference's message.
        """
        flags = self._viol_flags
        if flags is None:
            return
        vals = flags.tolist()
        if not any(vals):
            return
        sevs = self._viol_sevs or tuple("error" for _ in self._viol_msgs)
        errors = [m for m, s, v in zip(self._viol_msgs, sevs, vals) if v and s == "error"]
        warns = [m for m, s, v in zip(self._viol_msgs, sevs, vals) if v and s == "warn"]
        self._viol_flags = torch.zeros_like(flags)
        if _OBS.enabled:
            telem = _telemetry_for(self)
            if errors:
                telem.inc("deferred_violations|severity=error", len(errors))
            if warns:
                telem.inc("deferred_violations|severity=warn", len(warns))
        for msg in warns:
            rank_zero_warn(
                f"{msg} (surfaced asynchronously: this warn-severity check ran fused inside the compiled update)",
                UserWarning,
            )
        if errors:
            raise RuntimeError(
                f"{errors[0]} (raised asynchronously: with `auto_compile` the `validate_args=True`"
                " value checks run fused inside the compiled update and surface at the next host"
                " synchronization point)"
            )

    def _fixed_shape_state_names(self, method_name: str) -> Optional[List[str]]:
        """State names for the compiled paths; None = warm up eagerly first (JAX ``metric.py:1310``).

        A metric that delegates to child metrics, or holds an attribute that
        looks stateful, refuses; so does a list state. A ring buffer that has
        not seen a batch learns its row shape from an eager update first.
        """

        def metric_like(v: Any) -> bool:
            return isinstance(v, Metric) or (
                hasattr(v, "update")
                and hasattr(v, "compute")
                and hasattr(v, "reset")
                and (hasattr(v, "_defaults") or hasattr(v, "_modules"))
            )

        def stateful_like(v: Any) -> bool:
            return (
                not isinstance(v, (Metric, Tensor, RingBuffer))
                and hasattr(v, "update")
                and hasattr(v, "compute")
                and hasattr(v, "reset")
            )

        attrs = {k: v for k, v in self.__dict__.items() if k not in ("update", "compute", "_modules")}
        attrs.update(self._modules)
        for attr, value in attrs.items():
            if isinstance(value, dict):
                children = list(value.values())
            elif isinstance(value, (list, tuple)):
                children = list(value)
            elif isinstance(value, nn.Module) and not isinstance(value, Metric):
                children = list(value.modules())  # a ModuleList/ModuleDict of metrics, at any depth
            else:
                children = [value]
            if any(metric_like(v) for v in children):
                raise TorchMetricsUserError(
                    f"`{method_name}` is unsupported on {type(self).__name__}: it delegates to child"
                    f" metric(s) (`{attr}`) whose states live outside this metric's state registry."
                    " Call the compiled update on the component metrics directly."
                )
            if any(stateful_like(v) for v in children):
                raise TorchMetricsUserError(
                    f"`{method_name}` is unsupported on {type(self).__name__}: attribute `{attr}` looks"
                    " stateful (it exposes update/compute/reset) but is not a registered metric state."
                    " If `update()` mutates it, a replay would corrupt it; stream through the plain"
                    " `update()` path, or register its state with `add_state`."
                )
        names = list(self._defaults)
        if not names:
            raise TorchMetricsUserError(
                f"`{method_name}` is unsupported on {type(self).__name__}: it registers no state, so its update"
                " can only act outside this metric."
            )
        warm_up = False
        for name in names:
            state = getattr(self, name)
            if isinstance(state, list):
                raise TorchMetricsUserError(
                    f"`{method_name}` requires fixed-shape states, but state `{name}` is an append-mode"
                    " list. Construct the metric with `cat_state_capacity=N` to bound it into a device"
                    " ring buffer, or stream through the plain `update()` path."
                )
            if isinstance(state, RingBuffer) and not state.initialized:
                warm_up = True
        return None if warm_up else names

    def _auto_state_names(self, method_name: str) -> Optional[List[str]]:
        """Fixed-shape state names for the auto paths, cached once no ring buffer can go back to lazy."""
        if self._auto_names is not None:
            return self._auto_names
        names = self._fixed_shape_state_names(method_name)
        if names is not None and not any(isinstance(getattr(self, n), RingBuffer) for n in names):
            self._auto_names = names
        return names

    @staticmethod
    def _split_batch_args(method_name: str, args: tuple, kwargs: Dict[str, Any]) -> Tuple[Any, List[Tensor], Tuple]:
        """Split ``(args, kwargs)`` into tensors (the step's inputs) and static values (JAX ``metric.py:1407``).

        Static values (flags such as FID's ``real=True``) key the cache, so
        they must be hashable.
        """
        leaves: List[Any] = []
        treedef = _flatten_args((args, kwargs), leaves)
        dynamic = [leaf for leaf in leaves if isinstance(leaf, Tensor)]
        statics = tuple((i, leaf) for i, leaf in enumerate(leaves) if not isinstance(leaf, Tensor))
        try:
            hash(statics)
        except TypeError:
            raise TorchMetricsUserError(
                f"`{method_name}` arguments must be tensors or hashable static values, got"
                f" {[type(leaf).__name__ for _, leaf in statics]}; use the plain `update()` path."
            ) from None
        return (treedef, len(leaves)), dynamic, statics

    @staticmethod
    def _merge_batch_args(treedef: Any, dynamic: Sequence[Tensor], statics: Tuple) -> Tuple[tuple, Dict[str, Any]]:
        structure, n_leaves = treedef
        static_map = dict(statics)
        dyn_iter = iter(dynamic)
        leaves = [static_map[i] if i in static_map else next(dyn_iter) for i in range(n_leaves)]
        args, kwargs = _unflatten_args(structure, iter(leaves))
        return args, kwargs

    def _auto_signature(self, args: tuple, kwargs: Dict[str, Any], method_name: str = "update") -> Tuple:
        """Hashable ``(structure, statics, shapes/dtypes/devices/layouts)`` key of a call (JAX ``metric.py:1661``).

        The layout (strides, 16-byte alignment) is part of the key so that a
        graph reads its batch in the layout the eager update read, and its
        sums come out the same (``_compile.static_like``).
        """
        treedef, dynamic, statics = self._split_batch_args(method_name, args, kwargs)
        sig = (
            treedef,
            statics,
            tuple((tuple(d.shape), d.dtype, d.device, *_compile.layout_key(d)) for d in dynamic),
        )
        return sig, treedef, dynamic, statics

    def _fingerprint_exempt(self) -> bool:
        """True when the R1-certified manifest covers this instance's class.

        The analyzer (``python -m torchmetrics_tpu_torch._analysis
        --write-manifest``) records every class whose static MRO provably
        never mutates an unregistered attribute; for those the per-``update()``
        ``_host_attr_snapshot`` fingerprint is redundant work. Any class the
        analyzer has not seen (user subclasses included) keeps the guard.
        """
        # per-class memoization lives in the manifest module, so the runtime
        # toggle (set_fingerprint_skip_enabled) invalidates in one place
        return fingerprint_skip_allowed(type(self))

    def _host_attr_snapshot(self) -> Tuple[List[tuple], List[Any]]:
        """Fingerprint of the plain (public, unregistered) attributes (JAX ``metric.py:717``).

        A replay runs no Python, so an update that mutates such an attribute
        (a counter, a cached batch) would be frozen by it: every eager update
        of an eligible metric compares this before and after. Returns
        ``(fingerprint, keepalive)``; the caller holds ``keepalive`` across
        the update so an object fingerprinted by identity cannot be freed
        and its id reused.
        """
        keepalive: List[Any] = []

        def fp(v: Any) -> Any:
            if isinstance(v, (bool, int, float, complex, str, bytes, type(None))):
                return v
            keepalive.append(v)
            return id(v)

        snap: List[tuple] = []
        for k, v in self.__dict__.items():
            if k.startswith("_") or k in self._defaults or callable(v):
                continue
            if isinstance(v, (Tensor, RingBuffer)):
                keepalive.append(v)
                snap.append((k, id(v)))
            elif isinstance(v, (bool, int, float, complex, str, bytes, type(None))):
                snap.append((k, v))
            elif isinstance(v, dict) and len(v) <= 16:
                snap.append((k, id(v), tuple((fp(dk), fp(dv)) for dk, dv in v.items())))
            elif isinstance(v, (list, tuple)) and len(v) <= 16:
                snap.append((k, id(v), tuple(fp(i) for i in v)))
            elif isinstance(v, (list, tuple)):
                n = len(v)
                idxs = sorted({0, 1, 2, n // 4, n // 2, (3 * n) // 4, n - 3, n - 2, n - 1})
                snap.append((k, id(v), n, tuple((i, fp(v[i])) for i in idxs)))
            elif isinstance(v, (dict, set)):
                items = itertools.islice(v.items() if isinstance(v, dict) else v, 8)
                snap.append((k, id(v), len(v), tuple(fp(i) if not isinstance(i, tuple) else tuple(map(fp, i)) for i in items)))
            else:
                keepalive.append(v)
                snap.append((k, id(v)))
        return snap, keepalive

    def _traced_update(self, names: List[str], states: Dict[str, Any], args: tuple, kwargs: Dict[str, Any]) -> Dict[str, Any]:
        """Run the raw update on temporarily bound states; return the states it leaves (JAX ``metric.py:1378``)."""
        saved = {n: getattr(self, n) for n in names}
        try:
            for n in names:
                object.__setattr__(self, n, states[n])
            if _OBS.enabled and _OBS.profile_scopes:
                with _obs_scopes.named_scope(f"{type(self).__name__}.update"):
                    self.update.__wrapped__(*args, **kwargs)
            else:
                self.update.__wrapped__(*args, **kwargs)
            new_states = {n: getattr(self, n) for n in names}
            if self._dtype_policy is not None:
                new_states = {
                    n: v.to(self._dtype_policy) if isinstance(v, Tensor) and v.is_floating_point() else v
                    for n, v in new_states.items()
                }
            return new_states
        finally:
            for n, v in saved.items():
                object.__setattr__(self, n, v)

    def _traced_compute(self, names: List[str], states: Dict[str, Any]) -> Any:
        """Run the raw compute on temporarily bound states (JAX ``metric.py:1799``)."""
        saved = {n: getattr(self, n) for n in names}
        try:
            for n in names:
                object.__setattr__(self, n, states[n])
            if _OBS.enabled and _OBS.profile_scopes:
                with _obs_scopes.named_scope(f"{type(self).__name__}.compute"):
                    return self.compute.__wrapped__()
            return self.compute.__wrapped__()
        finally:
            for n, v in saved.items():
                object.__setattr__(self, n, v)

    def _step_flags(self, args: tuple, kwargs: Dict[str, Any]) -> Tensor:
        msgs, flags, sevs = self._split_value_flags(self._traced_value_flags(*args, **kwargs))
        if msgs != self._viol_msgs or sevs != self._viol_sevs:
            raise TorchMetricsUserError("traced validation messages changed across argument signatures")
        return flags

    def _masks_dropped_batch(self, states: Dict[str, Any]) -> bool:
        """True when the update scales its batch's contribution by ``_step_keep`` itself.

        A compiled step whose error checks may drop the batch sets
        ``_step_keep`` (a device bool, False for a violating batch) before the
        update; such an update needs no copy of the states to restore. The
        base says False: the step copies the states and chooses after.
        """
        return False

    def _error_flag(self, flags: Tensor) -> Optional[Tensor]:
        """True where an error-severity check fired (warn checks keep the batch); None when there are none."""
        err = [i for i, s in enumerate(self._viol_sevs) if s == "error"]
        if not err:
            return None
        if len(err) == len(self._viol_sevs):
            return flags.any()
        return torch.stack([flags[i] for i in err]).any()

    def _update_step(self, names: List[str], treedef: Any, statics: Tuple, validate: bool, steps: int = 0) -> Callable:
        """The step of ``update`` (``steps=0``), or of ``steps`` stacked batches (``scan_update``)."""

        def one(bufs: Dict[str, Any], dyn: Sequence[Tensor]) -> None:
            a, kw = self._merge_batch_args(treedef, dyn, statics)
            states = {n: bufs[n] for n in names}
            held = _hold(states)
            bad = None
            if validate:  # the checks read only the batch: they run first
                flags = self._step_flags(a, kw)
                bufs[_VIOL] |= flags
                bad = self._error_flag(flags)  # only an error check drops the batch
            masked = bad is not None and self._masks_dropped_batch(states)
            old = _snapshot(states) if bad is not None and not masked else None
            if masked:
                self.__dict__["_step_keep"] = ~bad
            try:
                new = self._traced_update(names, states, a, kw)
            finally:
                unused = self.__dict__.pop("_step_keep", None) is not None
            if masked and unused:
                raise TorchMetricsUserError(f"{type(self).__name__}'s update did not mask its batch with `_step_keep`")
            if old is not None:
                new = _keep_unless(bad, old, new, held)
            _write_back(held, new)

        def step(bufs: Dict[str, Any], dyn: List[Tensor]) -> None:
            with _compiled_step(), self._fused_flags(validate):
                if steps:
                    for i in range(steps):
                        one(bufs, [d[i] for d in dyn])
                else:
                    one(bufs, dyn)

        return step

    def _forward_step(self, names: List[str], treedef: Any, statics: Tuple, validate: bool) -> Callable:
        """One step computing the batch value and merging the batch into the states (JAX ``metric.py:1872``)."""
        reductions = {n: self._reductions[n] for n in names}

        def step(bufs: Dict[str, Any], dyn: List[Tensor]) -> Any:
            with _compiled_step(), self._fused_flags(validate):
                a, kw = self._merge_batch_args(treedef, dyn, statics)
                batch = self._traced_update(names, {n: self._defaults[n].clone() for n in names}, a, kw)
                batch_val = _squeeze_if_scalar(self._traced_compute(names, batch))
                bad = None
                if validate:
                    flags = self._step_flags(a, kw)
                    bufs[_VIOL] |= flags
                    bad = self._error_flag(flags)
                    if bad is not None:
                        batch_val = _tree_map(functools.partial(_poison, bad), batch_val)
                count = bufs[_COUNT]
                prev = count.to(torch.float32)
                merged = {}
                for n in names:
                    reduce_fn, g, loc = reductions[n], bufs[n], batch[n]
                    if reduce_fn == "sum":
                        m = g + loc
                    elif reduce_fn == "mean":
                        m = (prev * g + loc) / (prev + 1.0)
                    elif reduce_fn == "max":
                        m = torch.maximum(g, loc)
                    elif reduce_fn == "min":
                        m = torch.minimum(g, loc)
                    else:
                        m = reduce_fn(torch.stack([g, loc]))
                    # a violating batch adds nothing: the eager path raises before merging
                    merged[n] = m if bad is None else torch.where(bad, g, m)
                count += 1 if bad is None else (~bad).to(count.dtype)
                _write_back(_hold({n: bufs[n] for n in names}), merged)
            return batch_val

        return step

    @contextlib.contextmanager
    def _fused_flags(self, on: bool) -> Iterator[None]:
        """Mark a step that carries the fused flags (the aggregators' NaN ``"error"`` check reads it)."""
        if on:
            self.__dict__["_fused_flags_tracing"] = True
        try:
            yield
        finally:
            self.__dict__.pop("_fused_flags_tracing", None)

    def _step_bufs(self, names: List[str], validate: bool, count: bool, private: bool) -> Dict[str, Any]:
        """The step's buffers: the live states, or private copies of them (a graph's own, or scratch)."""
        bufs: Dict[str, Any] = {}
        for n in names:
            cur = getattr(self, n)
            if isinstance(cur, RingBuffer):
                ring = _ring_clone(cur) if private else cur
                ring._cursor = torch.full((), ring.count, dtype=torch.int64, device=ring.data.device)
                bufs[n] = ring
            else:
                bufs[n] = cur.clone() if private else cur
        if validate:
            bufs[_VIOL] = self._viol_flags.clone() if private else self._viol_flags
        if count:
            bufs[_COUNT] = torch.full((), self._update_count, dtype=torch.int64, device=self._device)
        return bufs

    # compile-cache attribute -> the churn detector's compile kind, and the profiled seam of its steps
    _COMPILE_KINDS = {
        "_auto_update_fn": ("auto_update", "update_compiled"),
        "_auto_forward_fn": ("auto_forward", "forward_compiled"),
        "_jit_update_fn": ("jit_update", "update_jit"),
        "_scan_update_fn": ("scan_update", "update_scan"),
    }

    def _obs_built(self, cache_name: str, key: Any, seconds: float, tally: Any, recorded: Any = None) -> None:
        """Report a step just built (captured on the card, first run on the CPU): its seconds and counted cost.

        The first call of a JAX executable pays its trace and compile
        (``trace_seconds``, JAX ``metric.py:1481``); the port's pays its
        warm-up and capture, or on the CPU its first eager run. ``recorded``
        is the cost an AOT cache hit carried, which stands in for the count.
        """
        if _OBS.enabled:
            telem = _telemetry_for(self)
            telem.inc("trace_seconds", seconds)
            telem.observe("trace", seconds)
        if _OBS.profiling:
            kind = self._COMPILE_KINDS[cache_name][0]
            _PROF_LEDGER.note_executable(
                owner=f"{type(self).__module__}.{type(self).__qualname__}",
                kind=kind,
                digest=hashlib.sha256(repr((kind, key)).encode()).hexdigest(),
                cost=recorded if tally is None else tally.cost(),
                compile_seconds=seconds,
                source="captured" if self._device.type == "cuda" else "compiled",
            )

    def _aot_resolve(self, cache_name: str, key: Any, names: List[str]) -> Any:
        """The AOT cache's word on a key about to be built (``_aot.cache.wrap_executable``); the cache is set.

        The record is keyed by the class, the kind, the churn components of
        ``key`` and the rest of it (the fused flags' switch), and the shapes
        of the states the step updates.
        """
        from torchmetrics_tpu_torch._aot import cache as _aot_cache

        (treedef, statics, sig_inputs, *rest), _policy = key
        states = []
        for n in names:
            v = getattr(self, n)
            v = v.data if isinstance(v, RingBuffer) else v
            states.append((n, tuple(v.shape), str(v.dtype)) if isinstance(v, Tensor) else (n, type(v).__name__))
        return _aot_cache.wrap_executable(
            owner=f"{type(self).__module__}.{type(self).__qualname__}",
            kind=self._COMPILE_KINDS[cache_name][0],
            components=self._compile_components(treedef, statics, sig_inputs),
            extra=repr((tuple(rest), states)),
            telem_obj=self,
        )

    @staticmethod
    def _counted_run(fn: Callable, dynamic: List[Tensor], bufs: Dict[str, Any]) -> Tuple[Any, Any]:
        """``fn()`` under a count of its flops and bytes (profiling on, a step's first run): ``(out, tally)``."""
        with _obs_costs.count_costs(dynamic, bufs) as tally:
            out = fn()
            _obs_costs.add_output_bytes(tally, out)
        return out, tally

    def _run_compiled(
        self, cache_name: str, key: Any, names: List[str], dynamic: List[Tensor], build: Callable, validate: bool, count: bool = False
    ) -> Any:
        """Run the step of ``key``: eagerly on a CPU metric, as a CUDA graph's replay on a CUDA metric.

        The dtype policy is part of the key (JAX ``metric.py:1447``). On the
        card the first call captures: the warm-up applies this batch to the
        graph's own copies of the states, then the capture on those copies
        runs nothing, so the batch reaches the states once. A failure
        anywhere leaves the metric's states as they were. With profiling on,
        a replay is timed by a CUDA event pair (``CapturedStep.replay``) and
        a CPU step by the host clock; the first call is the step's build.
        With the AOT cache set, a build first asks the cache for the key's
        record (which loads the libraries it names) and writes one after.
        """
        key = (key, None if self._dtype_policy is None else str(self._dtype_policy))
        cache = self.__dict__.setdefault(cache_name, {})
        if self._device.type != "cuda":
            first = key not in cache
            res = self._aot_resolve(cache_name, key, names) if first and _AOT.active else None
            if first:
                cache[key] = build()
            bufs = self._step_bufs(names, validate, count, private=first)
            if count:
                cnt = self.__dict__.get("_auto_cnt")
                if cnt is not None and cnt[0] == self._update_count:
                    bufs[_COUNT] = cnt[1]
            t0 = time.perf_counter() if (first and _OBS.enabled) or _OBS.profiling else None
            tally = None
            try:
                if first and _OBS.profiling and (res is None or res.counting):
                    out, tally = self._counted_run(lambda: cache[key](bufs, dynamic), dynamic, bufs)
                else:
                    out = cache[key](bufs, dynamic)
            except Exception:
                if first:
                    del cache[key]
                raise
            if t0 is not None:
                elapsed = time.perf_counter() - t0
                if first:
                    self._obs_built(cache_name, key, elapsed, tally, None if res is None else res.cost)
                elif _OBS.profiling:
                    _PROF_LEDGER.record_step(self._COMPILE_KINDS[cache_name][1], type(self).__name__, elapsed)
            if res is not None:
                res.done("eager", tally)
            self._commit_compiled_states(names, bufs, validate, count)
            return out
        entry = cache.get(key)
        if entry is None:
            res = self._aot_resolve(cache_name, key, names) if _AOT.active else None
            t0 = time.perf_counter()
            step, constants = build(), {}
            bufs = self._step_bufs(names, validate, count, private=True)
            warm = functools.partial(_compile.warm_up, step, bufs, dynamic, self._device, constants)
            counting = _OBS.profiling and (res is None or res.counting)
            out, tally = self._counted_run(warm, dynamic, bufs) if counting else (warm(), None)
            rings = {n: (b.count, b._warned_overflow) for n, b in bufs.items() if isinstance(b, RingBuffer)}
            # one memory pool for the metric's graphs; a pool whose graphs are all
            # gone is not reused (the allocator frees it lazily), so it gets a new one
            if not self._graph_buffer_ids():
                self.__dict__["_graph_pool"] = torch.cuda.graph_pool_handle()
            entry = _compile.CapturedStep(step, bufs, dynamic, self.__dict__["_graph_pool"], self._device, constants)
            # replays are timed on the card under this seam and class while profiling is on
            entry.seam, entry.owner = self._COMPILE_KINDS[cache_name][1], type(self).__name__
            if _OBS.enabled or _OBS.profiling:
                self._obs_built(cache_name, key, time.perf_counter() - t0, tally, None if res is None else res.cost)
            # the capture ran the step's Python but no kernel: put back the host side of each ring
            entry.ring_deltas = {n: bufs[n].count - c for n, (c, _) in rings.items()}
            for n, (c, warned) in rings.items():
                bufs[n].count, bufs[n]._warned_overflow = c, warned
            entry.cursor_at = {n: c for n, (c, _) in rings.items()}
            entry.count_at = self._update_count + 1
            cache[key] = entry
            if res is not None:
                res.done("captured", tally)
            self._commit_compiled_states(names, bufs, validate, count)
            return out
        bufs = entry.bufs
        # the metric may have rebound its states since the last replay
        # (reset, load_state_dict, merge_state, a forward's stash, an eager
        # update): the graph reads and writes only its own buffers
        for n in names:
            cur, buf = getattr(self, n), bufs[n]
            if isinstance(buf, RingBuffer):
                if cur is not buf:
                    buf.data.copy_(cur.data)
                    buf.count, buf._warned_overflow = cur.count, cur._warned_overflow
                buf._shared = False
                if entry.cursor_at[n] != buf.count:
                    buf._cursor.fill_(buf.count)
            elif cur is not buf:
                buf.copy_(cur)
        if validate and self._viol_flags is not bufs[_VIOL]:
            bufs[_VIOL].copy_(self._viol_flags)
        if count and entry.count_at != self._update_count:
            bufs[_COUNT].fill_(self._update_count)
        out = entry.replay(dynamic)
        for n, delta in entry.ring_deltas.items():
            bufs[n]._advance(delta)
            entry.cursor_at[n] = bufs[n].count
        entry.count_at = self._update_count + 1
        self._commit_compiled_states(names, bufs, validate, count)
        # the graph rewrites its outputs on the next replay: hand out copies
        return _tree_map(torch.clone, out)

    def _commit_compiled_states(self, names: List[str], bufs: Dict[str, Any], validate: bool, count: bool) -> None:
        """Bind the states (and flags) to the step's buffers (JAX ``metric.py:1984``)."""
        for n in names:
            buf = bufs[n]
            if isinstance(buf, RingBuffer) and self._device.type != "cuda":
                buf._cursor = None  # a CPU step makes its cursor afresh from the host count
            object.__setattr__(self, n, buf)
        if validate:
            self._viol_flags = bufs[_VIOL]
        if count and self._device.type != "cuda":
            self.__dict__["_auto_cnt"] = (self._update_count + 1, bufs[_COUNT])

    def _graph_buffer_ids(self) -> set:
        ids = set()
        for name in self._COMPILED_CACHES:
            for entry in self.__dict__.get(name, {}).values():
                for buf in getattr(entry, "bufs", {}).values():
                    ids.add(id(buf))
                    if isinstance(buf, RingBuffer):
                        ids.add(id(buf.data))
        return ids

    def _stash_states(self, deep: bool = False) -> Dict[str, State]:
        """The states by reference, except what a graph replay writes into, which is copied.

        ``deep`` also copies every ring buffer's storage (a plain ring copy
        shares it until one side appends, and a replay appends in place).
        """
        ids = self._graph_buffer_ids()
        out: Dict[str, State] = {}
        for attr in self._defaults:
            cur = getattr(self, attr)
            if isinstance(cur, RingBuffer):
                out[attr] = _ring_clone(cur) if (deep or id(cur) in ids or id(cur.data) in ids) else cur
            elif isinstance(cur, Tensor) and (deep or id(cur) in ids):
                out[attr] = cur.clone()
            else:
                out[attr] = cur
        return out

    def _release_graph_buffers(self) -> None:
        """Drop this metric's graphs when other metrics of a compute group hold their state buffers.

        The states are about to be rebound; a later replay would copy them
        into buffers the group's members still read. The signatures stay
        known, so the next call captures afresh.
        """
        if not self._states_aliased:
            return
        ids = self._graph_buffer_ids()
        if ids and any(id(getattr(self, a)) in ids for a in self._defaults):
            for name in self._COMPILED_CACHES:
                self.__dict__.pop(name, None)

    def _try_auto_update(self, args: tuple, kwargs: Dict[str, Any]) -> bool:
        """Route a repeat-signature ``update()`` through the compiled step (JAX ``metric.py:1672``).

        Returns True when the update was handled. The first call with a
        signature runs eagerly, with its checks; the second compiles. Any
        failure turns the path off for this instance only and falls back to
        the eager update, with the cause in ``_auto_disabled_reason``.
        """
        if not self._auto_eligible():
            return False
        try:
            sig, treedef, dynamic, statics = self._auto_signature(args, kwargs)
        except (TorchMetricsUserError, TypeError) as err:
            self._disable_auto(f"unhashable/unsupported update arguments: {err}")
            return False
        if not dynamic or any(d.device != self._device or _compile.overlapping(d) for d in dynamic):
            return False  # python scalars only, a batch on another device, or an expanded view: eager
        seen = self._auto_sigs
        if sig not in seen:
            if len(seen) < self._AUTO_MAX_SIGNATURES:
                seen[sig] = 0  # the first call runs eagerly (validation + warm-up)
                self.__dict__["_auto_capture_next"] = True
                if _OBS.enabled:
                    # a new signature means a new graph (captured at its next call): churn tracking
                    self._obs_compile_event("auto_update", treedef, statics, sig[2])
            elif _OBS.enabled:
                # the signature cache is full: this shape streams eagerly, and no graph is ever built for it
                _telemetry_for(self).inc("signature_overflow")
                self._obs_compile_event("auto_update", treedef, statics, sig[2], built=False)
            return False
        try:
            names = self._auto_state_names("update")
        except TorchMetricsUserError as err:
            self._disable_auto(f"states unsupported by the compiled path: {err}")
            return False
        if names is None:
            return False
        validate = self._auto_validate()
        if validate:
            try:
                validate = self._prime_violation_state(treedef, dynamic, statics)
            except Exception as err:
                self._disable_auto(f"traced validation failed: {type(err).__name__}: {err}", observe=False)
                return False
        if self._states_aliased:
            self._unshare_states()
        obs_sample = _OBS.enabled and _telemetry_for(self).sample_due("update_compiled")
        t0 = time.perf_counter() if obs_sample else 0.0
        key = (treedef, statics, sig[2], validate)
        build = lambda: self._update_step(names, treedef, statics, validate)  # noqa: E731
        try:
            if _OBS.enabled and _OBS.profile_scopes:
                with _obs_scopes.annotation(f"{type(self).__name__}.update[compiled]", self._device.type == "cuda"):
                    self._run_compiled("_auto_update_fn", key, names, dynamic, build, validate)
            else:
                self._run_compiled("_auto_update_fn", key, names, dynamic, build, validate)
        except Exception as err:
            self._disable_auto(f"compiled update failed: {type(err).__name__}: {err}")
            return False
        if _OBS.enabled:
            telem = _telemetry_for(self)
            telem.inc("update_calls|path=auto_compiled")
            if obs_sample:
                telem.observe("update_compiled", time.perf_counter() - t0)
        seen[sig] += 1
        self._computed = None
        self._update_count += 1
        return True

    def _auto_forward_mergeable(self, names: List[str]) -> bool:
        """True when every state merges by a fixed-shape reduction (no ring buffer)."""
        for n in names:
            if isinstance(getattr(self, n), RingBuffer):
                return False
            reduce_fn = self._reductions[n]
            if not (reduce_fn in ("sum", "mean", "max", "min") or callable(reduce_fn)):
                return False
        return True

    def _try_auto_forward(self, args: tuple, kwargs: Dict[str, Any]) -> Tuple[bool, Any]:
        """Compiled ``forward`` of a reduce-state metric (JAX ``metric.py:1821``).

        One step computes the batch value and merges the batch state into the
        global state, in place of the eager stash/reset/update/compute/merge.
        ``mean`` states are weighted by the previous update count, which the
        step keeps as a device scalar. A violating batch adds nothing, and
        its value comes back as NaN (or the integer type's least value).
        """
        if self._auto_forward_disabled or not self._auto_eligible():
            return False, None
        try:
            sig, treedef, dynamic, statics = self._auto_signature(args, kwargs)
        except (TorchMetricsUserError, TypeError) as err:
            self._disable_auto(f"unhashable/unsupported forward arguments: {err}", forward_only=True)
            return False, None
        if not dynamic or any(d.device != self._device or _compile.overlapping(d) for d in dynamic):
            return False, None
        seen = self._auto_fwd_sigs
        if sig not in seen:
            if len(seen) < self._AUTO_MAX_SIGNATURES:
                seen[sig] = 0
                if _OBS.enabled:
                    self._obs_compile_event("auto_forward", treedef, statics, sig[2])
            elif _OBS.enabled:
                _telemetry_for(self).inc("signature_overflow")
                self._obs_compile_event("auto_forward", treedef, statics, sig[2], built=False)
            return False, None
        try:
            names = self._auto_state_names("forward")
        except TorchMetricsUserError as err:
            self._disable_auto(f"states unsupported by the compiled forward: {err}", forward_only=True)
            return False, None
        if names is None or not self._auto_forward_mergeable(names):
            self._auto_forward_disabled = True
            if names is not None and _OBS.enabled:
                self._obs_auto_disabled("state reductions do not merge functionally under trace", "metric.forward")
            return False, None
        validate = self._auto_validate()
        if validate:
            try:
                validate = self._prime_violation_state(treedef, dynamic, statics)
            except Exception:
                self._auto_forward_disabled = True
                return False, None
        if self._states_aliased:  # the step merges into the states in place
            self._unshare_states()
        obs_sample = _OBS.enabled and _telemetry_for(self).sample_due("forward_compiled")
        t0 = time.perf_counter() if obs_sample else 0.0
        key = (treedef, statics, sig[2], validate)
        build = lambda: self._forward_step(names, treedef, statics, validate)  # noqa: E731
        try:
            if _OBS.enabled and _OBS.profile_scopes:
                with _obs_scopes.annotation(f"{type(self).__name__}.forward[compiled]", self._device.type == "cuda"):
                    batch_val = self._run_compiled("_auto_forward_fn", key, names, dynamic, build, validate, count=True)
            else:
                batch_val = self._run_compiled("_auto_forward_fn", key, names, dynamic, build, validate, count=True)
        except Exception as err:
            self._disable_auto(f"compiled forward failed: {type(err).__name__}: {err}", forward_only=True)
            return False, None
        if _OBS.enabled:
            telem = _telemetry_for(self)
            telem.inc("update_calls|path=forward_compiled")
            if obs_sample:
                telem.observe("forward_compiled", time.perf_counter() - t0)
        seen[sig] += 1
        self._update_count += 1
        self._computed = None
        self._is_synced = False
        self._should_unsync = True
        self._to_sync = self.sync_on_compute
        return True, batch_val

    def precompile(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Warm the compiled update for this argument signature (JAX ``metric.py:2007``).

        Runs the real update machinery on the example batch, so the step is
        built (and, on the card, captured), then puts back the states, the
        update count, the cached value and the violation flags exactly as
        they were. The signature stays registered, so the first real
        ``update()`` of that signature replays at once. Returns ``engaged``
        (the compiled path is armed) and ``reason`` when it is not.
        """
        report: Dict[str, Any] = {"engaged": False, "reason": None}
        if not self._auto_eligible():
            report["reason"] = (
                "auto path disabled for this instance"
                if (self._auto_disabled or not self.auto_compile)
                else "class streams eagerly (not certified for the compiled default path)"
            )
            return report
        stash = self._stash_states(deep=True)
        saved_count, saved_computed = self._update_count, self._computed
        saved_viol = None if self._viol_flags is None else self._viol_flags.clone()
        self.__dict__["_journal_suspend"] = True  # the warm-up's batches are not the stream's
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                try:
                    sig, treedef, dynamic, statics = self._auto_signature(args, kwargs)
                except (TorchMetricsUserError, TypeError):
                    sig = dynamic = None
                if dynamic and sig not in self._auto_sigs:
                    if len(self._auto_sigs) >= self._AUTO_MAX_SIGNATURES:
                        if _OBS.enabled:
                            _telemetry_for(self).inc("signature_overflow")
                        report["reason"] = (
                            f"signature cache saturated ({self._AUTO_MAX_SIGNATURES} shapes):"
                            " this signature streams eagerly"
                        )
                        return report
                    self._auto_sigs[sig] = 0
                    if _OBS.enabled:
                        self._obs_compile_event("auto_update", treedef, statics, sig[2])
                self.update(*args, **kwargs)
                if "_auto_update_fn" not in self.__dict__ and not self._auto_disabled:
                    # a lazily shaped ring buffer warms up on the first pass
                    self.update(*args, **kwargs)
        finally:
            self.__dict__.pop("_journal_suspend", None)
            self._update_count, self._computed = saved_count, saved_computed
            self._viol_flags = saved_viol
            self._restore_state(stash)
        report["engaged"] = "_auto_update_fn" in self.__dict__ and not self._auto_disabled
        if not report["engaged"]:
            report["reason"] = "update did not compile (see telemetry `auto_path_disabled` events)"
        return report

    def jit_update(self, *args: Any, **kwargs: Any) -> None:
        """``update()`` as one compiled step (JAX ``metric.py:2089``): a CUDA graph per signature on the card.

        The first call with a signature compiles (no eager pass); value
        checks are skipped, as under any compiled update with no fused
        flags. Tensor arguments are the step's inputs, other arguments
        static. A capture failure raises: this path never falls back.
        """
        names = self._fixed_shape_state_names("jit_update")
        if names is None:  # a ring buffer's first batch allocates eagerly
            self.update(*args, **kwargs)
            return
        sig, treedef, dynamic, statics = self._auto_signature(args, kwargs, "jit_update")
        if self._states_aliased:
            self._unshare_states()
        run = functools.partial(
            self._run_compiled,
            "_jit_update_fn",
            (treedef, statics, sig[2]),
            names,
            dynamic,
            lambda: self._update_step(names, treedef, statics, False),
            False,
        )
        if _OBS.enabled:
            self._obs_compile_event("jit_update", treedef, statics, sig[2])
            self._obs_call("update_calls|path=jit", "update_jit", "jit_update", run)
        else:
            run()
        self._computed = None
        self._update_count += 1
        self._journal_record("update", args, kwargs)

    def scan_update(self, *args: Any, **kwargs: Any) -> None:
        """Consume a stacked stream of batches in one compiled step (JAX ``metric.py:2127``).

        Every tensor argument carries a leading stream axis of one length
        ``S``; the call equals ``S`` successive ``update()`` calls. On the card
        the ``S`` steps are captured into one graph, so the stream costs one
        replay. Same constraints as :meth:`jit_update`; a capture failure raises.
        """
        names = self._fixed_shape_state_names("scan_update")
        if names is None:  # a ring buffer's first batch allocates eagerly
            first = _tree_map(lambda x: x[0], (args, kwargs))
            self.update(*first[0], **first[1])
            rest = _tree_map(lambda x: x[1:], (args, kwargs))
            leaves: List[Any] = []
            _flatten_args(rest, leaves)
            arr = [x for x in leaves if isinstance(x, Tensor)]
            if arr and arr[0].shape[0]:
                self.scan_update(*rest[0], **rest[1])
            return
        sig, treedef, dynamic, statics = self._auto_signature(args, kwargs, "scan_update")
        if not dynamic:
            raise TorchMetricsUserError("`scan_update` needs at least one tensor argument with a stream axis")
        n_steps = int(dynamic[0].shape[0])
        if self._states_aliased:
            self._unshare_states()
        run = functools.partial(
            self._run_compiled,
            "_scan_update_fn",
            (treedef, statics, sig[2]),
            names,
            dynamic,
            lambda: self._update_step(names, treedef, statics, False, steps=n_steps),
            False,
        )
        if _OBS.enabled:
            self._obs_compile_event("scan_update", treedef, statics, sig[2])
            self._obs_call("update_calls|path=scan", "update_scan", "scan_update", run)
            _telemetry_for(self).inc("scan_steps", n_steps)
        else:
            run()
        self._computed = None
        self._update_count += n_steps
        # "scan" replays through scan_update: the arguments carry a leading
        # stream axis that plain update() must not see as one batch
        self._journal_record("scan", args, kwargs)

    def to_spmd(self, *, mesh: Any = None, axis_name: str = "dp", **kwargs: Any) -> Any:
        """Hand this (fresh) metric to the SPMD in-graph engine (JAX ``metric.py:1069``).

        Returns a :class:`~torchmetrics_tpu_torch._spmd.SpmdEngine` whose
        ``step(batch)`` runs update, the sync over the mesh's rows and compute
        as one step, one CUDA graph a signature on the card, in place of
        streaming ``update()`` and syncing after. ``mesh``: a
        :func:`~torchmetrics_tpu_torch._spmd.build_mesh` mesh, taken as it
        is, whose rows in this process all lie on this metric's device
        (default: one row over the default process group where
        ``torch.distributed`` is initialized, else every visible card). A
        mesh built with ``process_group=`` spans the group's processes, one
        a card: each passes ``step`` its own share of the batch, and the
        sync runs collectives over the group. Classes the eligibility copy's
        ``in_graph_sync`` facet certifies host-bound raise
        :class:`~torchmetrics_tpu_torch._spmd.InGraphSyncUnsupported` and keep
        the eager path.
        """
        from torchmetrics_tpu_torch._spmd import SpmdEngine

        return SpmdEngine(self, mesh=mesh, axis_name=axis_name, **kwargs)

    def sync_in_jit(self, state: Dict[str, Any], axis_name: str, axis_index_groups: Optional[Any] = None) -> Dict[str, Any]:
        """Sync an explicit row-stacked state dict over a mesh axis by this metric's reductions (JAX ``metric.py:1104``).

        See :func:`~torchmetrics_tpu_torch.utilities.distributed.sync_in_jit`.
        ``axis_index_groups`` partitions the rows into independent groups (the
        in-graph form of ``process_group``). A flat ``process_group`` names one
        subset, not a partition of the whole axis, so it cannot be translated:
        it must be spelled out here.
        """
        if axis_index_groups is None and self.process_group is not None:
            raise TorchMetricsUserError(
                "This metric was constructed with `process_group`, which the in-jit sync cannot infer a"
                " mesh partition from. Pass `axis_index_groups` explicitly, e.g."
                " `metric.sync_in_jit(state, 'dp', axis_index_groups=[[0, 1], [2, 3]])`."
            )
        return sync_in_jit(state, self._reductions, axis_name, axis_index_groups=axis_index_groups)

    def to_stream_pool(self, *, capacity: int = 8, **kwargs: Any) -> Any:
        """N independent streams of this (fresh) metric behind one vmapped step (JAX ``metric.py:1085``).

        Returns a :class:`~torchmetrics_tpu_torch._streams.StreamPool` that
        stacks ``capacity`` independent copies of this metric's states along
        a leading slot axis on its device and updates any micro-batch of them
        in one step (``pool.update(stream_ids, *args)``), with O(1)
        ``attach``/``detach``/``reset(i)`` and per-stream ``compute(i)``. The
        metric itself is the template: it never accumulates. Classes whose
        update or compute does not trace raise
        :class:`~torchmetrics_tpu_torch._streams.StreamPoolUnsupported`.
        """
        from torchmetrics_tpu_torch._streams import StreamPool

        return StreamPool(self, capacity=capacity, **kwargs)

    def _apply_dtype_policy(self) -> None:
        """Re-cast floating states to the ``set_dtype`` policy after an update (JAX ``metric.py:782``)."""
        dst = self._dtype_policy
        for attr in self._defaults:
            current = getattr(self, attr)
            if isinstance(current, RingBuffer):
                if current.data is not None and current.data.is_floating_point():
                    current.data = current.data.to(dst)
            elif isinstance(current, list):
                setattr(self, attr, [v.to(dst) if v.is_floating_point() else v for v in current])
            elif current.is_floating_point():
                setattr(self, attr, current.to(dst))

    def set_dtype(self, dst_type: torch.dtype) -> "Metric":
        """Cast floating states to ``dst_type`` and keep them so (JAX ``metric.py:2513``).

        The policy is part of every compiled step's cache key, so a step
        compiled before the call is never replayed after it.
        """
        self._dtype_policy = dst_type
        # state dtypes are part of the cross-process structure contract: the
        # next guarded sync must run the handshake again
        self.__dict__.pop("_handshake_ok_digest", None)
        self._apply_dtype_policy()
        return self

    def _move_list_states_to_cpu(self) -> None:
        """Offload append-mode (list) states to host memory after each update (reference ``metric.py:483-488``)."""
        for attr in self._defaults:
            value = getattr(self, attr)
            if isinstance(value, RingBuffer):
                value.to_device("cpu")
            elif isinstance(value, list):
                setattr(self, attr, [v.to("cpu") for v in value])

    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            _sp = _obs_trace.begin_span("compute", type(self).__name__) if _OBS.tracing else None
            _sp_err: Optional[BaseException] = None
            try:
                return _compute_impl(_sp, args, kwargs)
            except BaseException as err:
                _sp_err = err
                raise
            finally:
                if _sp is not None:
                    _obs_trace.end_span(_sp, _sp_err)

        def _compute_impl(_sp: Any, args: tuple, kwargs: Dict[str, Any]) -> Any:
            self._check_pending_violations()
            if not self.update_called:
                rank_zero_warn(
                    f"The ``compute`` method of metric {self.__class__.__name__}"
                    " was called before the ``update`` method which may lead to errors,"
                    " as metric states have not yet been updated.",
                    UserWarning,
                )
            if self._computed is not None:
                if _sp is not None:
                    _sp.attrs["outcome"] = "cache_hit"
                if _OBS.enabled:
                    _telemetry_for(self).inc("compute_calls|outcome=cache_hit")
                return self._computed
            # the sync inside sync_context opens its own child span: a traced
            # compute reads update -> sync -> compute causally
            with self.sync_context(
                dist_sync_fn=self.dist_sync_fn,
                should_sync=self._to_sync,
                should_unsync=self._should_unsync,
            ):
                if _OBS.enabled:
                    value = _squeeze_if_scalar(
                        self._obs_call(
                            "compute_calls|outcome=computed", "compute", "compute", lambda: compute(*args, **kwargs)
                        )
                    )
                else:
                    value = _squeeze_if_scalar(compute(*args, **kwargs))
            if self.compute_with_cache:
                self._computed = value
            return value

        return wrapped_func

    @abstractmethod
    def update(self, *_: Any, **__: Any) -> None:
        """Override: accumulate batch statistics into the registered states."""

    @abstractmethod
    def compute(self) -> Any:
        """Override: compute the final value from the current state."""

    # ----------------------------------------------------------------- sync
    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Callable] = None,
    ) -> None:
        """Gather + reduce state across processes (reference ``metric.py:490-532``).

        Does nothing when no ``torch.distributed`` process group is
        initialised (nor a simulated world, ``_resilience.faultinject``). With
        a :class:`~torchmetrics_tpu_torch._resilience.policy.SyncPolicy`
        attached (the metric's ``sync_policy`` or the process-wide default)
        the gather runs guarded (JAX ``metric.py:894-949``): structure
        handshake, per-attempt timeout, retry with backoff and, once the
        attempts are spent, local-only state with a recorded
        ``DegradationEvent`` in place of a hang or an exception.
        """
        if self._is_synced and should_sync:
            raise TorchMetricsUserError("The Metric has already been synced.")
        if distributed_available is None:
            distributed_available = self.distributed_available_fn
        is_distributed = distributed_available() if callable(distributed_available) else None
        if not should_sync or not is_distributed:
            return
        if dist_sync_fn is None:
            dist_sync_fn = self.dist_sync_fn or gather_all_tensors
        self.__dict__.pop("_degraded_unsync_ok", None)  # a stale pairing flag
        group = process_group or self.process_group
        policy = self.sync_policy
        if policy is None and not self.__dict__.get("_sync_policy_explicit"):
            # the process-wide default, only where the metric expressed no
            # choice: an explicit sync_policy=None means unguarded
            policy = _res_policy.default_sync_policy()
        self._cache = self._copy_state_dict()
        _sp = None
        if _OBS.tracing:
            _sp = _obs_trace.begin_span("sync", type(self).__name__, mode="unguarded" if policy is None else "guarded")
        _sp_err: Optional[BaseException] = None
        try:
            self._sync_guarded_or_not(dist_sync_fn, group, policy)
        except BaseException as err:
            _sp_err = err
            raise
        finally:
            if _sp is not None:
                _obs_trace.end_span(_sp, _sp_err)

    def _sync_guarded_or_not(self, dist_sync_fn: Callable, group: Any, policy: Any) -> None:
        """The committed half of :meth:`sync` (the seam's span brackets exactly the collective work)."""
        if policy is None:
            if _OBS.enabled:
                self._obs_call(
                    "sync_calls|mode=unguarded", "sync", "sync", lambda: self._sync_dist(dist_sync_fn, process_group=group)
                )
            else:
                self._sync_dist(dist_sync_fn, process_group=group)
            self._is_synced = True
            return
        from torchmetrics_tpu_torch._resilience.guard import guarded_metric_sync

        try:
            if _OBS.enabled:
                synced = self._obs_call(
                    "sync_calls|mode=guarded", "sync", "sync",
                    lambda: guarded_metric_sync(self, dist_sync_fn, group, policy),
                )
            else:
                synced = guarded_metric_sync(self, dist_sync_fn, group, policy)
        except Exception:
            # on_exhausted="raise" or a handshake mismatch: the metric keeps
            # its intact local state, never half-committed
            self._restore_state(self._cache)
            self._cache = None
            self._is_synced = False
            raise
        if synced:
            self._is_synced = True
        else:
            # degraded: keep local-only state (the gather is pure, but an
            # overridden `_sync_dist` may fuse gather and commit). The flag
            # keeps a manual sync()/unsync() pairing graceful: the paired
            # unsync does nothing instead of raising
            self._restore_state(self._cache)
            self._cache = None
            self._is_synced = False
            self.__dict__["_degraded_unsync_ok"] = True

    def _dist_gather(self, dist_sync_fn: Callable, process_group: Optional[Any] = None) -> Dict[str, Any]:
        """Gather every state across processes: a pure read, no state changes (JAX ``metric.py:979``).

        Side-effect free, so the guarded sync can run it on a watchdog
        thread: an abandoned attempt that completes later has nothing it
        can corrupt. A ring buffer gathers its live rows, like a
        pre-concatenated list (JAX ``metric.py:989``).
        """
        input_dict = {attr: getattr(self, attr) for attr in self._reductions}
        for attr, value in input_dict.items():
            if isinstance(value, RingBuffer):
                input_dict[attr] = [value.values()] if value.num_valid else []
            # pre-concatenate list states to minimize the number of all_gathers
            elif isinstance(value, list) and len(value) >= 1:
                input_dict[attr] = [dim_zero_cat(value)]
        output_dict: Dict[str, Any] = {}
        for attr, value in input_dict.items():
            if isinstance(value, list):
                output_dict[attr] = _flatten_maybe([dist_sync_fn(v, process_group) for v in value])
            else:
                output_dict[attr] = dist_sync_fn(value, process_group)
        return output_dict

    def _sync_dist(self, dist_sync_fn: Callable = gather_all_tensors, process_group: Optional[Any] = None) -> None:
        """Reference ``metric.py:427-457``: pre-concat lists, gather, reduce.

        After the sync a ring buffer's state is the concatenation of its live
        rows over the ranks, rank by rank.
        """
        self._commit_gathered(self._dist_gather(dist_sync_fn, process_group))

    def _commit_gathered(self, output_dict: Dict[str, Any]) -> None:
        """Reduce the gathered per-process states into this metric's states (JAX ``metric.py:1008``)."""
        for attr, reduction_fn in self._reductions.items():
            gathered = output_dict[attr]
            if isinstance(gathered, list) and len(gathered) == 0:
                setattr(self, attr, [])
                continue
            if isinstance(gathered[0], Tensor) and not isinstance(getattr(self, attr), (list, RingBuffer)):
                if len({g.shape for g in gathered}) == 1:
                    gathered = torch.stack(gathered)
            fn = _STR_REDUCTIONS.get(reduction_fn, reduction_fn) if isinstance(reduction_fn, str) else reduction_fn
            setattr(self, attr, fn(gathered) if fn is not None else gathered)

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore cached local (pre-sync) state (reference ``metric.py:534-554``)."""
        if not should_unsync:
            return
        if not self._is_synced:
            if self.__dict__.pop("_degraded_unsync_ok", False):
                return  # the paired sync() degraded to local-only: nothing to undo
            raise TorchMetricsUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise TorchMetricsUserError("The internal cache should exist to unsync the Metric.")
        self._restore_state(self._cache)
        self._is_synced = False
        self._cache = None

    class _SyncContext:
        def __init__(self, metric: "Metric", kwargs: Dict[str, Any], should_unsync: bool):
            self.metric = metric
            self.kwargs = kwargs
            self.should_unsync = should_unsync

        def __enter__(self) -> None:
            self.metric.sync(**self.kwargs)

        def __exit__(self, *exc: Any) -> None:
            if self.should_unsync and self.metric._is_synced:
                self.metric.unsync()

    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[Callable] = None,
    ) -> "_SyncContext":
        """Context manager: sync on enter, restore on exit (reference ``metric.py:556-591``)."""
        return Metric._SyncContext(
            self,
            {
                "dist_sync_fn": dist_sync_fn,
                "process_group": process_group,
                "should_sync": should_sync,
                "distributed_available": distributed_available,
            },
            should_unsync,
        )

    # ---------------------------------------------------------------- merge
    def merge_state(self, incoming: Union["Metric", Dict[str, Any]]) -> None:
        """Merge another metric's (or a raw state dict's) state into this one.

        Applies the declared per-state reductions, as forward accumulation and
        distributed sync do. A raw dict counts as one update.

        A raw state dict that carries an integrity block (saved with
        ``state_dict(integrity=True)``) is verified before anything merges
        (JAX ``metric.py:2176-2212``): a checksum mismatch or a NaN-poisoned
        payload raises
        :class:`~torchmetrics_tpu_torch._resilience.errors.StateCorruptionError`
        instead of folding a corrupt contribution into this metric.
        """
        if isinstance(incoming, Metric):
            if type(incoming) is not type(self):
                raise TorchMetricsUserError(
                    f"Cannot merge state of {type(incoming).__name__} into {type(self).__name__}"
                )
            incoming_state = incoming.metric_state
            incoming_count = incoming._update_count
        else:
            meta = incoming.get(_integrity.integrity_key(""))
            if meta is not None:
                # the dict announced verifiability: honouring the block is not
                # optional, or a bit-flipped payload merges as clean data
                corrupted = _integrity.verify_states(incoming, "", meta, type(self).__name__, include_missing=True)
                if corrupted:
                    _integrity.raise_corrupted(type(self).__name__, corrupted)
            incoming_state = incoming
            incoming_count = 1
        self._merge_from(incoming_state, incoming_count)
        # a merge is a real stream transition: journal it (state and count),
        # so a restore after a crash replays the merged contribution too
        self._journal_record("merge", ({k: incoming_state[k] for k in self._defaults}, incoming_count), {})

    def _merge_from(self, incoming_state: Dict[str, Any], incoming_count: int) -> None:
        self._release_graph_buffers()
        prev_count = self._update_count
        self._update_count = prev_count + incoming_count
        current = self.metric_state
        self._restore_state({k: self._to_state(incoming_state[k]) for k in self._defaults})
        # `current` (pre-merge self) carries prev_count updates, the restored
        # incoming state carries incoming_count: weight mean-merges accordingly
        self._reduce_states(current, incoming_weight=prev_count, local_weight=max(incoming_count, 1))
        self._computed = None

    # ---------------------------------------------------------------- reset
    def reset(self) -> None:
        """Reset states to their defaults (reference ``metric.py:673-688``).

        A deferred violation of the compiled path still surfaces here, after
        the reset (JAX ``metric.py:2227``): one call both raises and leaves a
        clean metric.
        """
        pending: Optional[BaseException] = None
        try:
            self._check_pending_violations()
        except RuntimeError as err:  # the check has already cleared the flags
            pending = err
        self._release_graph_buffers()
        self._update_count = 0
        self._forward_cache = None
        self._computed = None
        for attr in self._defaults:
            self._reset_state_to_default(attr)
        self._cache = None
        self._is_synced = False
        self._states_aliased = False
        # a mid-stream reset is a state transition like any other: without a
        # journal entry, a restore after a crash would bring back the
        # accumulation reset() discarded
        self._journal_record("reset", (), {})
        if pending is not None:
            raise pending

    def _reset_state_to_default(self, attr: str) -> None:
        """Rebind one state to its default (``reset`` and ``load_state_dict(strict="repair")`` share it)."""
        default = self._defaults[attr]
        if isinstance(default, RingBuffer):
            setattr(self, attr, default.copy_empty())
        else:
            setattr(self, attr, [] if isinstance(default, list) else default.clone())

    def clone(self) -> "Metric":
        """Deep copy of the metric (reference ``metric.py:690-692``)."""
        return deepcopy(self)

    # ----------------------------------------------------------- persistence
    def _to_state(self, value: Any) -> State:
        """A private copy of ``value`` on the metric's device (states are mutated in place).

        Numpy arrays (a snapshot's or the JAX package's checkpoint) load too,
        ``bfloat16`` ones included.
        """
        if isinstance(value, RingBuffer):
            return value.copy().to_device(self._device)
        if isinstance(value, list):
            return [_integrity.from_host(v, self._device).clone() for v in value]
        return _integrity.from_host(value, self._device).clone()

    def _copy_state_dict(self) -> Dict[str, State]:
        def _copy(cur: State) -> State:
            if isinstance(cur, RingBuffer):
                return cur.copy()
            return [v.clone() for v in cur] if isinstance(cur, list) else cur.clone()

        return {attr: _copy(cur) for attr, cur in self.metric_state.items()}

    def _restore_state(self, cache: Dict[str, State]) -> None:
        for attr, val in cache.items():
            setattr(self, attr, val)

    def persistent(self, mode: bool = False) -> None:
        """Flip the persistence flag of all states (reference ``metric.py:834-837``)."""
        for key in self._persistent:
            self._persistent[key] = mode

    def state_dict(  # type: ignore[override]
        self,
        destination: Optional[Dict] = None,
        prefix: str = "",
        keep_vars: bool = False,
        integrity: bool = False,
        all_states: bool = False,
        _host: bool = False,
    ) -> Dict[str, State]:
        """Copies of the persistent states under their names (reference ``metric.py:839-871``).

        ``all_states=True`` includes every registered state regardless of its
        ``persistent`` flag (what the snapshot layer needs: a preemption must
        not lose non-persistent accumulators). Values are copies, since live
        states are updated in place. A ring buffer saves its live rows as one
        tensor.

        ``integrity=True`` also writes a checksummed, versioned metadata block
        under the non-identifier key ``{prefix}#integrity``
        (``_resilience/integrity.py``): a restore then verifies every state's
        checksum and the schema version, and rejects a corrupt or
        NaN-poisoned checkpoint. ``_host=True`` gives host numpy copies
        (one device-to-host copy a state, its digest taken from it).
        """
        destination = {} if destination is None else destination
        copy = _integrity.to_host if _host else (lambda t: t.detach().clone())
        for key, current in self.metric_state.items():
            if not (all_states or self._persistent[key]):
                continue
            if isinstance(current, RingBuffer):
                destination[prefix + key] = copy(current.values())
            elif isinstance(current, list):
                destination[prefix + key] = [copy(v) for v in current]
            else:
                destination[prefix + key] = copy(current)
        if integrity:
            _integrity.attach_integrity(destination, list(self._defaults), prefix, type(self).__name__)
        return destination

    def _loaded_value(self, key: str, value: Any) -> State:
        """A checkpoint's value of state ``key`` as this metric holds it.

        Integer counts take the default's integer dtype: the JAX package keeps
        int32 where the port keeps int64 (and back), so a checkpoint of either
        loads into the other, after its checksum was verified on what came in.
        """
        val = self._to_state(value)
        default = self._defaults[key]
        if isinstance(default, RingBuffer):
            ring = default.copy_empty()
            if not isinstance(val, Tensor) or val.numel():
                ring.extend(val)
            return ring
        if isinstance(default, list):
            # one concatenated array loaded into a list state
            return ([val] if val.numel() else []) if isinstance(val, Tensor) else val
        if (
            not val.is_floating_point() and not default.is_floating_point()
            and val.dtype != default.dtype and val.dtype != torch.bool and default.dtype != torch.bool
        ):
            val = val.to(default.dtype)
        return val

    def load_state_dict(  # type: ignore[override]
        self, state_dict: Dict[str, Any], strict: Union[bool, str] = True, prefix: str = "", _verified: bool = False
    ) -> None:
        """Restore states from a :meth:`state_dict` mapping; tensors or numpy arrays (JAX ``metric.py:2330``).

        When the checkpoint carries an integrity block (saved with
        ``state_dict(integrity=True)``) every covered state is verified
        before anything loads: a checksum mismatch, an unknown schema version
        or a NaN-poisoned payload raises
        :class:`~torchmetrics_tpu_torch._resilience.errors.StateCorruptionError`
        naming the states. ``strict="repair"`` instead resets only the
        corrupted states to their defaults, loads the rest and records a
        ``state_repair`` degradation (it also NaN-screens a checkpoint
        without an integrity block). ``_verified``: a collection's atomic
        pre-pass has already hashed every state.
        """
        corrupted: Dict[str, str] = {}
        meta = state_dict.get(_integrity.integrity_key(prefix))
        if meta is not None and not _verified:
            corrupted = _integrity.verify_states(
                state_dict,
                prefix,
                meta,
                type(self).__name__,
                # strict=False tolerates missing keys by contract (filtered or
                # partial checkpoints); present-but-corrupt states still raise
                include_missing=strict is not False,
            )
        elif meta is None and strict == "repair":
            corrupted = _integrity.screen_nonfinite(state_dict, prefix, list(self._defaults))
        if corrupted and strict != "repair":
            _integrity.raise_corrupted(type(self).__name__, corrupted)
        # every value is converted before any state binds: a bad one leaves the metric as it was
        loaded: Dict[str, State] = {}
        for key in self._defaults:
            if key in corrupted:
                continue
            if prefix + key in state_dict:
                loaded[key] = self._loaded_value(key, state_dict[prefix + key])
            elif strict == "repair" and self._persistent[key]:
                # repair does not depend on whether an integrity block survived:
                # a missing persistent state goes back to its default
                corrupted[key] = "missing from the checkpoint"
            elif strict and self._persistent[key]:
                raise KeyError(f"Missing key {key!r} in state_dict for {self.__class__.__name__}")
        self._release_graph_buffers()
        for key in self._defaults:
            if key in corrupted:
                self._reset_state_to_default(key)
            elif key in loaded:
                setattr(self, key, loaded[key])
        if corrupted:  # strict == "repair"
            self._record_degradation(
                "state_repair",
                detail=(
                    'load_state_dict(strict="repair") reset corrupted state(s) to defaults: '
                    + "; ".join(f"`{k}`: {v}" for k, v in sorted(corrupted.items()))
                ),
            )
            self._computed = None
        # restored dtypes and shapes may differ from what the last handshake saw
        self.__dict__.pop("_handshake_ok_digest", None)
        # a manual load mid-stream is a transition update entries cannot
        # reconstruct: the journal anchors it with a fresh snapshot
        self._journal_record("external", (), {})

    def __getstate__(self) -> Dict[str, Any]:
        """Pickle support: drop the wrapped bound methods (reference ``metric.py:694-702``)."""
        # telemetry is per-instance stream history: a pickled or cloned metric is a new stream
        # a SnapshotManager holds threads and file handles: clones and pickles travel without it
        dropped = (
            "update", "compute", "_update_signature", "_auto_sigs", "_auto_fwd_sigs", "_auto_cnt", "_graph_pool",
            "_telem", "_obs_seen_sigs", "_snapshot_hook",
        )
        state = {k: v for k, v in self.__dict__.items() if k not in dropped + self._COMPILED_CACHES}
        state["_computed"] = None
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        """Unpickle: re-wrap update/compute (reference ``metric.py:704-713``)."""
        super().__setstate__(state)
        self._update_signature = inspect.signature(self.update)
        self.update = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute = self._wrap_compute(self.compute)  # type: ignore[method-assign]
        self._auto_sigs = {}
        self._auto_fwd_sigs = {}
        self._auto_names = None
        # pickles written before the resilience knobs existed lack them
        for key, value in (("sync_policy", None), ("nan_policy", None), ("_sync_policy_explicit", False),
                           ("_quarantined_updates", 0), ("_snapshot_hook", None)):
            self.__dict__.setdefault(key, value)
        self.__dict__.setdefault("_resilience_events", [])

    def __setattr__(self, name: str, value: Any) -> None:
        """Class-flag immutability guard (reference ``metric.py:715-726``)."""
        if name in ("higher_is_better", "is_differentiable", "full_state_update"):
            raise RuntimeError(f"Can't change const `{name}`.")
        super().__setattr__(name, value)

    # ---------------------------------------------------------- device/dtype
    def _apply(self, fn: Callable, recurse: bool = True) -> "Metric":
        """Carry ``.to()``/``.cuda()``/``.cpu()`` over to the states, their defaults and the cached values.

        Only the device (and a 4-D/5-D memory format) of ``fn`` is applied:
        a floating dtype never changes here, neither a state's nor a child
        network's, as in the JAX package, where ``set_dtype`` is the only cast.
        """
        move, device = _device_move(fn, self._device)
        this = super()._apply(move, recurse)
        this._device = device
        # the graphs read and write buffers on the old device
        for name in self._COMPILED_CACHES + ("_auto_cnt", "_graph_pool"):
            this.__dict__.pop(name, None)
        if this._viol_flags is not None:
            this._viol_flags = this._viol_flags.to(this._device)
        for attr, default in self._defaults.items():
            cur = getattr(this, attr)
            if isinstance(cur, RingBuffer):
                cur._apply(move, this._device)
            else:
                setattr(this, attr, [move(v) for v in cur] if isinstance(cur, list) else move(cur))
            if isinstance(default, Tensor):
                this._defaults[attr] = move(default)
            elif isinstance(default, RingBuffer):
                default.device = this._device
        if isinstance(this._computed, Tensor):
            this._computed = move(this._computed)
        if isinstance(this._forward_cache, Tensor):
            this._forward_cache = move(this._forward_cache)
        return this

    def to_device(self, device: Union[str, torch.device]) -> "Metric":
        """Move every state, ring buffer and list state to ``device`` (JAX ``metric.py:2501``)."""
        return self.to(torch.device(device))

    @property
    def dtype(self) -> torch.dtype:
        """Default floating dtype (JAX ``metric.py:2549``): the ``set_dtype`` policy, else the first floating state's, else float32."""
        if self._dtype_policy is not None:
            return self._dtype_policy
        for attr in self._defaults:
            current = getattr(self, attr, None)
            if isinstance(current, Tensor) and current.is_floating_point():
                return current.dtype
        return torch.float32

    def type(self, dst_type: Any) -> "Metric":  # noqa: A003 - a no-op, as in the JAX package (metric.py:2560)
        return self

    def float(self) -> "Metric":  # noqa: A003 - a no-op, as in the JAX package
        return self

    def double(self) -> "Metric":
        return self

    def half(self) -> "Metric":
        return self

    def bfloat16(self) -> "Metric":
        return self

    # ---------------------------------------------------------------- dunder
    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Filter kwargs to those accepted by this metric's update (reference ``metric.py:892-911``)."""
        _params = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        _sign_params = self._update_signature.parameters
        filtered_kwargs = {
            k: v for k, v in kwargs.items() if (k in _sign_params and _sign_params[k].kind not in _params)
        }
        exists_var_keyword = any(v.kind == inspect.Parameter.VAR_KEYWORD for v in _sign_params.values())
        return kwargs if exists_var_keyword else filtered_kwargs

    def __hash__(self) -> int:
        """Id+state hash (reference ``metric.py:913-936``)."""
        hash_vals = [self.__class__.__name__, id(self)]
        for val in self.metric_state.values():
            if isinstance(val, RingBuffer):
                hash_vals.append(id(val))
            elif isinstance(val, list):
                hash_vals.extend(id(v) for v in val)
            else:
                hash_vals.append(id(val))
        return hash(tuple(hash_vals))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"

    def __iter__(self):
        raise NotImplementedError("Metrics does not support iteration.")

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, self, other)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, self, other)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.eq, self, other)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.ge, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.gt, self, other)

    def __invert__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_not, self, None)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.le, self, other)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.lt, self, other)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, self, other)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, self, other)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.ne, self, other)

    def __neg__(self) -> "CompositionalMetric":
        return CompositionalMetric(_neg, self, None)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, self, other)

    def __pos__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, other, self)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(lambda a, b: torch.bitwise_and(b, a), self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, other, self)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, other, self)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, other, self)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, other, self)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(lambda a, b: torch.bitwise_or(b, a), self, other)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, other, self)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, other, self)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, other, self)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(lambda a, b: torch.bitwise_xor(b, a), self, other)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, self, other)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, self, other)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, self, other)

    def __getitem__(self, idx: int) -> "CompositionalMetric":
        return CompositionalMetric(lambda x: x[idx], self, None)

    # ------------------------------------------------------------------ plot
    def _plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        """Plot ``val`` (default: ``compute()``) on the host (JAX ``metric.py:2700``)."""
        from torchmetrics_tpu_torch.utilities.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute()
        return plot_single_or_multi_val(
            val,
            ax=ax,
            higher_is_better=self.higher_is_better,
            lower_bound=self.plot_lower_bound,
            upper_bound=self.plot_upper_bound,
            legend_name=self.plot_legend_name,
            name=self.__class__.__name__,
        )

    def plot(self, *args: Any, **kwargs: Any) -> Any:
        """Plot the (current or provided) metric value."""
        return self._plot(*args, **kwargs)


def _neg(x: Tensor) -> Tensor:
    return -torch.abs(x)


class CompositionalMetric(Metric):
    """Lazy composition of metrics under an elementwise op (reference ``metric.py:1088-1211``)."""

    full_state_update = True

    def _wrap_compute(self, compute: Callable) -> Callable:
        # no caching/sync wrapping: children compute (and sync) themselves, and
        # their states keep changing between our compute() calls
        return compute

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, float, Tensor],
        metric_b: Union[Metric, float, Tensor, None],
    ) -> None:
        device = next(m.device for m in (metric_a, metric_b) if isinstance(m, Metric))
        super().__init__(device=device)
        self.op = operator
        self.metric_a = self._operand(metric_a)
        self.metric_b = self._operand(metric_b)

    def _operand(self, value: Any) -> Any:
        if isinstance(value, Metric) or value is None:
            return value
        return torch.as_tensor(value, device=self.device)

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        pass  # children sync themselves

    def update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a = (
            self.metric_a(*args, **self.metric_a._filter_kwargs(**kwargs))
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        val_b = (
            self.metric_b(*args, **self.metric_b._filter_kwargs(**kwargs))
            if isinstance(self.metric_b, Metric)
            else self.metric_b
        )
        if val_a is None:
            self._forward_cache = None
        elif val_b is None:
            self._forward_cache = None if isinstance(self.metric_b, Metric) else self.op(val_a)
        else:
            self._forward_cache = self.op(val_a, val_b)
        return self._forward_cache

    def reset(self) -> None:
        for child in (self.metric_a, self.metric_b):
            if isinstance(child, Metric):
                child.reset()

    def persistent(self, mode: bool = False) -> None:
        for child in (self.metric_a, self.metric_b):
            if isinstance(child, Metric):
                child.persistent(mode=mode)

    def __repr__(self) -> str:
        op_name = self.op.__name__ if hasattr(self.op, "__name__") else self.op
        return f"{self.__class__.__name__}(\n  {op_name}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"

    def __hash__(self) -> int:
        return object.__hash__(self)
