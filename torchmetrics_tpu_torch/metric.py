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
"""

from __future__ import annotations

import functools
import inspect
from abc import ABC, abstractmethod
from copy import deepcopy
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
from torch import Tensor, nn

from torchmetrics_tpu_torch.utilities.data import (
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
)
from torchmetrics_tpu_torch.utilities.distributed import distributed_available as _default_distributed_available
from torchmetrics_tpu_torch.utilities.distributed import gather_all_tensors
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn
from torchmetrics_tpu_torch.utilities.ringbuffer import RingBuffer

State = Union[Tensor, List[Tensor], RingBuffer]

_STR_REDUCTIONS = {
    "sum": dim_zero_sum,
    "mean": dim_zero_mean,
    "max": dim_zero_max,
    "min": dim_zero_min,
    "cat": dim_zero_cat,
}


def _resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device is available, and metric states live on `cuda` unless a device is given."
            ' Pass `device="cpu"` to keep them on the CPU.'
        )
    return torch.device("cuda", torch.cuda.current_device())


def _squeeze_if_scalar(data: Any) -> Any:
    """Squeeze 1-element tensors to 0-d (reference ``utilities/data.py`` helper)."""
    if isinstance(data, Tensor) and data.numel() == 1 and data.ndim > 0:
        return data.squeeze()
    return data


def _flatten_maybe(seq: Sequence) -> list:
    out = []
    for el in seq:
        if isinstance(el, (list, tuple)):
            out.extend(el)
        else:
            out.append(el)
    return out


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
        # bound append-mode ("cat") states to a fixed-capacity ring buffer instead of an unbounded list
        self.cat_state_capacity = kwargs.pop("cat_state_capacity", None)
        if self.cat_state_capacity is not None and not (
            isinstance(self.cat_state_capacity, int) and self.cat_state_capacity > 0
        ):
            raise ValueError(
                "Expected keyword argument `cat_state_capacity` to be `None` or a positive integer"
                f" but got {self.cat_state_capacity}"
            )
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
        if self.full_state_update or self.full_state_update is None or self.dist_sync_on_step:
            self._forward_cache = self._forward_full_state_update(*args, **kwargs)
        else:
            self._forward_cache = self._forward_reduce_state_update(*args, **kwargs)
        return self._forward_cache

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Double-update path (reference ``metric.py:308-351``)."""
        self.update(*args, **kwargs)
        self._to_sync = self.dist_sync_on_step
        # reset() rebinds every state to a fresh default, so the accumulated
        # states can be stashed by reference: the batch replay cannot touch them
        cache = self.metric_state
        update_count = self._update_count
        try:
            self.reset()
            self.update(*args, **kwargs)
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
        global_state = self.metric_state  # stashed by reference, as in the double-update path
        update_count = self._update_count
        self.reset()
        self._to_sync = self.dist_sync_on_step
        self._should_unsync = False
        try:
            self.update(*args, **kwargs)
            batch_val = self.compute()
        except Exception:
            # one bad batch must not destroy the whole accumulation
            self._update_count = update_count
            self._restore_state(global_state)
            raise
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
            self._computed = None
            if self._states_aliased:
                self._unshare_states()
            self._update_count += 1
            update(*args, **kwargs)
            if self.compute_on_cpu:
                self._move_list_states_to_cpu()

        return wrapped_func

    def _unshare_states(self) -> None:
        """Take private copies of the tensor states other metrics of a compute group hold (copy on write).

        Lists get a list of their own (their tensors are never written in
        place); a ring buffer from the group is already a copy on write.
        """
        for attr in self._defaults:
            cur = getattr(self, attr)
            if isinstance(cur, Tensor):
                setattr(self, attr, cur.clone())
            elif isinstance(cur, list):
                setattr(self, attr, list(cur))
        self._states_aliased = False

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
            if not self.update_called:
                rank_zero_warn(
                    f"The ``compute`` method of metric {self.__class__.__name__}"
                    " was called before the ``update`` method which may lead to errors,"
                    " as metric states have not yet been updated.",
                    UserWarning,
                )
            if self._computed is not None:
                return self._computed
            with self.sync_context(
                dist_sync_fn=self.dist_sync_fn,
                should_sync=self._to_sync,
                should_unsync=self._should_unsync,
            ):
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

        Does nothing when no ``torch.distributed`` process group is initialised.
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
        self._cache = self._copy_state_dict()
        self._sync_dist(dist_sync_fn, process_group=process_group or self.process_group)
        self._is_synced = True

    def _sync_dist(self, dist_sync_fn: Callable = gather_all_tensors, process_group: Optional[Any] = None) -> None:
        """Reference ``metric.py:427-457``: pre-concat lists, gather, reduce.

        A ring buffer gathers its live rows, like a pre-concatenated list (JAX
        ``metric.py:989``); after the sync the state is their concatenation
        over the ranks, rank by rank.
        """
        input_dict = {attr: getattr(self, attr) for attr in self._reductions}
        for attr, value in input_dict.items():
            if isinstance(value, RingBuffer):
                input_dict[attr] = [value.values()] if value.num_valid else []
            # pre-concatenate list states to minimize the number of all_gathers
            elif isinstance(value, list) and len(value) >= 1:
                input_dict[attr] = [dim_zero_cat(value)]
        for attr, reduction_fn in self._reductions.items():
            value = input_dict[attr]
            if isinstance(value, list):
                gathered = _flatten_maybe([dist_sync_fn(v, process_group) for v in value])
            else:
                gathered = dist_sync_fn(value, process_group)
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
        """
        if isinstance(incoming, Metric):
            if type(incoming) is not type(self):
                raise TorchMetricsUserError(
                    f"Cannot merge state of {type(incoming).__name__} into {type(self).__name__}"
                )
            incoming_state = incoming.metric_state
            incoming_count = incoming._update_count
        else:
            unknown = [k for k in incoming if not k.isidentifier()]
            if unknown:
                raise ValueError(f"Cannot merge state entries {unknown}: integrity blocks are not supported yet")
            incoming_state = incoming
            incoming_count = 1
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
        """Reset states to their defaults (reference ``metric.py:673-688``)."""
        self._update_count = 0
        self._forward_cache = None
        self._computed = None
        for attr in self._defaults:
            self._reset_state_to_default(attr)
        self._cache = None
        self._is_synced = False
        self._states_aliased = False

    def _reset_state_to_default(self, attr: str) -> None:
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
        """A private copy of ``value`` on the metric's device (states are mutated in place)."""
        if isinstance(value, RingBuffer):
            return value.copy().to_device(self._device)
        if isinstance(value, list):
            return [torch.as_tensor(v, device=self._device).clone() for v in value]
        return torch.as_tensor(value, device=self._device).clone()

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
        all_states: bool = False,
    ) -> Dict[str, State]:
        """Copies of the persistent states under their names (reference ``metric.py:839-871``).

        ``all_states=True`` includes every registered state regardless of its
        ``persistent`` flag. Values are copies, since live states are
        updated in place. A ring buffer saves its live rows as one tensor.
        """
        destination = {} if destination is None else destination
        for key, current in self.metric_state.items():
            if not (all_states or self._persistent[key]):
                continue
            if isinstance(current, RingBuffer):
                destination[prefix + key] = current.values().detach().clone()
            elif isinstance(current, list):
                destination[prefix + key] = [v.detach().clone() for v in current]
            else:
                destination[prefix + key] = current.detach().clone()
        return destination

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = True, prefix: str = "") -> None:  # type: ignore[override]
        """Restore states from a :meth:`state_dict` mapping; tensors or numpy arrays."""
        for key in self._defaults:
            if prefix + key in state_dict:
                val = self._to_state(state_dict[prefix + key])
                if isinstance(self._defaults[key], RingBuffer):
                    ring = self._defaults[key].copy_empty()
                    if not isinstance(val, Tensor) or val.numel():
                        ring.extend(val)
                    val = ring
                elif isinstance(self._defaults[key], list) and isinstance(val, Tensor):
                    # one concatenated array loaded into a list state
                    val = [val] if val.numel() else []
                setattr(self, key, val)
            elif strict and self._persistent[key]:
                raise KeyError(f"Missing key {key!r} in state_dict for {self.__class__.__name__}")

    def __getstate__(self) -> Dict[str, Any]:
        """Pickle support: drop the wrapped bound methods (reference ``metric.py:694-702``)."""
        state = {k: v for k, v in self.__dict__.items() if k not in ("update", "compute", "_update_signature")}
        state["_computed"] = None
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        """Unpickle: re-wrap update/compute (reference ``metric.py:704-713``)."""
        super().__setstate__(state)
        self._update_signature = inspect.signature(self.update)
        self.update = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute = self._wrap_compute(self.compute)  # type: ignore[method-assign]

    def __setattr__(self, name: str, value: Any) -> None:
        """Class-flag immutability guard (reference ``metric.py:715-726``)."""
        if name in ("higher_is_better", "is_differentiable", "full_state_update"):
            raise RuntimeError(f"Can't change const `{name}`.")
        super().__setattr__(name, value)

    # ---------------------------------------------------------------- device
    def _apply(self, fn: Callable, recurse: bool = True) -> "Metric":
        """Carry ``.to()``/``.cuda()``/``.cpu()`` over to the states, their defaults and the cached values."""
        this = super()._apply(fn, recurse)
        this._device = fn(torch.zeros(1, device=this._device)).device
        for attr, default in self._defaults.items():
            cur = getattr(this, attr)
            if isinstance(cur, RingBuffer):
                cur._apply(fn, this._device)
            else:
                setattr(this, attr, [fn(v) for v in cur] if isinstance(cur, list) else fn(cur))
            if isinstance(default, Tensor):
                this._defaults[attr] = fn(default)
            elif isinstance(default, RingBuffer):
                default.device = this._device
        if isinstance(this._computed, Tensor):
            this._computed = fn(this._computed)
        if isinstance(this._forward_cache, Tensor):
            this._forward_cache = fn(this._forward_cache)
        return this

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
