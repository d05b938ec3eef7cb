"""MetricCollection with automatic compute groups.

Port of ``torchmetrics_tpu/collections.py`` (parity target: reference
``torchmetrics/collections.py``). The collection is an ``nn.Module`` whose
submodules are its members, so ``.to()`` moves every member's states.

Compute groups are found as in the JAX package: the first update runs every
member, then members whose states are equal (same names, update counts,
shapes, dtypes and ``allclose`` values) are merged into groups until nothing
changes. From then on only each group's head runs ``update``, and the other
members are given the head's states.

States here are mutable tensors, updated in place. The members of a group
hold the head's tensors themselves (no copy on the update path), and the
metric runtime keeps any in-place write from reaching another metric: a
metric whose states are held by others copies them before its own next
``update`` (copy on write, ``Metric._states_aliased``). So a member's
``forward``, a user's direct ``collection[name].update(...)``, or a
full-state ``forward`` of the head never counts a batch twice; ``reset``,
``load_state_dict``, ``merge_state`` and ``unsync`` rebind states and never
write into them. Only the head's own ``update`` inside
:meth:`MetricCollection.update` writes into the shared tensors, and the
members are meant to see that. Ring-buffer states get one copy per member
(copy on write as well), as in the JAX package.

With the compiled path (``Metric.auto_compile``) a group's head replays its
CUDA graph, which writes into the graph's own state buffers, and
:meth:`MetricCollection._sync_compute_groups` gives the members those
buffers, as it gives them any head's states.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from torchmetrics_tpu_torch._observability import tracing as _obs_trace
from torchmetrics_tpu_torch._observability.state import OBS as _OBS
from torchmetrics_tpu_torch._resilience import integrity as _integrity
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError
from torchmetrics_tpu_torch.utilities.ringbuffer import RingBuffer

__all__ = ["MetricCollection"]


def _state_equal(a: Any, b: Any) -> bool:
    """Equal states for compute groups (JAX ``collections.py:32-47``): shape, dtype and float32 ``allclose``."""
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_state_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, list) != isinstance(b, list):
        return False
    if isinstance(a, RingBuffer) or isinstance(b, RingBuffer):
        if not (isinstance(a, RingBuffer) and isinstance(b, RingBuffer)):
            return False
        if a.capacity != b.capacity or len(a) != len(b):
            return False
        return len(a) == 0 or _state_equal(a.values(), b.values())
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return bool(torch.allclose(a.to(torch.float32), b.to(torch.float32)))


class MetricCollection(nn.Module):
    """Dict-like container fanning update/compute over many metrics.

    Reference ``collections.py:34``. Accepts a single metric, a sequence,
    a mapping, or nested collections.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MetricCollection
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassPrecision
        >>> mc = MetricCollection([MulticlassAccuracy(num_classes=3, device="cpu"),
        ...                        MulticlassPrecision(num_classes=3, device="cpu")])
        >>> preds = torch.tensor([0, 2, 1]); target = torch.tensor([0, 1, 1])
        >>> out = mc(preds, target)
        >>> sorted(out.keys())
        ['MulticlassAccuracy', 'MulticlassPrecision']
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
    ) -> None:
        super().__init__()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        self._groups_checked = False
        self._groups: Dict[int, List[str]] = {}
        # collection-level update-journal hook: one SnapshotManager attached
        # here journals whole-collection updates (members stay hook-free, so
        # nothing is journaled twice)
        self._snapshot_hook: Optional[Any] = None
        self.add_metrics(metrics, *additional_metrics)

    # ------------------------------------------------------------- construction
    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        """Add metrics to the collection (reference ``collections.py:389-454``)."""
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                raise ValueError(f"You have passed extra arguments {remain} which are not `Metric`.")
        elif additional_metrics:
            raise ValueError(
                f"You have passes extra arguments {additional_metrics} which are not compatible"
                f" with first passed dictionary {metrics} so they will be ignored."
            )

        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of"
                        " `Metric` or `MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    self.add_module(name, metric)
                else:
                    for k, v in metric.items(keep_base=False):
                        self.add_module(f"{name}_{k}", v)
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if isinstance(metric, MetricCollection):
                    for name, m in metric.items(keep_base=False):
                        if name in self._modules:
                            raise ValueError(f"Encountered two metrics both named {name}")
                        self.add_module(name, m)
                elif isinstance(metric, Metric):
                    name = metric.__class__.__name__
                    if name in self._modules:
                        raise ValueError(f"Encountered two metrics both named {name}")
                    self.add_module(name, metric)
                else:
                    raise ValueError(f"Input {metric} to `MetricCollection` is not a instance of `Metric`")
        else:
            raise ValueError(
                "Unknown input to MetricCollection. Expected a `Metric`, sequence of `Metric`s, or a dict."
            )
        self._groups_checked = False

    # ------------------------------------------------------------------ update
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update each metric (group heads only once groups are formed)."""
        # the collection span parents every member's update span (JAX `collections.py:152`)
        _sp = _obs_trace.begin_span("update", "MetricCollection") if _OBS.tracing else None
        _sp_err: Optional[BaseException] = None
        try:
            if self._groups_checked:
                for cg in self._groups.values():
                    head = self._modules[cg[0]]
                    head._states_aliased = False  # the members are meant to see the head's in-place writes
                    head.update(*args, **head._filter_kwargs(**kwargs))
                self._sync_compute_groups()
            else:
                for m in self._modules.values():
                    m.update(*args, **m._filter_kwargs(**kwargs))
                if self._enable_compute_groups:
                    self._merge_compute_groups()
                else:
                    self._groups = {i: [name] for i, name in enumerate(self._modules)}
                    self._groups_checked = True
        except BaseException as err:
            _sp_err = err
            raise
        finally:
            if _sp is not None:
                _obs_trace.end_span(_sp, _sp_err)
        self._journal_record("update", args, kwargs)

    def _journal_record(self, method: str, args: tuple, kwargs: Dict[str, Any]) -> None:
        """Feed one completed collection-wide update to the SnapshotManager (JAX ``collections.py:174``).

        Fires after every member (or group head, and the members given its
        states) committed, so a snapshot taken here captures a mutually
        consistent set of member states.
        """
        hook = self.__dict__.get("_snapshot_hook")
        if hook is not None:
            hook.record(self, method, args, kwargs)

    def precompile(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Warm every member's compiled update for this batch (``Metric.precompile``; JAX ``collections.py:187``).

        The batch is handed to each member as :meth:`update` hands it, so
        the steps built match the signatures real traffic brings. Member
        states are untouched. Returns ``{member name: report}``.
        """
        return {name: m.precompile(*args, **m._filter_kwargs(**kwargs)) for name, m in self._modules.items()}

    def to_spmd(self, *, mesh: Any = None, axis_name: str = "dp", **kwargs: Any) -> Any:
        """Hand the (fresh) collection to the SPMD in-graph engine (JAX ``collections.py:467``).

        Compute groups share ONE step: each group's head updates and syncs
        once over the mesh's rows, every member computes from the head's
        synced states in the same step, and ``step()`` returns a dict keyed
        like :meth:`compute`. Every member class must pass the eligibility
        copy's ``in_graph_sync`` gate.
        """
        from torchmetrics_tpu_torch._spmd import SpmdEngine

        return SpmdEngine(self, mesh=mesh, axis_name=axis_name, **kwargs)

    def to_stream_pool(self, *, capacity: int = 8, **kwargs: Any) -> Any:
        """N independent streams of this (fresh) collection, one vmapped step (JAX ``collections.py:480``).

        Compute groups share stacked states: each group's head updates once
        per lane, every member computes from the head's slot rows, and
        ``pool.compute(i)`` returns a dict keyed like :meth:`compute`. Every
        member class must pass the stream-pool gate.
        """
        from torchmetrics_tpu_torch._streams import StreamPool

        return StreamPool(self, capacity=capacity, **kwargs)

    def set_dtype(self, dst_type: torch.dtype) -> "MetricCollection":
        """``Metric.set_dtype`` on every member (JAX ``collections.py:493``)."""
        for m in self._modules.values():
            m.set_dtype(dst_type)
        return self

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None, together: bool = False) -> Any:
        """Plot every member, or all of them on one axis with ``together`` (JAX ``collections.py:559``)."""
        val = val if val is not None else self.compute()
        if together:
            from torchmetrics_tpu_torch.utilities.plot import plot_single_or_multi_val

            return plot_single_or_multi_val(val, ax=ax)
        return [m.plot(val[self._set_name(name)], ax=ax) for name, m in self._modules.items()]

    def to_device(self, device: Union[str, torch.device]) -> "MetricCollection":
        """``Metric.to_device`` on every member (JAX ``collections.py:498``)."""
        for m in self._modules.values():
            m.to_device(device)
        return self

    # nn.Module's casts are no-ops, as on each member: `set_dtype` is the only cast
    def type(self, dst_type: Any) -> "MetricCollection":  # noqa: A003
        return self

    def float(self) -> "MetricCollection":  # noqa: A003
        return self

    def double(self) -> "MetricCollection":
        return self

    def half(self) -> "MetricCollection":
        return self

    def bfloat16(self) -> "MetricCollection":
        return self

    def _merge_compute_groups(self) -> None:
        """Pairwise-merge metrics whose states are identical (reference ``collections.py:228-262``)."""
        if isinstance(self._enable_compute_groups, list):
            self._groups = {i: [str(n) for n in g] for i, g in enumerate(self._enable_compute_groups)}
            grouped = {n for g in self._groups.values() for n in g}
            i = len(self._groups)
            for name in self._modules:
                if name not in grouped:
                    self._groups[i] = [name]
                    i += 1
            self._groups_checked = True
            return

        self._groups = {i: [name] for i, name in enumerate(self._modules)}
        while True:
            for cg_idx1, cg_members1 in deepcopy(self._groups).items():
                for cg_idx2, cg_members2 in deepcopy(self._groups).items():
                    if cg_idx1 == cg_idx2:
                        continue
                    m1 = self._modules[cg_members1[0]]
                    m2 = self._modules[cg_members2[0]]
                    if self._equal_metric_states(m1, m2):
                        self._groups[cg_idx1].extend(self._groups.pop(cg_idx2))
                        break
                else:
                    continue
                break
            else:
                break
        self._groups = {i: g for i, g in enumerate(self._groups.values())}
        self._groups_checked = True

    @staticmethod
    def _equal_metric_states(metric1: Metric, metric2: Metric) -> bool:
        """Shape + allclose comparison of two metrics' states (reference ``collections.py:264-287``)."""
        if not metric1._defaults or not metric2._defaults:
            return False
        if metric1._defaults.keys() != metric2._defaults.keys():
            return False
        if metric1._update_count != metric2._update_count:
            return False
        return all(_state_equal(getattr(metric1, k), getattr(metric2, k)) for k in metric1._defaults)

    def _sync_compute_groups(self) -> None:
        """Give each member its group head's states: the same tensors, new lists, ring-buffer copies."""
        for cg in self._groups.values():
            head = self._modules[cg[0]]
            for name in cg[1:]:
                member = self._modules[name]
                for attr in head._defaults:
                    state = getattr(head, attr)
                    if isinstance(state, RingBuffer):
                        # mutable container: a member needs its own, or the next
                        # update would append once per member
                        setattr(member, attr, state.copy())
                    else:
                        setattr(member, attr, list(state) if isinstance(state, list) else state)
                member._update_count = head._update_count
                member._computed = None
                member._states_aliased = head._states_aliased = True

    # ----------------------------------------------------------------- compute
    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Per-batch value from every metric while accumulating global state."""
        _sp = _obs_trace.begin_span("forward", "MetricCollection") if _OBS.tracing else None
        _sp_err: Optional[BaseException] = None
        try:
            res = {name: m(*args, **m._filter_kwargs(**kwargs)) for name, m in self._modules.items()}
            if not self._groups_checked and self._enable_compute_groups:
                self._merge_compute_groups()
        except BaseException as err:
            _sp_err = err
            raise
        finally:
            if _sp is not None:
                _obs_trace.end_span(_sp, _sp_err)
        # forward and update leave the same accumulated state, so the journal
        # replays either through collection.update()
        self._journal_record("update", args, kwargs)
        return self._flatten_results(res)

    def compute(self) -> Dict[str, Any]:
        _sp = _obs_trace.begin_span("compute", "MetricCollection") if _OBS.tracing else None
        _sp_err: Optional[BaseException] = None
        try:
            if self._groups_checked:
                self._sync_compute_groups()
            res = {name: m.compute() for name, m in self._modules.items()}
        except BaseException as err:
            _sp_err = err
            raise
        finally:
            if _sp is not None:
                _obs_trace.end_span(_sp, _sp_err)
        return self._flatten_results(res)

    def _flatten_results(self, res: Dict[str, Any]) -> Dict[str, Any]:
        """Flatten dict-valued results and apply prefix/postfix (reference ``collections.py:314-359``)."""
        out: Dict[str, Any] = {}
        for name, value in res.items():
            if isinstance(value, dict):
                for k, v in value.items():
                    if k in res or k in out:
                        k = f"{name}_{k}"
                    out[k] = v
            else:
                out[name] = value
        return {self._set_name(k): v for k, v in out.items()}

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    # -------------------------------------------------------------- maintenance
    def reset(self) -> None:
        # a member's reset() may surface its pending deferred violation
        # (clear, then raise): every member still gets reset, and one call
        # raises the first violation
        pending: Optional[BaseException] = None
        for m in self._modules.values():
            try:
                m.reset()
            except RuntimeError as err:
                pending = pending or err
        # journaled as Metric.reset is: a restore must not bring back the
        # accumulation a reset mid-stream discarded
        self._journal_record("reset", (), {})
        if pending is not None:
            raise pending

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        mc = deepcopy(self)
        if prefix is not None:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix is not None:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for m in self._modules.values():
            m.persistent(mode)

    def state_dict(  # type: ignore[override]
        self, prefix: str = "", integrity: bool = False, all_states: bool = False, _host: bool = False
    ) -> Dict[str, Any]:
        """Every member's :meth:`Metric.state_dict` under ``{prefix}{name}.``, each with its integrity block if asked."""
        destination: Dict[str, Any] = {}
        for name, m in self._modules.items():
            m.state_dict(destination, prefix=f"{prefix}{name}.", integrity=integrity, all_states=all_states, _host=_host)
        return destination

    def load_state_dict(  # type: ignore[override]
        self, state_dict: Dict[str, Any], strict: Union[bool, str] = True, prefix: str = ""
    ) -> None:
        """Restore member states; ``strict="repair"`` resets corrupted states only (JAX ``collections.py:351-392``).

        Each member verifies its own integrity block (when present) under its
        ``{prefix}{name}.`` namespace. The verification of ALL members runs
        before ANY member loads, so a corrupted later member cannot leave the
        collection half restored: the whole load proceeds (repairing under
        ``strict="repair"``) or it raises with every member untouched.
        """
        if strict != "repair":
            corrupted_all: Dict[str, str] = {}
            for name, m in self._modules.items():
                member_prefix = f"{prefix}{name}."
                meta = state_dict.get(_integrity.integrity_key(member_prefix))
                if meta is not None:
                    bad = _integrity.verify_states(
                        state_dict, member_prefix, meta, type(m).__name__, include_missing=strict is not False
                    )
                    corrupted_all.update({f"{name}.{k}": v for k, v in bad.items()})
            if corrupted_all:
                _integrity.raise_corrupted(f"MetricCollection(prefix={prefix!r})", corrupted_all)
            # the pre-pass hashed every state: the members skip it
            for name, m in self._modules.items():
                m.load_state_dict(state_dict, strict=strict, prefix=f"{prefix}{name}.", _verified=True)
            self._journal_record("external", (), {})
            return
        # repair: a member's verification raises only on an unknown schema
        # version, so every block is validated before any member loads
        for name, m in self._modules.items():
            meta = state_dict.get(_integrity.integrity_key(f"{prefix}{name}."))
            if meta is not None:
                _integrity.validate_version(meta, type(m).__name__)
        for name, m in self._modules.items():
            m.load_state_dict(state_dict, strict=strict, prefix=f"{prefix}{name}.")
        # a manual load mid-stream: anchor the transition the journal cannot replay
        self._journal_record("external", (), {})

    def merge_state(self, incoming: "MetricCollection") -> None:
        """Merge another collection's state member by member.

        Both collections must hold the same member names with the same metric
        types; each member merge is ``Metric.merge_state`` (the declared
        per-state reductions). Everything is checked before any member
        merges, so a mismatch leaves this collection untouched (JAX
        ``collections.py:394-422``).
        """
        if not isinstance(incoming, MetricCollection):
            raise TorchMetricsUserError(
                f"MetricCollection.merge_state needs a MetricCollection, got {type(incoming).__name__}"
            )
        if set(incoming._modules) != set(self._modules):
            missing = sorted(set(self._modules) ^ set(incoming._modules))
            raise TorchMetricsUserError(
                f"Cannot merge MetricCollections with different members (mismatched: {missing})"
            )
        for name, m in self._modules.items():
            other = incoming._modules[name]
            if type(other) is not type(m):
                raise TorchMetricsUserError(
                    f"Cannot merge member {name!r}: {type(other).__name__} into {type(m).__name__}"
                )
        for name, m in self._modules.items():
            m.merge_state(incoming._modules[name])

    # ------------------------------------------------------------- resilience
    def set_resilience_policy(self, **kwargs: Any) -> "MetricCollection":
        """``Metric.set_resilience_policy`` on every member (``sync_policy``, ``nan_policy``; JAX ``collections.py:424``).

        Only the arguments passed change. A compute group's head and members
        share the policies, so degradation behaves alike within a group.
        """
        for m in self._modules.values():
            m.set_resilience_policy(**kwargs)
        return self

    def resilience_report(self) -> Dict[str, Any]:
        """Per-member resilience reports, keyed like :meth:`compute` results."""
        return {self._set_name(name): m.resilience_report() for name, m in self._modules.items()}

    def sync(self, **kwargs: Any) -> None:
        for m in self._modules.values():
            m.sync(**kwargs)

    def unsync(self, should_unsync: bool = True) -> None:
        for m in self._modules.values():
            m.unsync(should_unsync)

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        """Current compute-group assignment."""
        return self._groups

    # -------------------------------------------------------------- dict-like
    def items(self, keep_base: bool = False, copy_state: bool = True) -> Iterable[Tuple[str, Metric]]:
        """Members by name; ``copy_state`` is accepted for the reference's signature (copy on write makes it moot)."""
        if self._groups_checked:
            self._sync_compute_groups()
        if keep_base:
            return self._modules.items()
        return [(self._set_name(k), v) for k, v in self._modules.items()]

    def keys(self, keep_base: bool = False) -> Iterable[str]:
        if keep_base:
            return self._modules.keys()
        return [self._set_name(k) for k in self._modules]

    def values(self, copy_state: bool = True) -> Iterable[Metric]:
        if self._groups_checked:
            self._sync_compute_groups()
        return self._modules.values()

    def __getitem__(self, key: str) -> Metric:
        if self._groups_checked:
            self._sync_compute_groups()
        return self._modules[key]

    def __len__(self) -> int:
        return len(self._modules)

    def __iter__(self):
        return iter(self.keys())

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self.keys()

    def telemetry_report(self, aggregate: bool = False) -> Any:
        """Runtime telemetry for the collection (JAX ``collections.py:441``).

        With ``aggregate=False`` (default), each member's
        :class:`~torchmetrics_tpu_torch._observability.telemetry.TelemetryReport`
        keyed like :meth:`compute` results; with ``aggregate=True``, one
        merged report whose counters sum every member. With compute groups
        only the group heads run ``update``, so the members' path counters
        reflect the runtime's actual dispatch.
        """
        from torchmetrics_tpu_torch._observability.telemetry import TelemetryReport, report_for

        reports = {self._set_name(name): m.telemetry_report() for name, m in self._modules.items()}
        if self.__dict__.get("_telem") is not None:
            # a collection-level SnapshotManager counts its snapshots, journal
            # and restores on the COLLECTION object (JAX ``collections.py:455-461``)
            reports["__collection__"] = report_for(self)
        if not aggregate:
            return reports
        return TelemetryReport.merged(list(reports.values()), name="MetricCollection")

    def __repr__(self) -> str:
        repr_str = self.__class__.__name__ + "("
        for name, m in self._modules.items():
            repr_str += f"\n  {name}: {m!r}"
        if self.prefix:
            repr_str += f"\n  prefix={self.prefix}"
        if self.postfix:
            repr_str += f"\n  postfix={self.postfix}"
        return repr_str + "\n)"
