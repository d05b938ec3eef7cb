"""Distributed synchronization over ``torch.distributed``.

Parity target: reference ``torchmetrics/utilities/distributed.py:97-147``.
Tensors whose shapes differ between processes are padded to the per-dim
maximum, gathered, then trimmed back.

Every eager collective of the guarded sync flows through
:func:`process_allgather`, whose two module globals, ``_world_override`` and
``_transport``, are the seam the fault injectors patch (JAX
``utilities/distributed.py:176-300``): a simulated world, failing or stalling
transports. With neither set and a real process group, :func:`gather_all_tensors`
keeps its padded ``dist.all_gather``.

:func:`sync_in_jit` is the SPMD engine's sync: each state's reduction over
the rows of a row-stacked state, inside the engine's step.
:func:`sync_in_process_group` is the same sync for a mesh whose rows span
the processes of a process group: coalesced collectives, then
:func:`sync_in_jit` over the global rows.

:func:`kv_key` and :class:`KvTtlJanitor` name and expire the keys the fleet
tier (``_fleet/``) writes into a shared key-value store.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import Tensor

from torchmetrics_tpu_torch._analysis.locksan import new_lock as _san_lock

_world_override: Optional[int] = None  # simulated world size (None: the real one)
_transport: Optional[Callable[[Any], Any]] = None  # transport override (None: the real collective)


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _allgather_leaf(x: Any, group: Optional[Any] = None) -> Any:
    """All-gather one tensor (or numpy array) over ``group``; a leading world axis, on ``x``'s side.

    NCCL gathers on ``x``'s own card when it is a CUDA tensor, else on the
    calling thread's current card; gloo gathers on the host. Returns once the
    collective has finished, not when it is enqueued: an NCCL ``all_gather``
    only orders the current stream after itself, so the stream is
    synchronized here, on the calling (watchdog) thread.
    """
    host = isinstance(x, np.ndarray)
    t = torch.as_tensor(x)
    if dist.get_backend(group) == "nccl":
        dev = t.device if t.is_cuda else torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    src = t.to(dev).contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group, async_op=True).wait()
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    stacked = torch.stack(out)
    return stacked.numpy() if host else stacked.to(t.device)


def _default_transport(x: Any, group: Optional[Any] = None) -> Any:
    """The real collective: ``dist.all_gather`` of every leaf of ``x`` over ``group`` (None: the world)."""
    return _tree_map(lambda leaf: _allgather_leaf(leaf, group), x)


def _seam_active() -> bool:
    return _transport is not None or _world_override is not None


def process_allgather(x: Any, group: Optional[Any] = None) -> Any:
    """All-gather ``x`` across the processes of ``group`` (a leading world axis on every leaf).

    A transport override takes ``x`` alone, as the JAX package's does: it
    models the whole (simulated) world.
    """
    if _transport is not None:
        return _transport(x)
    return _default_transport(x, group)


def world_size() -> int:
    """Number of participating processes (honours the simulated-world override)."""
    if _world_override is not None:
        return _world_override
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def distributed_available() -> bool:
    """True when a ``torch.distributed`` process group is initialised, or a simulated world of 2+ is active."""
    if _world_override is not None:
        return _world_override > 1
    return dist.is_available() and dist.is_initialized()


def _allgather_list(t: Tensor, group: Optional[Any]) -> List[Tensor]:
    """One all-gather of ``t``, one tensor per process on ``t``'s device.

    The only collective of :func:`gather_all_tensors`: :func:`process_allgather`
    while a transport override or a simulated world is active, else
    ``dist.all_gather`` over ``group``.
    """
    if _seam_active():
        stacked = torch.as_tensor(process_allgather(t))
        return [stacked[i].to(t.device) for i in range(stacked.shape[0])]
    out = [torch.zeros_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def gather_all_tensors(result: Tensor, group: Optional[Any] = None) -> List[Tensor]:
    """Gather ``result`` from every process of ``group``; ``[result]`` without a process group.

    Shapes are gathered first; tensors whose shapes differ are padded to the
    per-dim maximum, gathered, then trimmed back. Under a simulated world,
    ``group`` may name a subset of process indices (a sequence of ints), as
    the JAX package's does.
    """
    if not distributed_available():
        return [result]
    members: Optional[List[int]] = None
    if _seam_active():
        if isinstance(group, (list, tuple)):
            members = [int(i) for i in group]
        group = None
    elif group is None:
        group = dist.group.WORLD
    result = result.contiguous()
    local_size = torch.tensor(result.shape, dtype=torch.int64, device=result.device)
    local_sizes = _allgather_list(local_size, group)
    if members is not None:
        if len(set(members)) != len(members):
            raise ValueError(f"`group` must not contain duplicate process indices, got {members}")
        if any(i < 0 or i >= len(local_sizes) for i in members):
            raise ValueError(f"`group` indices {members} out of range for world size {len(local_sizes)}")
    max_size = torch.stack(local_sizes).max(dim=0).values if result.ndim else local_size
    if all(bool((size == max_size).all()) for size in local_sizes):
        gathered = _allgather_list(result, group)
    else:
        pad: List[int] = []
        for missing in reversed((max_size - local_size).tolist()):
            pad.extend((0, int(missing)))
        gathered = _allgather_list(F.pad(result, pad), group)
        gathered = [g[tuple(slice(int(d)) for d in size.tolist())] for g, size in zip(gathered, local_sizes)]
    return gathered if members is None else [gathered[i] for i in members]


def reduce(x: Tensor, reduction: Optional[str]) -> Tensor:
    """Reduce a tensor: ``elementwise_mean``, ``sum`` or ``none`` (reference ``distributed.py:22``)."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction in ("none", None):
        return x
    raise ValueError("Reduction parameter unknown.")


def class_reduce(num: Tensor, denom: Tensor, weights: Tensor, class_reduction: str = "none") -> Tensor:
    """Per-class fraction with a ``micro``, ``macro``, ``weighted`` or no reduction (reference ``distributed.py:45``)."""
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    fraction = torch.sum(num) / torch.sum(denom) if class_reduction == "micro" else num / denom
    fraction = torch.where(torch.isnan(fraction), torch.zeros_like(fraction), fraction)
    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights.to(torch.float32) / torch.sum(weights)))
    if class_reduction in ("none", None):
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction} unknown. Choose between one of these: {valid_reduction}")


# ---------------------------------------------------------------------------
# KV namespace + TTL hygiene (JAX ``distributed.py:82-175``)
# ---------------------------------------------------------------------------

# every key this library writes into a shared key-value store lives under one
# namespace, so a shared store (the default process group's, the fleet
# aggregation tier's) can attribute and bulk-expire our keys without touching
# another tenant's
KV_NAMESPACE = "tm_tpu"


def kv_key(*parts: Any, namespace: str = KV_NAMESPACE) -> str:
    """Build one namespaced KV key (JAX ``distributed.py:93``).

    Parts are joined with ``/`` under the library namespace; a part that
    itself contains ``/`` (or is empty) is rejected: it would silently change
    the key's depth and break prefix scans (the fleet tier's contribution
    sweep and the TTL janitor both walk keys by prefix).
    """
    if not parts:
        raise ValueError("kv_key needs at least one part")
    rendered = []
    for part in parts:
        text = str(part)
        if not text or "/" in text:
            raise ValueError(f"kv_key part {part!r} must be non-empty and free of '/'")
        rendered.append(text)
    return "/".join([namespace, *rendered])


class KvTtlJanitor:  # concurrency: shared fleet publishers note() while epoch sweeps expire
    """Bounded TTL ledger for KV keys this process published (JAX ``distributed.py:112``).

    A store keeps a key until someone deletes it, so a long-running stream
    that publishes per-epoch keys (the fleet aggregation tier) must
    garbage-collect its own writes or grow the store without bound. Writers
    :meth:`note` every key they publish; a periodic :meth:`sweep` deletes the
    ones older than ``ttl_s`` through the caller's delete function. Consumed
    keys are :meth:`forget`-ed at fold time, so the janitor only ever touches
    keys nobody claimed (dead publishers, orphaned epochs).
    """

    def __init__(self, ttl_s: float = 300.0) -> None:
        if ttl_s <= 0:
            raise ValueError(f"`ttl_s` must be positive, got {ttl_s}")
        self.ttl_s = float(ttl_s)
        self._lock = _san_lock("KvTtlJanitor._lock")
        self._born: Dict[str, float] = {}

    def note(self, key: str, now: Optional[float] = None) -> None:
        """Record (or refresh) one published key's birth time."""
        ts = time.monotonic() if now is None else float(now)
        with self._lock:
            self._born[key] = ts

    def forget(self, key: str) -> None:
        """Drop a key from the ledger (it was consumed and deleted by a reader)."""
        with self._lock:
            self._born.pop(key, None)

    def pending(self) -> int:
        with self._lock:
            return len(self._born)

    def sweep(self, delete: Callable[[str], Any], now: Optional[float] = None) -> List[str]:
        """Delete every tracked key older than the TTL; return the reaped keys.

        Delete failures (a key already consumed by a reader, a store restart)
        drop the key from the ledger anyway: the janitor bounds the store's
        memory, it does not guarantee deletion receipts.
        """
        ts = time.monotonic() if now is None else float(now)
        with self._lock:
            expired = [k for k, born in self._born.items() if ts - born >= self.ttl_s]
            for key in expired:
                del self._born[key]
        for key in expired:
            try:
                delete(key)
            except Exception:  # noqa: BLE001 - best-effort hygiene, never a fault
                pass
        return expired


# ---------------------------------------------------------------------------
# The in-graph sync over the rows of a stacked state (JAX ``distributed.py:363``)
# ---------------------------------------------------------------------------


def sync_in_jit(
    state: Dict[str, Any],
    reductions: Dict[str, Union[str, Callable, None]],
    axis_name: str = "dp",
    axis_index_groups: Optional[Sequence[Sequence[int]]] = None,
) -> Dict[str, Any]:
    """What each row of a row-stacked metric state holds after the collective of its declared reduction.

    The JAX function runs inside ``shard_map`` on each device's local value
    and lowers each reduction to a named-axis collective over ``axis_name``.
    ``torch.func.vmap`` has no named-axis collectives, so here each state
    comes with the mesh axis leading, ``(D, *s)`` for ``D`` rows (the SPMD
    engine's stacked layout), or, for a ring buffer, its stacked leaves
    ``{"data": (D, cap, *row), "valid": (D, cap), "count": (D,)}``. The result
    is still row-stacked: row ``d`` holds what device ``d`` holds after the
    collective:

    - ``"sum"``/``"mean"``/``"max"``/``"min"``: the reduction over the rows
      (``psum``/``pmean``/``pmax``/``pmin``);
    - ``"cat"``: the rows' values concatenated (a tiled ``all_gather``);
    - ``None``: the rows' values stacked, ``(D, *s)`` in each row (``all_gather``);
    - a callable: applied to the stacked ``(D, *s)`` values;
    - a ring buffer: its data and valid mask concatenated, its count summed.

    Without groups every row holds the same value, so the result is an
    ``expand`` of it, not ``D`` copies. ``axis_index_groups`` partitions the
    rows into equal-sized disjoint groups that each reduce their own rows
    (the in-graph ``process_group``: ``[[0, 1], [2, 3]]`` keeps two
    independent replicas), and each row holds its group's value. Rows are
    read with integer indexing and stacked, so the sync reads no host data
    and can be captured in a CUDA graph.
    """
    select = None if axis_index_groups is None else _grouped_member_selector(axis_name, axis_index_groups)
    out: Dict[str, Any] = {}
    for name, value in state.items():
        red = reductions.get(name, "sum")
        if red not in _COLLECTIVES and not callable(red):
            raise ValueError(f"Unknown reduction {red!r} for state {name!r}")
        if isinstance(value, dict):
            # a ring buffer's stacked leaves: the storage and the mask gather, the cursor sums
            if red not in ("cat", None):
                raise ValueError(f"RingBuffer state {name!r} requires a 'cat' reduction, got {red!r}")
            out[name] = {
                "data": _over_rows(value["data"], _COLLECTIVES["cat"], select),
                "valid": _over_rows(value["valid"], _COLLECTIVES["cat"], select),
                "count": _over_rows(value["count"], _COLLECTIVES["sum"], select),
            }
            continue
        out[name] = _over_rows(value, _COLLECTIVES[red] if red in _COLLECTIVES else red, select)
    return out


# reduction kind -> its reduction over the gathered leading (row) axis: over
# every row, or over one group's rows. One row per kind, as the JAX table.
# Sums keep the state's dtype, as psum does (torch would widen int32 to int64).
_COLLECTIVES: Dict[Any, Callable[[Tensor], Tensor]] = {
    "sum": lambda m: m.sum(0, dtype=m.dtype),
    "mean": lambda m: m.sum(0, dtype=m.dtype) / m.shape[0],  # pmean is psum / n, also for integer states
    "max": lambda m: m.amax(0),
    "min": lambda m: m.amin(0),
    "cat": lambda m: m.reshape(m.shape[0] * m.shape[1], *m.shape[2:]),
    None: lambda m: m,
}


def _over_rows(value: Tensor, local: Callable[[Tensor], Tensor], select: Optional[Callable]) -> Tensor:
    """``local`` over the rows each row syncs with: all of them (one value, expanded), or its group's."""
    if select is None:
        res = local(value)
        return res.unsqueeze(0).expand(value.shape[0], *res.shape)
    return select(value, local)


def validate_axis_groups(groups: Sequence[Sequence[int]], world: Optional[int] = None) -> None:
    """The ``axis_index_groups`` invariant, in one place: equal-sized disjoint groups partitioning ``0..world-1``.

    ``world`` defaults to the total membership; callers who know their axis
    size pass it so a wrong-sized partition fails too. The grouped selector
    and the SPMD engine's construction check both call this.
    """
    sizes = {len(g) for g in groups}
    if len(sizes) != 1:
        raise ValueError(f"All `axis_index_groups` must have the same size, got sizes {sorted(sizes)}")
    expected = sum(len(g) for g in groups) if world is None else world
    seen = sorted(i for g in groups for i in g)
    if seen != list(range(expected)):
        raise ValueError(f"`axis_index_groups` must partition 0..{expected - 1}, got {groups}")


def _grouped_member_selector(axis_name: str, groups: Sequence[Sequence[int]]) -> Callable[[Tensor, Callable], Tensor]:
    """Build ``(value, local) -> (D, *r)``: row ``d`` holds ``local`` over the rows of ``d``'s group.

    Groups must be equal-sized and partition the rows (the constraints the
    JAX package's ``axis_index_groups`` primitives have). ``axis_name`` is
    the mesh axis the rows run over; the rows of one tensor need no name to
    find each other.
    """
    validate_axis_groups(groups)
    world = sum(len(g) for g in groups)
    group_of = [0] * world
    for gid, g in enumerate(groups):
        for rank in g:
            group_of[rank] = gid
    members = [[int(i) for i in g] for g in groups]

    def select(value: Tensor, local: Callable[[Tensor], Tensor]) -> Tensor:
        per_group = [local(torch.stack([value[i] for i in g])) for g in members]
        return torch.stack([per_group[group_of[d]] for d in range(world)])

    return select


# ---------------------------------------------------------------------------
# The same sync over a mesh whose rows span the processes of a process group
# ---------------------------------------------------------------------------

_EXACT_REDUCTIONS = ("sum", "max", "min")


def _exact(dtype: torch.dtype) -> bool:
    """An integer dtype: its sums, maxima and minima come out the same in any order of their terms."""
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


def _all_gather_into(out: Tensor, x: Tensor, group: Any) -> None:
    """``out`` (``P * x.shape[0]`` rows) filled with every process's ``x``, rank by rank: one collective.

    ``all_gather_single`` where torch has it (it deprecates
    ``all_gather_into_tensor`` for it), else ``all_gather_into_tensor``.
    """
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=group)


def sync_in_process_group(
    states: Sequence[Dict[str, Any]],
    reductions: Sequence[Dict[str, Union[str, Callable, None]]],
    group: Any,
    axis_name: str = "dp",
    axis_index_groups: Optional[Sequence[Sequence[int]]] = None,
    tally: Optional[Dict[str, int]] = None,
) -> List[Dict[str, Any]]:
    """:func:`sync_in_jit` of each row-stacked ``states[i]`` over the global rows of a mesh that spans ``group``.

    Each state holds this process's rows, ``(rows, *s)`` (a ring buffer: its
    stacked leaves); global row ``g`` is row ``g % rows`` of rank
    ``g // rows``. The result is :func:`sync_in_jit`'s on the global
    ``(P * rows, *s)`` stack, bit for bit with a one-process mesh of the same
    global rows, and the same on every process:

    - without ``axis_index_groups``, an integer ``sum``/``max``/``min`` state
      reduces its local rows, then takes one ``all_reduce`` a (dtype,
      reduction) over a flat buffer of every such state: integer reductions
      do not depend on the order of their terms;
    - every other leaf (floating states, whose sums must keep the one-process
      order, ``mean``, ``cat`` rings, ``None`` gathers, and every state under
      groups) takes one all-gather a dtype, coalesced (a ``bool`` leaf as
      ``uint8``), into the global stack, over which :func:`sync_in_jit` runs.

    The collectives are issued on the current stream's side, so a CUDA graph
    captures them with the step. ``tally`` counts them (``all_reduce``,
    ``all_gather``).
    """
    procs = dist.get_world_size(group)
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    reduced: Dict[tuple, List[tuple]] = {}  # (dtype, reduction) -> [(i, name, local reduction)]
    gathered: Dict[torch.dtype, List[tuple]] = {}  # wire dtype -> [(i, name, ring part or None, rows)]
    for i, (state, reds) in enumerate(zip(states, reductions)):
        for name, value in state.items():
            red = reds.get(name, "sum")
            if isinstance(value, dict):
                for part, leaf in value.items():
                    gathered.setdefault(_wire(leaf.dtype), []).append((i, name, part, leaf))
            elif axis_index_groups is None and red in _EXACT_REDUCTIONS and _exact(value.dtype):
                reduced.setdefault((value.dtype, red), []).append((i, name, _COLLECTIVES[red](value), value.shape[0]))
            else:
                gathered.setdefault(_wire(value.dtype), []).append((i, name, None, value))
    out: List[Dict[str, Any]] = [{} for _ in states]
    for (_, red), items in reduced.items():
        flat = torch.cat([v.reshape(-1) for _, _, v, _ in items])
        if flat.numel():
            dist.all_reduce(flat, op=ops[red], group=group)
            _count(tally, "all_reduce")
        for (i, name, v, rows), piece in zip(items, flat.split([v.numel() for _, _, v, _ in items])):
            res = piece.view(v.shape)
            out[i][name] = res.unsqueeze(0).expand(procs * rows, *res.shape)
    stacks: List[Dict[str, Any]] = [{} for _ in states]
    for wire, items in gathered.items():
        rows = items[0][3].shape[0]
        widths = [leaf[0].numel() for *_, leaf in items]
        local = torch.cat([leaf.view(wire).reshape(rows, w) for (*_, leaf), w in zip(items, widths)], dim=1)
        full = local.new_empty((procs * rows, local.shape[1]))
        if local.numel():
            _all_gather_into(full, local, group)
            _count(tally, "all_gather")
        off = 0
        for (i, name, part, leaf), w in zip(items, widths):
            # a contiguous copy of each leaf: its reduction reads the layout the one-process rows have
            glob = full[:, off:off + w].contiguous().view(procs * rows, *leaf.shape[1:]).view(leaf.dtype)
            off += w
            if part is None:
                stacks[i][name] = glob
            else:
                stacks[i].setdefault(name, {})[part] = glob
    synced = []
    for i, (state, reds) in enumerate(zip(states, reductions)):
        if stacks[i]:
            out[i].update(sync_in_jit(stacks[i], reds, axis_name, axis_index_groups=axis_index_groups))
        synced.append({name: out[i][name] for name in state})
    return synced


def _wire(dtype: torch.dtype) -> torch.dtype:
    """The dtype a leaf travels as: ``bool`` as ``uint8`` (NCCL has no ``bool``), every other as itself."""
    return torch.uint8 if dtype == torch.bool else dtype


def _count(tally: Optional[Dict[str, int]], kind: str) -> None:
    if tally is not None:
        tally[kind] = tally.get(kind, 0) + 1
