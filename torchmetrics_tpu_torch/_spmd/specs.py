"""The SPMD engine's mesh, its stacked-state layout and its reduction checks.

Port of ``torchmetrics_tpu/_spmd/specs.py``. The engine (``engine.py``)
keeps every metric state *stacked*: a state whose per-device value has shape
``(*s,)`` lives as one ``(D, *s)`` tensor, one row per mesh position, each
row that position's local accumulator. A ring-buffer ("cat") state stacks
as its ``{"data", "valid", "count"}`` leaves. This module builds the mesh,
names the layout, derives the per-state collective plan that the step's
in-graph sync (``utilities.distributed.sync_in_jit``) follows, and checks
that a live metric's declared reductions map onto those collectives at all.

The JAX package shards the rows over a ``jax.sharding.Mesh`` of devices.
Here a :class:`Mesh` is this process's rows (a tuple of ``torch.device``, all
one device), one axis name and, across processes, a ``torch.distributed``
process group. Rows share their device: eight rows on one card (or on the
CPU) are one ``(8, *s)`` tensor there, and the sync is a reduction over its
leading axis. Over a group of ``P`` processes the mesh has ``P`` times this
process's rows, rank-major (global row ``g`` is row ``g % rows`` of rank
``g // rows``), as a JAX mesh over the devices of several processes orders
them; the sync then also runs collectives over the group.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from torchmetrics_tpu_torch._streams.manifest import _in_graph_sync
from torchmetrics_tpu_torch._streams.pool import stack_default
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError
from torchmetrics_tpu_torch.utilities.ringbuffer import RingBuffer

__all__ = [
    "COLLECTIVE_FOR",
    "InGraphSyncUnsupported",
    "Mesh",
    "build_mesh",
    "in_graph_sync_eligible",
    "stack_default",
    "state_specs",
    "sync_plan",
    "validate_reductions",
]

class InGraphSyncUnsupported(TorchMetricsUserError):
    """The metric cannot take the fused in-graph sync path.

    Raised at engine construction, never mid-stream, so callers keep the
    eager gather path (``Metric.sync``) with no state committed.
    """


# reduction kind -> the collective the JAX package's fused step lowers it
# to; the port's sync (``utilities.distributed.sync_in_jit``) computes each
# over the rows of a stacked state. ``None`` is the reference's "gather,
# don't reduce" kind (PearsonCorrCoef's algorithmic merge): fixed-shape
# states gather into a stacked ``(D, *s)`` moment set that the class's own
# compute folds (``_final_aggregation``).
COLLECTIVE_FOR: Dict[Optional[str], str] = {
    "sum": "psum",
    "mean": "pmean",
    "max": "pmax",
    "min": "pmin",
    "cat": "all_gather",
    None: "all_gather",
}


def _normal(device: Any) -> torch.device:
    """``device`` as a ``torch.device``, a bare ``cuda`` pinned to the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A 1-D named mesh: this process's rows (one ``torch.device`` each), one axis name and a process group.

    The counterpart of a 1-D ``jax.sharding.Mesh``. ``devices`` are this
    process's rows; ``shape`` maps the axis name to the *global* number of
    rows, ``local_rows`` times the size of ``process_group`` (1 without
    one), as the JAX mesh's counts every device of the job. ``rank`` is this
    process's rank in the group (0 without one).
    """

    def __init__(self, devices: Sequence[Any], axis_names: Tuple[str, ...], process_group: Any = None) -> None:
        self.devices: Tuple[torch.device, ...] = tuple(_normal(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.process_group = process_group
        self.local_rows = len(self.devices)
        self.processes = 1 if process_group is None else dist.get_world_size(process_group)
        self.rank = 0 if process_group is None else dist.get_rank(process_group)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: self.local_rows * self.processes}


def build_mesh(
    axis_name: str = "dp", devices: Optional[Sequence[Any]] = None, process_group: Any = None
) -> Mesh:
    """A 1-D named mesh over ``devices``, across the processes of ``process_group``.

    ``devices`` may repeat a device: ``build_mesh(devices=["cuda:0"] * 8)``
    runs a world of 8 rows on one card, ``["cpu"] * 8`` on the CPU. With
    ``process_group``, ``devices`` are this process's rows (default: one
    row, on this process's current card under an NCCL group, else on the
    CPU) and the mesh spans every process of the group. With neither, the
    mesh is one such row over the default group where ``torch.distributed``
    is initialized (one process a card: the counterpart of the JAX mesh over
    every device of the job), else every visible card, one row each.
    """
    if process_group is None and devices is None and dist.is_available() and dist.is_initialized():
        process_group = dist.group.WORLD
    if process_group is not None and devices is None:
        on_card = dist.get_backend(process_group) == "nccl"
        devices = [torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")]
    devs = list(devices) if devices is not None else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())
    ]
    if not devs:
        raise InGraphSyncUnsupported("no devices available to build a mesh over")
    return Mesh(devs, (axis_name,), process_group)


def state_specs(names: Sequence[str], axis_name: str) -> Dict[str, Tuple[str]]:
    """The stacked layout's spec of each state: its leading axis runs over the mesh axis ``axis_name``.

    The JAX package returns ``PartitionSpec(axis_name)``; the spec covers a
    plain stacked tensor and a ring state's ``{data, valid, count}`` leaves
    alike (each leaf carries the row axis first).
    """
    return {name: (axis_name,) for name in names}


def in_graph_sync_eligible(cls: type) -> str:
    """The engine's gate: ``"safe"``/``"runtime"``/``"unsupported"``/``"host_bound"``/``"unknown"`` for the exact class.

    The port's reading of ``_eligibility.json["in_graph_sync"]`` (JAX
    ``_analysis/manifest.py:159``) through the stream pool's reader. ``safe``
    certifies the fused update, sync and compute outright; ``runtime`` means
    the engine checks the live instance's ``_reductions`` itself; a class
    the copy does not name (a user subclass) reads ``"unknown"``. The JAX
    package's switch that turns its static analysis off has no counterpart:
    the port has no ``_analysis/``.
    """
    return _in_graph_sync().get(f"{cls.__module__}.{cls.__qualname__}") or "unknown"


def sync_plan(reductions: Dict[str, Any]) -> Dict[str, str]:
    """``state -> collective`` plan for a metric's declared reductions.

    Raises :class:`InGraphSyncUnsupported` (listing every offending state)
    when a reduction has no in-graph collective. This is the runtime twin
    of the manifest's ``in_graph_sync`` facet: the facet proves it
    statically where it can; this check decides the ``"runtime"`` classes
    from the live instance.
    """
    plan: Dict[str, str] = {}
    bad: List[str] = []
    for name, red in reductions.items():
        if red is None or (isinstance(red, str) and red in COLLECTIVE_FOR):
            plan[name] = COLLECTIVE_FOR[red]
        else:
            desc = red if isinstance(red, str) else f"callable:{getattr(red, '__name__', 'fn')}"
            bad.append(f"`{name}` (dist_reduce_fx={desc!r})")
    if bad:
        raise InGraphSyncUnsupported(
            "These states declare reductions with no in-graph collective semantics: "
            + ", ".join(sorted(bad))
            + ". The fused SPMD step supports sum/mean/max/min (psum/pmean/pmax/pmin),"
            " ring-buffer cat states and fixed-shape gather (None) states (all_gather);"
            " keep the eager gather path for the rest."
        )
    return plan


def validate_reductions(metric: Any) -> Dict[str, str]:
    """Check a live metric's states for the fused step; return the plan.

    Beyond reduction kinds, ``cat`` list states are refused unless they are
    ring buffers (a growing concatenated state changes shape every step,
    one new graph a batch: what ``cat_state_capacity`` bounds), and so are
    list states with ``dist_reduce_fx=None`` (the gather needs one fixed
    shape a row).
    """
    plan = sync_plan(dict(metric._reductions))
    for name, red in metric._reductions.items():
        value = getattr(metric, name)
        if red == "cat" and not isinstance(value, RingBuffer):
            raise InGraphSyncUnsupported(
                f"state `{name}` is an unbounded cat state; its carried shape would grow"
                " every fused step (one recompile per batch). Construct the metric with"
                " `cat_state_capacity=N` to bound it into a ring buffer."
            )
        if red is None and isinstance(value, list):
            raise InGraphSyncUnsupported(
                f"state `{name}` is a list state with dist_reduce_fx=None; in-graph gather"
                " needs a fixed per-device shape (an array state, as the Pearson moment"
                " states are). Keep the eager gather path."
            )
    return plan
