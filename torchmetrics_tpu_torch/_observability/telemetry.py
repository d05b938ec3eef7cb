"""Per-metric telemetry and the process-wide registry.

A :class:`MetricTelemetry` is a small host-side bag of counters + latency
reservoirs attached lazily to a metric instance the first time an
instrumented seam fires with telemetry enabled. The
:class:`TelemetryRegistry` tracks every live telemetry (weakly — metrics
stay garbage-collectable) and folds finished instances into per-class
retired totals, so process-wide exports (:meth:`TelemetryRegistry.render_prometheus`,
:meth:`TelemetryRegistry.to_json`) survive metric churn.

Counter keys use a flat ``"family|label=value"`` convention (e.g.
``"update_calls|path=eager"``): one dict increment on the enabled hot path,
structured labels for the exporters. The families and their labels are
``export.EXPORT_SCHEMA``, the JAX package's.

Recompile-churn detection also lives here: every compiled-path cache key
(an argument signature of a CUDA graph, see ``_compile.py``) the runtime builds
is reported through :meth:`MetricTelemetry.compile_event`; the second
*distinct* key for the same compile kind is a recompile, and the first
recompile per instance raises a rate-limited :class:`RecompileChurnWarning`
naming exactly which cache-key component(s) changed (argument shapes,
dtypes, devices, layouts, static values, tree structure, or dtype policy) —
the information needed to pin down why a "compiled" metric keeps paying
capture time.
"""

from __future__ import annotations

import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from torchmetrics_tpu_torch._analysis.locksan import SAN as _SAN
from torchmetrics_tpu_torch._analysis.locksan import check_access as _san_check
from torchmetrics_tpu_torch._analysis.locksan import new_lock as _san_lock
from torchmetrics_tpu_torch._observability.events import BUS
from torchmetrics_tpu_torch._observability.reservoir import LatencyReservoir
from torchmetrics_tpu_torch._observability.state import OBS
from torchmetrics_tpu_torch._observability.tracing import current_trace_id

__all__ = [
    "diff_components",
    "MetricTelemetry",
    "TelemetryRegistry",
    "TelemetryReport",
    "RecompileChurnWarning",
    "REGISTRY",
    "get_registry",
    "telemetry_for",
    "report_for",
]


class RecompileChurnWarning(UserWarning):
    """A metric's compiled path keeps rebuilding its executable."""


def diff_components(prev: Dict[str, str], cur: Dict[str, str]) -> Tuple[List[str], str]:
    """Name the cache-key component(s) differing between two compile keys.

    The churn detector's diff, in the wording a ``RecompileChurnWarning``
    uses (the JAX package's recompile gate shares it).
    """
    changed = sorted(k for k in set(prev) | set(cur) if prev.get(k) != cur.get(k))
    diff = "; ".join(f"{k}: {prev.get(k)!r} -> {cur.get(k)!r}" for k in changed)
    return changed, diff


# histogram bucket upper bounds (seconds) for `latency_bucket|op=|le=`
# counters. Buckets are recorded NON-cumulative (one counter bump per
# observation, in the first bucket whose bound covers it); the exporter
# cumsums over the sorted bounds — a sum of monotonic counters stays
# monotonic, so the exposed cumulative series never regresses.
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0005,
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
)

_BUCKET_LABELS: Tuple[str, ...] = tuple(repr(b) for b in LATENCY_BUCKETS) + ("+Inf",)


def _bucket_label(seconds: float) -> str:
    for bound, label in zip(LATENCY_BUCKETS, _BUCKET_LABELS):
        if seconds <= bound:
            return label
    return "+Inf"


def _split_key(key: str) -> Tuple[str, Dict[str, str]]:
    """``"update_calls|path=eager"`` -> ``("update_calls", {"path": "eager"})``."""
    if "|" not in key:
        return key, {}
    family, _, rest = key.partition("|")
    labels: Dict[str, str] = {}
    for part in rest.split("|"):
        name, _, value = part.partition("=")
        labels[name] = value
    return family, labels


class MetricTelemetry:  # concurrency: shared exporters scrape via the registry while hot paths mutate
    """Counters + latency reservoirs for ONE metric instance (host-side).

    Deliberately lock-free: each instance has ONE writer (the thread
    driving its metric) and scrape-side readers copy containers with
    C-level ``dict(...)`` under the GIL before iterating (see
    ``TelemetryRegistry.aggregate``). A lock here would put a contended
    acquire on the telemetry-enabled hot path for every counter bump. The
    static concurrency pass (R7) flags this class's container accesses;
    the findings are baselined with this justification rather than locked
    — the single-writer contract is the design.
    """

    __slots__ = (
        "name",
        "counters",
        "reservoirs",
        "gauges",
        "exemplars",
        "_ticks",
        "_compile_keys",
        "_recent_keys",
        "_last_compile",
        "_churn_warned",
        "last_churn_diff",
        "__weakref__",
    )

    def __init__(self, name: str) -> None:
        self.name = name
        self.counters: Dict[str, float] = {}
        self.reservoirs: Dict[str, LatencyReservoir] = {}
        self.gauges: Dict[str, float] = {}
        # "op|le" -> (observed value, unix ts, trace id): the most recent
        # traced observation per histogram bucket, exported as an
        # OpenMetrics exemplar. Cardinality is ops x buckets — bounded.
        self.exemplars: Dict[str, Tuple[float, float, int]] = {}
        self._ticks: Dict[str, int] = {}
        # compiled-path cache keys already seen, per compile kind
        self._compile_keys: set = set()
        # post-cap fallback dedup window, per compile kind (see compile_event)
        self._recent_keys: Dict[str, Any] = {}
        self._last_compile: Dict[str, Dict[str, str]] = {}
        self._churn_warned = False
        self.last_churn_diff: Optional[str] = None

    # ------------------------------------------------------------- recording
    def inc(self, key: str, n: float = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    def set_gauge(self, key: str, value: float) -> None:
        """Set an instantaneous (non-monotonic) value; last write wins.

        Gauges describe the instance's *current* state (e.g. the predicted
        per-replica state footprint), so they are summed over live instances
        at aggregation time and deliberately NOT folded into retired totals
        — a collected metric no longer occupies the bytes it predicted.
        """
        self.gauges[key] = float(value)

    def sample_due(self, op: str) -> bool:
        """True once every ``OBS.sample_every`` calls OF THIS OP.

        Per-op tick counters: a shared counter would let a periodic mix of
        ops (e.g. 15 updates then 1 compute at ``sample_every=16``) sample
        one op on 100% of its calls and starve the others forever.
        """
        tick = self._ticks.get(op, 0) + 1
        self._ticks[op] = tick
        return tick % OBS.sample_every == 0

    def observe(self, op: str, seconds: float) -> None:
        res = self.reservoirs.get(op)
        if res is None:
            res = self.reservoirs[op] = LatencyReservoir()
        res.push(seconds)
        # lifetime sample count AND summed seconds as REGULAR counters: they
        # survive instance retirement and stay monotonic, which the
        # Prometheus summary export needs for its `_count`/`_sum` series
        # (the reservoir's retained window shrinks/vanishes on GC)
        self.inc(f"latency_samples|op={op}")
        self.inc(f"latency_sum_seconds|op={op}", seconds)
        le = _bucket_label(seconds)
        self.inc(f"latency_bucket|op={op}|le={le}")
        if OBS.tracing:
            tid = current_trace_id()
            if tid is not None:
                self.exemplars[f"{op}|{le}"] = (seconds, time.time(), tid)

    # ---------------------------------------------------------------- compile
    # distinct cache keys remembered for dedup; beyond this a churn-pathology
    # stream stops growing host memory (dedup weakens to "new vs last key",
    # which is all the churn warning needs)
    _COMPILE_KEY_CAP = 512

    def compile_event(self, kind: str, components: Dict[str, str], built: bool = True) -> None:
        """Record one compiled-executable cache key; warn on churn.

        ``components`` maps cache-key component names to printable values
        (``shapes``, ``dtypes``, ``static_args``, ``arg_structure``,
        ``dtype_policy``, ...). The first distinct key per ``kind`` is the
        expected initial compile; each further distinct key is a recompile.
        The first recompile per instance warns (naming the differing
        components); later ones are counted as suppressed — a steady churner
        would otherwise flood the log at stream rate.

        ``built=False`` records a signature that will NEVER compile (the
        saturated auto-signature cache streams it eagerly forever): churn
        tracking still applies, but it is counted separately so
        ``compiles`` only ever names executables that were actually built.
        """
        key = (kind, tuple(sorted(components.items())))
        if key in self._compile_keys:
            return
        recent = self._recent_keys.get(kind)
        if recent is not None and key in recent:
            # post-cap fallback: the key store is full, so dedup weakens to
            # a small recent-key window — steady or short-cycle alternating
            # signatures must not be re-counted (or bus-published) per call
            return
        if len(self._compile_keys) < self._COMPILE_KEY_CAP:
            self._compile_keys.add(key)
        else:
            if recent is None:
                from collections import deque

                recent = self._recent_keys[kind] = deque(maxlen=16)
            recent.append(key)
        self.inc(f"compiles|kind={kind}" if built else f"uncompiled_signatures|kind={kind}")
        prev = self._last_compile.get(kind)
        self._last_compile[kind] = dict(components)
        if prev is None:
            return
        self.inc(f"recompiles|kind={kind}")
        changed, diff = diff_components(prev, components)
        self.last_churn_diff = diff or "(identical components, distinct key)"
        BUS.publish(
            "recompile_churn",
            self.name,
            f"{kind} recompiled; changed cache-key component(s): {', '.join(changed) or '?'}",
            data={"kind": kind, "changed": changed},
        )
        if self._churn_warned:
            self.inc("churn_suppressed")
            return
        self._churn_warned = True
        self.inc("churn_warnings")
        from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

        rank_zero_warn(
            f"{self.name} is recompiling its `{kind}` executable: cache-key component(s)"
            f" {', '.join(changed) or 'unknown'} changed ({self.last_churn_diff}). Every distinct"
            " key pays a warm-up and a CUDA graph capture — pad/bucket inputs to stable shapes and"
            " keep static arguments constant. Further"
            " recompile-churn warnings for this metric are suppressed and counted in"
            " `telemetry_report()`.",
            RecompileChurnWarning,
        )

    # ----------------------------------------------------------------- report
    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": dict(self.counters),
            "latency": {op: res.stats() for op, res in self.reservoirs.items()},
            "churn": {
                "warnings": int(self.counters.get("churn_warnings", 0)),
                "suppressed": int(self.counters.get("churn_suppressed", 0)),
                "last_diff": self.last_churn_diff,
            },
        }

    def __deepcopy__(self, memo: Dict[int, Any]) -> None:
        # a cloned metric/collection is a NEW stream: deepcopy the cached
        # `_telem` slot to None so the clone re-registers lazily on first
        # use — a copied MetricTelemetry object would hold counters the
        # registry never sees (unregistered, never retired, absent from
        # every export)
        return None


@dataclass(frozen=True)
class TelemetryReport:
    """Queryable per-metric (or aggregated) telemetry snapshot."""

    metric: str
    enabled: bool
    counters: Dict[str, float] = field(default_factory=dict)
    latency: Dict[str, Dict[str, float]] = field(default_factory=dict)
    churn: Dict[str, Any] = field(default_factory=dict)

    @property
    def path_counts(self) -> Dict[str, int]:
        """update/forward executions by path (eager, auto_compiled, jit, scan, forward_compiled)."""
        out: Dict[str, int] = {}
        for key, val in self.counters.items():
            family, labels = _split_key(key)
            if family == "update_calls" and "path" in labels:
                out[labels["path"]] = out.get(labels["path"], 0) + int(val)
        return out

    @property
    def total_updates(self) -> int:
        return sum(self.path_counts.values())

    def counter(self, key: str) -> float:
        return self.counters.get(key, 0)

    @staticmethod
    def merged(reports: List["TelemetryReport"], name: str = "aggregate") -> "TelemetryReport":
        """Sum counters across reports (collection-level aggregation)."""
        counters: Dict[str, float] = {}
        churn_warn = churn_supp = 0
        enabled = False
        for rep in reports:
            enabled = enabled or rep.enabled
            for key, val in rep.counters.items():
                counters[key] = counters.get(key, 0) + val
            churn_warn += int(rep.churn.get("warnings", 0) or 0)
            churn_supp += int(rep.churn.get("suppressed", 0) or 0)
        return TelemetryReport(
            metric=name,
            enabled=enabled,
            counters=counters,
            latency={},
            churn={"warnings": churn_warn, "suppressed": churn_supp, "last_diff": None},
        )


class TelemetryRegistry:
    """Process-wide directory of live metric telemetries + retired totals."""

    def __init__(self) -> None:
        self._lock = _san_lock("TelemetryRegistry._lock")
        # id(metric) -> (weakref-to-metric, telemetry); the weakref callback
        # queues the entry for retirement, folding its counters into
        # per-class totals at the next locked entry point
        self._live: Dict[int, Tuple[Any, MetricTelemetry]] = {}
        self._retired: Dict[str, Dict[str, float]] = {}
        self._retired_instances: Dict[str, int] = {}
        # oids whose metric was collected but not yet folded. The weakref
        # callback must NOT take _lock: gc can run it on ANY thread at ANY
        # allocation — including inside this registry's own critical
        # sections, where a non-reentrant acquire self-deadlocks (and a
        # reentrant one would mutate _live mid-iteration). deque.append is
        # GIL-atomic, so the callback stays lock-free and every locked
        # entry point drains the queue first.
        self._pending_retire: "deque[int]" = deque()

    # ------------------------------------------------------------- lifecycle
    def register(self, obj: Any) -> MetricTelemetry:
        telem = MetricTelemetry(type(obj).__name__)
        oid = id(obj)

        def _on_collect(_ref: Any, registry: "TelemetryRegistry" = self, oid: int = oid) -> None:
            # lock-free by contract — see _pending_retire above
            registry._pending_retire.append(oid)

        try:
            ref = weakref.ref(obj, _on_collect)
        except TypeError:  # objects without weakref support still get counters
            ref = None
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_live")
            self._drain_retired()
            self._live[oid] = (ref, telem)
        return telem

    def _drain_retired(self) -> None:  # concurrency: guarded-by _lock
        """Fold queued retirements into the per-class totals. Caller holds
        ``_lock``; never raises on an unknown oid (reset may have dropped it)."""
        while True:
            try:
                oid = self._pending_retire.popleft()
            except IndexError:
                return
            entry = self._live.pop(oid, None)
            if entry is None:
                continue
            telem = entry[1]
            bucket = self._retired.setdefault(telem.name, {})
            for key, val in telem.counters.items():
                bucket[key] = bucket.get(key, 0) + val
            self._retired_instances[telem.name] = self._retired_instances.get(telem.name, 0) + 1

    def telemetries(self) -> List[MetricTelemetry]:
        with self._lock:
            self._drain_retired()
            return [t for _, t in self._live.values()]

    def reset(self) -> None:
        """Drop every live registration and all retired totals (tests/tools)."""
        with self._lock:
            self._live.clear()
            self._retired.clear()
            self._retired_instances.clear()
            self._pending_retire.clear()

    # ------------------------------------------------------------- aggregate
    def aggregate(self) -> Dict[str, Dict[str, Any]]:
        """Per-class merged view: counters summed over live+retired instances,
        latency reservoirs pooled over live instances."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_live,_retired,_retired_instances")
            self._drain_retired()
            live = [t for _, t in self._live.values()]
            retired = {k: dict(v) for k, v in self._retired.items()}
            retired_n = dict(self._retired_instances)
        blank = lambda: {  # noqa: E731 — one-line schema shared by both loops
            "counters": {},
            "gauges": {},
            "latency": {},
            "exemplars": {},
            "instances": 0,
            "retired_instances": 0,
        }
        for telem in live:
            entry = out.setdefault(telem.name, blank())
            entry["instances"] += 1
            # dict(...) is a C-level copy (atomic under the GIL): the hot
            # path may be inserting first-time keys concurrently with an
            # export scrape, and iterating the live dict directly would
            # raise "dictionary changed size during iteration"
            for key, val in dict(telem.counters).items():
                entry["counters"][key] = entry["counters"].get(key, 0) + val
            # gauges sum over LIVE instances only: they are instantaneous
            # occupancy, not lifetime totals, so retirement drops them
            for key, val in dict(telem.gauges).items():
                entry["gauges"][key] = entry["gauges"].get(key, 0) + val
            for op, res in dict(telem.reservoirs).items():
                pool = entry["latency"].setdefault(op, [])
                pool.extend(res.values())
            # most recent traced observation per op|le bucket wins across
            # instances — an exemplar is a pointer at fresh evidence, not
            # an aggregate, so summing would be meaningless
            for key, ex in dict(telem.exemplars).items():
                cur = entry["exemplars"].get(key)
                if cur is None or ex[1] > cur[1]:
                    entry["exemplars"][key] = ex
        for name, counters in retired.items():
            entry = out.setdefault(name, blank())
            entry["retired_instances"] = retired_n.get(name, 0)
            for key, val in counters.items():
                entry["counters"][key] = entry["counters"].get(key, 0) + val
        # summarize pooled latency samples
        for entry in out.values():
            summarized: Dict[str, Dict[str, float]] = {}
            for op, samples in entry["latency"].items():
                res = LatencyReservoir(capacity=max(1, len(samples)))
                for s in samples:
                    res.push(s)
                summarized[op] = res.stats()
            entry["latency"] = summarized
        return out

    def counter_totals(self) -> Dict[str, float]:
        """Counter totals summed over live+retired instances of every class,
        full ``family|label=value`` keys preserved — the counters-only slice
        of :meth:`aggregate` without the latency pooling/sorting (SLO probes
        hit this every few seconds; sorting retained samples per probe just
        to discard them is wasted work)."""
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_live,_retired,_retired_instances")
            self._drain_retired()
            live = [t for _, t in self._live.values()]
            retired = [dict(v) for v in self._retired.values()]
        totals: Dict[str, float] = {}
        # dict(...) copies are C-level (atomic under the GIL) — see aggregate()
        for counters in [dict(t.counters) for t in live] + retired:
            for key, val in counters.items():
                totals[key] = totals.get(key, 0.0) + float(val)
        return totals

    # --------------------------------------------------------------- exports
    def render_prometheus(self) -> str:
        from torchmetrics_tpu_torch._observability.export import render_prometheus
        from torchmetrics_tpu_torch._observability.profiling import LEDGER

        return render_prometheus(self.aggregate(), BUS, OBS.enabled, ledger=LEDGER)

    def render_openmetrics(self) -> str:
        """OpenMetrics text exposition (``application/openmetrics-text``):
        same families as :meth:`render_prometheus` plus trace-id exemplars
        on the latency histogram buckets, terminated by ``# EOF``."""
        from torchmetrics_tpu_torch._observability.export import render_openmetrics
        from torchmetrics_tpu_torch._observability.profiling import LEDGER

        return render_openmetrics(self.aggregate(), BUS, OBS.enabled, ledger=LEDGER)

    def to_json(self) -> Dict[str, Any]:
        from torchmetrics_tpu_torch._observability.export import to_json
        from torchmetrics_tpu_torch._observability.profiling import LEDGER

        return to_json(self.aggregate(), BUS, OBS.enabled, ledger=LEDGER)


REGISTRY = TelemetryRegistry()


def get_registry() -> TelemetryRegistry:
    return REGISTRY


def telemetry_for(obj: Any, create: bool = True) -> Optional[MetricTelemetry]:
    """The instance's telemetry, creating + registering it on first use.

    The telemetry object is cached in the instance ``__dict__`` so hot-path
    helpers reach it with one dict probe (only ever executed with telemetry
    enabled — the disabled path never calls this).
    """
    telem = obj.__dict__.get("_telem")
    if telem is None and create:
        telem = REGISTRY.register(obj)
        obj.__dict__["_telem"] = telem
    return telem


def report_for(obj: Any) -> TelemetryReport:
    telem = obj.__dict__.get("_telem")
    name = type(obj).__name__
    if telem is None:
        return TelemetryReport(metric=name, enabled=OBS.enabled)
    snap = telem.snapshot()
    return TelemetryReport(
        metric=name,
        enabled=OBS.enabled,
        counters=snap["counters"],
        latency=snap["latency"],
        churn=snap["churn"],
    )
