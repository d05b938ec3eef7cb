"""Continuous profiling: device-time accounting, MFU gauges, perf anomalies.

The telemetry layer (counters + reservoirs) answers *how often* and *how
slow*; this module answers the two questions a production metrics service
gets asked first — **where does the device time go** (per seam, per metric
class, per tenant) and **how far from the hardware ceiling are we running**.

One process-wide :class:`CostLedger` (:data:`LEDGER`) accumulates:

- **Seam/class buckets** — every profiled step seam
  (``update_compiled``, ``forward_compiled``, ``update_jit``,
  ``update_scan``, and the trunks' ``trunk_forward``) records its measured
  seconds into a ``(seam, metric class)`` bucket via
  :meth:`CostLedger.record_step`. Unlike latency *sampling* (1-in-N),
  profiling times EVERY step while enabled: cost accounting has to add up,
  so the ledger's bucket total IS the measured device time.
- **Device seconds from CUDA events** — where the JAX package reads
  ``perf_counter`` around a dispatch, a replay of a CUDA graph is timed on
  the card: a timing event pair (:meth:`CostLedger.event_pair`) is recorded
  around it and handed to :meth:`CostLedger.record_event_pair`. No pair is
  waited for on the hot path: each new pair first resolves the earlier
  ones whose end event has completed (``query()``), and only a read of the
  ledger (:meth:`~CostLedger.gauges`, :meth:`~CostLedger.snapshot`,
  :meth:`~CostLedger.total_device_seconds`) synchronizes on the rest. A
  CPU metric's step keeps ``perf_counter``.
- **Executable costs** — when a step is captured (or a CPU metric's step
  first runs) the runtime counts its flops and bytes
  (``costs.count_costs``) and reports them per step, keyed by the churn
  detector's cache-key digest (:meth:`CostLedger.note_executable`).
  Buckets then accrue predicted flops/bytes per step, giving live
  **MFU and roofline-ceiling gauges**: cumulative
  ``mfu = flops / (device_seconds * peak)`` against
  :func:`~torchmetrics_tpu_torch._observability.costs.get_ceilings`.
- **Compile seconds** — wall time spent in warm-up + capture per cache-key
  digest, the cold-start cost surface.
- **A perf-anomaly detector** — a rolling per-seam baseline (EWMA of the
  step latency + EWMA of absolute deviation, a streaming stand-in for
  p50 + MAD). A *sustained* run of steps beyond
  ``baseline + max(k·1.4826·MAD, rel·baseline)`` publishes ONE rate-limited
  ``perf_regression`` bus event carrying the seam, the ambient trace id,
  and observed-vs-baseline seconds — which the flight recorder
  (``flight.py``) turns into a post-mortem dump, so the dump machinery
  fires on *slowness*, not only on faults. The baseline is frozen while a
  run of high samples is active: a regression must not be EWMA-absorbed
  into its own threshold.

Per-tenant cost meters (``pool_cost_*``) belong to the stream pool, which
the port does not have yet; the ledger does not duplicate that bookkeeping.

Switch: ``OBS.profiling`` (env ``TM_TPU_PROFILING=1``,
:func:`set_profiling_enabled`); one slot load + branch per seam while off.
Bus events additionally require the main telemetry switch (``BUS.publish``
no-ops while ``OBS.enabled`` is false), so perf-regression *dumps* need
both switches on; the gauges need only profiling.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from torchmetrics_tpu_torch._analysis.locksan import SAN as _SAN
from torchmetrics_tpu_torch._analysis.locksan import check_access as _san_check
from torchmetrics_tpu_torch._analysis.locksan import new_lock as _san_lock
from torchmetrics_tpu_torch._observability.costs import ExecutableCost, get_ceilings
from torchmetrics_tpu_torch._observability.events import BUS
from torchmetrics_tpu_torch._observability.state import OBS
from torchmetrics_tpu_torch._observability.tracing import current_trace_id

__all__ = [
    "CostLedger",
    "LEDGER",
    "get_ledger",
    "reset_ledger",
    "set_profiling_enabled",
    "profiling_enabled",
    "SEAM_KINDS",
    "owner_class",
]

# profiled seam -> the step kinds whose counted cost backs its flops/bytes
# attribution (the kind vocabulary the churn detector and
# `telemetry_report()` share); `trunk_forward` is a trunk's own graph
# (`_compile.CapturedForward`), which the JAX package does not profile
SEAM_KINDS: Dict[str, Tuple[str, ...]] = {
    "update_compiled": ("auto_update",),
    "forward_compiled": ("auto_forward",),
    "update_jit": ("jit_update",),
    "update_scan": ("scan_update",),
    "trunk_forward": ("trunk_forward",),
    "spmd_step": ("spmd_step",),
    "stream_step": ("stream_step",),
}

_KIND_SEAM: Dict[str, str] = {k: seam for seam, kinds in SEAM_KINDS.items() for k in kinds}

# distinct executables remembered for the compile-seconds surface; beyond
# this a churn pathology stops growing host memory (the churn detector
# already names the pathology itself)
_EXECUTABLE_CAP = 256


def set_profiling_enabled(flag: bool) -> None:
    """Runtime switch for the continuous-profiling layer.

    Enabling starts device-time accounting (every profiled seam pays one
    CUDA event pair per replay, or a ``perf_counter`` pair per CPU step),
    cost attribution, MFU gauges, and the perf-anomaly detector. Already-accumulated ledger
    state stays readable after disabling.
    """
    OBS.profiling = bool(flag)


def profiling_enabled() -> bool:
    return OBS.profiling


def owner_class(owner: str) -> str:
    """Metric class behind a dispatcher owner string.

    Owners arrive as ``"StreamPool[BinaryAccuracy]"`` /
    ``"SpmdEngine[FrechetInceptionDistance]"`` (engine seams) or the
    dotted ``module.QualName`` of the metric class itself (Metric seams).
    """
    if "[" in owner and owner.endswith("]"):
        return owner[owner.index("[") + 1 : -1]
    return owner.rsplit(".", 1)[-1]


class _Baseline:
    """Streaming per-seam latency baseline: EWMA p50 proxy + MAD proxy."""

    __slots__ = ("ewma", "ewmad", "n", "high_run", "cooldown_until", "triggered")

    def __init__(self) -> None:
        self.ewma = 0.0
        self.ewmad = 0.0
        self.n = 0
        self.high_run = 0
        self.cooldown_until = 0.0  # monotonic deadline of the trigger cooldown
        self.triggered = 0


class CostLedger:  # concurrency: shared step threads record while scrapes/tools snapshot
    """Process-wide device-time + cost accounting (the profiling substrate).

    All mutation happens under ``_lock`` — unlike the per-metric telemetry
    (single-writer by contract), the ledger is one object shared by every
    metric, engine, and pool in the process, so concurrent steps on
    different threads genuinely race here. The lock is uncontended in the
    common single-thread case and only taken while profiling is ON.
    """

    # anomaly-detector tuning (instance attributes so tests can
    # tighten them without monkeypatching module globals)
    WARMUP = 64  # baseline samples before the detector arms
    ALPHA = 0.05  # EWMA smoothing for baseline + deviation
    K_MAD = 6.0  # threshold = baseline + K_MAD * 1.4826 * MAD-proxy ...
    REL_FLOOR = 0.5  # ... but at least REL_FLOOR * baseline above it
    SUSTAIN = 8  # consecutive over-threshold steps before triggering
    COOLDOWN_SECONDS = 30.0  # per-seam re-trigger rate limit

    def __init__(self) -> None:
        self._lock = _san_lock("CostLedger._lock")
        # concurrency: guarded-by _lock — (kind, class) -> latest cost claim
        self._costs: Dict[Tuple[str, str], ExecutableCost] = {}
        # concurrency: guarded-by _lock — digest12 -> executable record
        self._executables: Dict[str, Dict[str, Any]] = {}
        # concurrency: guarded-by _lock — (seam, class) -> accumulators
        self._buckets: Dict[Tuple[str, str], Dict[str, float]] = {}
        # concurrency: guarded-by _lock — seam -> rolling baseline
        self._baselines: Dict[str, _Baseline] = {}
        # concurrency: guarded-by _lock — (seam, class, start, end, then) event
        # pairs recorded on the card and not yet resolved, oldest first
        self._pending: "deque[Tuple[str, str, Any, Any, Any]]" = deque()
        # concurrency: guarded-by _lock — resolved pairs' events for reuse
        self._free_events: List[Tuple[Any, Any]] = []
        self.warmup = self.WARMUP
        self.alpha = self.ALPHA
        self.k_mad = self.K_MAD
        self.rel_floor = self.REL_FLOOR
        self.sustain = self.SUSTAIN
        self.cooldown_seconds = self.COOLDOWN_SECONDS

    # ------------------------------------------------------------ executables
    def note_executable(
        self,
        *,
        owner: str,
        kind: str,
        digest: str,
        cost: Optional[ExecutableCost],
        compile_seconds: float = 0.0,
        source: str = "compiled",
    ) -> None:
        """Record one step's counted cost + the seconds its build took.

        Called when a step is captured into a CUDA graph (``source=
        "captured"``, ``compile_seconds`` the warm-up plus the capture) or a
        CPU metric's step first runs (``source="compiled"``). ``digest`` is
        the churn detector's cache-key digest (sha256 hex); the ledger keys
        the compile-seconds surface by its first 12 chars (bounded label).
        """
        cls = owner_class(owner)
        key = digest[:12] if digest else "?"
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_costs,_executables")
            if cost is not None:
                self._costs[(kind, cls)] = cost
            entry = self._executables.get(key)
            if entry is None:
                if len(self._executables) >= _EXECUTABLE_CAP:
                    return
                entry = self._executables[key] = {
                    "kind": kind,
                    "class": cls,
                    "flops": cost.flops if cost is not None else 0.0,
                    "bytes_accessed": cost.bytes_accessed if cost is not None else 0.0,
                    "compile_seconds": 0.0,
                    "resolutions": 0,
                    "source": source,
                }
            entry["compile_seconds"] += float(compile_seconds)
            entry["resolutions"] += 1
            entry["source"] = source

    def cost_for(self, seam: str, cls: str) -> Optional[ExecutableCost]:
        """Latest cost claim backing ``seam`` for metric class ``cls``."""
        kinds = SEAM_KINDS.get(seam, (seam,))
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_costs")
            for kind in kinds:
                cost = self._costs.get((kind, cls))
                if cost is not None:
                    return cost
        return None

    # ------------------------------------------------------------ device time
    def event_pair(self) -> Tuple[Any, Any]:
        """Two timing CUDA events for one step, reused from resolved pairs where possible."""
        with self._lock:
            if self._free_events:
                return self._free_events.pop()
        import torch

        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def record_event_pair(self, seam: str, cls: str, start: Any, end: Any, then: Any = None) -> None:
        """Account one step timed on the card between ``start`` and ``end`` (both recorded).

        The pair joins the pending queue; the pairs before it whose end
        event has completed are resolved now, in order. Nothing here waits
        for the card. ``then``, if given, is called with the step's seconds
        once the pair is resolved (a stream pool meters them to its tenants).
        """
        with self._lock:
            self._pending.append((seam, cls, start, end, then))
            ready = self._take_resolved()
        self._account_resolved(ready)

    def _take_resolved(self) -> List[Tuple[str, str, float, Any]]:  # concurrency: guarded-by _lock
        """Pop the pending pairs whose end has completed, in order, as seconds."""
        out: List[Tuple[str, str, float, Any]] = []
        while self._pending:
            seam, cls, start, end, then = self._pending[0]
            if not end.query():
                break
            self._pending.popleft()
            out.append((seam, cls, start.elapsed_time(end) / 1e3, then))
            self._free_events.append((start, end))
        return out

    def _account_resolved(self, ready: List[Tuple[str, str, float, Any]]) -> None:
        for seam, cls, seconds, then in ready:
            self._account(seam, cls, seconds)
            if then is not None:
                then(seconds)

    def flush(self) -> None:
        """Wait for every pending event pair and account it (done by each read of the ledger).

        The wait runs outside the lock, so a thread recording its steps
        meanwhile never waits for the card behind a reader.
        """
        with self._lock:
            ends = [pair[3] for pair in self._pending]
        for end in ends:
            end.synchronize()
        with self._lock:
            ready = self._take_resolved()
        self._account_resolved(ready)

    # ------------------------------------------------------------------ steps
    def record_step(self, seam: str, cls: str, seconds: float) -> None:
        """Account one measured step: bucket seconds/flops/bytes + anomaly check.

        The caller guards with ``OBS.profiling`` (one slot branch); the
        ledger itself is unconditional so tools can drive it directly.
        """
        self._account(seam, cls, seconds)

    def _account(self, seam: str, cls: str, seconds: float) -> None:
        seconds = float(seconds)
        if seconds < 0.0:
            return
        trigger: Optional[Tuple[float, float]] = None
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_buckets,_baselines,_costs")
            bucket = self._buckets.get((seam, cls))
            if bucket is None:
                bucket = self._buckets[(seam, cls)] = {
                    "device_seconds": 0.0,
                    "flops": 0.0,
                    "bytes_accessed": 0.0,
                    "steps": 0.0,
                    "unattributed_steps": 0.0,
                }
            bucket["device_seconds"] += seconds
            bucket["steps"] += 1.0
            cost = None
            for kind in SEAM_KINDS.get(seam, (seam,)):
                cost = self._costs.get((kind, cls))
                if cost is not None:
                    break
            if cost is not None:
                bucket["flops"] += cost.flops
                bucket["bytes_accessed"] += cost.bytes_accessed
            else:
                # wall time is still attributed to (seam, class); only the
                # flops/MFU view is blind for these steps — counted, not
                # silently folded in
                bucket["unattributed_steps"] += 1.0
            trigger = self._observe_baseline(seam, seconds)
        if trigger is not None:
            self._publish_regression(seam, cls, seconds, trigger)

    def _observe_baseline(  # concurrency: guarded-by _lock
        self, seam: str, seconds: float
    ) -> Optional[Tuple[float, float]]:
        """Update the seam baseline; return (baseline, threshold) on a trigger.

        Caller holds ``_lock``. The bus publish happens OUTSIDE the lock:
        subscribers run inline (the flight recorder assembles a whole dump)
        and must not serialize every other seam's accounting behind it.
        """
        base = self._baselines.get(seam)
        if base is None:
            base = self._baselines[seam] = _Baseline()
        if base.n < self.warmup:
            base.n += 1
            if base.n == 1:
                base.ewma = seconds
                base.ewmad = 0.0
            else:
                dev = abs(seconds - base.ewma)
                base.ewmad += self.alpha * (dev - base.ewmad)
                base.ewma += self.alpha * (seconds - base.ewma)
            return None
        threshold = base.ewma + max(
            self.k_mad * 1.4826 * base.ewmad, self.rel_floor * base.ewma, 1e-9
        )
        if seconds > threshold:
            base.high_run += 1
            # baseline deliberately NOT updated: a sustained regression must
            # not raise its own threshold while we are counting it
            if base.high_run >= self.sustain:
                base.high_run = 0
                now = time.monotonic()
                if now >= base.cooldown_until:
                    base.cooldown_until = now + self.cooldown_seconds
                    base.triggered += 1
                    return base.ewma, threshold
            return None
        base.high_run = 0
        dev = abs(seconds - base.ewma)
        base.ewmad += self.alpha * (dev - base.ewmad)
        base.ewma += self.alpha * (seconds - base.ewma)
        return None

    def _publish_regression(
        self, seam: str, cls: str, seconds: float, trigger: Tuple[float, float]
    ) -> None:
        baseline, threshold = trigger
        BUS.publish(
            "perf_regression",
            cls,
            f"{seam} sustained {self.sustain} steps over the rolling baseline:"
            f" observed {seconds * 1e3:.3f}ms vs baseline {baseline * 1e3:.3f}ms"
            f" (threshold {threshold * 1e3:.3f}ms)",
            data={
                "seam": seam,
                "class": cls,
                "observed_seconds": seconds,
                "baseline_seconds": baseline,
                "threshold_seconds": threshold,
                "trace_id": current_trace_id(),
            },
        )

    # --------------------------------------------------------------- reporting
    def gauges(self) -> Dict[str, Dict[str, float]]:
        """Live gauge values per ``(seam, class)`` flat key (export surface)."""
        self.flush()
        ceilings = get_ceilings()
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_buckets,_costs")
            items = [(k, dict(v)) for k, v in self._buckets.items()]
            costs = dict(self._costs)
        for (seam, cls), bucket in items:
            entry = {
                "device_seconds": bucket["device_seconds"],
                "flops": bucket["flops"],
                "bytes_accessed": bucket["bytes_accessed"],
                "steps": bucket["steps"],
                "unattributed_steps": bucket["unattributed_steps"],
            }
            if bucket["flops"] > 0 and bucket["device_seconds"] > 0:
                entry["mfu"] = bucket["flops"] / (bucket["device_seconds"] * ceilings.peak_flops)
            cost = None
            for kind in SEAM_KINDS.get(seam, (seam,)):
                cost = costs.get((kind, cls))
                if cost is not None:
                    break
            if cost is not None:
                entry["roofline_ceiling"] = cost.roofline_ceiling(ceilings)
            out[f"{seam}|{cls}"] = entry
        return out

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able ledger state (riding registry exports + flight dumps)."""
        self.flush()
        ceilings = get_ceilings()
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_buckets,_executables,_baselines")
            buckets = [(seam, cls, dict(b)) for (seam, cls), b in self._buckets.items()]
            executables = {k: dict(v) for k, v in self._executables.items()}
            baselines = {
                seam: {
                    "ewma_seconds": b.ewma,
                    "mad_proxy_seconds": b.ewmad,
                    "samples": b.n,
                    "triggered": b.triggered,
                }
                for seam, b in self._baselines.items()
            }
        seams: List[Dict[str, Any]] = []
        for seam, cls, bucket in sorted(buckets):
            row: Dict[str, Any] = {"seam": seam, "class": cls, **bucket}
            if bucket["flops"] > 0 and bucket["device_seconds"] > 0:
                row["mfu"] = bucket["flops"] / (bucket["device_seconds"] * ceilings.peak_flops)
                if bucket["bytes_accessed"] > 0:
                    cost = ExecutableCost(
                        flops=bucket["flops"], bytes_accessed=bucket["bytes_accessed"]
                    )
                    row["roofline_ceiling"] = cost.roofline_ceiling(ceilings)
            seams.append(row)
        return {
            "enabled": bool(OBS.profiling),
            "ceilings": ceilings.to_json(),
            "seams": seams,
            "executables": {k: executables[k] for k in sorted(executables)},
            "baselines": baselines,
            "regressions": {s: b["triggered"] for s, b in baselines.items() if b["triggered"]},
        }

    def total_device_seconds(self) -> float:
        self.flush()
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_buckets")
            return sum(b["device_seconds"] for b in self._buckets.values())

    def reset(self) -> None:
        """Drop all accumulated state, pending event pairs included (tests, tools)."""
        with self._lock:
            self._costs.clear()
            self._executables.clear()
            self._buckets.clear()
            self._baselines.clear()
            self._pending.clear()


LEDGER = CostLedger()


def get_ledger() -> CostLedger:
    return LEDGER


def reset_ledger() -> None:
    LEDGER.reset()
