"""Aggregation node: one vertex of the edge -> region -> global rollup tree.

Port of ``torchmetrics_tpu/_fleet/node.py``. An :class:`AggregationNode`
owns one metric *accumulator* (the cumulative rollup of everything it has
ever folded) and speaks two verbs:

- :meth:`AggregationNode.rollup`: sweep its children's contribution keys off
  the KV transport, fence out duplicates and zombies, quarantine corrupt
  payloads, and fold the survivors with the merge operator
  (``Metric.merge_state``). The fan-in wait is **deadline bounded**:
  children missing at the deadline are *degraded, not awaited*; the rollup
  completes partial, stamped with exactly the contributing ``(child,
  epoch)`` set, and a ``fleet_partial`` degradation event (which the flight
  recorder turns into a dump). A straggler's contribution is not lost: it
  folds into the *next* epoch's rollup as a late arrival.
- :meth:`AggregationNode.publish`: encode this node's *per-epoch delta*
  (everything folded since its last successful publish) as an
  integrity-checked wire contribution and push it to the parent's namespace
  under ``(node_id, epoch, state_digest)``, through ``run_guarded`` with the
  node's :class:`RetryPolicy`. Exhausted retries degrade: the delta is
  *retained* and rides along with the next epoch's publish, so a flaky
  transport costs staleness, never data.

Each ``(leaf, epoch)`` delta enters the global accumulator at most once (the
fold ledger drops at-least-once redeliveries and zombie replays), so the root
rollup equals a flat sequential ``merge_state`` fold of precisely the
contributions it names in ``Rollup.sources``.

Where the states live: every node's metrics are clones of its template, on
the template's device (a CUDA template gives CUDA nodes). ``clone()`` drops a
template's compiled steps and CUDA graphs (``Metric.__getstate__``) and
copies its states, so a template that has already updated is safe to use: its
clones start from a ``reset()`` with no graph of their own. A leaf's live
metric compiles its update as any metric does (a CUDA graph per signature on
the card); the publish merges it into the pending delta and resets it, which
keeps the graph: the next epoch's updates replay it.

Divergence by design from the JAX node: the send thread touches no tensor.
:meth:`publish_async` encodes on the caller's thread (the device-to-host copy
of the states, the pickle and the checksum) and hands the send thread only
the key, the bytes and the provenance. When its retries are exhausted, the
thread hands the bytes back under ``_pub_lock`` instead of merging the
outbound delta into the pending one itself (the JAX ``_send``, ``node.py:456``,
merges on the send thread): a CUDA call from another thread while a leaf
captures its update would invalidate the capture. The node's thread decodes the
returned bytes and merges them at its next :meth:`publish` /
:meth:`publish_async` or :meth:`join_pending`; a synchronous :meth:`publish`
merges at once. The states round-trip the host exactly, so the fold is the
JAX node's.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from torchmetrics_tpu_torch._analysis.locksan import new_lock as _san_lock
from torchmetrics_tpu_torch._fleet.observe import RegionLabeler
from torchmetrics_tpu_torch._fleet.transport import contribution_key, contribution_prefix
from torchmetrics_tpu_torch._fleet.wire import (
    Contribution,
    CorruptContribution,
    decode_contribution,
    encode_contribution,
)
from torchmetrics_tpu_torch._observability import tracing as _obs_trace
from torchmetrics_tpu_torch._observability.state import OBS as _OBS
from torchmetrics_tpu_torch._observability.telemetry import telemetry_for as _telemetry_for
from torchmetrics_tpu_torch._resilience.guard import SyncRetriesExhausted, run_guarded
from torchmetrics_tpu_torch._resilience.policy import RetryPolicy
from torchmetrics_tpu_torch.utilities.distributed import kv_key as _kv_key

__all__ = ["AggregationNode", "Rollup"]

# one shared default: fleet regions are bounded to top-K label slots
_DEFAULT_LABELER = RegionLabeler()

# what the send thread gets: (key, blob, epoch, leaf provenance); bytes and strings only
_Prepared = Tuple[str, bytes, int, Set[Tuple[str, int]]]


@dataclass(frozen=True)
class Rollup:
    """The receipt one :meth:`AggregationNode.rollup` call returns.

    ``contributing`` names exactly the ``(child, epoch)`` contributions
    folded THIS call (late arrivals from earlier epochs included);
    ``sources`` is their union of leaf-level provenance. ``partial`` is True
    iff at least one expected child missed the fan-in deadline.
    """

    node_id: str
    epoch: int
    contributing: Tuple[Tuple[str, int], ...]
    missing: Tuple[str, ...]
    sources: Tuple[Tuple[str, int], ...]
    partial: bool
    late_arrivals: int
    duplicates_dropped: int
    corrupt_quarantined: int
    staleness_ms: float
    latency_ms: float
    rows_folded: int = 0
    details: Tuple[str, ...] = field(default=())

    def describe(self) -> str:
        state = "partial" if self.partial else "full"
        return (
            f"rollup[{self.node_id} epoch={self.epoch} {state}] "
            f"folded={len(self.contributing)} missing={len(self.missing)} "
            f"late={self.late_arrivals} dup={self.duplicates_dropped} "
            f"corrupt={self.corrupt_quarantined} staleness={self.staleness_ms:.1f}ms"
        )


class AggregationNode:
    """One vertex of the fleet aggregation tree (leaf, region, or root).

    A leaf has no ``children``: its ``metric`` is the live edge metric the
    application updates, and :meth:`publish` ships the accumulated delta. An
    interior node's ``metric`` is the cumulative rollup of its subtree;
    :meth:`rollup` folds children, :meth:`publish` forwards the per-epoch
    delta upward. The root simply never publishes.

    Every node object is owned by exactly one thread, which is the
    only thread that touches its metrics; cross-node concurrency happens
    only through the (internally synchronized) KV transport and the send
    threads, which carry bytes.
    """

    def __init__(
        self,
        node_id: str,
        template: Any,
        kv: Any,
        *,
        children: Sequence[str] = (),
        namespace: str = "default",
        region: Optional[str] = None,
        deadline_s: float = 2.0,
        retry: Optional[RetryPolicy] = None,
        epoch_window: int = 4,
        labeler: Optional[RegionLabeler] = None,
        sources_cap: int = 65536,
    ) -> None:
        if epoch_window < 1:
            raise ValueError(f"epoch_window must be >= 1, got {epoch_window}")
        self.node_id = str(node_id)
        self.children: Tuple[str, ...] = tuple(str(c) for c in children)
        self.kv = kv
        self.namespace = str(namespace)
        self.region = str(region) if region is not None else self.node_id
        self.deadline_s = float(deadline_s)
        self.retry = retry if retry is not None else RetryPolicy(max_retries=2, backoff_base=0.05, backoff_max=1.0)
        self.epoch_window = int(epoch_window)
        self._labeler = labeler if labeler is not None else _DEFAULT_LABELER
        # cumulative accumulator: everything this subtree ever folded
        self.metric = template.clone()
        self.metric.reset()
        self._template = template.clone()
        self._template.reset()
        # delta pending upward publish (owned by the node's thread). A publish SWAPS it out
        # and encodes it on the node's thread; a send whose retries are exhausted
        # hands its bytes back, and the node's thread merges them into the pending
        # delta before its next publish, so concurrent in-flight publishes
        # carry disjoint data and can never double-count a row upstream.
        self._pending_delta = self._fresh_delta(template)
        self._pending_sources: Set[Tuple[str, int]] = set()
        self._pending_epochs: Set[int] = set()  # leaf provenance between publishes
        # concurrency: _returned, publish_failures, _send_threads, _pending_*, _ledger
        # guarded-by _pub_lock (send threads hand back failed bytes while the node's
        # thread settles; the node's thread keeps its pending sets under it too)
        self._pub_lock = _san_lock("AggregationNode._pub_lock")
        self._returned: List[Tuple[bytes, Set[Tuple[str, int]]]] = []
        # epoch fence: (child, epoch) -> digest of the contribution folded.
        # Pruned below the watermark; anything at/below the watermark is a
        # zombie by definition (its epoch already aged out of the window).
        self._ledger: Dict[Tuple[str, int], str] = {}
        self._watermark = -1
        # full leaf provenance of the accumulator (golden-equality witness)
        self.folded_sources: Set[Tuple[str, int]] = set()
        self.sources_cap = int(sources_cap)
        self.sources_truncated = False
        self.last_rollup: Optional[Rollup] = None
        self.publish_failures = 0
        self._send_threads: List[threading.Thread] = []
        # the newest send thread, joined by join_pending beside the list (the lint's R9 sees a join
        # through a `self.<attr>.join`, as the JAX node keeps it)
        self._send_thread: Optional[threading.Thread] = None
        # per-fold scratch outputs read back by _rollup_inner
        self._last_fold_sources: Tuple[Tuple[str, int], ...] = ()
        self._last_fold_rows = 0
        self._last_fold_age_ms = 0.0

    def _fresh_delta(self, template: Optional[Any] = None) -> Any:
        delta = (template if template is not None else self._template).clone()
        delta.reset()
        return delta

    # ------------------------------------------------------------------ leaf
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Convenience passthrough for leaves: update the live edge metric."""
        self.metric.update(*args, **kwargs)

    # ---------------------------------------------------------------- rollup
    def rollup(self, epoch: int) -> Rollup:
        """Fold this epoch's child contributions; degrade stragglers at the deadline."""
        epoch = int(epoch)
        t0 = time.perf_counter()
        span = None
        if _OBS.enabled and _OBS.tracing:
            span = _obs_trace.begin_span("fleet.rollup", self.node_id, epoch=epoch)
        try:
            result = self._rollup_inner(epoch, t0)
        except BaseException as err:
            if span is not None:
                _obs_trace.end_span(span, err)
                span = None
            raise
        finally:
            if span is not None:
                _obs_trace.end_span(span)
        self.last_rollup = result
        return result

    def _rollup_inner(self, epoch: int, t0: float) -> Rollup:
        prefixes = {c: contribution_prefix(self.namespace, c, epoch) for c in self.children}
        # the fan-in deadline: wait until every child has >= 1 key for THIS
        # epoch, or the clock runs out (degrade signal, not an error)
        if prefixes:
            common = _kv_key("fleet", self.namespace, "contrib") + "/"
            self.kv.wait_until(
                lambda snap: all(any(k.startswith(p) for k in snap) for p in prefixes.values()),
                self.deadline_s,
                prefix=common,
            )

        contributing: List[Tuple[str, int]] = []
        sources: Set[Tuple[str, int]] = set()
        details: List[str] = []
        late = duplicates = corrupt = 0
        rows = 0
        max_age_ms = 0.0
        floor = max(0, self._watermark + 1, epoch - self.epoch_window + 1)
        for child in self.children:
            for e in range(floor, epoch + 1):
                items = self.kv.scan(contribution_prefix(self.namespace, child, e))
                for key in sorted(items):
                    outcome = self._fold_one(child, e, key, items[key], details)
                    if outcome == "folded":
                        contributing.append((child, e))
                        sources.update(self._last_fold_sources)
                        rows += self._last_fold_rows
                        max_age_ms = max(max_age_ms, self._last_fold_age_ms)
                        if e < epoch:
                            late += 1
                    elif outcome == "duplicate":
                        duplicates += 1
                    elif outcome == "corrupt":
                        corrupt += 1

        missing = tuple(c for c in self.children if all(cc != c for cc, _ in contributing))
        partial = bool(missing)
        latency_ms = (time.perf_counter() - t0) * 1000.0

        # advance the fence: epochs at/below the new watermark are closed; a
        # zombie replaying one is dropped before decode from now on
        self._watermark = max(self._watermark, epoch - self.epoch_window)
        with self._pub_lock:
            for fence_key in [k for k in self._ledger if k[1] <= self._watermark]:
                del self._ledger[fence_key]

        if partial:
            self.metric._record_degradation(
                "fleet_partial",
                detail=(
                    f"node {self.node_id} epoch {epoch}: fan-in deadline "
                    f"{self.deadline_s:.2f}s expired with {len(missing)}/"
                    f"{len(self.children)} children missing ({', '.join(missing)}); "
                    f"folded {len(contributing)} contribution(s)"
                ),
            )
        if _OBS.enabled:
            telem = _telemetry_for(self.metric)
            label = self._labeler.note(self.region)
            outcome = "partial" if partial else "full"
            telem.inc(f"fleet_rollups|region={label}|outcome={outcome}")
            if contributing:
                telem.inc(f"fleet_contributions|region={label}", len(contributing))
            if late:
                telem.inc(f"fleet_late_arrivals|region={label}", late)
            if duplicates:
                telem.inc(f"fleet_duplicates_dropped|region={label}", duplicates)
            if corrupt:
                telem.inc(f"fleet_corrupt_quarantined|region={label}", corrupt)
            telem.set_gauge(f"fleet_rollup_staleness_ms|region={label}", max_age_ms)

        return Rollup(
            node_id=self.node_id,
            epoch=epoch,
            contributing=tuple(contributing),
            missing=missing,
            sources=tuple(sorted(sources)),
            partial=partial,
            late_arrivals=late,
            duplicates_dropped=duplicates,
            corrupt_quarantined=corrupt,
            staleness_ms=max_age_ms,
            latency_ms=latency_ms,
            rows_folded=rows,
            details=tuple(details),
        )

    def _fold_one(self, child: str, epoch: int, key: str, blob: bytes, details: List[str]) -> str:
        """Fence, verify, and fold one contribution key. Returns the outcome."""
        fence = (child, epoch)
        if epoch <= self._watermark or fence in self._ledger:
            # at-least-once redelivery or zombie replay: exactly-once fold
            # means everything after the first accepted payload is dropped
            self.kv.delete(key)
            details.append(f"dropped duplicate {key} (epoch fence)")
            return "duplicate"
        try:
            contrib = decode_contribution(blob)
            if contrib.node != child or contrib.epoch != epoch:
                raise CorruptContribution(
                    f"key/payload fence mismatch: key says ({child}, {epoch}), "
                    f"payload says ({contrib.node}, {contrib.epoch})"
                )
            if contrib.metric_class != type(self._template).__name__:
                raise CorruptContribution(
                    f"metric class mismatch: expected {type(self._template).__name__}, got {contrib.metric_class}"
                )
            scratch = self._verified_scratch(contrib)
        except CorruptContribution as err:
            self.kv.delete(key)
            details.append(f"quarantined {key}: {err}")
            self.metric._record_degradation(
                "fleet_corrupt",
                detail=f"node {self.node_id} quarantined contribution {key}: {err}",
            )
            return "corrupt"
        # a zero-count contribution is a liveness heartbeat: it counts toward
        # fan-in completeness but carries no rows, so it must leave no
        # provenance, or idle epochs would pollute the golden-equality witness
        carried = contrib.count > 0
        self._last_fold_sources = contrib.sources if carried else ()
        self._last_fold_rows = contrib.count
        self._last_fold_age_ms = contrib.age_ms
        new_sources = set(contrib.sources) if carried else set()
        if carried:
            # fold into the cumulative accumulator, then into the pending
            # delta headed upward (merge_state does not mutate its argument,
            # so one scratch serves both)
            self.metric.merge_state(scratch)
            self._pending_delta.merge_state(scratch)
        with self._pub_lock:
            self._pending_sources.update(new_sources)
            self._ledger[fence] = contrib.digest
        if carried:
            if len(self.folded_sources) + len(new_sources) <= self.sources_cap:
                self.folded_sources.update(new_sources)
            else:
                self.sources_truncated = True
        self.kv.delete(key)  # folded: reap the key (and its TTL record)
        return "folded"

    def _verified_scratch(self, contrib: Contribution) -> Any:
        """Load a contribution into a scratch clone, quarantining on repair.

        ``strict="repair"`` is deliberately run on a *scratch* metric: if the
        integrity pass repairs anything, the payload was corrupt, and a
        silently-repaired (defaulted) state must quarantine the whole
        contribution instead of folding a wrong value into the rollup. The
        host states move to the scratch's device here.
        """
        scratch = self._template.clone()
        scratch.reset()
        scratch.__dict__["_resilience_events"] = []
        try:
            scratch.load_state_dict(dict(contrib.states), strict="repair")
        except Exception as err:  # noqa: BLE001 - any load failure is a quarantine
            raise CorruptContribution(f"state load failed: {type(err).__name__}: {err}") from err
        repaired = [
            ev for ev in scratch.__dict__.get("_resilience_events", ()) if getattr(ev, "kind", "") == "state_repair"
        ]
        if repaired:
            raise CorruptContribution(f"integrity repair fired during load: {repaired[0].detail}")
        scratch._update_count = contrib.count
        return scratch

    # --------------------------------------------------------------- publish
    def publish(self, epoch: int) -> bool:
        """Push this node's pending delta to the parent namespace; degrade on exhaustion.

        Returns True on success. On ``SyncRetriesExhausted`` the delta is
        merged back into the pending accumulator at once (it rides the next
        epoch's publish), a ``fleet_publish_degraded`` event is recorded, and
        False returns: a failed publish is a staleness event, not a
        correctness event.
        """
        ok = self._send(self._prepare_publish(epoch))
        self._settle_returned()
        return ok

    def publish_async(self, epoch: int) -> threading.Thread:
        """Like :meth:`publish`, but the (possibly stalling) wire send runs on a daemon thread.

        The delta swap-out and its encoding happen synchronously on the
        caller's thread, so the live metric is free for the next epoch's
        updates the moment this returns, and the send thread holds bytes
        only. A failed send's delta merges at the next publish or
        :meth:`join_pending` on this thread.
        """
        prepared = self._prepare_publish(epoch)
        self._send_thread = threading.Thread(
            target=self._send,
            args=(prepared,),
            name=f"fleet-publish-{self.node_id}-{prepared[2]}",
            daemon=True,
        )
        with self._pub_lock:
            self._send_threads.append(self._send_thread)
        self._send_thread.start()
        return self._send_thread

    def join_pending(self, timeout: Optional[float] = None) -> None:
        """Join outstanding async publish threads, then merge back what they failed to send."""
        with self._pub_lock:
            threads, self._send_threads = self._send_threads, []
        for t in threads:
            t.join(timeout)
        if self._send_thread is not None:
            self._send_thread.join(timeout)
            self._send_thread = None
        self._settle_returned()

    def _settle_returned(self) -> None:
        """Merge the deltas of exhausted sends back into the pending delta (the node's own thread only)."""
        with self._pub_lock:
            returned, self._returned = self._returned, []
        for blob, out_sources in returned:
            contrib = decode_contribution(blob)
            if contrib.count > 0:
                self._pending_delta.merge_state(self._verified_scratch(contrib))
            with self._pub_lock:
                self._pending_sources.update(out_sources)
                self._pending_epochs.update(e for n, e in out_sources if n == self.node_id)

    def _prepare_publish(self, epoch: int) -> _Prepared:
        """Swap the pending delta out and encode it for exclusive wire ownership."""
        epoch = int(epoch)
        self._settle_returned()
        if not self.children and self.metric._update_count > 0:
            # fold the live edge delta into the unACKed pending pile
            self._pending_delta.merge_state(self.metric)
            self.metric.reset()
        with self._pub_lock:
            if not self.children:
                self._pending_epochs.add(epoch)
                out_sources: Set[Tuple[str, int]] = {(self.node_id, e) for e in self._pending_epochs}
            else:
                out_sources = set(self._pending_sources)
            self._pending_sources.clear()
            self._pending_epochs.clear()
        outbound = self._pending_delta
        self._pending_delta = self._fresh_delta()
        blob, digest = encode_contribution(outbound, self.node_id, epoch, tuple(sorted(out_sources)))
        key = contribution_key(self.namespace, self.node_id, epoch, digest)
        return key, blob, epoch, out_sources

    def _send(self, prepared: _Prepared) -> bool:
        key, blob, epoch, out_sources = prepared
        telem = _telemetry_for(self.metric) if _OBS.enabled else None
        label = self._labeler.note(self.region) if telem is not None else ""

        def _attempt() -> None:
            if telem is not None:
                telem.inc(f"fleet_publish_attempts|region={label}")
            self.kv.set(key, blob)

        try:
            run_guarded(_attempt, self.retry, describe=f"fleet publish {self.node_id} epoch {epoch}")
        except SyncRetriesExhausted as err:
            # hand the unACKed bytes back: the node's thread merges them into the
            # pending delta, and they ride the next publish
            with self._pub_lock:
                self._returned.append((blob, set(out_sources)))
                self.publish_failures += 1
            self.metric._record_degradation(
                "fleet_publish_degraded",
                detail=(
                    f"node {self.node_id} epoch {epoch}: publish exhausted "
                    f"{err.attempts} attempt(s) ({err.last_error}); delta retained "
                    f"for next epoch"
                ),
                attempts=err.attempts,
            )
            return False
        return True

    # ------------------------------------------------------------- lifecycle
    def step(self, epoch: int, *, publish: bool = True) -> Optional[Rollup]:
        """One epoch tick: interior nodes roll up, then (non-root) publish."""
        result = self.rollup(epoch) if self.children else None
        if publish:
            self.publish(epoch)
        return result
