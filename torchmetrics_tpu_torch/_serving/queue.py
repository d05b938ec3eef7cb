"""Bounded ingress queue with backpressure and load-shedding.

Port of ``torchmetrics_tpu/_serving/queue.py``. The admission edge of the serving runtime: every update request passes
through here before the ingest worker sees it. Three properties are
non-negotiable and enforced structurally:

- **Bounded.** The FIFO never exceeds ``capacity`` requests; an arrival
  beyond the bound is rejected *synchronously* with
  :class:`~torchmetrics_tpu_torch._serving.requests.BackpressureError` — queue
  memory is O(capacity), never O(arrival rate).
- **Retry-after from the live drain rate.** The worker reports every drain
  through :meth:`note_drained`; an EWMA of rows/second turns the current
  depth into an honest ``retry_after_s`` hint (``depth / drain_rate``),
  clamped to a sane band so a cold queue still answers.
- **Shedding is a controller decision, not a queue heuristic.** The SLO
  control loop flips :meth:`set_shedding` when the latency budget burns at
  page-now speed; while set, arrivals are rejected even below the bound —
  EXCEPT a single-in-flight canary (admitted when the queue is empty).
  Without the canary, shedding would be an absorbing state: no admissions
  → no acks → no fresh latency samples → the burn rate freezes at its
  page-now value and the loop can never observe recovery. Episode
  *transitions* (not every rejected request) publish ``load_shed`` bus
  events — a flight-recorder trigger kind — so dumps capture the decision
  without an event per arrival.

The FIFO itself is a :class:`queue.Queue` (its internal lock is the
synchronization for put/get); the lock here guards only the host-side
bookkeeping (depth, drain EWMA, shed flag, episode counters). It is a plain
``threading.Lock`` where the JAX package takes its lock sanitizer's.
"""

from __future__ import annotations

import queue as _pyqueue
import threading
from typing import Optional

from torchmetrics_tpu_torch._analysis.locksan import SAN as _SAN
from torchmetrics_tpu_torch._analysis.locksan import check_access as _san_check
from torchmetrics_tpu_torch._analysis.locksan import new_lock as _san_lock
from torchmetrics_tpu_torch._observability.events import BUS as _BUS
from torchmetrics_tpu_torch._serving.requests import BackpressureError, UpdateRequest

__all__ = ["IngressQueue"]

# retry-after clamp band: below, clients hammer; above, they give up
_MIN_RETRY_S = 0.005
_MAX_RETRY_S = 5.0

# EWMA half-life weight for the drain-rate estimate (per drain report)
_DRAIN_ALPHA = 0.3


class IngressQueue:  # concurrency: shared client threads put while the ingest worker drains
    """Bounded FIFO + admission bookkeeping for the ingest worker."""

    def __init__(self, capacity: int = 1024) -> None:
        if not (isinstance(capacity, int) and capacity >= 1):
            raise ValueError(f"`capacity` must be a positive int, got {capacity!r}")
        self.capacity = capacity
        self._q: "_pyqueue.Queue[Optional[UpdateRequest]]" = _pyqueue.Queue()
        self._lock = _san_lock("IngressQueue._lock")
        self._depth = 0  # live request count (Queue.qsize also counts sentinels)
        self._drain_rate = 0.0  # EWMA rows/second; 0.0 = no evidence yet
        self._shedding = False
        self._shed_episodes = 0
        self.accepted = 0
        self.rejected = 0
        self.shed = 0

    # ------------------------------------------------------------- admission
    def put(self, req: UpdateRequest) -> None:
        """Admit one request or raise :class:`BackpressureError`."""
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_depth,_shedding")
            if self._shedding and self._depth > 0:
                # canary admission: one in-flight probe keeps latency
                # samples flowing so the controller can observe recovery
                self.shed += 1
                retry = self._retry_after_locked()
                raise_shed = True
            elif self._depth >= self.capacity:
                self.rejected += 1
                retry = self._retry_after_locked()
                raise_shed = False
            else:
                self._depth += 1
                self.accepted += 1
                self._q.put(req)
                return
        if raise_shed:
            raise BackpressureError(
                f"load shedding active (episode {self._shed_episodes}): the latency SLO is"
                f" burning at page-now speed; retry in {retry:.3f}s",
                retry_after_s=retry,
                kind="shed",
            )
        raise BackpressureError(
            f"ingress queue full ({self.capacity} requests); retry in {retry:.3f}s",
            retry_after_s=retry,
            kind="full",
        )

    # concurrency: guarded-by _lock
    def _retry_after_locked(self) -> float:
        """Depth / drain-rate, clamped — the honest wait for a free slot."""
        if self._drain_rate <= 0.0:
            return _MAX_RETRY_S if self._depth >= self.capacity else _MIN_RETRY_S * 10
        est = max(1, self._depth) / self._drain_rate
        return min(_MAX_RETRY_S, max(_MIN_RETRY_S, est))

    # ----------------------------------------------------------- worker side
    def get(self, timeout: Optional[float] = None) -> Optional[UpdateRequest]:
        """Next request (FIFO), or None on timeout/wake sentinel."""
        try:
            req = self._q.get(timeout=timeout) if timeout is not None else self._q.get_nowait()
        except _pyqueue.Empty:
            return None
        if req is not None:
            with self._lock:
                self._depth -= 1
        return req

    def wake(self) -> None:
        """Unblock one blocked :meth:`get` (shutdown/preemption path)."""
        self._q.put(None)

    def requeue(self, req: UpdateRequest) -> None:
        """Return an undrained request to the FIFO (post-recovery replay).

        Bypasses admission: the request was already accepted once and its
        client holds a pending ack — rejecting it now would lose it.
        """
        with self._lock:
            self._depth += 1
            self._q.put(req)

    def note_drained(self, rows: int, elapsed_s: float) -> None:
        """Fold one drain observation into the rows/second EWMA."""
        if rows <= 0 or elapsed_s <= 0.0:
            return
        rate = rows / elapsed_s
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_drain_rate")
            self._drain_rate = (
                rate if self._drain_rate <= 0.0
                else (1.0 - _DRAIN_ALPHA) * self._drain_rate + _DRAIN_ALPHA * rate
            )

    # ------------------------------------------------------------ controller
    def set_shedding(self, flag: bool, source: str = "IngressQueue", detail: str = "") -> bool:
        """Enter/leave a shed episode; publishes on TRANSITIONS only.

        Returns True when the call changed state. The ``load_shed`` bus kind
        is a flight-recorder trigger: entering an episode freezes a dump
        with the decision's context (burn rate, queue depth) — one dump per
        episode, not per rejected arrival.
        """
        publish = None
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_shedding")
            if flag == self._shedding:
                return False
            self._shedding = flag
            if flag:
                self._shed_episodes += 1
            publish = (
                "enter" if flag else "exit",
                self._shed_episodes,
                self._depth,
            )
        phase, episode, depth = publish
        # entering is the fault (trigger kind -> one flight dump per
        # episode); leaving is the recovery — journaled, but no dump
        _BUS.publish(
            "load_shed" if phase == "enter" else "load_shed_recovered",
            source,
            detail or f"{phase} shed episode {episode} (queue depth {depth})",
            data={"seam": "serving.ingress", "phase": phase, "episode": episode, "depth": depth},
        )
        return True

    # --------------------------------------------------------------- queries
    @property
    def depth(self) -> int:
        return self._depth

    @property
    def shedding(self) -> bool:
        return self._shedding

    @property
    def drain_rate(self) -> float:
        return self._drain_rate

    @property
    def shed_episodes(self) -> int:
        return self._shed_episodes

    def retry_after(self) -> float:
        """The current retry hint (for probes; ``put`` computes its own)."""
        with self._lock:
            return self._retry_after_locked()
