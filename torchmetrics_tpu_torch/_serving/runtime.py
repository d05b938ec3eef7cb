"""The metrics-as-a-service ingestion runtime.

Port of ``torchmetrics_tpu/_serving/runtime.py``. :class:`MetricServer` is
the long-running process that *connects* the production ingredients — the
vmapped multi-tenant :class:`~torchmetrics_tpu_torch._streams.StreamPool`,
the stream-sharded snapshot journal, ``warm_start``, burn-rate SLOs, and the
flight recorder — into one serving loop:

- **Ingest.** Client threads :meth:`submit` one stream's batch (numpy
  arrays, lists or tensors) and get an
  :class:`~torchmetrics_tpu_torch._serving.requests.Ack` handle; a single
  ingest worker drains the bounded queue, stacks same-signature requests
  (one row per distinct stream — the pool's masked scatter applies one row
  per slot per step) into a micro-batch on the host, pads it to the nearest
  power-of-two bucket (so batch sizing never mints a novel step key), and
  dispatches ONE vmapped pool step: on the card the replay of the bucket's
  CUDA graph. Acks resolve after the step is enqueued — by then the pool's
  snapshot hook has already journaled the batch, so *acked means durable*.
- **Serve.** :meth:`compute` / :meth:`compute_all` reads and Prometheus
  :meth:`scrape` run concurrently with ingest. One pool lock serializes
  every touch of the card by the server: the worker's host copies of tensor
  arguments, its uploads and steps (a bucket's first step captures a CUDA
  graph, and a capture must see no CUDA call from another thread), and the
  clients' reads. :meth:`scrape` and :meth:`health` read host counters only.
- **Close the loop.** After every micro-batch the worker offers the
  :class:`~torchmetrics_tpu_torch._serving.controller.BatchController` a
  decision; its burn-rate verdict resizes the next drain and flips load
  shedding at the ingress edge. Nothing else in the loop looks at latency
  — the SLO layer is the single source of "too slow".
- **Warm boot.** :meth:`warm` builds every bucket size's step before the
  first request (on the card, its warm-up run and its capture), so
  first-request latency is steady-state latency.
- **Absorb faults.** :meth:`simulate_preemption` / :meth:`recover` model
  the kill/restore cycle the chaos-under-load suite drives: recovery
  rebuilds the pool from the journal chain (its graphs are captured again
  at each bucket's next step), requeues the carried requests, and resumes —
  acknowledged rows are never lost, unacknowledged ones are retried
  (at-least-once below the ack, exactly-once above it).

The ingest worker is a thread the server starts; it runs under the pool's
card (a new thread's current CUDA device is 0), as the guarded collectives'
workers run under their caller's (``_resilience/guard.py``).

Kill switches: ``queue_capacity`` bounds ingress memory; the controller's
``max_batch`` bounds device step size; ``StreamPool`` admission control
(``TM_TPU_MEM_CEILING``) bounds tenant count; :meth:`stop` drains or
abandons cleanly (worker joined, journal closed).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch._analysis.locksan import SAN as _SAN
from torchmetrics_tpu_torch._analysis.locksan import check_access as _san_check
from torchmetrics_tpu_torch._analysis.locksan import new_lock as _san_lock
from torchmetrics_tpu_torch._observability.slo import HealthReport
from torchmetrics_tpu_torch._observability.slo import health_report as _health_report
from torchmetrics_tpu_torch._observability.state import OBS as _OBS
from torchmetrics_tpu_torch._observability.telemetry import REGISTRY as _REGISTRY
from torchmetrics_tpu_torch._observability.telemetry import telemetry_for as _telemetry_for
from torchmetrics_tpu_torch._serving.controller import BatchController, ControllerConfig
from torchmetrics_tpu_torch._serving.queue import IngressQueue
from torchmetrics_tpu_torch._serving.requests import (
    Ack,
    BackpressureError,
    ServerClosedError,
    UpdateRequest,
)
from torchmetrics_tpu_torch._streams.pool import StreamPool
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = ["MetricServer"]

# worker block on an empty queue before re-checking the stop flag
_DRAIN_TIMEOUT_S = 0.02


def _bucket_of(n: int, max_batch: int) -> int:
    """Smallest power-of-two >= n, capped at ``max_batch``."""
    b = 1
    while b < n and b < max_batch:
        b <<= 1
    return min(b, max_batch)


def _host(a: Any) -> np.ndarray:
    """One request argument as a host array (a tensor on the card is copied off it)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _shape_dtype(a: Any) -> Tuple[Tuple[int, ...], str]:
    """Shape and dtype name of an array argument, read without a copy (numpy's names: a tensor's match)."""
    if isinstance(a, torch.Tensor):
        return tuple(a.shape), str(a.dtype).replace("torch.", "")
    arr = np.asarray(a)
    return arr.shape, str(arr.dtype)


def _signature_of(req: UpdateRequest) -> Tuple[Any, ...]:
    """Stacking-compatibility key: array shapes/dtypes + static kwargs (touches no card)."""
    parts: List[Any] = [_shape_dtype(a) for a in req.args]
    kw: List[Any] = []
    for k in sorted(req.kwargs):
        v = req.kwargs[k]
        if hasattr(v, "shape") or isinstance(v, (list, np.ndarray)):
            kw.append((k, *_shape_dtype(v)))
        else:
            kw.append((k, repr(v)))
    return (tuple(parts), tuple(kw))


class MetricServer:
    """Long-running ingestion runtime over one :class:`StreamPool` template."""

    def __init__(
        self,
        template: Any,
        *,
        capacity: int = 64,
        queue_capacity: int = 1024,
        controller: Optional[ControllerConfig] = None,
        snapshot_dir: Optional[Any] = None,
        snapshot_policy: Optional[Any] = None,
        enforce_manifest: bool = True,
    ) -> None:
        self._template = template
        self._pool_kwargs = {"capacity": capacity, "enforce_manifest": enforce_manifest}
        self._pool = StreamPool(template, **self._pool_kwargs)
        self._snapshot_dir = snapshot_dir
        self._snapshot_policy = snapshot_policy
        self._mgr: Optional[Any] = None
        self._queue = IngressQueue(queue_capacity)
        self._controller = BatchController(controller)
        self._pool_lock = _san_lock("MetricServer._pool_lock")
        self._stop_flag = threading.Event()
        self._drain_on_stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._closed = False
        # requests pulled off the queue but not yet batchable (stream-id
        # collision within one micro-batch); survives worker restarts so
        # per-stream FIFO order holds across preemption recovery
        self._carry: List[UpdateRequest] = []
        self._warm_outcomes: Dict[str, str] = {}
        # example batch captured by warm() (tuples: immutable, shared freely)
        self._warm_rows: Tuple[Any, ...] = ()
        self._warm_kw_items: Tuple[Any, ...] = ()
        # test/chaos hook: injected seconds of extra latency per micro-batch
        # (how the closed-loop and chaos tests force a latency burn)
        self._step_delay_s = 0.0
        self.batches = 0
        self.rows_applied = 0
        self.recoveries = 0

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "MetricServer":
        """Bind durability (if configured) and spawn the ingest worker."""
        if self._closed:
            raise ServerClosedError("server is closed")
        if self._running:
            return self
        if self._snapshot_dir is not None and self._mgr is None:
            from torchmetrics_tpu_torch._streams.durability import StreamSnapshotManager

            self._mgr = (
                StreamSnapshotManager(self._pool, self._snapshot_dir, self._snapshot_policy)
                if self._snapshot_policy is not None
                else StreamSnapshotManager(self._pool, self._snapshot_dir)
            )
        self._stop_flag.clear()
        self._drain_on_stop.clear()
        self._thread = threading.Thread(
            target=self._worker_loop, name="tm-serving-ingest", daemon=False
        )
        self._thread.start()
        self._running = True
        self._prime_worker()
        return self

    def _prime_worker(self) -> None:
        """Push one real scratch-stream request through the fresh worker.

        Thread bootstrap and the loop's first-iteration interpreter costs
        land on this probe instead of the first client request — the last
        piece of the warm-boot contract (``warm()`` covers the steps
        and the host-side telemetry/SLO plumbing; this covers the worker).
        """
        if not self._warm_rows:
            return
        try:
            with self._pool_lock:
                if len(self._pool.active_streams) >= self._pool.capacity:
                    return  # the probe must never force pool growth
                scratch = self._pool.attach()
            probe = UpdateRequest(scratch, self._warm_rows, dict(self._warm_kw_items))
            self._queue.requeue(probe)  # bypasses admission: internal traffic
            probe.ack.wait(timeout=30.0)
            with self._pool_lock:
                self._pool.detach(scratch)
        except Exception:
            return  # a failed probe must never block startup

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Quiesce the worker (drain the queue first unless ``drain=False``)."""
        if not self._running:
            return
        if drain:
            self._drain_on_stop.set()
        self._stop_flag.set()
        self._queue.wake()
        if self._thread is not None:
            self._thread.join(timeout)
        self._thread = None
        self._running = False

    def close(self, drain: bool = True) -> None:
        """Stop serving and release the journal; idempotent."""
        if self._closed:
            return
        self.stop(drain=drain)
        if self._mgr is not None:
            self._mgr.close()
            self._mgr = None
        self._closed = True

    def __enter__(self) -> "MetricServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # --------------------------------------------------------------- tenants
    def attach_stream(self) -> int:
        """Admit one tenant (raises ``StreamPoolAdmissionError`` past the
        memory ceiling — the pool's admission control IS the serving one)."""
        with self._pool_lock:
            return self._pool.attach()

    def detach_stream(self, stream_id: int) -> None:
        with self._pool_lock:
            self._pool.detach(stream_id)

    # ------------------------------------------------------------- warm boot
    def warm(self, *example_args: Any, **example_kwargs: Any) -> Dict[str, str]:
        """Build every bucket size's step before serving.

        ``example_args`` is ONE stream's batch shaped exactly like real
        traffic. Each power-of-two bucket up to the controller's
        ``max_batch`` warms its own ``stream_step`` key (distinct leading
        axis = distinct step). The pool's ``warm_start`` runs the step once
        with every row masked as padding (id -1), so the example lands in the
        scratch row only and no stream changes; on the card that run is the
        warm-up before the bucket's CUDA graph is captured, and the bucket's
        first real micro-batch replays. (The JAX package follows its
        ``warm_start``, which compiles without running, with an all-masked
        ``update``: that run is already this one.) Returns
        ``{"<bucket>:<kind>": outcome}``, where an outcome is the pool's:
        ``"compiled"`` (built now), ``"hit"`` (built now on a verified AOT
        cache record, with every kernel library it names loaded without
        ``nvcc``) or ``"ready"``.
        """
        cfg = self._controller.config
        buckets: List[int] = []
        b = 1
        while b < cfg.max_batch:
            buckets.append(b)
            b <<= 1
        buckets.append(cfg.max_batch)
        # a tensor on the card is copied off it before the lock, so no thread waits behind the copy
        rows = [_host(a) for a in example_args]
        with self._pool_lock:
            if _SAN.enabled:
                _san_check(self, "_warm_outcomes")
            self._warm_rows = tuple(rows)
            self._warm_kw_items = tuple(sorted(example_kwargs.items()))
            actives = self._pool.active_streams
            scratch = None if actives else self._pool.attach()
            sid = actives[0] if actives else scratch
            try:
                for bucket in buckets:
                    ids = np.full(bucket, -1, dtype=np.int32)
                    ids[0] = sid
                    stacked = [
                        np.broadcast_to(r, (bucket,) + r.shape).copy() for r in rows
                    ]
                    outcomes = self._pool.warm_start(ids, *stacked, **example_kwargs)
                    for kind, outcome in outcomes.items():
                        self._warm_outcomes[f"{bucket}:{kind}"] = outcome
            finally:
                if scratch is not None:
                    self._pool.detach(scratch)
            result = dict(self._warm_outcomes)
        # prime the host side of the ack path too (outside the pool lock):
        # the first dispatch otherwise pays telemetry registration, reservoir
        # allocation, and the first SLO health report — one-off latency the
        # first request would wear
        if _OBS.enabled:
            _telemetry_for(self).observe("ingest", 0.0)
        self._controller.maybe_decide(self._queue.depth, source="MetricServer.warm")
        return result

    @property
    def warm_outcomes(self) -> Dict[str, str]:
        with self._pool_lock:
            if _SAN.enabled:
                _san_check(self, "_warm_outcomes")
            return dict(self._warm_outcomes)

    # ---------------------------------------------------------------- ingest
    def submit(self, stream_id: int, *args: Any, **kwargs: Any) -> Ack:
        """Enqueue one stream's batch; returns its ack handle.

        Raises :class:`BackpressureError` (with ``retry_after_s``) when the
        queue is full or shedding, :class:`ServerClosedError` when the
        server is not accepting traffic.
        """
        if self._closed or not self._running:
            raise ServerClosedError("server is not accepting requests (not started or closed)")
        if not args:
            raise TorchMetricsUserError("`submit` needs at least one array argument")
        req = UpdateRequest(stream_id, args, kwargs)
        try:
            self._queue.put(req)
        except BackpressureError as err:
            if _OBS.enabled:
                _telemetry_for(self).inc(
                    f"serving_requests|outcome={'shed' if err.kind == 'shed' else 'rejected'}"
                )
            raise
        if _OBS.enabled:
            _telemetry_for(self).inc("serving_requests|outcome=accepted")
        return req.ack

    # ----------------------------------------------------------------- serve
    def compute(self, stream_id: int) -> Any:
        """One tenant's current value (runs concurrently with ingest)."""
        if self._closed:
            raise ServerClosedError("server is closed")
        t0 = time.perf_counter()
        with self._pool_lock:
            value = self._pool.compute(stream_id)
        if _OBS.enabled:
            telem = _telemetry_for(self)
            telem.observe("serve_compute", time.perf_counter() - t0)
            telem.inc("serving_requests|outcome=served")
        return value

    def compute_all(self) -> Dict[int, Any]:
        if self._closed:
            raise ServerClosedError("server is closed")
        t0 = time.perf_counter()
        with self._pool_lock:
            values = self._pool.compute_all()
        if _OBS.enabled:
            _telemetry_for(self).observe("serve_compute", time.perf_counter() - t0)
        return values

    def scrape(self) -> str:
        """Prometheus exposition of the process-wide registry."""
        return _REGISTRY.render_prometheus()

    def health(self) -> HealthReport:
        """Readiness snapshot from the process-wide SLO tracker."""
        return _health_report()

    # --------------------------------------------------------------- queries
    @property
    def running(self) -> bool:
        return self._running

    @property
    def pool(self) -> StreamPool:
        return self._pool

    @property
    def device(self) -> torch.device:
        """The card (or CPU) of the template, where the pool's states live."""
        return self._pool.device

    @property
    def queue(self) -> IngressQueue:
        return self._queue

    @property
    def controller(self) -> BatchController:
        return self._controller

    @property
    def snapshot_manager(self) -> Optional[Any]:
        return self._mgr

    def set_step_delay(self, seconds: float) -> None:
        """Chaos/test hook: add ``seconds`` of latency to every micro-batch."""
        self._step_delay_s = max(0.0, float(seconds))

    # ---------------------------------------------------------- chaos surface
    def simulate_preemption(self) -> None:
        """Kill the worker and the journal fd mid-flight (chaos preemption).

        Queued and carried requests survive in memory (their clients hold
        pending acks); :meth:`recover` replays the journal into a fresh
        pool and resumes them. Acked rows are already journaled — the
        restore replays them, losing nothing.
        """
        self.stop(drain=False)
        if self._mgr is not None:
            self._mgr.simulate_preemption()
            self._mgr = None

    def recover(self) -> Tuple[Any, float]:
        """Rebuild the pool from the journal chain and resume serving.

        Returns ``(RestoreReport, recovery_ms)`` — recovery covers rebuild
        + restore + worker restart. The rebuilt pool captures each bucket's
        graph again at that bucket's first micro-batch after the recovery.
        """
        if self._snapshot_dir is None:
            raise TorchMetricsUserError("recover() needs a snapshot_dir-configured server")
        from torchmetrics_tpu_torch._streams.durability import StreamSnapshotManager

        t0 = time.perf_counter()
        with self._pool_lock:
            self._pool = StreamPool(self._template, **self._pool_kwargs)
            self._mgr = (
                StreamSnapshotManager(self._pool, self._snapshot_dir, self._snapshot_policy)
                if self._snapshot_policy is not None
                else StreamSnapshotManager(self._pool, self._snapshot_dir)
            )
            report = self._mgr.restore_latest()
            self.recoveries += 1
        self.start()
        elapsed_ms = (time.perf_counter() - t0) * 1000.0
        if _OBS.enabled:
            _telemetry_for(self).inc("serving_recoveries")
        return report, elapsed_ms

    # ------------------------------------------------------------ the worker
    def _on_pool_device(self) -> Any:
        """The pool's card as the worker thread's current device (a new thread's is 0)."""
        device = self._pool.device
        return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()

    def _worker_loop(self) -> None:
        with self._on_pool_device():
            self._drain_loop()

    def _drain_loop(self) -> None:
        while True:
            if self._stop_flag.is_set():
                if not self._drain_on_stop.is_set():
                    return
                # drain mode: exit only once carry + queue are empty
                with self._pool_lock:
                    carried = len(self._carry)
                if carried == 0 and self._queue.depth == 0:
                    return
            batch, sig = self._assemble_batch()
            if not batch:
                # idle tick: the loop must keep evaluating with no traffic,
                # otherwise a shed episode entered just before the queue
                # drained could never exit (no dispatch -> no decision)
                self._tick_controller()
                continue
            self._dispatch(batch, sig)

    def _assemble_batch(self) -> Tuple[List[UpdateRequest], Optional[Tuple[Any, ...]]]:
        """Up to ``target`` same-signature requests with distinct streams.

        Carried requests (prior collisions) go first — per-stream FIFO order
        is the replay contract. The first request fixes the batch signature;
        a same-stream or different-signature request goes (back) to carry.
        """
        target = self._controller.target
        batch: List[UpdateRequest] = []
        streams: set = set()
        sig: Optional[Tuple[Any, ...]] = None
        recarry: List[UpdateRequest] = []
        with self._pool_lock:
            if _SAN.enabled:
                _san_check(self, "_carry")
            carried, self._carry = self._carry, []
        for req in carried:
            if len(batch) < target and req.stream_id not in streams:
                req_sig = _signature_of(req)
                if sig is None or req_sig == sig:
                    sig = req_sig
                    batch.append(req)
                    streams.add(req.stream_id)
                    continue
            recarry.append(req)
        # block for the first queue item only when nothing is carried —
        # otherwise a quiet queue would stall already-accepted requests
        block = not batch and not recarry
        while len(batch) < target:
            req = self._queue.get(timeout=_DRAIN_TIMEOUT_S if block else None)
            block = False
            if req is None:
                break
            if req.stream_id in streams:
                recarry.append(req)
                continue
            req_sig = _signature_of(req)
            if sig is not None and req_sig != sig:
                recarry.append(req)
                continue
            sig = req_sig
            batch.append(req)
            streams.add(req.stream_id)
        if recarry:
            with self._pool_lock:
                self._carry.extend(recarry)
        return batch, sig

    def _dispatch(self, batch: List[UpdateRequest], sig: Optional[Tuple[Any, ...]]) -> None:
        """Stack on the host, pad to the bucket, run ONE pool step, resolve the acks."""
        cfg = self._controller.config
        bucket = _bucket_of(len(batch), cfg.max_batch)
        ids = np.full(bucket, -1, dtype=np.int32)
        for i, req in enumerate(batch):
            ids[i] = req.stream_id
        n_args = len(batch[0].args)
        kwargs = dict(batch[0].kwargs)
        err: Optional[BaseException] = None
        elapsed = 0.0
        q_before: Dict[int, int] = {}
        q_after: Dict[int, int] = {}
        stacked: List[np.ndarray] = []
        try:
            # a tensor argument on the card is copied to the host here, before the lock
            for pos in range(n_args):
                rows = [_host(req.args[pos]) for req in batch]
                pad = [np.zeros_like(rows[0])] * (bucket - len(batch))
                stacked.append(np.stack(rows + pad, axis=0))
        except BaseException as caught:  # noqa: BLE001 - one bad batch must not kill the worker
            err = caught
        if err is None:
            with self._pool_lock:
                try:
                    for req in batch:
                        q_before[req.stream_id] = self._pool.quarantined_updates(req.stream_id)
                    t0 = time.perf_counter()
                    self._pool.update(ids, *stacked, **kwargs)
                    elapsed = time.perf_counter() - t0
                    for req in batch:
                        q_after[req.stream_id] = self._pool.quarantined_updates(req.stream_id)
                except BaseException as caught:  # noqa: BLE001 - one bad batch must not kill the worker
                    err = caught
        if self._step_delay_s > 0.0:
            time.sleep(self._step_delay_s)
            elapsed += self._step_delay_s
        now = time.monotonic()
        if err is not None:
            for req in batch:
                req.ack._resolve("failed", error=err)
            if _OBS.enabled:
                _telemetry_for(self).inc("serving_requests|outcome=failed", len(batch))
        else:
            with self._pool_lock:
                self.batches += 1
                self.rows_applied += len(batch)
            telem = _telemetry_for(self) if _OBS.enabled else None
            for req in batch:
                latency = now - req.enqueued_mono
                quarantined = q_after[req.stream_id] > q_before[req.stream_id]
                req.ack._resolve("acked", latency_s=latency, quarantined=quarantined)
                if telem is not None:
                    telem.observe("ingest", latency)
            if telem is not None:
                telem.inc("serving_batches")
                telem.inc("serving_batch_rows", len(batch))
        self._queue.note_drained(len(batch), max(elapsed, 1e-9))
        self._tick_controller()

    def _tick_controller(self) -> None:
        """Offer the controller a decision and apply it at the ingress edge."""
        decision = self._controller.maybe_decide(self._queue.depth, source="MetricServer")
        if decision is not None:
            changed = self._queue.set_shedding(decision.shed, source="MetricServer")
            if _OBS.enabled:
                telem = _telemetry_for(self)
                telem.set_gauge("serving_queue_depth", self._queue.depth)
                if changed and decision.shed:
                    telem.inc("serving_shed_episodes")
