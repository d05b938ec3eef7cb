"""Guarded execution of eager multi-process collectives.

Port of ``torchmetrics_tpu/_resilience/guard.py``. The eager sync path
(``Metric.sync`` → ``gather_all_tensors`` → ``torch.distributed`` or
``process_allgather``) is the one seam of the runtime that can
*block forever*: a peer that died mid-step leaves every other process stuck
inside the collective. This module wraps that seam with

1. a **structure handshake** — one scalar all-gather of a digest over the
   metric's state tree (names, dtypes, shapes, reductions) so mismatched
   collectives fail fast with :class:`StateStructureMismatchError` instead of
   deadlocking on mismatched buffer counts;
2. a **watchdog** — each attempt runs on a persistent daemon worker thread
   and is abandoned after ``RetryPolicy.timeout`` seconds (a stuck worker is
   replaced; being a daemon it cannot block interpreter exit);
3. **retry with exponential backoff**, and on exhaustion **graceful
   degradation**: the metric keeps its local state, records a
   :class:`DegradationEvent`, and ``compute()`` proceeds local-only.

The gather phase is *pure* (``Metric._dist_gather`` reads state, mutates
nothing), so an abandoned timed-out attempt that eventually completes on its
orphaned worker can never corrupt the metric — results are committed on the
caller's thread only after a successful attempt.
"""

from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np

import torch

from torchmetrics_tpu_torch._analysis.locksan import new_lock as _san_lock
from torchmetrics_tpu_torch._observability import tracing as _obs_trace
from torchmetrics_tpu_torch._observability.state import OBS as _OBS
from torchmetrics_tpu_torch._observability.telemetry import telemetry_for as _telemetry_for
from torchmetrics_tpu_torch._resilience.errors import (
    CollectiveTimeoutError,
    StateStructureMismatchError,
    SyncRetriesExhausted,
)
from torchmetrics_tpu_torch._resilience.policy import RetryPolicy, SyncPolicy
from torchmetrics_tpu_torch.utilities import distributed as _dist
from torchmetrics_tpu_torch.utilities.ringbuffer import RingBuffer

__all__ = [
    "run_guarded",
    "state_structure_digest",
    "guarded_metric_sync",
    "handshake_at_trace",
]


# ---------------------------------------------------------------------------
# watchdog worker
# ---------------------------------------------------------------------------


class _Worker:
    """One persistent daemon thread executing guarded attempts.

    A fresh thread per attempt would cost ~100µs of spawn latency on every
    sync; a shared ``ThreadPoolExecutor`` would either queue new attempts
    behind a stuck worker or hang interpreter exit on its atexit join. This
    hand-rolled worker gives the cheap steady-state (one queue handoff per
    attempt) and the right failure mode: on timeout the whole worker is
    discarded — the stuck thread parks on its orphaned queue as a daemon —
    and the next attempt gets a new one.
    """

    def __init__(self) -> None:
        self._tasks: "queue.Queue[Tuple[Callable[[], Any], list, threading.Event]]" = queue.Queue()
        self.busy = False  # guarded by _worker_lock
        self._thread = threading.Thread(target=self._loop, name="tm-tpu-guarded-sync", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            # plain blocking pickup: hot-spinning here would burn scheduler
            # quota (containers throttle it, delaying the very wakeups the
            # guard exists to bound) for ~60µs of saved handoff latency
            fn, box, done = self._tasks.get()
            try:
                box.append((True, fn()))
            except BaseException as err:  # noqa: BLE001 - relayed to the caller
                box.append((False, err))
            done.set()

    def run(self, fn: Callable[[], Any], timeout: float) -> Any:
        box: list = []
        done = threading.Event()
        start = time.monotonic()
        self._tasks.put((fn, box, done))
        # spin-assist: a blocking futex wait costs ~100µs of wakeup latency
        # per sync, which would dominate the guard's overhead on fast
        # (in-process / simulated) transports. Yield-spin briefly — trivial
        # gathers complete inside the window — then block. The window is
        # deliberately short: a longer yield-spin GIL-starves the worker
        # (CPython's GIL hand-off is not FIFO), *adding* latency to real
        # transports instead of hiding it.
        spin_until = start + min(0.0002, timeout)
        while not box and time.monotonic() < spin_until:
            time.sleep(0)
        if not box and not done.is_set():
            remaining = timeout - (time.monotonic() - start)
            if remaining <= 0 or not done.wait(remaining):
                raise CollectiveTimeoutError(
                    f"guarded collective did not complete within {timeout:g}s (attempt abandoned)"
                )
        ok, val = box[0]
        if ok:
            return val
        raise val


_worker_lock = _san_lock("guard._worker_lock")
_workers: list = []  # idle-or-busy pool; stuck (timed-out) workers are evicted
_METRIC_BASE: Optional[type] = None  # lazily bound to Metric (import-cycle break)


def _on_callers_device(fn: Callable[[], Any]) -> Callable[[], Any]:
    """``fn``, to run on a worker under the calling thread's current CUDA device.

    The current device is per thread and starts at 0 on a new one, so a rank
    that called ``torch.cuda.set_device(local_rank)`` would otherwise run its
    attempt, and any NCCL collective in it, on card 0.
    """
    if not torch.cuda.is_initialized():
        return fn
    device = torch.cuda.current_device()

    def run() -> Any:
        with torch.cuda.device(device):
            return fn()

    return run


def _run_with_timeout(fn: Callable[[], Any], timeout: Optional[float]) -> Any:
    if timeout is None:
        return fn()
    fn = _on_callers_device(fn)
    # one worker per concurrent attempt: queueing a second metric's sync
    # behind a busy worker would burn its timeout budget on waiting, then
    # discard a healthy worker and fake a degradation on a healthy fabric
    with _worker_lock:
        w = next((x for x in _workers if not x.busy and x._thread.is_alive()), None)
        if w is None:
            w = _Worker()
            _workers.append(w)
        w.busy = True
    try:
        result = w.run(fn, timeout)
    except CollectiveTimeoutError:
        with _worker_lock:  # the worker may be stuck mid-transport: evict it
            if w in _workers:
                _workers.remove(w)
        raise
    except BaseException:
        with _worker_lock:
            w.busy = False
        raise
    with _worker_lock:
        w.busy = False
    return result


# deterministic programming errors: a wrong-signature dist_sync_fn, a bad
# process_group, a typo'd attribute — retrying cannot fix them, and degrading
# would reduce a bug to a warning with silently-local (cross-host divergent)
# results. Transport faults surface as OSError/ConnectionError/TimeoutError/
# RuntimeError (a failed NCCL or gloo call) and stay retryable.
_NON_RETRYABLE = (TypeError, AttributeError, NameError, KeyError, IndexError, ValueError)


def run_guarded(
    fn: Callable[[], Any],
    retry: RetryPolicy,
    describe: str = "collective",
    on_attempt: Optional[Callable[[int], None]] = None,
) -> Any:
    """Run ``fn`` under the retry policy; raise :class:`SyncRetriesExhausted` at the end.

    ``StateStructureMismatchError`` and the ``_NON_RETRYABLE`` programming
    errors are never retried (and never degraded) — they are deterministic,
    so retrying only burns the backoff budget and degrading hides a bug.

    Caveat for timeout-armed policies on a *live* fabric: abandoning a
    timed-out collective and issuing a retry means this process has entered
    the collective one more time than peers that were merely slow — which can
    skew collective ordering until the abandoned call drains. Set ``timeout``
    well above worst-case congestion (it is a deadlock escape hatch, not a
    latency SLO), and prefer ``max_retries=0`` + degradation where peers may
    be slow rather than dead.

    On the real transport (no injector, no simulated world) a timed-out
    attempt is the last one: the abandoned NCCL or gloo call may still hold
    the communicator, so the sync gives up and degrades rather than enter it
    again.
    """
    last_err: Optional[BaseException] = None
    attempts = retry.attempts
    for attempt in range(retry.attempts):
        if on_attempt is not None:
            on_attempt(attempt)
        # one span per collective attempt, opened on the CALLING thread so a
        # timed-out, abandoned worker attempt can never write into the trace;
        # retries appear as sibling spans under the seam's sync span
        _sp = (
            _obs_trace.begin_span("sync_attempt", describe, attempt=attempt)
            if _OBS.tracing
            else None
        )
        try:
            result = _run_with_timeout(fn, retry.timeout)
        except StateStructureMismatchError as err:
            if _sp is not None:
                _obs_trace.end_span(_sp, err)
            raise
        except _NON_RETRYABLE as err:
            if _sp is not None:
                _obs_trace.end_span(_sp, err)
            raise
        except Exception as err:  # noqa: BLE001 - transport errors are policy-handled
            if _sp is not None:
                _obs_trace.end_span(_sp, err)
            last_err = err
            if isinstance(err, CollectiveTimeoutError) and _dist._transport is None and _dist._world_override is None:
                # a timed-out NCCL/gloo collective may leave the communicator unusable (the abandoned
                # call still holds it): no further attempt enters it in this sync, which degrades
                attempts = attempt + 1
                break
            if attempt + 1 < retry.attempts:
                delay = retry.backoff(attempt)
                if delay:
                    time.sleep(delay)
        except BaseException as err:  # KeyboardInterrupt/SystemExit: close the span, never swallow
            if _sp is not None:
                _obs_trace.end_span(_sp, err)
            raise
        else:
            if _sp is not None:
                _obs_trace.end_span(_sp)
            return result
    raise SyncRetriesExhausted(
        f"{describe} failed after {attempts} attempt(s); last error:"
        f" {type(last_err).__name__}: {last_err}",
        attempts=attempts,
        last_error=last_err,
    )


def _attempt_recorder(metric: Any) -> Optional[Callable[[int], None]]:
    """Telemetry hook counting collective attempts/retries for a metric.

    Returns None while telemetry is disabled so :func:`run_guarded`'s loop
    pays nothing (one is-None check per attempt, and attempts are rare).
    """
    if not _OBS.enabled:
        return None
    telem = _telemetry_for(metric)

    def record(attempt: int) -> None:
        telem.inc("sync_attempts")
        if attempt:
            telem.inc("sync_retries")

    return record


# ---------------------------------------------------------------------------
# structure handshake
# ---------------------------------------------------------------------------


def state_structure_digest(metric: Any) -> Tuple[int, str]:
    """``(digest, description)`` of the metric's state structure.

    Covers exactly what must agree across processes for the collective to be
    well-formed: sorted state names, each state's declared reduction, and for
    plain array states the dtype and shape (shape mismatches would stack into
    garbage reductions). List and ring-buffer ("cat") states contribute only
    their kind — their lengths and row counts legitimately differ per process
    and are handled by the uneven-gather protocol.
    """
    parts = []
    for name in sorted(metric._defaults):
        red = metric._reductions.get(name)
        red_desc = red if isinstance(red, str) or red is None else f"callable:{getattr(red, '__name__', 'fn')}"
        value = getattr(metric, name)
        if isinstance(value, RingBuffer):
            kind: Tuple[Any, ...] = ("ring", int(value.capacity))
        elif isinstance(value, list):
            kind = ("list",)
        else:
            # numpy's dtype names (`float32`, `int64`, `bfloat16`), and no device: ranks on
            # `cuda:0` and `cuda:1` hold the same structure
            kind = ("array", str(value.dtype).replace("torch.", ""), tuple(int(s) for s in value.shape))
        parts.append((name, red_desc, kind))
    description = repr(tuple(parts))
    digest = int.from_bytes(hashlib.sha256(description.encode()).digest()[:8], "big")
    return digest, description


def _handshake(metric: Any, policy: SyncPolicy, group: Optional[Any] = None) -> bool:
    """Exchange structure digests over ``group``; True on success, False on degraded transport.

    The digest travels on the metric's card when its states are on one (so
    NCCL gathers it where the state gather runs), else on the host.

    Raises :class:`StateStructureMismatchError` when digests disagree — that
    is a fail-fast diagnosis, not a degradable transient.
    """
    # one successful handshake certifies the structure for the metric's
    # lifetime: every structure-changing entry point (`add_state`,
    # `set_resilience_policy`, `set_dtype`, `load_state_dict`) drops this
    # cache. The skip
    # decision is LOCAL — it stays collective-count-symmetric only while
    # every process runs the same code path (see SyncPolicy.handshake docs);
    # `handshake_every_sync=True` trades one scalar all-gather per sync for
    # a fail-fast diagnostic even under mid-stream structure divergence.
    if not policy.handshake_every_sync and metric.__dict__.get("_handshake_ok_digest") is not None:
        return True
    digest, description = state_structure_digest(metric)
    # the digest travels as TWO words below 2**32 in an int64 tensor: NCCL
    # has no unsigned 64-bit gather and no reliable uint32 one, and a
    # uint64 digest would not fit an int64 word
    device = getattr(metric, "device", None)
    device = device if device is not None and device.type == "cuda" else None
    local_words = torch.tensor([(digest >> 32) & 0xFFFFFFFF, digest & 0xFFFFFFFF], dtype=torch.int64, device=device)
    try:
        gathered = run_guarded(
            lambda: _dist.process_allgather(local_words, group),
            policy.retry,
            describe=f"{type(metric).__name__} pre-sync structure handshake",
            on_attempt=_attempt_recorder(metric),
        )
    except SyncRetriesExhausted as err:
        if policy.on_exhausted == "raise":
            raise
        metric._record_degradation("handshake_degraded", detail=str(err), attempts=err.attempts)
        return False
    words = np.asarray(torch.as_tensor(gathered).cpu()).astype(np.uint64).reshape(-1, 2)
    digests = [(int(hi) << 32) | int(lo) for hi, lo in words.tolist()]
    if any(d != digest for d in digests):
        mismatched = sorted(set(digests))
        raise StateStructureMismatchError(
            f"State-structure handshake failed for {type(metric).__name__}: processes reported"
            f" {len(mismatched)} distinct structure digests {[f'{d:016x}' for d in mismatched]}."
            " Entering the collective would deadlock or mis-reduce. This process's structure is:"
            f" {description}. Check that every process constructed the metric with identical"
            " configuration (state names, dtypes, shapes, and reductions must all match)."
        )
    object.__setattr__(metric, "_handshake_ok_digest", digest)
    return True


def handshake_at_trace(metric: Any) -> bool:
    """One structure handshake for a compiled (SPMD) path, at trace time.

    The in-graph engine checks the cross-process structure contract ONCE,
    before building the fused executable — a per-step handshake would
    re-introduce the eager round-trip the engine removes. Policy resolution
    mirrors ``Metric.sync``: the metric's own ``sync_policy``, else the
    process-wide default unless the metric explicitly opted out. Returns
    False when the handshake transport degraded (caller must keep the eager
    path); raises :class:`StateStructureMismatchError` on digest mismatch;
    True when single-process, unguarded, or verified.
    """
    if not callable(getattr(metric, "distributed_available_fn", None)) or not metric.distributed_available_fn():
        return True
    policy = metric.sync_policy
    if policy is None and not metric.__dict__.get("_sync_policy_explicit"):
        from torchmetrics_tpu_torch._resilience.policy import default_sync_policy

        policy = default_sync_policy()
    if policy is None or not policy.handshake:
        return True
    return _handshake(metric, policy, getattr(metric, "process_group", None))


# ---------------------------------------------------------------------------
# metric-level guarded sync
# ---------------------------------------------------------------------------


def guarded_metric_sync(metric: Any, dist_sync_fn: Callable, process_group: Any, policy: SyncPolicy) -> bool:
    """Run one guarded sync; True = gathered state committed, False = degraded.

    Degradation (False) means the caller must keep the metric's local state
    and skip marking it synced. Structure mismatches raise. Metrics that
    override ``_sync_dist`` wholesale (fusing gather and commit) run their
    override inline — retries and backoff still apply, but no watchdog
    thread: a timed-out override could commit state from an abandoned worker,
    which the split gather/commit protocol exists to prevent.
    """
    global _METRIC_BASE
    if _METRIC_BASE is None:  # lazy: guard must stay importable before metric
        from torchmetrics_tpu_torch.metric import Metric as _METRIC_BASE  # noqa: N806

    Metric = _METRIC_BASE
    if policy.handshake and not _handshake(metric, policy, process_group):
        return False

    overridden = type(metric)._sync_dist is not Metric._sync_dist
    if overridden:
        retry = policy.retry if policy.retry.timeout is None else dataclasses.replace(policy.retry, timeout=None)

        def attempt() -> None:
            try:
                metric._sync_dist(dist_sync_fn, process_group=process_group)
            except BaseException:
                # a fused override may have committed some states before the
                # transport failed; undo the partial commit so the retry does
                # not re-reduce already-reduced values (double counting)
                if metric._cache is not None:
                    metric._restore_state(metric._cache)
                raise

        commit: Callable[[Any], None] = lambda _out: None  # noqa: E731
    else:
        retry = policy.retry

        def attempt() -> Any:
            gathered = metric._dist_gather(dist_sync_fn, process_group)
            if metric.device.type == "cuda":
                # an NCCL gather returns once enqueued: the attempt ends when the data has
                # arrived, so the watchdog times the collective and not its launch
                torch.cuda.current_stream(metric.device).synchronize()
            return gathered

        commit = metric._commit_gathered
    try:
        gathered = run_guarded(
            attempt, retry,
            describe=f"{type(metric).__name__} state gather",
            on_attempt=_attempt_recorder(metric),
        )
    except SyncRetriesExhausted as err:
        if policy.on_exhausted == "raise":
            raise
        metric._record_degradation("sync_degraded", detail=str(err), attempts=err.attempts)
        return False
    commit(gathered)
    return True
