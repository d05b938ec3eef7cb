"""Request-scoped span tracing with propagated correlation ids.

Aggregate telemetry (counters + reservoirs) answers "how often / how slow on
average"; this module answers "*which* request, through *which* seams, in
*what* causal order". A :class:`Span` is one timed region of one runtime
seam (an update, a guarded sync attempt, a snapshot write, a fused SPMD
step, a StreamPool micro-batch); spans carry a shared ``trace_id`` and a
``parent_id``, so one ingest call — however many seams it crosses — yields a
single causally-ordered tree.

Propagation is ``contextvars``-based: :func:`trace_context` opens an ambient
root span for a request; every instrumented seam that fires inside it
becomes a child (and nested seams become grandchildren) with **no** id
plumbed through any call signature. Context-vars follow the thread driving
the request, which is exactly the correlation the serving runtime needs —
the guarded-sync watchdog worker is deliberately *not* traced from inside
(attempt spans are opened on the calling thread around the handoff, so a
timed-out, abandoned attempt cannot write into a dead trace).

Completed spans land in the process-wide bounded :data:`TRACER` ring
(newest-wins, O(1) append, fixed memory) and can be exported as Chrome
trace-event JSON (:func:`export_chrome_trace` — loads in ``chrome://tracing``
and Perfetto) next to the existing Prometheus text exposition.

Hot-path discipline (same contract as the telemetry switch): every seam
guards itself with ``if _OBS.tracing:`` — one slot-bool load and one branch
while tracing is off, no allocation, no clock read.
Enable with ``TM_TPU_TRACING=1`` or :func:`set_tracing_enabled`.

This module must stay import-light (no torch, no numpy): ``metric.py``
imports it at module scope.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from torchmetrics_tpu_torch._analysis.locksan import SAN as _SAN
from torchmetrics_tpu_torch._analysis.locksan import check_access as _san_check
from torchmetrics_tpu_torch._analysis.locksan import new_lock as _san_lock
from torchmetrics_tpu_torch._observability.state import OBS

__all__ = [
    "Span",
    "SpanRecorder",
    "TRACER",
    "begin_span",
    "end_span",
    "trace_context",
    "current_span",
    "current_trace_id",
    "set_tracing_enabled",
    "tracing_enabled",
    "export_chrome_trace",
    "span_tree",
]

DEFAULT_SPAN_CAPACITY = 2048

# process-wide id fountains; ``next()`` on an itertools.count is GIL-atomic,
# so concurrent request threads mint ids without a lock
_span_ids = itertools.count(1)
_trace_ids = itertools.count(1)

# the ambient span of the current logical request (per thread / per context)
_CURRENT: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "tm_tpu_current_span", default=None
)


class Span:
    """One timed region of one runtime seam, linked into a request tree.

    ``trace_id`` correlates every span of one request; ``parent_id`` is the
    enclosing span's ``span_id`` (0 for roots). Timestamps are
    ``time.monotonic()`` — the same clock the event bus stamps (satellite:
    ``TelemetryEvent.mono``), so flight-recorder dumps interleave spans and
    events on one axis. ``attrs`` must stay small and JSON-serializable
    (exports embed it verbatim).
    """

    __slots__ = (
        "trace_id",
        "span_id",
        "parent_id",
        "name",
        "source",
        "attrs",
        "t0_wall",
        "t0_mono",
        "t1_mono",
        "status",
        "error",
        "thread_id",
        "_token",
    )

    def __init__(self, trace_id: int, span_id: int, parent_id: int, name: str, source: str) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.source = source
        self.attrs: Dict[str, Any] = {}
        self.t0_wall = time.time()
        self.t0_mono = time.monotonic()
        self.t1_mono: Optional[float] = None
        self.status = "ok"
        self.error: Optional[str] = None
        self.thread_id = threading.get_ident()
        self._token: Any = None

    @property
    def duration_s(self) -> float:
        end = self.t1_mono if self.t1_mono is not None else time.monotonic()
        return end - self.t0_mono

    def to_json(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "source": self.source,
            "attrs": dict(self.attrs),
            "t0_wall": self.t0_wall,
            "t0_mono": self.t0_mono,
            "t1_mono": self.t1_mono,
            "duration_s": self.duration_s,
            "status": self.status,
            "error": self.error,
            "thread_id": self.thread_id,
        }

    def __repr__(self) -> str:
        return (
            f"Span(trace={self.trace_id}, id={self.span_id}, parent={self.parent_id},"
            f" name={self.name!r}, source={self.source!r}, status={self.status})"
        )


class SpanRecorder:  # concurrency: shared request threads record() while exporters read
    """Bounded ring of completed spans (process-wide, thread-safe).

    The ring holds the ``capacity`` most recent completed spans — enough for
    flight-recorder context and for exporting the traces a test or operator
    just produced, without growing host memory at stream rate.
    """

    def __init__(self, capacity: int = DEFAULT_SPAN_CAPACITY) -> None:
        self._lock = _san_lock("SpanRecorder._lock")
        self._spans: "deque[Span]" = deque(maxlen=capacity)
        self.dropped = 0
        self.recorded = 0

    def record(self, span: Span) -> None:
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_spans")
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span)
            self.recorded += 1

    def spans(self, trace_id: Optional[int] = None, name: Optional[str] = None) -> Tuple[Span, ...]:
        """Retained spans, oldest-completed first; optionally filtered."""
        with self._lock:
            out = tuple(self._spans)
        if trace_id is not None:
            out = tuple(s for s in out if s.trace_id == trace_id)
        if name is not None:
            out = tuple(s for s in out if s.name == name)
        return out

    def recent(self, n: int) -> Tuple[Span, ...]:
        """The last ``n`` completed spans, oldest first (flight-recorder window)."""
        with self._lock:
            if n >= len(self._spans):
                return tuple(self._spans)
            return tuple(itertools.islice(self._spans, len(self._spans) - n, None))

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0
            self.recorded = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


# the process-wide recorder every seam reports completed spans to
TRACER = SpanRecorder()


# ---------------------------------------------------------------------------
# switches
# ---------------------------------------------------------------------------


def set_tracing_enabled(flag: bool) -> None:
    """Runtime kill switch for span collection (env twin: ``TM_TPU_TRACING=1``).

    Disabling stops every seam from opening spans; already-recorded spans
    stay readable (:data:`TRACER`, :func:`export_chrome_trace`).
    """
    OBS.tracing = bool(flag)


def tracing_enabled() -> bool:
    return OBS.tracing


# ---------------------------------------------------------------------------
# span lifecycle (seam-facing: explicit begin/end, no context-manager frames)
# ---------------------------------------------------------------------------


def begin_span(name: str, source: str = "", **attrs: Any) -> Span:
    """Open a span under the current ambient context and make it current.

    Callers (the instrumented seams) guard on ``OBS.tracing`` BEFORE calling:
    this function allocates and reads the clock. Must be paired with
    :func:`end_span` in a ``finally`` on the same thread.
    """
    parent = _CURRENT.get()
    if parent is not None:
        span = Span(parent.trace_id, next(_span_ids), parent.span_id, name, source)
    else:
        span = Span(next(_trace_ids), next(_span_ids), 0, name, source)
    if attrs:
        span.attrs.update(attrs)
    span._token = _CURRENT.set(span)
    return span


def end_span(span: Span, error: Optional[BaseException] = None) -> None:
    """Close a span, restore its parent as current, and record it."""
    span.t1_mono = time.monotonic()
    if error is not None:
        span.status = "error"
        span.error = f"{type(error).__name__}: {error}"
    token, span._token = span._token, None
    if token is not None:
        try:
            _CURRENT.reset(token)
        except ValueError:
            # closed in a different context than it was opened (e.g. a
            # generator finalized elsewhere): the span is still recorded,
            # only the ambient pointer restore is skipped
            pass
    TRACER.record(span)


class _NullSpan:
    """Inert span stand-in yielded while tracing is disabled.

    ``with trace_context(...) as sp`` code must keep working unconditionally:
    attribute writes land in a fresh throwaway dict, reads return disabled
    markers, nothing is recorded.
    """

    __slots__ = ()

    trace_id = None
    span_id = 0
    parent_id = 0
    name = "disabled"
    source = ""
    status = "disabled"
    error = None
    t0_wall = 0.0
    t0_mono = 0.0
    t1_mono = 0.0
    thread_id = 0

    @property
    def attrs(self) -> Dict[str, Any]:
        # a fresh dict per read: writes are accepted and dropped, and no
        # shared container can accumulate garbage across requests
        return {}

    @property
    def duration_s(self) -> float:
        return 0.0

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "status": self.status}

    def __repr__(self) -> str:
        return "Span(disabled)"


NULL_SPAN = _NullSpan()


class _NullContext:
    """Shared no-op for ``trace_context`` while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return NULL_SPAN

    def __exit__(self, *exc: Any) -> None:
        return None


_NULL = _NullContext()


class _SpanContext:
    """Context-manager shell over begin/end for user code."""

    __slots__ = ("_name", "_source", "_attrs", "span")

    def __init__(self, name: str, source: str, attrs: Dict[str, Any]) -> None:
        self._name = name
        self._source = source
        self._attrs = attrs
        self.span: Optional[Span] = None

    def __enter__(self) -> Span:
        self.span = begin_span(self._name, self._source, **self._attrs)
        return self.span

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        if self.span is not None:
            end_span(self.span, error=exc if isinstance(exc, BaseException) else None)
        return None


def trace_context(name: str = "request", source: str = "", **attrs: Any) -> Any:
    """Open an ambient (usually root) span for one logical request.

    The public entry point: wrap one ingest call / eval step / scrape in it
    and every instrumented seam inside becomes part of one correlated tree::

        with trace_context("ingest", tenant="42"):
            pool.update(ids, preds, target)
            pool.compute_all()

    While tracing is disabled this returns a no-op context yielding an inert
    :data:`NULL_SPAN` (attribute writes accepted and dropped), so callers may
    leave the ``with`` block — including an ``as sp`` binding — in place
    unconditionally.
    """
    if not OBS.tracing:
        return _NULL
    return _SpanContext(name, source, attrs)


def current_span() -> Optional[Span]:
    """The ambient span of the calling context (None outside any trace)."""
    return _CURRENT.get()


def current_trace_id() -> Optional[int]:
    span = _CURRENT.get()
    return None if span is None else span.trace_id


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------


def export_chrome_trace(
    trace_id: Optional[int] = None,
    spans: Optional[Tuple[Span, ...]] = None,
    path: Optional[str] = None,
) -> Dict[str, Any]:
    """Chrome trace-event JSON for the retained (or given) spans.

    The payload is the classic ``{"traceEvents": [...]}`` object of complete
    (``"ph": "X"``) events — loadable in ``chrome://tracing`` and Perfetto.
    Span linkage rides ``args`` (``trace_id``/``span_id``/``parent_id``)
    and the ``tid`` axis is the recording thread. Serializability is
    guaranteed at the source (``json.dumps`` runs before returning); pass
    ``path`` to also write the file.
    """
    if spans is None:
        spans = TRACER.spans(trace_id=trace_id)
    pid = os.getpid()
    events: List[Dict[str, Any]] = []
    for s in spans:
        end = s.t1_mono if s.t1_mono is not None else s.t0_mono
        events.append(
            {
                "name": f"{s.source}.{s.name}" if s.source else s.name,
                "cat": s.source or "tmtpu",
                "ph": "X",
                "ts": round(s.t0_mono * 1e6, 3),
                "dur": round((end - s.t0_mono) * 1e6, 3),
                "pid": pid,
                "tid": s.thread_id,
                "args": {
                    "trace_id": s.trace_id,
                    "span_id": s.span_id,
                    "parent_id": s.parent_id,
                    "status": s.status,
                    **({"error": s.error} if s.error else {}),
                    **s.attrs,
                },
            }
        )
    # user span attrs may hold values json can't represent (numpy scalars,
    # arbitrary objects): coerce via repr() so the export never raises — the
    # returned payload is the already-serialized form, loadable as written
    payload = {"traceEvents": events, "displayTimeUnit": "ms"}
    text = json.dumps(payload, default=repr)
    payload = json.loads(text)
    if path is not None:
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(text)
    return payload


def span_tree(trace_id: int, spans: Optional[Tuple[Span, ...]] = None) -> List[Dict[str, Any]]:
    """Causally-ordered tree(s) of one trace: roots with nested children.

    Children are ordered by start time. The return value is a list because a
    bounded ring may have evicted a trace's root while children survive —
    every retained span still appears exactly once, parented as deeply as
    the retained window allows.
    """
    if spans is None:
        spans = TRACER.spans(trace_id=trace_id)
    nodes = {s.span_id: {**s.to_json(), "children": []} for s in spans}
    roots: List[Dict[str, Any]] = []
    for s in sorted(spans, key=lambda x: x.t0_mono):
        node = nodes[s.span_id]
        parent = nodes.get(s.parent_id)
        if parent is not None:
            parent["children"].append(node)
        else:
            roots.append(node)
    return roots
