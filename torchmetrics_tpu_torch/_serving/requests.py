"""Request/acknowledgement types for the metrics-as-a-service runtime.

Port of ``torchmetrics_tpu/_serving/requests.py``. A client thread submits
one stream's batch and gets back an :class:`Ack` handle immediately; the
ingest worker resolves it after the micro-batch the request rode in has
been applied to the :class:`~torchmetrics_tpu_torch._streams.StreamPool`
AND journaled by the pool's snapshot hook (``record_streams`` writes and
flushes the frame before ``update`` returns). "Acked" therefore means
*durable*: a preemption after the ack replays the row from the journal,
which is the no-lost-acknowledged-batches invariant the chaos-under-load
suite asserts. On the card "applied" means the micro-batch's step is
enqueued on the pool's stream (its replay, or its first run and capture):
every later ``compute`` on that stream sees it, and no ack waits for the
card to finish it.

Rejections are synchronous — an over-capacity or load-shedding
:class:`~torchmetrics_tpu_torch._serving.queue.IngressQueue` raises
:class:`BackpressureError` from ``submit`` itself, carrying a
``retry_after_s`` hint computed from the live drain rate; nothing rejected
ever occupies queue memory.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = ["Ack", "BackpressureError", "ServerClosedError", "UpdateRequest"]


class BackpressureError(TorchMetricsUserError):
    """The ingress queue refused the request; retry after ``retry_after_s``.

    Raised synchronously from ``submit`` when the bounded queue is full or
    the controller has entered load-shedding. The hint is computed from the
    observed drain rate (queue depth / rows-per-second), so a well-behaved
    client that honors it arrives when capacity plausibly exists.
    """

    def __init__(self, message: str, retry_after_s: float, kind: str = "full") -> None:
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.kind = kind  # "full" (queue at capacity) | "shed" (controller decision)


class ServerClosedError(TorchMetricsUserError):
    """``submit``/``compute`` on a server that is not accepting traffic."""


class Ack:  # concurrency: shared client threads wait() while the ingest worker resolves
    """One request's completion handle (resolved exactly once).

    States: ``pending`` -> ``acked`` | ``failed``. The transition is
    published through a :class:`threading.Event`, so :meth:`wait` never
    spins; scalar result fields are written before the event is set and
    read only after it fires (the Event is the synchronization edge).
    """

    __slots__ = ("_done", "_state", "_error", "_latency_s", "_quarantined")

    def __init__(self) -> None:
        self._done = threading.Event()
        self._state = "pending"
        self._error: Optional[BaseException] = None
        self._latency_s: Optional[float] = None
        self._quarantined = False

    # ------------------------------------------------------------ resolution
    def _resolve(
        self,
        state: str,
        error: Optional[BaseException] = None,
        latency_s: Optional[float] = None,
        quarantined: bool = False,
    ) -> None:
        # result fields first, event last: wait() returning guarantees the
        # fields are visible (happens-before via Event's internal lock)
        self._error = error
        self._latency_s = latency_s
        self._quarantined = quarantined
        self._state = state
        self._done.set()

    # --------------------------------------------------------------- queries
    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until resolved (True) or ``timeout`` elapses (False)."""
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> str:
        """Final state, re-raising the worker-side error for failed requests."""
        if not self._done.wait(timeout):
            raise TimeoutError("request not resolved within timeout")
        if self._state == "failed" and self._error is not None:
            raise self._error
        return self._state

    @property
    def state(self) -> str:
        return self._state

    @property
    def acked(self) -> bool:
        return self._state == "acked"

    @property
    def quarantined(self) -> bool:
        """True when the row was dropped by the NaN quarantine (still acked:
        the *request* completed; the golden-equality contract excludes
        quarantined rows from the accumulated stream)."""
        return self._quarantined

    @property
    def latency_s(self) -> Optional[float]:
        """Enqueue-to-ack seconds (the `ingest` SLO's unit of account)."""
        return self._latency_s


class UpdateRequest:
    """One stream's single-row update riding the ingress queue.

    ``args``/``kwargs`` are exactly what the client would pass to an eager
    ``metric.update`` for ONE batch; the worker stacks same-signature
    requests into the pool's leading stream axis.
    """

    __slots__ = ("stream_id", "args", "kwargs", "ack", "enqueued_mono")

    def __init__(self, stream_id: int, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> None:
        self.stream_id = int(stream_id)
        self.args = args
        self.kwargs = kwargs
        self.ack = Ack()
        self.enqueued_mono = time.monotonic()
