"""Bounded per-stream telemetry labels: top-K by volume + an overflow bucket.

Port of ``torchmetrics_tpu/_streams/telemetry.py``. A pool serving thousands
of tenants cannot hand every tenant its own Prometheus label: unbounded label
cardinality melts a metrics backend. The :class:`StreamLabeler` keeps exact
per-stream volume counts on the host (one dict increment per applied row,
bounded by the pool's capacity) but exposes at most ``k`` distinct
``stream=<id>`` label values at a time; everything else lands in the shared
``stream=__overflow__`` bucket. Label ownership starts first-come and is
re-balanced to the top K by cumulative volume every ``rebalance_every``
notes, so a tenant that turns noisy after the first K arrived still becomes
attributable (its counter starts at the takeover point; the overflow bucket
keeps the full history, so nothing is lost, only un-attributed).

Thread safety: ingestion threads ``note`` while scrapes ``label``. The volume
dict and the label set are guarded by one ``threading.Lock`` (the JAX
package takes its lock sanitizer's lock here; the port has no sanitizer, as
in its ``_observability``). ``label`` stays lock-free on purpose: a single
set-membership probe is atomic under the GIL, and a rebalance replaces the
set wholesale, so a scrape sees the old or the new labelling, never a torn one.
"""

from __future__ import annotations

import threading
from typing import Dict, Set

__all__ = ["OVERFLOW_LABEL", "StreamLabeler"]

OVERFLOW_LABEL = "__overflow__"


class StreamLabeler:
    """Map stream ids onto a bounded set of telemetry label values."""

    def __init__(self, k: int = 8, rebalance_every: int = 512) -> None:
        if k < 0:
            raise ValueError(f"`k` must be >= 0, got {k}")
        self.k = int(k)
        self.rebalance_every = max(1, int(rebalance_every))
        self._lock = threading.Lock()
        self.volumes: Dict[int, int] = {}
        self._labeled: Set[int] = set()
        self._since_rebalance = 0

    def note(self, stream_id: int, n: int = 1) -> str:
        """Record ``n`` events for the stream; return its current label value."""
        sid = int(stream_id)
        with self._lock:
            self.volumes[sid] = self.volumes.get(sid, 0) + n
            self._since_rebalance += 1
            if sid not in self._labeled and len(self._labeled) < self.k:
                self._labeled.add(sid)
            if self._since_rebalance >= self.rebalance_every:
                self._rebalance_locked()
            return str(sid) if sid in self._labeled else OVERFLOW_LABEL

    def label(self, stream_id: int) -> str:
        """Current label value for a stream without recording an event (lock-free)."""
        return str(int(stream_id)) if int(stream_id) in self._labeled else OVERFLOW_LABEL

    def rebalance(self) -> None:
        """Re-assign label ownership to the top-K streams by cumulative volume."""
        with self._lock:
            self._rebalance_locked()

    def _rebalance_locked(self) -> None:  # caller holds _lock
        self._since_rebalance = 0
        if len(self.volumes) <= self.k:
            self._labeled = set(self.volumes)
            return
        top = sorted(self.volumes.items(), key=lambda kv: (-kv[1], kv[0]))[: self.k]
        self._labeled = {sid for sid, _ in top}

    def retire(self, stream_id: int) -> None:
        """Forget a detached stream (its label slot frees up at rebalance)."""
        sid = int(stream_id)
        with self._lock:
            self.volumes.pop(sid, None)
            self._labeled.discard(sid)
