"""Fleet observability helpers: bounded ``region=`` label cardinality.

Port of ``torchmetrics_tpu/_fleet/observe.py``. A fleet has thousands of
edge nodes; exporting one Prometheus label value per node is the classic
cardinality explosion. The fleet tier therefore reuses the pool tier's
:class:`~torchmetrics_tpu_torch._streams.telemetry.StreamLabeler` (top-K by
volume + ``__overflow__`` bucket) behind a thin string adapter: regions are
named (``"region-eu"``), the labeler speaks integer ids, so this wrapper owns
the name <-> id table and returns the region *name* while it holds a label
slot and the shared overflow bucket once it loses one. Its lock is a plain
``threading.Lock`` where the JAX package takes its lock sanitizer's.
"""

from __future__ import annotations

import threading
from typing import Dict

from torchmetrics_tpu_torch._analysis.locksan import SAN as _SAN
from torchmetrics_tpu_torch._analysis.locksan import check_access as _san_check
from torchmetrics_tpu_torch._analysis.locksan import new_lock as _san_lock
from torchmetrics_tpu_torch._streams.telemetry import OVERFLOW_LABEL, StreamLabeler

__all__ = ["OVERFLOW_LABEL", "RegionLabeler"]


class RegionLabeler:  # concurrency: shared node rollup threads note() while scrapes label()
    """Bounded region-name -> telemetry-label mapping (top-K by volume)."""

    def __init__(self, k: int = 8, rebalance_every: int = 512) -> None:
        self._inner = StreamLabeler(k=k, rebalance_every=rebalance_every)
        self._lock = _san_lock("RegionLabeler._lock")
        # concurrency: shared name->id table guarded-by _lock
        self._ids: Dict[str, int] = {}

    def _id_of(self, region: str) -> int:
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_ids")
            rid = self._ids.get(region)
            if rid is None:
                rid = self._ids[region] = len(self._ids)
            return rid

    def note(self, region: str, n: int = 1) -> str:
        """Record ``n`` events for the region; return its current label value."""
        label = self._inner.note(self._id_of(str(region)), n)
        return str(region) if label != OVERFLOW_LABEL else OVERFLOW_LABEL

    def label(self, region: str) -> str:
        """Current label value WITHOUT recording an event (scrape path)."""
        with self._lock:
            rid = self._ids.get(str(region))
        if rid is None:
            return OVERFLOW_LABEL
        inner = self._inner.label(rid)
        return str(region) if inner != OVERFLOW_LABEL else OVERFLOW_LABEL
