"""The pool's two admission facts: eligibility and the predicted state bytes.

The port's copies of the pieces of ``torchmetrics_tpu/_analysis/manifest.py``
the stream pool reads (``stream_pool_eligible``, ``predicted_state_bytes`` and
their helpers, JAX ``manifest.py:188`` and ``:420-520``); the port has no
``_analysis/``.

- Eligibility: a class pools when its update verdict
  (``_eligibility.json["classes"]``, the compiled path's copy) is
  ``metadata_only`` or ``value_flags`` and its ``in_graph_sync`` facet
  (``_eligibility.json["in_graph_sync"]``, the JAX manifest's compute walk)
  reads ``safe`` or ``runtime``.
- Memory: ``_memory.json`` holds each class's closed-form state formulas as
  terms over constructor symbols, priced in the port's own state dtypes (an
  int64 count is 8 bytes here where the JAX package's int32 is 4; JAX's byte
  counts would under-admit). ``tools/port_memory_manifest.py`` writes it
  from the JAX package's ``memory.json`` and the port's classes.
"""

from __future__ import annotations

import fnmatch
import functools
import json
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

from torchmetrics_tpu_torch import _compile

__all__ = ["PredictedMemory", "memory_entry_for", "predicted_state_bytes", "stream_pool_eligible"]

_PACKAGE = Path(__file__).resolve().parents[1]
_ELIGIBILITY_PATH = _PACKAGE / "_eligibility.json"
MEMORY_PATH = _PACKAGE / "_memory.json"

# a ring state's stacked row beside its data: the valid mask (1 byte a row)
# and the int64 write count (the JAX package's is int32: 4 bytes)
_RING_VALID_BYTES = 1
_RING_COUNT_BYTES = 8


@functools.lru_cache(maxsize=1)
def _in_graph_sync() -> Dict[str, str]:
    return json.loads(_ELIGIBILITY_PATH.read_text(encoding="utf-8")).get("in_graph_sync", {})


@functools.lru_cache(maxsize=1)
def _memory() -> Dict[str, dict]:
    return json.loads(MEMORY_PATH.read_text(encoding="utf-8")).get("classes", {})


def _qualname(cls: type) -> str:
    return f"{cls.__module__}.{cls.__qualname__}"


def stream_pool_eligible(cls: type) -> str:
    """``"safe"``/``"runtime"``/``"host_bound"``/``"unsupported"``/``"unknown"`` for the exact class (JAX ``manifest.py:188``).

    The pool vmaps one metric's update and compute over stacked state
    copies, so a class pools when both bodies trace: the class verdict says
    so for the update, the ``in_graph_sync`` facet's compute walk for the
    compute. A class the copy does not name (a user subclass) reads
    ``"unknown"``.
    """
    verdict = _compile.eligibility_verdict(cls)
    if verdict is None:
        return "unknown"
    if verdict not in ("metadata_only", "value_flags"):
        return "host_bound"
    facet = _in_graph_sync().get(_qualname(cls))
    return facet if facet in ("safe", "runtime") else "unsupported"


def memory_entry_for(cls: type) -> Optional[dict]:
    """The ``_memory.json`` entry of the exact class (user subclasses read None)."""
    return _memory().get(_qualname(cls))


class PredictedMemory(NamedTuple):
    """One instance's predicted state footprint (JAX ``manifest.py:395``).

    ``exact`` is False when a state's symbols could not be resolved against
    the live instance and its live bytes were used instead.
    """

    bytes: float
    verdict: str  # "bounded" | "unbounded"
    exact: bool
    peak_factor: float


def _row_bytes(obj: object, state_name: str, rows: Optional[Dict[str, float]] = None) -> Optional[float]:
    """Bytes of one appended row of a cat state: from ``rows`` (a pool's learned rows), else the live state."""
    if rows and state_name in rows:
        return rows[state_name]
    value = getattr(obj, state_name, None)
    if value is None:
        return None
    if hasattr(value, "capacity") and hasattr(value, "append"):
        data = getattr(value, "data", None)
        if data is not None and getattr(value, "capacity", 0):
            return float(data.nbytes) / float(value.capacity)
        return None
    if isinstance(value, (list, tuple)) and value and hasattr(value[0], "nbytes"):
        first = value[0]
        lead = first.shape[0] if getattr(first, "ndim", 0) >= 1 and first.shape[0] else 1
        return float(first.nbytes) / float(lead)
    return None


def _resolve_symbol(obj: object, sym: str) -> Optional[float]:
    """One formula symbol on a live instance.

    A bare name is a numeric constructor argument (``self.<name>``; a tensor
    resolves to its leading dimension, the ``thresholds`` count idiom);
    ``len(x)`` is the length of a stored collection; ``row_bytes(s)`` is the
    live row width of cat state ``s``.
    """
    if sym.startswith("row_bytes(") and sym.endswith(")"):
        return _row_bytes(obj, sym[len("row_bytes(") : -1])
    if sym.startswith("len(") and sym.endswith(")"):
        value = getattr(obj, sym[4:-1], None)
        try:
            return float(len(value))  # type: ignore[arg-type]
        except TypeError:
            return None
    value = getattr(obj, sym, None)
    if value is None:
        return None
    if isinstance(value, (bool, int, float)):
        return float(value)
    shape = getattr(value, "shape", None)
    if shape is not None and len(shape) >= 1:
        return float(shape[0])
    try:
        return float(len(value))  # type: ignore[arg-type]
    except TypeError:
        return None


def _eval_terms(obj: object, terms: List[dict]) -> Optional[float]:
    total = 0.0
    for term in terms:
        value = float(term.get("coeff", 0.0))
        for sym, power in (term.get("vars") or {}).items():
            resolved = _resolve_symbol(obj, sym)
            if resolved is None:
                return None
            value *= resolved ** int(power)
        total += value
    return total


def _expand_state_names(obj: object, pattern: str) -> List[str]:
    """A dynamic-name record (``rouge*_*``) expands against the live state registry; a literal passes through."""
    if "*" not in pattern:
        return [pattern]
    defaults = getattr(obj, "_defaults", None)
    if not isinstance(defaults, dict):
        return []
    return sorted(n for n in defaults if fnmatch.fnmatch(n, pattern))


def _live_state_bytes(obj: object, name: str) -> Optional[float]:
    value = getattr(obj, name, None)
    if value is None:
        return None
    if hasattr(value, "nbytes"):
        return float(value.nbytes)
    data = getattr(value, "data", None)
    if data is not None and hasattr(value, "capacity"):
        return float(data.nbytes) + value.capacity * _RING_VALID_BYTES + _RING_COUNT_BYTES
    return None


def _registered_kind(defaults: Optional[dict], name: str) -> Optional[str]:
    """``"list"`` or ``"array"``: the kind of state ``name`` the instance registered (None: unknown)."""
    if not isinstance(defaults, dict) or name not in defaults:
        return None
    value = defaults[name]
    return "list" if isinstance(value, list) or hasattr(value, "capacity") else "array"


def predicted_state_bytes(obj: object, ring_rows: Optional[Dict[str, float]] = None) -> Optional[PredictedMemory]:
    """The class's closed-form byte formula on a live instance (JAX ``manifest.py:512``), or None.

    None when the model has nothing to say: a class absent from
    ``_memory.json`` (user subclasses) or an opaque verdict. An instance
    with ``cat_state_capacity`` turns an unbounded list state into a ring
    buffer of ``capacity * (row + 1) + 8`` bytes (data, valid mask, int64
    count); ``ring_rows`` gives the row bytes of rings the instance itself
    never filled (a pool's template). A state the manifest records both as
    an array and as a conditional list (``multidim_average="samplewise"``)
    is priced by the kind the instance registered; the JAX evaluator adds
    both records, and reads such a class as unbounded.
    """
    entry = memory_entry_for(type(obj))
    if entry is None or entry.get("verdict") == "opaque":
        return None
    capacity = getattr(obj, "cat_state_capacity", None)
    defaults = getattr(obj, "_defaults", None)
    total, exact, verdict = 0.0, True, "bounded"
    for state in entry.get("states", ()):
        kind = state.get("kind")
        if kind == "opaque":
            exact = False
            continue
        names = _expand_state_names(obj, state.get("name", ""))
        conditional = bool(state.get("conditional"))
        if isinstance(defaults, dict):
            live_names = [n for n in names if n in defaults]
            if conditional or live_names:
                names = live_names
        if not names:
            if conditional:
                continue
            names = [state.get("name", "")]
        for name in names:
            registered = _registered_kind(defaults, name)
            if registered is not None and registered != kind:
                continue
            if kind == "list":
                if capacity:
                    row = _row_bytes(obj, name, ring_rows)
                    if row is None:
                        row, exact = 4.0, False  # a ring with no storage yet: the least row
                    total += float(capacity) * (row + _RING_VALID_BYTES) + _RING_COUNT_BYTES
                else:
                    verdict, total = "unbounded", float("inf")
                continue
            value = _eval_terms(obj, state.get("terms", ()))
            if value is None:
                live = _live_state_bytes(obj, name)
                if live is None:
                    exact = False
                    continue
                value, exact = live, False
            total += value
    if total != total:  # pragma: no cover - NaN guard
        return None
    return PredictedMemory(
        bytes=total, verdict=verdict, exact=exact and verdict == "bounded", peak_factor=float(entry.get("peak_factor", 1.0))
    )
