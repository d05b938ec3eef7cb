"""Checksummed, versioned metric checkpoints + NaN/Inf state sentinels.

Port of ``torchmetrics_tpu/_resilience/integrity.py``.
``Metric.state_dict(..., integrity=True)`` attaches one metadata block per
metric under the non-identifier key ``{prefix}#integrity`` (state names are
python identifiers, so the key can never collide with a real state):

.. code-block:: python

    {"version": 1, "class": "MulticlassAccuracy",
     "states": {"tp": {"sha256": "...", "finite": True}, ...}}

``Metric.load_state_dict`` verifies the block when present: unknown schema
versions and checksum mismatches raise :class:`StateCorruptionError`
immediately; ``strict="repair"`` instead resets only the corrupted states to
their registered defaults and loads the rest.

A checksum hashes what the JAX package's hashes (its ``integrity.py:59-71``):
the dtype's numpy name, the shape and the bytes, so equal data of equal
dtype gives equal digests in both packages and a checkpoint moves between
them. A state on the card goes to the host once for its digest; a
``bfloat16`` state, which numpy cannot hold, is hashed as ``"bfloat16"`` and
its raw 2-byte words (as the JAX package's ``ml_dtypes`` array is) and
carried to the host in a :class:`HostBF16`.

The finiteness sentinels here also back the ``nan_policy`` update guard:
NaN anywhere is flagged; ±Inf is flagged only for states whose *default* is
fully finite, so min/max accumulators seeded with ±Inf sentinels stay legal
while a sum state overflowing to Inf is caught. They run on the tensor's
own device, one host read for the whole scan.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch._resilience.errors import StateCorruptionError
from torchmetrics_tpu_torch.utilities.ringbuffer import RingBuffer

__all__ = [
    "INTEGRITY_VERSION",
    "integrity_key",
    "attach_integrity",
    "verify_states",
    "nonfinite_state_report",
]

INTEGRITY_VERSION = 1
_INTEGRITY_SUFFIX = "#integrity"


class HostBF16:
    """A ``bfloat16`` array on the host: its raw 2-byte words (numpy has no bfloat16).

    Picklable with numpy alone, so snapshots and journals stay torch-free.
    """

    __slots__ = ("words",)

    def __init__(self, words: np.ndarray) -> None:
        self.words = np.ascontiguousarray(words, dtype=np.uint16)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.words.shape)

    @property
    def dtype(self) -> str:
        return "bfloat16"

    def __getstate__(self) -> np.ndarray:
        return self.words

    def __setstate__(self, words: np.ndarray) -> None:
        self.words = words


def to_host(t: Tensor) -> Any:
    """One device-to-host copy of a tensor: a numpy array, or a :class:`HostBF16`."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return HostBF16(t.view(torch.int16).cpu().numpy().view(np.uint16))
    return t.cpu().numpy()


def from_host(value: Any, device: Any = None) -> Tensor:
    """A tensor of a host value: numpy (``ml_dtypes`` bfloat16 included), a :class:`HostBF16` or a tensor."""
    if isinstance(value, HostBF16):
        return torch.from_numpy(value.words.view(np.int16).copy()).view(torch.bfloat16).to(device)
    if isinstance(value, np.ndarray) and value.dtype.name == "bfloat16":
        return torch.from_numpy(value.view(np.int16).copy()).view(torch.bfloat16).to(device)
    if isinstance(value, np.ndarray) and not value.flags.writeable:
        value = value.copy()  # a tensor may not share a read-only buffer
    return torch.as_tensor(value, device=device)


def integrity_key(prefix: str = "") -> str:
    """Checkpoint key of the integrity block for one metric's ``prefix``."""
    return prefix + _INTEGRITY_SUFFIX


def _pieces(value: Any) -> List[Any]:
    """The arrays of one serialized state value (array or list of arrays)."""
    return list(value) if isinstance(value, (list, tuple)) else [value]


def _host_bytes(arr: Any) -> Tuple[str, Tuple[int, ...], bytes]:
    """``(numpy dtype name, shape, bytes)`` of one array, tensor or host bfloat16."""
    if isinstance(arr, Tensor):
        arr = to_host(arr)
    if isinstance(arr, HostBF16):
        return "bfloat16", arr.shape, arr.words.tobytes()
    arr = np.ascontiguousarray(np.asarray(arr))
    return str(arr.dtype), tuple(int(s) for s in arr.shape), arr.tobytes()


def _checksum(value: Any) -> str:
    """sha256 over dtype + shape + bytes of every array in the state value.

    Dtype and shape participate so a reinterpret-cast or reshape of the same
    bytes cannot masquerade as the original state.
    """
    h = hashlib.sha256()
    for arr in _pieces(value):
        dtype, shape, raw = _host_bytes(arr)
        h.update(dtype.encode())
        h.update(repr(shape).encode())
        h.update(raw)
    return h.hexdigest()


def _floating(arr: Any) -> bool:
    if isinstance(arr, Tensor):
        return arr.is_floating_point()
    if isinstance(arr, HostBF16):
        return True
    dtype = np.asarray(arr).dtype
    return np.issubdtype(dtype, np.floating) or dtype.name == "bfloat16"


def _host_float(arr: Any) -> np.ndarray:
    if isinstance(arr, HostBF16):
        return from_host(arr).float().numpy()
    arr = np.asarray(arr)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def _all_finite(value: Any) -> bool:
    """True when every floating array in the value is fully finite (decided where each array lives)."""
    for arr in _pieces(value):
        if not _floating(arr) or not _numel(arr):
            continue
        if isinstance(arr, Tensor):
            if not bool(torch.isfinite(arr).all()):
                return False
        elif not np.isfinite(_host_float(arr)).all():
            return False
    return True


def _has_nan(value: Any) -> bool:
    for arr in _pieces(value):
        if not _floating(arr) or not _numel(arr):
            continue
        if isinstance(arr, Tensor):
            if bool(torch.isnan(arr).any()):
                return True
        elif np.isnan(_host_float(arr)).any():
            return True
    return False


def _numel(arr: Any) -> int:
    if isinstance(arr, Tensor):
        return arr.numel()
    return int(np.prod(arr.shape))


def attach_integrity(destination: Dict[str, Any], keys: Iterable[str], prefix: str, metric_name: str) -> None:
    """Write the integrity block for the states already serialized in ``destination``."""
    states: Dict[str, Dict[str, Any]] = {}
    for key in keys:
        full = prefix + key
        if full not in destination:
            continue  # non-persistent state: nothing serialized, nothing to cover
        value = destination[full]
        states[key] = {"sha256": _checksum(value), "finite": _all_finite(value)}
    destination[integrity_key(prefix)] = {
        "version": INTEGRITY_VERSION,
        "class": metric_name,
        "states": states,
    }


def validate_version(meta: Dict[str, Any], metric_name: str) -> None:
    """Raise on an unknown integrity-block schema version (nothing can load)."""
    version = meta.get("version")
    if version != INTEGRITY_VERSION:
        raise StateCorruptionError(
            f"Cannot restore {metric_name}: checkpoint integrity block has schema version"
            f" {version!r} but this runtime understands version {INTEGRITY_VERSION}."
            " The checkpoint is from an incompatible writer or its metadata is corrupted."
        )


def verify_states(
    state_dict: Dict[str, Any],
    prefix: str,
    meta: Dict[str, Any],
    metric_name: str,
    include_missing: bool = True,
) -> Dict[str, str]:
    """Verify one metric's states against its integrity block.

    Returns ``{state_name: reason}`` for every corrupted state. Raises
    :class:`StateCorruptionError` on an unknown schema version (a corrupted
    or future block cannot be meaningfully verified, so nothing loads).
    ``include_missing=False`` skips block-covered keys absent from the
    checkpoint — ``load_state_dict(strict=False)``'s tolerate-missing
    contract must keep holding for deliberately filtered checkpoints.
    """
    validate_version(meta, metric_name)
    corrupted: Dict[str, str] = {}
    for key, entry in meta.get("states", {}).items():
        full = prefix + key
        if full not in state_dict:
            if include_missing:
                corrupted[key] = "state covered by the integrity block is missing from the checkpoint"
            continue
        value = state_dict[full]
        if _checksum(value) != entry.get("sha256"):
            corrupted[key] = "checksum mismatch (bytes differ from what was saved)"
        elif entry.get("finite", True) and _has_nan(value):
            # unreachable when the checksum matched, but kept as defense in
            # depth for blocks regenerated by tools that skip finiteness
            corrupted[key] = "NaN values in a state recorded as finite at save time"
    return corrupted


def screen_nonfinite(state_dict: Dict[str, Any], prefix: str, keys: Iterable[str]) -> Dict[str, str]:
    """Best-effort NaN screen for checkpoints without an integrity block.

    Only NaN is flagged (not ±Inf): min/max accumulators legitimately persist
    infinite sentinels, while NaN in any state poisons every downstream
    ``compute``.
    """
    corrupted: Dict[str, str] = {}
    for key in keys:
        full = prefix + key
        if full in state_dict and _has_nan(state_dict[full]):
            corrupted[key] = "NaN values in restored state (checkpoint has no integrity block)"
    return corrupted


def raise_corrupted(metric_name: str, corrupted: Dict[str, str]) -> None:
    detail = "; ".join(f"`{k}`: {v}" for k, v in sorted(corrupted.items()))
    raise StateCorruptionError(
        f"Refusing to restore corrupted state_dict into {metric_name} — {len(corrupted)}"
        f" state(s) failed integrity verification: {detail}. Pass `strict=\"repair\"` to"
        " reset only the corrupted states to their defaults and load the rest.",
        corrupted=corrupted,
    )


# ---------------------------------------------------------------------------
# live-state sentinels (the `nan_policy` update guard)
# ---------------------------------------------------------------------------


def _default_is_finite(default: Any) -> bool:
    if isinstance(default, (list, RingBuffer)):
        return True  # empty containers: treat appended data as finite-by-default
    if not default.is_floating_point() or not default.numel():
        return True
    return bool(torch.isfinite(default).all())


def _state_arrays(value: Any, list_from: int = 0) -> List[Tensor]:
    if isinstance(value, RingBuffer):
        return [value.values()] if value.num_valid else []
    if isinstance(value, list):
        return list(value[list_from:])
    return [value]


def nonfinite_state_report(
    metric: Any, list_scan_from: Optional[Dict[str, int]] = None
) -> Dict[str, str]:
    """``{state_name: "nan"|"inf"}`` over the metric's live states.

    NaN always counts. ±Inf counts only when the state's registered default
    is fully finite — min/max states seeded with ±Inf sentinels are exempt.
    It runs only when a ``nan_policy`` is enabled on the metric.

    One ``aminmax`` a floating array, on the array's own device (NaN
    propagates into both ends, ±Inf shows at an end); the ends of all arrays
    on a device are stacked in float64, which holds every float type's
    values, and read back in one transfer.

    ``list_scan_from`` maps list-state names to the index their scan starts
    at (the pre-update length): append-mode streams then pay per-batch cost
    proportional to the batch, not the whole accumulated history.
    """
    # the finiteness of a default never changes: cache it on the metric
    inf_counts = metric.__dict__.get("_nan_inf_counts")
    if inf_counts is None or inf_counts.keys() != metric._defaults.keys():
        inf_counts = {name: _default_is_finite(d) for name, d in metric._defaults.items()}
        metric.__dict__["_nan_inf_counts"] = inf_counts
    names: List[Tuple[str, Any]] = []
    ends: Dict[Any, List[Tensor]] = {}
    for name in metric._defaults:
        list_from = (list_scan_from or {}).get(name, 0)
        for arr in _state_arrays(getattr(metric, name), list_from):
            if not arr.is_floating_point() or not arr.numel():
                continue
            lo, hi = torch.aminmax(arr.detach())
            ends.setdefault(arr.device, []).append(torch.stack([lo, hi]).to(torch.float64))
            names.append((name, arr.device))
    if not names:
        return {}
    read = {dev: iter(torch.stack(rows).tolist()) for dev, rows in ends.items()}
    report: Dict[str, str] = {}
    for name, dev in names:
        lo, hi = next(read[dev])
        if name in report:
            continue
        if lo != lo or hi != hi:
            report[name] = "nan"
        elif inf_counts[name] and (lo == float("-inf") or hi == float("inf")):
            report[name] = "inf"
    return report
