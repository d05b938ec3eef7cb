"""Fleet wire payloads: integrity-checked metric state as the transport format.

Port of ``torchmetrics_tpu/_fleet/wire.py``. One contribution = one metric's
per-epoch state delta, serialized as

.. code-block:: text

    TMFLEET1\\n                  magic
    <32-byte sha256(payload)>    outer checksum (transport corruption fence)
    <payload>                    pickled contribution record

The pickled record carries the states as
``Metric.state_dict(integrity=True, all_states=True, _host=True)`` produced
them, including the per-state ``#integrity`` block, plus the epoch fence
coordinates (``node``, ``epoch``), the update count the merge operator needs
for correct mean weighting, and leaf-level *provenance* (which
``(leaf, epoch)`` deltas were folded into this contribution).

The states on the wire are host values only: numpy arrays, and
:class:`~torchmetrics_tpu_torch._resilience.integrity.HostBF16` for a
bfloat16 state. ``state_dict`` without ``_host`` gives detached device
clones; a pickled CUDA tensor would make the payload decodable only where
CUDA is, and its bytes would never pass through the host where the checksum
is taken. The JAX package's ``state_dict`` is host numpy by nature, so a
float32 contribution of either package decodes and folds in the other.

Two independent verification layers per hop, by design:

1. the **outer checksum** rejects transport-mangled bytes before pickle
   ever runs (a bit-flipped pickle stream can raise anything, or load);
2. the **integrity block** travels inside and is re-verified at *fold*
   time through ``load_state_dict(strict="repair")`` on a scratch clone: a
   corrupt state quarantines the whole contribution instead of folding a
   silently-repaired (wrong) value into the rollup.
"""

from __future__ import annotations

import hashlib
import pickle
import time
from dataclasses import dataclass
from typing import Any, Dict, Tuple

__all__ = [
    "WIRE_VERSION",
    "WIRE_MAGIC",
    "Contribution",
    "encode_contribution",
    "decode_contribution",
    "CorruptContribution",
]

WIRE_VERSION = 1
WIRE_MAGIC = b"TMFLEET1\n"
_SHA_BYTES = 32


class CorruptContribution(ValueError):
    """A contribution failed outer-envelope verification (quarantine, don't fold)."""


@dataclass(frozen=True)
class Contribution:
    """One decoded, envelope-verified contribution (integrity block unverified yet)."""

    node: str
    epoch: int
    count: int
    metric_class: str
    states: Dict[str, Any]
    sources: Tuple[Tuple[str, int], ...]
    published_at: float
    digest: str

    @property
    def age_ms(self) -> float:
        return max(0.0, (time.time() - self.published_at) * 1000.0)


def encode_contribution(
    metric: Any,
    node: str,
    epoch: int,
    sources: Tuple[Tuple[str, int], ...],
) -> Tuple[bytes, str]:
    """Serialize one metric's current state as a wire contribution.

    Returns ``(blob, digest)`` where ``digest`` is the state-digest component
    of the contribution key: sha256 over the payload, so two different states
    for the same ``(node, epoch)`` (a zombie's stale replay vs the live
    replica) can never collide onto one key. The states are copied to the
    host here, on the caller's thread: one device-to-host copy a state.
    """
    record = {
        "version": WIRE_VERSION,
        "node": str(node),
        "epoch": int(epoch),
        "count": int(metric._update_count),
        "class": type(metric).__name__,
        "states": metric.state_dict(integrity=True, all_states=True, _host=True),
        "sources": tuple((str(n), int(e)) for n, e in sources),
        "published_at": time.time(),
    }
    payload = pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
    sha = hashlib.sha256(payload).digest()
    return WIRE_MAGIC + sha + payload, sha.hex()[:16]


def decode_contribution(blob: bytes) -> Contribution:
    """Verify the outer envelope and unpickle; raise :class:`CorruptContribution`.

    The checksum is verified BEFORE pickle touches the payload: a corrupt
    pickle stream fails unpredictably, and the quarantine path needs one
    deterministic, attributable error per corrupt payload.
    """
    if not blob.startswith(WIRE_MAGIC):
        raise CorruptContribution("bad magic (not a fleet contribution)")
    body = blob[len(WIRE_MAGIC):]
    if len(body) < _SHA_BYTES:
        raise CorruptContribution("truncated envelope (missing checksum)")
    sha, payload = body[:_SHA_BYTES], body[_SHA_BYTES:]
    if hashlib.sha256(payload).digest() != sha:
        raise CorruptContribution("payload checksum mismatch (corrupt in transit)")
    try:
        record = pickle.loads(payload)
    except Exception as err:  # noqa: BLE001 - checksum passed but content unloadable
        raise CorruptContribution(f"payload unpicklable: {type(err).__name__}: {err}") from err
    if not isinstance(record, dict) or record.get("version") != WIRE_VERSION:
        raise CorruptContribution(
            f"unsupported wire version {record.get('version') if isinstance(record, dict) else '?'}"
        )
    try:
        return Contribution(
            node=str(record["node"]),
            epoch=int(record["epoch"]),
            count=int(record["count"]),
            metric_class=str(record["class"]),
            states=dict(record["states"]),
            sources=tuple((str(n), int(e)) for n, e in record["sources"]),
            published_at=float(record["published_at"]),
            digest=sha.hex()[:16],
        )
    except (KeyError, TypeError, ValueError) as err:
        raise CorruptContribution(f"malformed contribution record: {err}") from err
