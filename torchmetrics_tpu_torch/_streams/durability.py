"""Per-stream sharded durability for a :class:`StreamPool`.

Port of ``torchmetrics_tpu/_streams/durability.py``. A pool-level
:class:`~torchmetrics_tpu_torch._resilience.snapshot.SnapshotManager` would
journal every tenant's updates into one undifferentiated log, so one tenant's
restore would replay everyone's records. :class:`StreamSnapshotManager`
extends the manager with stream-keyed journal shards:

- **Tagged frames.** Every journal frame carries the micro-batch's stream
  ids in its header (``<I8sH``: payload length, sha256 prefix, id count;
  then the int32 ids; then the pickled payload), so a per-stream restore
  skips other streams' frames without unpickling them.
- **Full-pool snapshots.** Periodic snapshots capture the whole stacked state
  through the pool's integrity-checksummed ``state_dict`` (its ``#streams``
  block records capacity, active slots and counts), with the base manager's
  atomic rotation, async writer and corruption fallback.
- **Two restore granularities.** ``restore_latest()`` (the base flow)
  rebuilds the whole pool and replays every journal record in order,
  lifecycle records included (attach pops the lowest free slot, a pure
  function of the free set). ``restore_stream(i)`` takes ONE stream's rows
  from the newest verifiable snapshot and replays only the frames tagged
  with stream ``i``: a tenant's recovery costs its own traffic, not the
  pool's.

A replayed frame goes to the pool's device and through the real
``pool.update``, so on the card it replays the captured step.
``restore_stream`` takes no trailing snapshot: restoring tenants one by one
must keep older generations (which hold the other tenants' rows)
restorable. Call ``snapshot_now()`` once the selective restores are done.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from torchmetrics_tpu_torch._observability.state import OBS as _OBS
from torchmetrics_tpu_torch._observability.telemetry import telemetry_for as _telemetry_for
from torchmetrics_tpu_torch._resilience.errors import SnapshotRestoreError
from torchmetrics_tpu_torch._resilience.snapshot import SnapshotManager, _journal_name, _to_device, _to_host

__all__ = ["StreamRestoreReport", "StreamSnapshotManager"]

# stream journal frame header: little-endian u32 payload length + 8-byte
# sha256 prefix + u16 stream-id count; the ids (i32 each) follow the header,
# the pickled payload follows the ids
_SFRAME_HEAD = struct.Struct("<I8sH")


def _row(tree: Any, b: int) -> Any:
    """Row ``b`` of every array leaf of a journaled batch, keeping its leading axis."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_row(x, b) for x in tree)
    if isinstance(tree, dict):
        return {k: _row(v, b) for k, v in tree.items()}
    return tree[b : b + 1] if getattr(tree, "ndim", 0) >= 1 else tree


@dataclass(frozen=True)
class StreamRestoreReport:
    """What a per-stream (or whole-pool) restore actually did."""

    generation: int
    replayed: int
    stream: Optional[int] = None
    skipped: Dict[int, str] = field(default_factory=dict)
    truncated_journal: bool = False

    @property
    def fell_back(self) -> bool:
        return bool(self.skipped) or self.truncated_journal


class StreamSnapshotManager(SnapshotManager):
    """Continuous durability for a :class:`~torchmetrics_tpu_torch._streams.StreamPool`."""

    def __init__(self, pool: Any, *args: Any, **kwargs: Any) -> None:
        from torchmetrics_tpu_torch._streams.pool import StreamPool

        if not isinstance(pool, StreamPool):
            raise ValueError(
                f"StreamSnapshotManager target must be a StreamPool, got {type(pool).__name__};"
                " plain metrics/collections take the base SnapshotManager"
            )
        super().__init__(pool, *args, **kwargs)

    # --------------------------------------------------------------- hot path
    def record(self, target: Any, method: str, args: tuple, kwargs: Dict[str, Any]) -> None:
        raise TypeError(
            "StreamSnapshotManager journals through record_streams/record_lifecycle;"
            " the untagged record() path would produce frames no per-stream restore"
            " can filter"
        )

    def record_streams(self, ids: np.ndarray, args: tuple, kwargs: Dict[str, Any]) -> None:
        """Journal one completed micro-batch update, tagged with its stream ids."""
        if self._paused or self._replaying or self._disabled or self._closed:
            return
        try:
            if self._journal_fh is None:
                # the first journaled record: the base snapshot (taken now,
                # after the update) anchors the chain, as in the base manager
                self.snapshot_now(_inline=True)
                return
            self._write_frame("pool", [int(i) for i in np.asarray(ids).reshape(-1)], args, kwargs)
            if self._snapshot_due():
                self.snapshot_now()
        except Exception as err:  # noqa: BLE001 - durability must never break the stream
            self._disable(err)

    def record_lifecycle(self, kind: str, stream_id: int) -> None:
        """Journal an attach/detach/reset transition (or anchor an external load)."""
        if self._paused or self._replaying or self._disabled or self._closed:
            return
        if self.target._states is None:
            # bookkeeping before the first batch needs no journal entry: the
            # base snapshot (taken at the first update) holds the net
            # active/free/counts in its `#streams` block
            return
        try:
            if self._journal_fh is None or kind == "external":
                # an un-journalable transition (a manual load_state_dict): anchor it
                self.snapshot_now(_inline=True)
                return
            self._write_frame(kind, [int(stream_id)] if stream_id >= 0 else [], (), {})
            if self._snapshot_due():
                self.snapshot_now()
        except Exception as err:  # noqa: BLE001
            self._disable(err)

    def _write_frame(self, method: str, ids: List[int], args: tuple, kwargs: Dict[str, Any]) -> None:
        entry = (method, _to_host(args), _to_host(kwargs))
        blob = pickle.dumps(entry, protocol=pickle.HIGHEST_PROTOCOL)
        head = _SFRAME_HEAD.pack(len(blob), hashlib.sha256(blob).digest()[:8], len(ids))
        self._journal_fh.write(head + np.asarray(ids, dtype="<i4").tobytes() + blob)
        self._journal_fh.flush()
        if self.policy.fsync_journal:
            os.fsync(self._journal_fh.fileno())
        self._journal_len += 1
        self._updates_since += 1
        self.journaled_updates += 1
        if _OBS.enabled:
            telem = _telemetry_for(self.target)
            telem.inc("journal_entries")
            telem.inc("journal_bytes", _SFRAME_HEAD.size + 4 * len(ids) + len(blob))

    # ---------------------------------------------------------- count capture
    # capacity, active slots and counts live in the state's `#streams` block,
    # so the base payload's update_counts field carries nothing extra
    def _capture_counts(self) -> Any:
        return None

    def _restore_counts(self, counts: Any) -> None:
        return None

    def _load_into_target(self, payload: Dict[str, Any]) -> None:
        # no reset first: the pool's load_state_dict adopts the snapshot's
        # capacity, active slots and free-list wholesale
        self.target.load_state_dict(payload["state"], strict=True)

    # ----------------------------------------------------------------- replay
    def _read_journal(self, gen: int) -> Tuple[List[tuple], bool]:
        entries: List[tuple] = []
        raw = (self.directory / _journal_name(gen)).read_bytes()
        pos = 0
        while pos < len(raw):
            if pos + _SFRAME_HEAD.size > len(raw):
                return entries, False  # torn header: crash mid-append
            length, digest8, n_ids = _SFRAME_HEAD.unpack_from(raw, pos)
            pos += _SFRAME_HEAD.size
            ids_bytes = raw[pos : pos + 4 * n_ids]
            if len(ids_bytes) < 4 * n_ids:
                return entries, False
            ids = np.frombuffer(ids_bytes, dtype="<i4").tolist()
            pos += 4 * n_ids
            blob = raw[pos : pos + length]
            if len(blob) < length or hashlib.sha256(blob).digest()[:8] != digest8:
                return entries, False  # torn or corrupted frame
            try:
                method, args, kwargs = pickle.loads(blob)
            except Exception:  # noqa: BLE001 - checksum passed but payload unreadable
                return entries, False
            # the ids ride in the args slot, so the base replay loop's
            # (method, args, kwargs) hands them to _dispatch_replay
            entries.append((method, (ids,) + tuple(args), kwargs))
            pos += length
        return entries, True

    def _dispatch_replay(self, method: str, args: tuple, kwargs: Dict[str, Any]) -> None:
        pool = self.target
        ids = args[0]
        if method == "pool":
            rows, row_kwargs = _to_device(tuple(args[1:]), pool.device), _to_device(kwargs, pool.device)
            pool.update(np.asarray(ids, dtype=np.int64), *rows, **row_kwargs)
        elif method == "attach":
            got = pool.attach()
            if got != ids[0]:
                raise SnapshotRestoreError(
                    f"journal replay diverged: attach() handed out slot {got}, the journal"
                    f" recorded {ids[0]} (corrupted or reordered journal chain)"
                )
        elif method == "detach":
            pool.detach(ids[0])
        elif method == "reset":
            pool.reset(ids[0])
        elif method == "reset_all":
            pool.reset()
        else:
            raise SnapshotRestoreError(f"unknown journal record kind {method!r}")

    # ------------------------------------------------------ per-stream restore
    def restore_stream(self, stream_id: int) -> StreamRestoreReport:
        """Restore ONE stream: its snapshot rows and only its journal segment.

        Walks the generations newest-first like ``restore_latest``, but loads
        only stream ``stream_id``'s rows and replays only the journal frames
        whose header tags include that stream. The slot must already be
        attached in the live pool. No trailing snapshot is taken (see the
        module docstring).
        """
        from torchmetrics_tpu_torch._resilience import integrity as _integrity

        sid = int(stream_id)
        pool = self.target
        pool._check_slot(sid, attached=True)
        gens = sorted(self._generations_on_disk(), reverse=True)
        skipped: Dict[int, str] = {}
        loaded: Optional[int] = None
        payload: Optional[Dict[str, Any]] = None
        for gen in gens:
            try:
                payload = self._read_snapshot(gen)
                state = payload["state"]
                meta = state.get(_integrity.integrity_key(""))
                if meta is not None:
                    corrupted = _integrity.verify_states(state, "", meta, type(pool).__name__, include_missing=True)
                    if corrupted:
                        _integrity.raise_corrupted(type(pool).__name__, corrupted)
            except Exception as err:  # noqa: BLE001 - fall back one generation
                skipped[gen] = f"{type(err).__name__}: {err}"
                continue
            loaded = gen
            break
        if loaded is None:
            raise SnapshotRestoreError(
                f"no restorable snapshot generation in {self.directory}"
                + (f" — {len(skipped)} generation(s) failed verification: {skipped}" if skipped else ""),
                failures=skipped,
            )
        state = payload["state"]
        blk = state["#streams"]
        self._replaying = True
        try:
            pool.ensure_ready_from_snapshot(blk, state)
            if sid < int(blk["capacity"]) and sid in set(int(i) for i in blk["active"]):
                rows = {
                    k: v[sid] for k, v in state.items() if not k.startswith("#") and not k.endswith("#integrity")
                }
                pool.load_stream_state(sid, rows, int(np.asarray(blk["counts"])[sid]))
            else:
                # the stream did not exist (or was detached) at this boundary:
                # it starts from the defaults and its journal segment carries
                # its whole history
                pool.reset(sid)
            replayed, truncated = self._replay_stream_journals(loaded, sid)
        finally:
            self._replaying = False
        report = StreamRestoreReport(
            generation=loaded, replayed=replayed, stream=sid, skipped=dict(skipped), truncated_journal=truncated
        )
        if _OBS.enabled:
            telem = _telemetry_for(pool)
            telem.inc(f"restores|outcome={'fallback' if report.fell_back else 'ok'}")
            if replayed:
                telem.inc("restore_replayed_updates", replayed)
        return report

    def _replay_stream_journals(self, start_gen: int, sid: int) -> Tuple[int, bool]:
        replayed = 0
        truncated = False
        pool = self.target
        gen = start_gen
        while (self.directory / _journal_name(gen)).exists():
            entries, clean = self._read_journal(gen)
            for method, args, kwargs in entries:
                ids = args[0]
                if method == "reset_all":
                    # a whole-pool reset touches every stream, tagged or not
                    pool.reset(sid)
                    replayed += 1
                    continue
                if sid not in ids:
                    continue
                if method == "pool":
                    b = ids.index(sid)
                    self._dispatch_replay("pool", ([sid],) + _row(tuple(args[1:]), b), _row(kwargs, b))
                else:
                    # tenant boundaries and resets both zero the slot; the
                    # replay keeps only the records after the last boundary
                    pool.reset(sid)
                replayed += 1
            if not clean:
                truncated = True
                break
            gen += 1
        return replayed, truncated
