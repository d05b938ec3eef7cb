"""Preemption-safe metric snapshots: continuous durability for accumulated state.

Port of ``torchmetrics_tpu/_resilience/snapshot.py``, with its on-disk
format: the ``TMSNAP1`` magic and a whole-file sha256 in ``snap-%08d.ckpt``,
``<I8s``-framed ``journal-%08d.log`` entries, and pickles of host numpy
only (no tensor is pickled), so either package restores the other's
directory. The capture (the device-to-host copies) runs on the calling
thread; the writer thread only writes, fsyncs and renames bytes. A replayed
batch goes back to the target's device and through its real ``update``
(the compiled route included).

A preemption or process crash between manual ``state_dict()`` calls
vaporizes every accumulated batch since the last save — on a long eval
stream that silently restarts an epoch's worth of accumulation. The
:class:`SnapshotManager` closes that gap with two cooperating pieces:

1. **Periodic snapshots** — every N journaled updates and/or T seconds
   (evaluated at update boundaries), the target's full state is serialized
   through the integrity path (``state_dict(integrity=True, all_states=True)``
   — per-state sha256 + finiteness) and written with an atomic
   write-temp → fsync → rename rotation, keeping the last K generations.
   With ``async_write`` (default) the state is *captured* inline — a
   consistent host copy on the caller's thread — and the IO runs on a
   background daemon writer.
2. **A bounded post-snapshot update journal** — every completed
   ``update()``/``forward()`` (eager or auto-compiled) appends one framed,
   checksummed entry (the host-copied batch arguments) to the current
   generation's journal, flushed per entry so it survives process death.
   When the journal reaches its bound, a snapshot rolls it. The hook is
   inline on the hot path — one attribute probe when no manager is
   attached.

``restore_latest()`` walks generations newest-first, verifies the file-level
checksum and the per-state integrity block, falls back to the previous
generation on any corruption, then replays the journal *chain* from the
loaded generation forward — so a crash that outran an in-flight async
snapshot write loses nothing, and a clean restore loses at most the one
batch that was in flight when the process died. Restore is idempotent:
it ends by writing a fresh snapshot of the restored state, so repeating it
(or crashing again immediately) converges to the same state.

The journal records *arguments*, not states: replay re-runs the real
``update()`` path, so NaN quarantine, validation, and every other update
guard behave identically on replay — restored state is bit-identical to a
run that never crashed.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import queue
import re
import struct
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch._observability import tracing as _obs_trace
from torchmetrics_tpu_torch._observability.events import BUS as _BUS
from torchmetrics_tpu_torch._observability.state import OBS as _OBS
from torchmetrics_tpu_torch._observability.telemetry import telemetry_for as _telemetry_for
from torchmetrics_tpu_torch._resilience.errors import SnapshotRestoreError
from torchmetrics_tpu_torch._resilience.integrity import HostBF16, from_host, to_host
from torchmetrics_tpu_torch._resilience.policy import SnapshotPolicy
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn
from torchmetrics_tpu_torch.utilities.ringbuffer import RingBuffer

__all__ = ["SNAPSHOT_VERSION", "SnapshotManager", "RestoreReport"]

SNAPSHOT_VERSION = 1

_MAGIC = b"TMSNAP1\n"
_SNAP_RE = re.compile(r"^snap-(\d{8})\.ckpt$")
_JOURNAL_RE = re.compile(r"^journal-(\d{8})\.log$")
# journal frame header: little-endian uint32 payload length + 8-byte sha256 prefix
_FRAME_HEAD = struct.Struct("<I8s")


def _snap_name(gen: int) -> str:
    return f"snap-{gen:08d}.ckpt"


def _journal_name(gen: int) -> str:
    return f"journal-{gen:08d}.log"


def _to_host(tree: Any) -> Any:
    """Host-numpy copy of every tensor leaf (device buffers must not be pickled)."""
    if isinstance(tree, torch.Tensor):
        return to_host(tree)
    if isinstance(tree, RingBuffer):
        return to_host(tree.values())
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def _to_device(tree: Any, device: Any) -> Any:
    """A journaled batch back on ``device``: every host array leaf becomes a tensor there."""
    if isinstance(tree, (np.ndarray, HostBF16)):
        return from_host(tree, device)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree


def _fsync_dir(directory: Path) -> None:
    """Best-effort directory fsync so a rename survives a machine crash."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _is_collection(target: Any) -> bool:
    from torchmetrics_tpu_torch.collections import MetricCollection

    return isinstance(target, MetricCollection)


def _target_device(target: Any) -> Any:
    """The device a replayed batch goes to: the metric's, or a collection's first member's."""
    if _is_collection(target):
        return next((m.device for m in target._modules.values()), None)
    return target.device


@dataclass(frozen=True)
class RestoreReport:
    """What ``restore_latest`` actually did (assertable in tests/harnesses).

    ``generation`` is the snapshot generation that loaded; ``skipped``
    maps newer generations that failed verification to the reason they were
    rejected; ``replayed`` counts journal entries re-applied on top of the
    snapshot; ``truncated_journal`` is True when replay stopped at a
    corrupt/short journal frame (everything before the bad frame was
    replayed).
    """

    generation: int
    replayed: int
    skipped: Dict[int, str] = field(default_factory=dict)
    truncated_journal: bool = False

    @property
    def fell_back(self) -> bool:
        return bool(self.skipped) or self.truncated_journal


class _Writer:
    """Daemon writer executing snapshot IO jobs off the caller's thread.

    One plain queue-fed thread (same shape as the guarded-sync worker): a
    ``ThreadPoolExecutor`` would hang interpreter exit on its atexit join,
    and snapshot IO must never block process teardown. Jobs are thunks;
    a failing job records ``last_error`` for the manager to surface.
    """

    def __init__(self) -> None:
        self._jobs: "queue.Queue[Optional[Any]]" = queue.Queue()
        self.last_error: Optional[BaseException] = None
        self._abandoned = False
        # shutdown-ordering contract: once the None sentinel is queued the
        # loop thread exits, so a later submit() would enqueue a job NOBODY
        # ever runs (silent durability loss) and a later drain()'s barrier
        # event would never be set (a full-timeout stall on every flush()
        # after close()). `_closed` makes both misuses loud/cheap instead;
        # `_gate` orders the flag check against the sentinel put, so a
        # submit racing a concurrent close can never slip a job in BEHIND
        # the loop-exit sentinel (the one silent-drop window a bare flag
        # would leave open).
        self._closed = False
        self._gate = threading.Lock()
        self._thread = threading.Thread(target=self._loop, name="tm-tpu-snapshot-writer", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            if self._abandoned:
                continue
            try:
                job()
            except BaseException as err:  # noqa: BLE001 - surfaced via last_error
                self.last_error = err

    def submit(self, job: Any) -> None:
        with self._gate:
            if self._closed:
                raise RuntimeError("snapshot writer is closed; job refused (would never run)")
            self._jobs.put(job)

    def drain(self, timeout: float = 30.0) -> None:
        """Block until every queued job ran (barrier job + event)."""
        done = threading.Event()
        with self._gate:
            if self._closed:
                # close() queued the loop-exit sentinel (and already joined):
                # a barrier event enqueued behind it could never fire, and no
                # job can have been accepted since — return instead of stalling
                return
            self._jobs.put(done.set)
        done.wait(timeout)

    def close(self, timeout: float = 30.0) -> None:
        """Idempotent: stop accepting jobs, stop the loop, join the thread."""
        with self._gate:
            if not self._closed:
                self._closed = True
                self._jobs.put(None)
        self._thread.join(timeout)

    def abandon(self) -> None:
        """Drop queued jobs (simulated preemption: writes die with the process)."""
        with self._gate:
            self._closed = True
            self._abandoned = True
            try:
                while True:
                    self._jobs.get_nowait()
            except queue.Empty:
                pass
            self._jobs.put(None)


class SnapshotManager:
    """Continuous, automatic durability for one metric or collection.

    Attaching installs the update-journal hook on the target; every
    completed update is journaled and snapshots are taken per the
    :class:`~torchmetrics_tpu_torch._resilience.policy.SnapshotPolicy`. The
    manager degrades instead of breaking the stream: any IO error disables
    it, warns, and records a ``snapshot_degraded`` event — metric updates
    keep flowing.

    >>> import tempfile
    >>> import torch
    >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
    >>> from torchmetrics_tpu_torch._resilience import SnapshotManager, SnapshotPolicy
    >>> d = tempfile.mkdtemp()
    >>> metric = MeanSquaredError(device="cpu")
    >>> mgr = SnapshotManager(metric, d, SnapshotPolicy(every_n_updates=2, async_write=False))
    >>> for i in range(5):
    ...     metric.update(torch.ones(4) * i, torch.zeros(4))
    >>> fresh = MeanSquaredError(device="cpu")
    >>> mgr2 = SnapshotManager(fresh, d, SnapshotPolicy(async_write=False))
    >>> report = mgr2.restore_latest()
    >>> bool(torch.allclose(fresh.compute(), metric.compute()))
    True
    >>> mgr.close(); mgr2.close()
    """

    def __init__(
        self,
        target: Any,
        directory: Union[str, Path],
        policy: Optional[SnapshotPolicy] = None,
        clock: Any = time.monotonic,
    ) -> None:
        if not (_is_collection(target) or hasattr(target, "_defaults")):
            raise ValueError(
                f"SnapshotManager target must be a Metric or MetricCollection, got {type(target).__name__}"
            )
        self.target = target
        self.policy = policy if policy is not None else SnapshotPolicy()
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self._clock = clock
        self._is_collection = _is_collection(target)
        existing = self._generations_on_disk()
        journal_gens = self._journal_generations_on_disk()
        self._next_gen = max(existing + journal_gens, default=-1) + 1
        self._journal_fh: Optional[Any] = None
        self._journal_len = 0
        self._updates_since = 0
        self._last_snap_time = self._clock()
        self._paused = False
        self._replaying = False
        self._disabled = False
        self._closed = False
        self.last_error: Optional[BaseException] = None
        # total journaled updates / snapshots taken, for telemetry + tests
        self.journaled_updates = 0
        self.snapshots_taken = 0
        # validate + attach BEFORE spawning the writer thread: a rejected
        # construction (double-attach) must not leak a parked daemon thread
        self._writer: Optional[_Writer] = None
        self._attach()
        try:
            self._writer = _Writer() if self.policy.async_write else None
        except BaseException:
            self.detach()
            raise

    # ------------------------------------------------------------- lifecycle
    def _attach(self) -> None:
        prior = self.target.__dict__.get("_snapshot_hook")
        if prior is not None and prior is not self and not prior._closed:
            raise ValueError(
                "target already has an active SnapshotManager attached; close() it first"
                " (one journal stream per target — two managers would double-journal)"
            )
        object.__setattr__(self.target, "_snapshot_hook", self)

    def detach(self) -> None:
        if self.target.__dict__.get("_snapshot_hook") is self:
            object.__setattr__(self.target, "_snapshot_hook", None)

    def close(self) -> None:
        """Detach, flush pending writes, close the journal. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.detach()
        if self._writer is not None:
            self._writer.drain()
            self._writer.close()
            if self._writer.last_error is not None:
                self.last_error = self._writer.last_error
        if self._journal_fh is not None:
            try:
                self._journal_fh.close()
            except OSError:
                pass
            self._journal_fh = None

    def simulate_preemption(self) -> None:
        """Die like a preempted process: no final snapshot, no graceful flush.

        Queued async snapshot writes are dropped (a killed process never
        finishes them), the journal file handle is abandoned as-is (entries
        already flushed per-entry survive, exactly like OS-buffered writes
        of a killed process), and the hook detaches. The on-disk state is
        then what a real SIGKILL would have left; pair with a fresh target +
        manager + :meth:`restore_latest` to model the full kill/restore
        cycle. Test/chaos-harness API — production code never calls this.
        """
        self._closed = True
        self.detach()
        if self._writer is not None:
            self._writer.abandon()
        if self._journal_fh is not None:
            try:
                self._journal_fh.close()  # per-entry flush already persisted the frames
            except OSError:
                pass
            self._journal_fh = None

    def __enter__(self) -> "SnapshotManager":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __reduce__(self):
        # a manager holds threads and file handles: cloned/pickled metrics
        # travel without their hook (re-attach a manager at the destination)
        return (_none, ())

    # ------------------------------------------------------------ properties
    @property
    def generation(self) -> int:
        """Generation of the most recently *started* snapshot (-1 before any)."""
        return self._next_gen - 1

    @property
    def has_snapshots(self) -> bool:
        return bool(self._generations_on_disk())

    @property
    def journal_len(self) -> int:
        return self._journal_len

    def flush(self) -> None:
        """Block until every queued async snapshot write (and prune) landed."""
        if self._writer is not None:
            self._writer.drain()

    def pause(self) -> None:
        """Stop journaling/snapshotting until :meth:`resume` (hook stays attached)."""
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    # -------------------------------------------------------------- hot path
    def record(self, target: Any, method: str, args: tuple, kwargs: Dict[str, Any]) -> None:
        """Journal one completed update; trigger a snapshot when due.

        Called by the target's update hook *after* the state transition
        committed, so a crash mid-update never journals the half-applied
        batch — restore then loses exactly that in-flight batch and nothing
        else. Never raises: IO failures disable the manager and degrade.
        """
        if self._paused or self._replaying or self._disabled or self._closed:
            return
        try:
            if self._journal_fh is None:
                # first journaled update of this manager's life: the base
                # snapshot (taken now, post-update) already covers it. It is
                # written SYNCHRONOUSLY even under async_write — it anchors
                # the whole journal chain, so with it on disk every later
                # crash (even one that drops all pending async writes) can
                # still restore base + journals with zero loss
                self.snapshot_now(_inline=True)
                return
            if method == "external":
                # un-journalable transition (manual mid-stream load_state_dict):
                # update entries can't reconstruct it, so anchor the new state
                # with an immediate synchronous snapshot — the chain stays
                # gap-free and later updates journal against the new generation
                self.snapshot_now(_inline=True)
                return
            entry = (method, _to_host(args), _to_host(kwargs))
            blob = pickle.dumps(entry, protocol=pickle.HIGHEST_PROTOCOL)
            self._journal_fh.write(_FRAME_HEAD.pack(len(blob), hashlib.sha256(blob).digest()[:8]) + blob)
            self._journal_fh.flush()
            if self.policy.fsync_journal:
                os.fsync(self._journal_fh.fileno())
            self._journal_len += 1
            self._updates_since += 1
            self.journaled_updates += 1
            if _OBS.enabled:
                telem = _telemetry_for(self.target)
                telem.inc("journal_entries")
                telem.inc("journal_bytes", _FRAME_HEAD.size + len(blob))
            if self._snapshot_due():
                self.snapshot_now()
        except Exception as err:  # noqa: BLE001 - durability must never break the stream
            self._disable(err)

    def note_update(self, n: int = 1) -> None:
        """Count ``n`` completed *opaque* updates without journaling them.

        The SPMD engine's donated device states cannot be arg-journaled per
        step — the batch lives sharded on-device, and a host copy per step
        would reintroduce exactly the round-trip the fused path removes. The
        engine reports step boundaries here instead: snapshots still fire
        per policy (captured as host copies through the
        engine's ``state_dict``), and a restore returns to the newest
        snapshot boundary, losing at most the steps since it — the
        documented durability trade of the in-graph path.
        """
        if self._paused or self._replaying or self._disabled or self._closed:
            return
        try:
            if self._journal_fh is None:
                # first boundary: anchor the chain with a synchronous base
                # snapshot, same contract as the first journaled update
                self.snapshot_now(_inline=True)
                return
            self._updates_since += n
            if self._snapshot_due():
                self.snapshot_now()
        except Exception as err:  # noqa: BLE001 - durability must never break the stream
            self._disable(err)

    def _snapshot_due(self) -> bool:
        p = self.policy
        if self._journal_len >= p.journal_max_entries:
            return True
        if p.every_n_updates is not None and self._updates_since >= p.every_n_updates:
            return True
        if p.every_seconds is not None and self._clock() - self._last_snap_time >= p.every_seconds:
            return True
        return False

    # ------------------------------------------------------------- snapshots
    def snapshot_now(self, _inline: bool = False) -> int:
        """Capture state inline, rotate the journal, write (async by default).

        Returns the new generation number. The journal rotates *immediately*
        (subsequent updates journal against the new generation), so even if
        the async write never lands — crash, preemption — the restore chain
        is gap-free: the previous generation's snapshot plus both journals
        reconstruct the same state.
        """
        if self._closed:
            # refuse BEFORE rotating: rotating first would open a journal fd
            # close() can never reach (it already ran) and advance the
            # generation for a snapshot the dead writer will never write
            raise RuntimeError("SnapshotManager is closed; snapshot refused")
        gen = self._next_gen
        self._next_gen += 1
        _sp = None
        if _OBS.tracing:
            # the span covers capture + rotation + (inline) write; an async
            # write's disk time lands on the writer thread, outside the
            # request — exactly the cost the caller actually paid
            _sp = _obs_trace.begin_span(
                "snapshot.write", type(self.target).__name__, generation=gen, inline=bool(_inline)
            )
        _sp_err: Optional[BaseException] = None
        try:
            return self._snapshot_now_impl(gen, _inline)
        except BaseException as err:
            _sp_err = err
            raise
        finally:
            if _sp is not None:
                _obs_trace.end_span(_sp, _sp_err)

    def _snapshot_now_impl(self, gen: int, _inline: bool) -> int:
        payload = {
            "version": SNAPSHOT_VERSION,
            "kind": "collection" if self._is_collection else "metric",
            "class": type(self.target).__name__,
            "generation": gen,
            "update_counts": self._capture_counts(),
            "state": self._capture_state(),
            "saved_at": time.time(),
        }
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        digest = hashlib.sha256(blob).digest()
        if self._journal_fh is not None:
            try:
                self._journal_fh.close()
            except OSError:
                pass
        self._journal_fh = open(self.directory / _journal_name(gen), "ab")
        self._journal_len = 0
        self._updates_since = 0
        self._last_snap_time = self._clock()
        job = _SnapshotWriteJob(self.directory, gen, digest, blob, self.policy.keep)
        if self._writer is not None and not _inline:
            self._writer.submit(job)
            if self._writer.last_error is not None:
                err, self._writer.last_error = self._writer.last_error, None
                raise err
        else:
            job()
        self.snapshots_taken += 1
        if _OBS.enabled:
            telem = _telemetry_for(self.target)
            telem.inc("snapshot_writes")
            telem.inc("snapshot_bytes", len(_MAGIC) + len(digest) + len(blob))
            _BUS.publish(
                "snapshot_write", type(self.target).__name__,
                f"generation {gen} ({len(blob)} payload bytes)",
                data={"generation": gen, "bytes": len(blob)},
            )
        return gen

    def _capture_state(self) -> Dict[str, Any]:
        # Metric and MetricCollection share the kwarg surface here: full
        # integrity-checksummed host serialization of EVERY state (snapshots
        # must cover non-persistent states too — durability is not the same
        # contract as checkpoint portability). `_host`: each state crosses to
        # the host once, and its digest is taken from that copy
        return self.target.state_dict(integrity=True, all_states=True, _host=True)

    def _capture_counts(self) -> Any:
        if self._is_collection:
            return {name: m._update_count for name, m in self.target._modules.items()}
        return self.target._update_count

    def _restore_counts(self, counts: Any) -> None:
        if self._is_collection:
            for name, m in self.target._modules.items():
                m._update_count = int(counts.get(name, 0))
        else:
            self.target._update_count = int(counts)

    # --------------------------------------------------------------- restore
    def restore_latest(self) -> RestoreReport:
        """Restore the newest verifiable generation + replay its journal chain.

        Walks snapshot generations newest-first; a generation whose file
        checksum, pickle payload, or per-state integrity block fails is
        skipped (reason recorded) and the previous one is tried. After a
        successful load, every journal from the loaded generation forward is
        replayed in order through the real update path; a corrupt or
        truncated journal frame stops replay at the last good entry. Ends by
        taking a fresh snapshot of the restored state, making the whole
        operation idempotent. Raises :class:`SnapshotRestoreError` when no
        generation is restorable.
        """
        _sp = (
            _obs_trace.begin_span("snapshot.restore", type(self.target).__name__)
            if _OBS.tracing
            else None
        )
        _sp_err: Optional[BaseException] = None
        try:
            report = self._restore_latest_impl()
            if _sp is not None:
                _sp.attrs["generation"] = report.generation
                _sp.attrs["replayed"] = report.replayed
            return report
        except BaseException as err:
            _sp_err = err
            raise
        finally:
            if _sp is not None:
                _obs_trace.end_span(_sp, _sp_err)

    def _restore_latest_impl(self) -> RestoreReport:
        gens = sorted(self._generations_on_disk(), reverse=True)
        skipped: Dict[int, str] = {}
        loaded: Optional[int] = None
        counts: Any = None
        # a failed load attempt has already reset the live target, so a total
        # failure must put the accumulated state back before raising
        pre_counts = self._capture_counts()
        try:
            pre_state: Optional[Dict[str, Any]] = self._capture_state()
        except Exception:  # noqa: BLE001 - unstashable state just loses the rollback
            pre_state = None
        # _replaying also covers the target.reset() inside _load_into_target:
        # restore's own resets are mechanics, not stream transitions — they
        # must never be journaled (a journaled one would break idempotence)
        self._replaying = True
        try:
            for gen in gens:
                try:
                    payload = self._read_snapshot(gen)
                    self._load_into_target(payload)
                except Exception as err:  # noqa: BLE001 - every reason falls back one generation
                    skipped[gen] = f"{type(err).__name__}: {err}"
                    continue
                loaded = gen
                counts = payload["update_counts"]
                break
        finally:
            self._replaying = False
        if loaded is None:
            if pre_state is not None:
                self._replaying = True
                try:
                    self._load_into_target({"state": pre_state})
                    self._restore_counts(pre_counts)
                except Exception:  # noqa: BLE001 - never mask the restore error
                    pass
                finally:
                    self._replaying = False
            if _OBS.enabled:
                _telemetry_for(self.target).inc("restores|outcome=failed")
                _BUS.publish(
                    "snapshot_restore", type(self.target).__name__,
                    f"restore failed: {len(skipped)} generation(s) rejected",
                    data={"outcome": "failed", "skipped": {str(k): v for k, v in skipped.items()}},
                )
            raise SnapshotRestoreError(
                f"no restorable snapshot generation in {self.directory}"
                + (f" — {len(skipped)} generation(s) failed verification: {skipped}" if skipped else ""),
                failures=skipped,
            )
        self._restore_counts(counts)
        replayed, truncated = self._replay_journals(loaded)
        report = RestoreReport(
            generation=loaded, replayed=replayed, skipped=dict(skipped), truncated_journal=truncated
        )
        if _OBS.enabled:
            telem = _telemetry_for(self.target)
            telem.inc(f"restores|outcome={'fallback' if report.fell_back else 'ok'}")
            if replayed:
                telem.inc("restore_replayed_updates", replayed)
            _BUS.publish(
                "snapshot_restore", type(self.target).__name__,
                f"restored generation {loaded}, replayed {replayed} journaled update(s)"
                + (" (fell back past corruption)" if report.fell_back else ""),
                data={"outcome": "fallback" if report.fell_back else "ok",
                      "generation": loaded, "replayed": replayed},
            )
        if report.fell_back:
            self._record_degradation(
                "snapshot_restore",
                f"restored generation {loaded} (skipped: {skipped or 'none'};"
                f" journal truncated: {truncated}); replayed {replayed} journaled update(s)",
            )
        # re-arm durability on the restored state: the next crash restores to
        # exactly here, and restore_latest() is idempotent by construction.
        # The restore itself already succeeded — an IO failure here degrades
        # (same contract as record()) instead of masking the good report
        if not self._closed and not self._disabled:
            try:
                self.snapshot_now()
            except Exception as err:  # noqa: BLE001 - durability must never break a done restore
                self._disable(err)
        return report

    def _read_snapshot(self, gen: int) -> Dict[str, Any]:
        raw = (self.directory / _snap_name(gen)).read_bytes()
        if not raw.startswith(_MAGIC):
            raise SnapshotRestoreError(f"generation {gen}: bad magic (not a snapshot file)")
        digest, blob = raw[len(_MAGIC) : len(_MAGIC) + 32], raw[len(_MAGIC) + 32 :]
        if hashlib.sha256(blob).digest() != digest:
            raise SnapshotRestoreError(f"generation {gen}: file checksum mismatch (corrupted on disk)")
        payload = pickle.loads(blob)
        if payload.get("version") != SNAPSHOT_VERSION:
            raise SnapshotRestoreError(
                f"generation {gen}: snapshot schema version {payload.get('version')!r}"
                f" unsupported (this runtime understands {SNAPSHOT_VERSION})"
            )
        want = "collection" if self._is_collection else "metric"
        if payload.get("kind") != want:
            raise SnapshotRestoreError(
                f"generation {gen}: snapshot holds a {payload.get('kind')}, target is a {want}"
            )
        cls = type(self.target).__name__
        if payload.get("class") != cls:
            raise SnapshotRestoreError(
                f"generation {gen}: snapshot of {payload.get('class')!r}, target is a {cls!r}"
            )
        return payload

    def _load_into_target(self, payload: Dict[str, Any]) -> None:
        self.target.reset()
        # strict=True: the integrity block written at capture time verifies
        # every state's checksum before anything binds
        self.target.load_state_dict(payload["state"], strict=True)

    def _replay_journals(self, start_gen: int) -> Tuple[int, bool]:
        replayed = 0
        truncated = False
        self._replaying = True
        try:
            gen = start_gen
            while (self.directory / _journal_name(gen)).exists():
                entries, clean = self._read_journal(gen)
                for method, args, kwargs in entries:
                    self._dispatch_replay(method, args, kwargs)
                    replayed += 1
                if not clean:
                    # a gap in the chain: later journals' entries would be
                    # applied out of order, so replay must stop here
                    truncated = True
                    break
                gen += 1
        finally:
            self._replaying = False
        return replayed, truncated

    def _dispatch_replay(self, method: str, args: tuple, kwargs: Dict[str, Any]) -> None:
        device = _target_device(self.target)
        args, kwargs = _to_device(args, device), _to_device(kwargs, device)
        if method == "scan":
            self.target.scan_update(*args, **kwargs)
        elif method == "reset":
            self.target.reset()
        elif method == "merge":
            self.target._merge_from(*args)
        else:
            self.target.update(*args, **kwargs)

    def _read_journal(self, gen: int) -> Tuple[List[tuple], bool]:
        entries: List[tuple] = []
        raw = (self.directory / _journal_name(gen)).read_bytes()
        pos = 0
        while pos < len(raw):
            if pos + _FRAME_HEAD.size > len(raw):
                return entries, False  # torn header: crash mid-append
            length, digest8 = _FRAME_HEAD.unpack_from(raw, pos)
            pos += _FRAME_HEAD.size
            blob = raw[pos : pos + length]
            if len(blob) < length or hashlib.sha256(blob).digest()[:8] != digest8:
                return entries, False  # torn or corrupted frame
            try:
                entries.append(pickle.loads(blob))
            except Exception:  # noqa: BLE001 - checksum passed but payload unreadable
                return entries, False
            pos += length
        return entries, True

    # ------------------------------------------------------------- internals
    def _generations_on_disk(self) -> List[int]:
        out = []
        for p in self.directory.iterdir() if self.directory.exists() else ():
            m = _SNAP_RE.match(p.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _journal_generations_on_disk(self) -> List[int]:
        out = []
        for p in self.directory.iterdir() if self.directory.exists() else ():
            m = _JOURNAL_RE.match(p.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _disable(self, err: BaseException) -> None:
        self._disabled = True
        self.last_error = err
        self._record_degradation(
            "snapshot_degraded",
            f"SnapshotManager disabled after {type(err).__name__}: {err} — updates continue unjournaled",
        )

    def _record_degradation(self, kind: str, detail: str) -> None:
        if hasattr(self.target, "_record_degradation"):
            self.target._record_degradation(kind, detail=detail)
        else:
            from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserWarning

            rank_zero_warn(f"{type(self.target).__name__} {kind}: {detail}", TorchMetricsUserWarning)


class _SnapshotWriteJob:
    """One atomic snapshot write: temp → fsync → rename → dir fsync → prune."""

    def __init__(self, directory: Path, gen: int, digest: bytes, blob: bytes, keep: int) -> None:
        self.directory = directory
        self.gen = gen
        self.digest = digest
        self.blob = blob
        self.keep = keep

    def __call__(self) -> None:
        final = self.directory / _snap_name(self.gen)
        tmp = self.directory / (final.name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(_MAGIC + self.digest + self.blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        _fsync_dir(self.directory)
        self._prune()

    def _prune(self) -> None:
        snaps = sorted(
            (int(m.group(1)) for p in self.directory.iterdir() if (m := _SNAP_RE.match(p.name))),
        )
        cut = snaps[-self.keep :]
        oldest_kept = cut[0] if cut else 0
        for gen in snaps[: -self.keep] if len(snaps) > self.keep else []:
            (self.directory / _snap_name(gen)).unlink(missing_ok=True)
        # journals bridge restore from the oldest kept snapshot forward;
        # anything older than that can never be replayed again
        for p in list(self.directory.iterdir()):
            m = _JOURNAL_RE.match(p.name)
            if m and int(m.group(1)) < oldest_kept:
                p.unlink(missing_ok=True)


def _none() -> None:
    return None
