"""The on-disk AOT cache: kernel libraries and step records (JAX ``_aot/cache.py``).

With a cache directory set (``TM_TPU_AOT_CACHE`` or
:func:`~torchmetrics_tpu_torch._aot.state.set_aot_cache`), the port keeps
two kinds of artifact under ``<dir>/torch/`` (``artifacts.py``):

- ``kernel_library``: the ``.so`` that ``utilities/nvcc.py`` builds from one
  source. A loader takes, in order: the library already in ``_build/``
  (storing it when the cache lacks it), a verified artifact installed into
  ``_build/`` by an atomic rename and loaded from there (never from the
  shared directory, where another writer may replace it), or a fresh
  ``nvcc``/``cc`` build, which is then stored. A failed build raises.
- ``step_record``: one per compiled key (``auto_update``, ``auto_forward``,
  ``jit_update``, ``scan_update``, ``stream_step``, ``spmd_step``), keyed by
  the owner class, the kind and the key's components.

What a hit means: the key's record was found and verified, and every
library it names was loaded before the warm-up, from ``_build/`` or from the
cache, with no ``nvcc``. While profiling, the recorded flops and bytes stand
in for the ``FlopCounterMode`` count, as the JAX header's ``cost_flops``
does. The warm-up and the CUDA graph's capture still run in the process; on
the CPU a hit is the verified record.

Artifact layout (one file each, ``<kind>.<digest>.aot``)::

    TMAOTTORCH1\\n                  magic
    <8-byte LE header length>
    <header json>                  format, key digest, fingerprint,
                                   payload sha256, sizes, created timestamp
    <payload>                      the library's bytes, or the record's JSON

Writes are atomic (same-directory temp file, ``fsync``, rename, directory
``fsync``); loads verify the magic, the key digest, the fingerprint and the
payload checksum before use. Any failure (corrupt, truncated, a foreign
fingerprint, an unwritable directory) falls back to a rebuild or a fresh
warm-up, counted as ``aot_cache|result=fallback`` with an ``aot_fallback``
bus event, or ``aot_cache_unwritable`` for a write: cold, never wrong.

Trust model: a library artifact is machine code the process will load, so
the cache directory must be operator-controlled; the checksummed header
defends against corruption, not tampering.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from torchmetrics_tpu_torch._analysis.locksan import SAN as _SAN
from torchmetrics_tpu_torch._analysis.locksan import check_access as _san_check
from torchmetrics_tpu_torch._analysis.locksan import new_lock as _san_lock
from torchmetrics_tpu_torch._analysis.locksan import new_rlock as _san_rlock
from torchmetrics_tpu_torch._aot import artifacts as _artifacts
from torchmetrics_tpu_torch._aot.state import AOT
from torchmetrics_tpu_torch._observability import costs as _costs
from torchmetrics_tpu_torch._observability import tracing as _obs_trace
from torchmetrics_tpu_torch._observability.events import BUS as _BUS
from torchmetrics_tpu_torch._observability.state import OBS as _OBS

__all__ = [
    "AotCache",
    "RESOLVE_LOCK",
    "StepResolution",
    "aot_stats",
    "get_cache",
    "reset_aot_stats",
    "store_library",
    "supply_library",
    "wrap_executable",
]

_MAGIC = b"TMAOTTORCH1\n"
_HEADER_LEN = struct.Struct("<Q")
_HEADER_VERSION = 1
_SUFFIX = ".aot"
SUBDIR = "torch"  # the port's artifacts, apart from the JAX package's top level and `xla/`
LIBRARY_KIND = _artifacts.FORMAT_KERNEL_LIBRARY

_STEP_COUNTERS = ("hits", "misses", "fallbacks", "writes", "write_errors")
_LIBRARY_COUNTERS = (
    "library_local", "library_hits", "library_misses", "library_fallbacks", "library_builds",
    "library_writes", "library_write_errors",
)


def _fsync_dir(directory: Path) -> None:
    """Best-effort directory fsync so a rename survives a machine crash."""
    try:
        fd = os.open(str(directory), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_atomic(final: Path, data: bytes) -> None:
    """Write ``data`` to ``final`` through a temp file of this process and thread, then rename it into place."""
    tmp = final.with_name(f"{final.name}.tmp.{os.getpid()}.{threading.get_ident()}")
    try:
        final.parent.mkdir(parents=True, exist_ok=True)
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, final)
    except BaseException:
        try:
            tmp.unlink(missing_ok=True)
        except OSError:
            pass
        raise
    _fsync_dir(final.parent)


def _current_fingerprint(header: Dict[str, Any]) -> Dict[str, str]:
    """The fingerprint this process would write for the artifact of ``header``."""
    if header.get("format") == _artifacts.FORMAT_KERNEL_LIBRARY:
        target = (header.get("fingerprint") or {}).get("target")
        return _artifacts.library_fingerprint("host" if target == "host" else _artifacts.device_target())
    return _artifacts.backend_fingerprint()


class AotCache:  # concurrency: shared hot paths bump stats while benches/tests scrape
    """The port's artifact store under ``<directory>/torch/`` (list, load, store, verify, evict).

    Disk operations never run under the lock: it only guards the stats
    counters, which hot paths bump while tests and benchmarks read them.
    Concurrent writers of one artifact are safe: each writes its own temp
    file and the atomic rename makes one of them win.
    """

    def __init__(self, directory: str) -> None:
        self.root = Path(directory)
        self.directory = self.root / SUBDIR
        self._lock = _san_lock("AotCache._lock")
        # concurrency: shared stats dict guarded-by _lock
        self._stats: Dict[str, int] = {k: 0 for k in _STEP_COUNTERS + _LIBRARY_COUNTERS}

    # --------------------------------------------------------------- counters
    def _bump(self, key: str, telem_obj: Any = None, label: Optional[str] = None) -> None:
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_stats")
            self._stats[key] = self._stats.get(key, 0) + 1
        if telem_obj is not None and _OBS.enabled and label is not None:
            from torchmetrics_tpu_torch._observability.telemetry import telemetry_for

            telemetry_for(telem_obj).inc(f"aot_cache|result={label}")

    def stats(self) -> Dict[str, int]:
        """Step counters under the JAX package's keys, library counters under ``library_*``."""
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_stats")
            return dict(self._stats)

    # ------------------------------------------------------------------ paths
    def artifact_path(self, kind: str, digest: str) -> Path:
        return self.directory / f"{kind}.{digest[:24]}{_SUFFIX}"

    # ------------------------------------------------------------------- load
    def load(
        self, kind: str, digest: str, fingerprint: Dict[str, str]
    ) -> Tuple[Optional[Dict[str, Any]], bytes, Optional[str]]:
        """``(header, payload, None)`` for a verified artifact, ``(None, b"", None)`` when there is none,
        ``(None, b"", reason)`` when one exists but cannot be trusted."""
        path = self.artifact_path(kind, digest)
        try:
            raw = path.read_bytes()
        except (FileNotFoundError, NotADirectoryError):
            return None, b"", None
        except OSError as err:
            return None, b"", f"unreadable artifact: {type(err).__name__}"
        header, payload, reason = self._parse(raw)
        if header is None:
            return None, b"", reason
        if header.get("key_digest") != digest:
            return None, b"", "cache-key digest mismatch"
        if header.get("fingerprint") != fingerprint:
            theirs = header.get("fingerprint") or {}
            changed = sorted(k for k in set(theirs) | set(fingerprint) if theirs.get(k) != fingerprint.get(k))
            return None, b"", f"backend fingerprint mismatch ({', '.join(changed) or '?'})"
        return header, payload, None

    @staticmethod
    def _parse(raw: bytes) -> Tuple[Optional[Dict[str, Any]], bytes, Optional[str]]:
        """The header and payload of an artifact's bytes, its magic, framing, version and checksum verified."""
        if not raw.startswith(_MAGIC):
            return None, b"", "bad magic (not a port AOT artifact)"
        body = raw[len(_MAGIC):]
        if len(body) < _HEADER_LEN.size:
            return None, b"", "truncated header length"
        (hlen,) = _HEADER_LEN.unpack(body[: _HEADER_LEN.size])
        body = body[_HEADER_LEN.size:]
        if len(body) < hlen:
            return None, b"", "truncated header"
        try:
            header = json.loads(body[:hlen].decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            return None, b"", "corrupt header json"
        version = header.get("version") if isinstance(header, dict) else "?"
        if version != _HEADER_VERSION:
            return None, b"", f"unsupported artifact version {version}"
        payload = body[hlen:]
        if header.get("payload_sha256") != hashlib.sha256(payload).hexdigest():
            return None, b"", "payload checksum mismatch (corrupt artifact)"
        return header, payload, None

    # ------------------------------------------------------------------ store
    def store(
        self, kind: str, digest: str, fmt: str, payload: bytes, meta: Dict[str, Any], fingerprint: Dict[str, str],
        counter: str = "writes",
    ) -> bool:
        """Atomically write one artifact; False (counted, with an ``aot_cache_unwritable`` event) on an IO error."""
        header = {
            "version": _HEADER_VERSION,
            "format": fmt,
            "kind": kind,
            "key_digest": digest,
            "payload_sha256": hashlib.sha256(payload).hexdigest(),
            "payload_bytes": len(payload),
            "fingerprint": fingerprint,
            "created": time.time(),
            **meta,
        }
        blob = json.dumps(header, sort_keys=True).encode("utf-8")
        final = self.artifact_path(kind, digest)
        errors = "library_write_errors" if counter == "library_writes" else "write_errors"
        try:
            _write_atomic(final, _MAGIC + _HEADER_LEN.pack(len(blob)) + blob + payload)
        except OSError as err:
            self._bump(errors)
            _BUS.publish(
                "aot_cache_unwritable",
                "AotCache",
                f"artifact write failed: {type(err).__name__}: {err}",
                data={"kind": kind, "path": str(final)},
            )
            return False
        self._bump(counter)
        return True

    # ------------------------------------------------------------- inventory
    def entries(self) -> List[Dict[str, Any]]:
        """Header and integrity status of every port artifact (``<dir>/torch/*.aot``)."""
        out: List[Dict[str, Any]] = []
        try:
            paths = sorted(self.directory.glob(f"*{_SUFFIX}"))
        except OSError:
            return out
        for path in paths:
            entry: Dict[str, Any] = {"path": str(path)}
            try:
                entry["file_bytes"] = path.stat().st_size
                raw = path.read_bytes()
            except OSError as err:
                # a concurrent evict can unlink between glob and read: report it, do not fail the listing
                entry.setdefault("file_bytes", 0)
                entry["status"] = f"unreadable: {type(err).__name__}"
                out.append(entry)
                continue
            header, _payload, reason = self._parse(raw)
            if header is None:
                entry["status"] = reason or "corrupt"
            else:
                refused = header.get("format") == LIBRARY_KIND and _artifacts.library_refusal(header) is not None
                entry.update(
                    {
                        "status": "ok",
                        "kind": header.get("kind", path.name.split(".", 1)[0]),
                        "owner": header.get("owner", "?"),
                        "format": header.get("format"),
                        "created": header.get("created"),
                        "fingerprint": header.get("fingerprint", {}),
                        "stale": refused or header.get("fingerprint") != _current_fingerprint(header),
                        "key_digest": header.get("key_digest"),
                        "payload_bytes": header.get("payload_bytes"),
                    }
                )
            out.append(entry)
        return out

    def evict(
        self,
        *,
        stale_only: bool = False,
        kind: Optional[str] = None,
        entries: Optional[List[Dict[str, Any]]] = None,
    ) -> List[str]:
        """Delete port artifacts: all, one kind, or only the stale and corrupt ones.

        ``entries`` lets a caller that already listed the store skip a
        second read of every artifact.
        """
        removed: List[str] = []
        for entry in entries if entries is not None else self.entries():
            if kind is not None and entry.get("kind") != kind:
                continue
            if stale_only and entry.get("status") == "ok" and not entry.get("stale"):
                continue
            try:
                os.unlink(entry["path"])
                removed.append(entry["path"])
            except OSError:
                continue
        return removed


# one AotCache a directory, so re-pointing the cache mid-process keeps each directory's counters
_CACHES: Dict[str, AotCache] = {}
_CACHES_LOCK = _san_lock("aot._CACHES_LOCK")


def get_cache(directory: Optional[str] = None) -> Optional[AotCache]:
    """The cache of ``directory`` (default: the one set); None when the cache is off."""
    path = directory if directory is not None else AOT.cache_dir
    if not path:
        return None
    with _CACHES_LOCK:
        cache = _CACHES.get(path)
        if cache is None:
            cache = _CACHES[path] = AotCache(path)
        return cache


def aot_stats() -> Dict[str, int]:
    """Process-wide AOT counters summed over every cache directory used."""
    with _CACHES_LOCK:
        caches = list(_CACHES.values())
    totals: Dict[str, int] = {}
    for cache in caches:
        for key, val in cache.stats().items():
            totals[key] = totals.get(key, 0) + val
    return totals


def reset_aot_stats() -> None:
    with _CACHES_LOCK:
        caches = list(_CACHES.values())
    for cache in caches:
        with cache._lock:
            for key in cache._stats:
                cache._stats[key] = 0


def _publish_fallback(source: str, kind: str, reason: str) -> None:
    _BUS.publish("aot_fallback", source, f"{kind}: {reason}", data={"kind": kind, "reason": reason})


# ----------------------------------------------------------------- kernel libraries
def _library_digest(source_digest: str, target: str) -> str:
    """A library's key: its source and flags (as ``nvcc.library_path`` hashes them) and its target."""
    record = json.dumps({"v": _HEADER_VERSION, "format": LIBRARY_KIND, "source": source_digest, "target": target},
                        sort_keys=True)
    return hashlib.sha256(record.encode("utf-8")).hexdigest()


def supply_library(source: Path, path: Path, source_digest: str, target: str) -> str:
    """Put the library of ``source`` at ``path`` without building it, if the cache can.

    Returns the route: ``"local"`` (it was in ``_build/``; stored when the
    cache lacks it), ``"cache"`` (a verified artifact installed at ``path``)
    or ``"nvcc"``: no artifact (a miss), or one that cannot be used (a
    fallback, with an ``aot_fallback`` event); the caller then builds and
    calls :func:`store_library`.
    """
    cache = get_cache()
    if path.exists():
        if cache is not None:
            cache._bump("library_local")
            digest = _library_digest(source_digest, target)
            if not cache.artifact_path(LIBRARY_KIND, digest).exists():
                _store_library_bytes(cache, source, path, digest, target, compiler=None, nvcc_path=None, seconds=0.0)
        return "local"
    if cache is None:
        return "nvcc"
    digest = _library_digest(source_digest, target)
    header, payload, reason = cache.load(LIBRARY_KIND, digest, _artifacts.library_fingerprint(target))
    if header is not None:
        data = _artifacts.load_library_artifact(header, payload)
        if data is None:
            reason = _artifacts.library_refusal(header) or "payload is not a shared library"
        else:
            try:
                _write_atomic(path, data)
            except OSError as err:
                reason = f"install into {path.parent} failed: {type(err).__name__}: {err}"
            else:
                cache._bump("library_hits")
                return "cache"
    if reason is None:
        cache._bump("library_misses")
    else:
        cache._bump("library_fallbacks")
        _publish_fallback(source.name, LIBRARY_KIND, reason)
    return "nvcc"


def store_library(
    source: Path, path: Path, source_digest: str, target: str, compiler: str, nvcc_path: Optional[str], seconds: float
) -> bool:
    """Store the library just built at ``path`` (no-op with the cache off)."""
    cache = get_cache()
    if cache is None:
        return False
    cache._bump("library_builds")
    return _store_library_bytes(cache, source, path, _library_digest(source_digest, target), target, compiler,
                                nvcc_path, seconds)


def _store_library_bytes(
    cache: AotCache, source: Path, path: Path, digest: str, target: str, compiler: Optional[str],
    nvcc_path: Optional[str], seconds: float,
) -> bool:
    if compiler is None:  # a library found in `_build/`: its compiler follows from its target
        from torchmetrics_tpu_torch.utilities import nvcc

        try:
            compiler, nvcc_path = ("cc", None) if target == "host" else ("nvcc", nvcc._nvcc())
        except FileNotFoundError:  # no nvcc here to read the release from: leave it to a replica that has one
            return False
    try:
        built = _artifacts.build_library_artifact(path.read_bytes(), compiler, nvcc_path)
    except OSError:
        built = None
    if built is None:
        return False
    payload, meta = built
    return cache.store(
        LIBRARY_KIND, digest, LIBRARY_KIND, payload,
        {"owner": source.name, "library": path.name, "build_seconds": seconds, **meta},
        _artifacts.library_fingerprint(target), counter="library_writes",
    )


# ----------------------------------------------------------------- step records
# Cold resolution of every seam is serialized under this one lock (JAX
# `_aot/cache.py:396`): the disk probe, the library loads, and, at the stream
# pool's and the SPMD engine's seams, the whole build, with a second probe of
# the seam's own cache once it is held (so a concurrent `warm_start` of one
# key builds once). Reentrant: a seam that holds it calls `wrap_executable`.
RESOLVE_LOCK = _san_rlock("aot.RESOLVE_LOCK")


def _step_digest(owner: str, kind: str, components: Dict[str, str], extra: str) -> str:
    """A step record's key: the owner class, the kind and the key's components.

    The fingerprint is deliberately not part of it: a torch upgrade finds
    the old record and refuses it by name (a fallback, then a rewrite),
    rather than missing beside it.
    """
    record = json.dumps(
        {"v": _HEADER_VERSION, "owner": owner, "kind": kind, "components": components, "extra": extra}, sort_keys=True
    )
    return hashlib.sha256(record.encode("utf-8")).hexdigest()


class StepResolution:
    """What the cache said of one key about to be built: ``outcome`` ``"hit"`` or ``"compiled"``.

    ``cost`` is the recorded :class:`~torchmetrics_tpu_torch._observability.costs.ExecutableCost`
    on a hit that carries one (None otherwise): while profiling it stands in
    for counting the warm-up. After the build the seam calls :meth:`done`,
    which writes the record unless the key was a hit.
    """

    __slots__ = ("outcome", "cost", "_cache", "_digest", "_owner", "_kind", "_components", "_extra", "_launches0")

    def __init__(self, owner: str, kind: str, components: Dict[str, str], extra: str) -> None:
        self.outcome = "compiled"
        self.cost: Optional[_costs.ExecutableCost] = None
        self._cache: Optional[AotCache] = None
        self._digest = ""
        self._owner, self._kind, self._components, self._extra = owner, kind, components, extra
        self._launches0: Dict[str, int] = {}

    @property
    def counting(self) -> bool:
        """True when the warm-up's flops and bytes must be counted (profiling on, no recorded cost)."""
        return _OBS.profiling and self.cost is None

    def done(self, capture: str, tally: Any = None) -> None:
        """Write the key's record after its build: the libraries its warm-up launched, its cost, ``capture``."""
        if self.outcome == "hit" or self._cache is None:
            return
        from torchmetrics_tpu_torch._kernels.launch_counter import eager_launches
        from torchmetrics_tpu_torch.utilities import nvcc

        launched = eager_launches()
        libraries = [
            {"source": name, "digest": nvcc.source_digest(nvcc.CSRC_DIR / name)}
            for name in sorted(launched)
            if launched[name] > self._launches0.get(name, 0)
        ]
        cost = None if tally is None else tally.cost()
        payload = _artifacts.build_step_record({
            "owner": self._owner,
            "kind": self._kind,
            "components": self._components,
            "extra": self._extra,
            "libraries": libraries,
            "cost": None if cost is None else cost.to_json(),
            "capture": capture,
        })
        if payload is not None:
            self._cache.store(self._kind, self._digest, _artifacts.FORMAT_STEP_RECORD, payload,
                              {"owner": self._owner}, _artifacts.backend_fingerprint())


def _supply_record_libraries(libraries: List[Dict[str, Any]]) -> Optional[str]:
    """Load every library a record names; None when each came from ``_build/`` or the cache, else why not.

    A library the cache cannot supply (or whose source changed since the
    record) is built here, which raises if ``nvcc`` fails: the step is then
    a fallback and its record is rewritten.
    """
    import ctypes

    from torchmetrics_tpu_torch.utilities import nvcc

    reason = None
    for lib in libraries:
        source = nvcc.CSRC_DIR / str(lib.get("source", ""))
        if not source.is_file():
            reason = reason or f"library {lib.get('source')!r}: no such source"
            continue
        if nvcc.source_digest(source) != lib.get("digest"):
            reason = reason or f"library {source.name}: source changed since the record"
        info = nvcc.build_all([source])[0]
        if info["route"] == "nvcc":
            reason = reason or f"library {source.name} could not be supplied, and was rebuilt"
        ctypes.CDLL(info["path"])
    return reason


def wrap_executable(
    *, owner: str, kind: str, components: Dict[str, str], extra: str = "", telem_obj: Any = None
) -> StepResolution:
    """Probe the record of one key about to be built and load the libraries it names (JAX ``wrap_executable``).

    The JAX package wraps a fresh jitted callable in a dispatcher that loads
    its executable from disk. A CUDA graph cannot be loaded, so the port's
    seam calls this before it builds the key (warm-up, then capture) and
    :meth:`StepResolution.done` after.

    Counts ``hits`` (a verified record whose libraries were all supplied
    without ``nvcc``), ``misses`` or ``fallbacks`` (with an ``aot_fallback``
    event), and the ``aot_cache|result=`` counter of ``telem_obj``. Called
    only with the cache set; makes no CUDA call but the libraries' loads.
    """
    res = StepResolution(owner, kind, components, extra)
    cache = get_cache()
    if cache is None:
        return res
    span = _obs_trace.begin_span("aot.load", owner, kind=kind) if _OBS.tracing else None
    try:
        with RESOLVE_LOCK:
            res._cache = cache
            record = None
            try:
                res._digest = _step_digest(owner, kind, components, extra)
                header, payload, reason = cache.load(kind, res._digest, _artifacts.backend_fingerprint())
                if header is not None:
                    record = _artifacts.load_step_record(payload)
                    if record is None:
                        reason = "unparsable step record"
            except Exception as err:  # noqa: BLE001 - a cache failure never breaks the stream
                record, reason = None, f"cache probe failed: {type(err).__name__}: {err}"
            if record is not None:
                reason = _supply_record_libraries(record["libraries"])
            if record is not None and reason is None:
                res.outcome = "hit"
                cache._bump("hits", telem_obj, "hit")
                cost = record.get("cost")
                if isinstance(cost, dict):
                    res.cost = _costs.ExecutableCost(float(cost["flops"]), float(cost["bytes_accessed"]))
            elif reason is not None:
                cache._bump("fallbacks", telem_obj, "fallback")
                _publish_fallback(owner, kind, reason)
            else:
                cache._bump("misses", telem_obj, "miss")
            from torchmetrics_tpu_torch._kernels.launch_counter import eager_launches

            res._launches0 = eager_launches()
    except BaseException as err:
        if span is not None:
            _obs_trace.end_span(span, err)
        raise
    if span is not None:
        span.attrs["outcome"] = res.outcome
        _obs_trace.end_span(span)
    return res
