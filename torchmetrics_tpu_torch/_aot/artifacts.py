"""The port's two AOT artifact formats (JAX ``_aot/artifacts.py``), and the fingerprints they are checked against.

The JAX package serializes compiled XLA executables. A CUDA graph cannot be
written to disk, so the port stores the two things another process can
reuse:

- ``kernel_library`` (:data:`FORMAT_KERNEL_LIBRARY`): the shared library
  that ``utilities/nvcc.py`` builds from one source under ``csrc/`` (with
  ``nvcc``, or ``cc`` for the C codec). The payload is the ``.so`` bytes; the
  header records the ``nvcc`` release that built it, and a loader whose CUDA
  driver is older than that release refuses it.
- ``step_record`` (:data:`FORMAT_STEP_RECORD`): one compiled key's record, a
  JSON payload naming the owner class, the key's components, the kernel
  libraries its warm-up launched, its counted flops and bytes (where
  profiling counted them) and its capture's outcome.

Each ``build_*`` and ``load_*`` function returns ``None`` on any failure, as the JAX
package's do: the cache then rebuilds (cold, never wrong).
"""

from __future__ import annotations

import ctypes
import functools
import json
import platform
import re
import subprocess
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "FORMAT_KERNEL_LIBRARY",
    "FORMAT_STEP_RECORD",
    "backend_fingerprint",
    "build_library_artifact",
    "build_step_record",
    "cuda_driver_version",
    "device_target",
    "library_fingerprint",
    "library_refusal",
    "load_library_artifact",
    "load_step_record",
]

FORMAT_KERNEL_LIBRARY = "kernel_library"
FORMAT_STEP_RECORD = "step_record"

_RECORD_FIELDS = ("owner", "kind", "components", "libraries", "cost", "capture")
_FINGERPRINT: Optional[Dict[str, str]] = None


@functools.lru_cache(maxsize=None)
def cuda_driver_version() -> Optional[int]:
    """The CUDA driver's version (``cuDriverGetVersion``, 1000 * major + 10 * minor); None with no driver.

    Read from ``libcuda`` without initialising a context, so it makes no call
    a graph capture on another thread could see.
    """
    try:
        libcuda = ctypes.CDLL("libcuda.so.1")
        out = ctypes.c_int(0)
        if libcuda.cuDriverGetVersion(ctypes.byref(out)) != 0:
            return None
        return int(out.value)
    except OSError:
        return None


def device_target() -> str:
    """The card's compute capability as ``sm_<major><minor>`` (device 0); ``none`` without a card."""
    import torch

    if not torch.cuda.is_available():
        return "none"
    major, minor = torch.cuda.get_device_capability(0)
    return f"sm_{major}{minor}"


def backend_fingerprint() -> Dict[str, str]:
    """Identity of the runtime a step record was made on (JAX ``artifacts.py:45``).

    torch's version and CUDA build, the platform, the card's name and compute
    capability, the driver and the card count. A record whose fingerprint
    differs is refused (a named fallback, then rewritten), never used.
    Computed once a process, at the first cache use, which is outside any
    graph capture.
    """
    global _FINGERPRINT
    if _FINGERPRINT is None:
        import torch

        on_card = torch.cuda.is_available()
        driver = cuda_driver_version()
        _FINGERPRINT = {
            "torch": torch.__version__,
            "cuda": str(torch.version.cuda),
            "platform": f"{platform.system()}-{platform.machine()}",
            "device_name": torch.cuda.get_device_name(0) if on_card else "cpu",
            "compute_capability": device_target(),
            "driver": str(driver) if driver is not None else "none",
            "device_count": str(torch.cuda.device_count() if on_card else 0),
        }
    return dict(_FINGERPRINT)


def library_fingerprint(target: str) -> Dict[str, str]:
    """Identity of the runtime a kernel library runs on: the platform and the target it was compiled for.

    A library has a plain C interface and links no torch, so torch's version
    and the card count do not bear on it; the driver is checked against the
    ``nvcc`` release in the header instead (:func:`library_refusal`).
    """
    return {"platform": f"{platform.system()}-{platform.machine()}", "target": target}


@functools.lru_cache(maxsize=None)
def _nvcc_release(compiler: str) -> Optional[str]:
    try:
        out = subprocess.run([compiler, "--version"], capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    found = re.search(r"release (\d+)\.(\d+)", out)
    return f"{found.group(1)}.{found.group(2)}" if found else None


def build_library_artifact(
    library: bytes, compiler: str, nvcc_path: Optional[str]
) -> Optional[Tuple[bytes, Dict[str, Any]]]:
    """``(payload, header fields)`` of a library just built; None when it is not a shared object.

    ``nvcc_path`` is the ``nvcc`` that built it (None for ``cc``): its release
    goes into the header. A CUDA library whose release cannot be read is not
    stored, since no loader could check its driver against it.
    """
    if not library.startswith(b"\x7fELF"):
        return None
    release = None
    if nvcc_path is not None:
        release = _nvcc_release(nvcc_path)
        if release is None:
            return None
    return library, {"compiler": compiler, "nvcc_release": release}


def library_refusal(header: Dict[str, Any]) -> Optional[str]:
    """Why this process may not load the library of ``header``; None when it may."""
    release = header.get("nvcc_release")
    if release is None:
        return None if header.get("compiler") == "cc" else "no nvcc release recorded"
    driver = cuda_driver_version()
    if driver is None:
        return "no CUDA driver to run a CUDA library"
    try:
        major, minor = (int(p) for p in str(release).split("."))
    except ValueError:
        return f"unreadable nvcc release {release!r}"
    if driver < 1000 * major + 10 * minor:
        return f"driver {driver // 1000}.{driver % 1000 // 10} is older than the nvcc release {release} that built it"
    return None


def load_library_artifact(header: Dict[str, Any], payload: bytes) -> Optional[bytes]:
    """The library's bytes, ready to install; None when this process may not load it."""
    if library_refusal(header) is not None or not payload.startswith(b"\x7fELF"):
        return None
    return payload


def build_step_record(record: Dict[str, Any]) -> Optional[bytes]:
    """A step record's JSON payload; None when a field is missing or not JSON-serializable."""
    if any(k not in record for k in _RECORD_FIELDS):
        return None
    try:
        return json.dumps(record, sort_keys=True).encode("utf-8")
    except (TypeError, ValueError):
        return None


def load_step_record(payload: bytes) -> Optional[Dict[str, Any]]:
    """A step record from its payload; None when it is not JSON or lacks a field."""
    try:
        record = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError):
        return None
    if not isinstance(record, dict) or any(k not in record for k in _RECORD_FIELDS):
        return None
    if not isinstance(record["libraries"], list) or not isinstance(record["components"], dict):
        return None
    return record
