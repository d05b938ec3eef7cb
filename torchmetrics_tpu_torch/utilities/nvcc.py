"""Build the package's CUDA sources with ``nvcc`` (and its C codec with ``cc``) at first use; load them with ``ctypes``.

Every kernel source under ``torchmetrics_tpu_torch/csrc/`` has a plain C
interface and builds the same way: one shared library per source and flag
set, named by a hash of both, compiled into ``torchmetrics_tpu_torch/_build/``
and renamed into place atomically. ``nvcc`` is only looked for when a
library is built, so the package imports where there is no CUDA toolkit.
:func:`build_all` starts one ``nvcc`` per source at once, so several kernels
build in the time of the slowest.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise FileNotFoundError("nvcc not found on PATH or under CUDA_HOME: the CUDA kernels cannot be built")


def library_path(source: Path) -> Path:
    """Where the library of ``source`` at the current flags lives; the name carries a hash of both."""
    source = Path(source)
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build_all(sources: Sequence[Path]) -> List[Dict[str, Any]]:
    """Compile each source whose library is missing, all ``nvcc`` processes at once.

    Returns, per source and in order, ``{"path", "seconds", "built", "log"}``:
    ``seconds`` is that compile's wall time (0 when the library existed) and
    ``log`` the compiler's output, with ptxas' register and spill lines. An
    edited source gets a new hash, so it is never served by a stale build.
    """
    results: List[Dict[str, Any]] = []
    running = []
    for source in sources:
        path = library_path(source)
        if path.exists():
            results.append({"path": str(path), "seconds": 0.0, "built": False, "log": ""})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        log = tempfile.TemporaryFile("w+")  # a file, not a pipe: nothing blocks while another build is awaited
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True)
        result = {"path": str(path), "seconds": 0.0, "built": True, "log": ""}
        results.append(result)
        running.append((proc, log, cmd, tmp, path, result, time.perf_counter()))
    failures = []
    while running:  # each compile is timed to its own exit, whatever order they finish in
        time.sleep(0.02)
        for item in [r for r in running if r[0].poll() is not None]:
            proc, log, cmd, tmp, path, result, t0 = item
            result["seconds"] = time.perf_counter() - t0
            running.remove(item)
            with log:
                log.seek(0)
                result["log"] = log.read()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{result['log']}")
            else:
                os.replace(tmp, path)  # atomic: a process building at the same time never loads a half-written file
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def load(source: Path) -> Any:
    """Build ``source`` if needed and load its library.

    Every source exports ``const char* tm_cuda_error_string(int)``, declared
    here for :func:`raise_on_error`; the caller declares its own entry points.
    """
    import ctypes

    lib = ctypes.CDLL(build_all([source])[0]["path"])
    lib.tm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def raise_on_error(lib: Any, err: int, what: str) -> None:
    """Raise if an entry point of ``lib`` returned a CUDA error (its ``cudaError_t``, 0 for success)."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.tm_cuda_error_string(err).decode()}")


CC_FLAGS = ("-O2", "-shared", "-fPIC")


def load_c(source: Path) -> Any:
    """Build the plain C ``source`` with the system C compiler if needed and load it with ``ctypes``.

    The library goes to ``_build/`` under a hash of the source and flags,
    renamed into place atomically, as :func:`build_all` does for CUDA
    sources. A failed build raises; there is no fallback.
    """
    import ctypes

    source = Path(source)
    digest = hashlib.sha256(source.read_bytes() + " ".join(CC_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"lib{source.stem}-{digest}.so"
    if not path.exists():
        compiler = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
        if compiler is None:
            raise FileNotFoundError(f"no C compiler (cc, gcc or $CC) to build {source.name}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([compiler, *CC_FLAGS, "-o", str(tmp), str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{compiler} failed ({proc.returncode}) on {source}:\n{proc.stderr}")
        os.replace(tmp, path)
    return ctypes.CDLL(str(path))
