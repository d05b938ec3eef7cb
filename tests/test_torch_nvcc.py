"""The port's ``nvcc`` build helper on the CPU, with a stand-in compiler on ``PATH``.

The stand-in sleeps longer for one source than for the others, prints a
ptxas-like line and writes its ``-o`` file, or fails for a source whose name
says so. No CUDA toolkit is needed.
"""

import os
import stat
import time

import pytest

from torchmetrics_tpu_torch.utilities import nvcc

STAND_IN = """#!/bin/sh
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
case "$*" in *slow.cu*) sleep 1.5;; *broken.cu*) echo "error: broken source"; exit 2;; *) sleep 0.1;; esac
echo "ptxas info    : Used 40 registers"
echo built > "$out"
"""


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    compiler = bin_dir / "nvcc"
    compiler.write_text(STAND_IN)
    compiler.chmod(compiler.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    sources = tmp_path / "src"
    sources.mkdir()
    return sources


def _source(folder, name):
    path = folder / name
    path.write_text(f"// {name}\n")
    return path


def test_build_all_compiles_at_once_and_times_each_to_its_own_exit(fake_toolkit):
    slow, fast = _source(fake_toolkit, "slow.cu"), _source(fake_toolkit, "fast.cu")
    t0 = time.perf_counter()
    first = nvcc.build_all([slow, fast])
    wall = time.perf_counter() - t0
    assert wall < 1.5 + 1.0  # started together, not one after the other
    assert all(r["built"] and os.path.exists(r["path"]) and "Used 40 registers" in r["log"] for r in first)
    assert first[0]["seconds"] >= 1.5 and first[1]["seconds"] < 1.0  # the fast one is not charged the slow one's wait
    again = nvcc.build_all([slow, fast])  # the libraries exist now
    assert [r["built"] for r in again] == [False, False] and [r["path"] for r in again] == [r["path"] for r in first]


def test_a_failed_compile_raises_with_its_log_and_leaves_no_library(fake_toolkit):
    broken, fast = _source(fake_toolkit, "broken.cu"), _source(fake_toolkit, "fast.cu")
    with pytest.raises(RuntimeError, match="error: broken source"):
        nvcc.build_all([broken, fast])
    assert not nvcc.library_path(broken).exists()
    assert nvcc.library_path(fast).exists()
    assert not list(nvcc.BUILD_DIR.glob("*.tmp"))
