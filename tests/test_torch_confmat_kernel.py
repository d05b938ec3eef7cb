"""The port's confusion-matrix kernel module, on the CPU.

Its plain version (what :func:`confusion_matrix_cuda` runs for CPU tensors) is
held against the TPU kernel ``confusion_matrix_pallas`` in interpret mode, at
the shapes of ``tests/unittests/classification/test_pallas_confmat.py``.
Counts are compared exactly; float32 weighted sums with ``rtol=1e-5,
atol=1e-6``, since the two sum in a different order. The CUDA kernel itself
runs only on a card (``chip_smoke.py``).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.functional.classification._pallas_confmat import confusion_matrix_pallas
from torchmetrics_tpu_torch.functional.classification import _confmat_kernel as kernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(64, 5), (1000, 10), (517, 300), (2048, 1000), (8, 256)]


def _labels(rng, n, c, lo=0, hi=None):
    return rng.integers(lo, c if hi is None else hi, n)


def _pallas(p, t, c, w=None):
    weights = None if w is None else jnp.asarray(np.asarray(w, np.float32))
    out = confusion_matrix_pallas(
        jnp.asarray(p.astype(np.int32)), jnp.asarray(t.astype(np.int32)), c, weights=weights, interpret=True
    )
    return np.asarray(out)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize(("n", "c"), SHAPES)
def test_plain_matches_pallas_counts(n, c, dtype):
    rng = np.random.default_rng(n * 7 + c)
    p, t = _labels(rng, n, c).astype(dtype), _labels(rng, n, c).astype(dtype)
    got = kernel.confusion_matrix_cuda(torch.from_numpy(p), torch.from_numpy(t), c)
    assert got.dtype == torch.int32 and got.shape == (c, c)
    np.testing.assert_array_equal(got.numpy(), _pallas(p, t, c).astype(np.int64))


@pytest.mark.parametrize(("n", "c"), [(700, 300), (2048, 1000)])
def test_plain_matches_pallas_weighted(n, c):
    rng = np.random.default_rng(c)
    p, t = _labels(rng, n, c), _labels(rng, n, c)
    w = rng.random(n).astype(np.float32)
    got = kernel.confusion_matrix_cuda(torch.from_numpy(p), torch.from_numpy(t), c, torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas(p, t, c, w), rtol=1e-5, atol=1e-6)


def test_bool_mask_gives_int32_counts():
    rng = np.random.default_rng(1)
    p, t = _labels(rng, 700, 300), _labels(rng, 700, 300)
    mask = rng.random(700) < 0.7
    got = kernel.confusion_matrix_cuda(torch.from_numpy(p), torch.from_numpy(t), 300, torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _pallas(p, t, 300, mask).astype(np.int64))
    assert int(got.sum()) == int(mask.sum())


@pytest.mark.parametrize("c", [256, 300])
@pytest.mark.parametrize("weighted", [False, True])
def test_out_of_range_labels_are_dropped(c, weighted):
    """Labels -2, -1, C and C+1 with no mask: the TPU kernel's iota compare drops them, so must the port."""
    rng = np.random.default_rng(c + weighted)
    n = 3000
    p, t = _labels(rng, n, c, lo=-2, hi=c + 2), _labels(rng, n, c, lo=-2, hi=c + 2)
    w = rng.random(n).astype(np.float32) if weighted else None
    got = kernel.confusion_matrix_cuda(
        torch.from_numpy(p), torch.from_numpy(t), c, None if w is None else torch.from_numpy(w)
    )
    want = _pallas(p, t, c, w)
    keep = (p >= 0) & (p < c) & (t >= 0) & (t < c)
    numpy_ref = np.zeros((c, c), np.float64)
    np.add.at(numpy_ref, (t[keep], p[keep]), 1.0 if w is None else w[keep])
    if weighted:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), numpy_ref, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        np.testing.assert_array_equal(got.numpy(), numpy_ref.astype(np.int64))


def test_launch_counter_stays_zero_on_cpu():
    before = int(kernel.confusion_matrix_cuda.launches)
    p = torch.randint(0, 300, (100,))
    for w in (None, torch.ones(100, dtype=torch.bool), torch.ones(100)):
        kernel.confusion_matrix_cuda(p, p, 300, w)
    assert int(kernel.confusion_matrix_cuda.launches) == before == 0


@pytest.mark.parametrize(
    ("args", "error"),
    [
        ((torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int64), 300, None), TypeError),
        ((torch.zeros(4), torch.zeros(4), 300, None), TypeError),
        ((torch.zeros((2, 2), dtype=torch.int64), torch.zeros((2, 2), dtype=torch.int64), 300, None), ValueError),
        ((torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int64), 300, torch.zeros(3)), ValueError),
        ((torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int64), 300, torch.zeros(4, dtype=torch.int8)), TypeError),
        ((torch.zeros(4, dtype=torch.int64, device="meta"), torch.zeros(4, dtype=torch.int64, device="meta"), 300, None), ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(args, error):
    with pytest.raises(error):
        kernel.confusion_matrix_cuda(*args)


def test_module_imports_and_runs_without_nvcc():
    """No CUDA toolkit: the module imports and the CPU path runs without touching the build."""
    code = (
        "import shutil, torch\n"
        "from torchmetrics_tpu_torch.functional.classification import _confmat_kernel as k\n"
        "assert shutil.which('nvcc') is None\n"
        "p = torch.randint(0, 300, (50,))\n"
        "assert int(k.confusion_matrix_cuda(p, p, 300).trace()) == 50\n"
        "assert k._library.cache_info().currsize == 0 and int(k.confusion_matrix_cuda.launches) == 0\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PATH": os.path.dirname(sys.executable), "CUDA_HOME": os.path.join(ROOT, "no-cuda-here")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("weights", ["none", "mask", "float"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_out_adds_into_the_given_matrix(weights, dtype):
    """``out=`` (a metric's state) gets ``out_before + fresh`` and is returned, not a copy."""
    rng = np.random.default_rng(21)
    n, c = 900, 300
    p, t = (torch.from_numpy(_labels(rng, n, c, lo=-1, hi=c + 1)).to(dtype) for _ in range(2))
    w = {"none": None, "mask": torch.from_numpy(rng.random(n) < 0.7), "float": torch.from_numpy(rng.random(n).astype(np.float32))}[weights]
    fresh = kernel.confusion_matrix_cuda(p, t, c, w)
    before = torch.from_numpy(rng.integers(0, 5, (c, c))).to(fresh.dtype)
    out = before.clone()
    got = kernel.confusion_matrix_cuda(p, t, c, w, out=out)
    assert got is out
    if weights == "float":
        torch.testing.assert_close(out, before + fresh, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(out, before + fresh)
    again = kernel.confusion_matrix_plain(p, t, c, w, out=out.clone())
    torch.testing.assert_close(again, before + 2 * fresh, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    ("weights", "out"),
    [
        (None, torch.zeros((300, 300), dtype=torch.int64)),  # wrong dtype: counts are int32
        (None, torch.zeros((300, 300), dtype=torch.float32)),
        (torch.ones(50), torch.zeros((300, 300), dtype=torch.int32)),  # float weights sum in float32
        (torch.ones(50, dtype=torch.bool), torch.zeros((300, 301), dtype=torch.int32)),  # wrong shape
        (None, torch.zeros((300, 300), dtype=torch.int32, device="meta")),  # wrong device
        (None, torch.zeros((300, 300), dtype=torch.int32).t()),  # not contiguous
    ],
)
def test_out_is_checked_before_anything_is_added(weights, out):
    p = torch.randint(0, 300, (50,))
    before = out.clone() if out.device.type == "cpu" else None
    with pytest.raises(ValueError):
        kernel.confusion_matrix_cuda(p, p, 300, weights, out=out)
    if before is not None:
        assert torch.equal(out, before)
    assert int(kernel.confusion_matrix_cuda.launches) == 0


@pytest.mark.parametrize(
    ("arrays", "n", "head"),
    [
        ([(4096, 8), (8192, 8), (12288, 1)], 1000, 0),  # fresh allocations: all aligned from row 0
        ([(4096 + 24, 8), (8192 + 24, 8), (12288 + 3, 1)], 1000, 5),  # a slice 3 rows in: aligned again 5 rows on
        ([(4096 + 8, 8), (8192 + 8, 8)], 1000, 1),  # int64 labels both one row in: row 1 aligns both
        ([(4096 + 4, 4), (8192 + 4, 4), (12288 + 4, 4)], 1000, 3),  # int32 + float32 weights, one row in
        ([(4096 + 8, 8), (8192, 8)], 1000, 1000),  # labels one row apart: no common boundary, every row scalar
        ([(4096 + 24, 8), (8192 + 24, 8), (12288 + 3, 1)], 3, 3),  # fewer rows than the head
    ],
)
def test_vector_head(arrays, n, head):
    assert kernel.vector_head(n, arrays) == head
