"""The port's LPIPS head kernel (B3) on the CPU, against the JAX package's ``lpips_head``.

On CPU tensors :func:`lpips_head` runs the oracle chain; the JAX side runs
its Pallas kernel in interpret mode (``pallas``) and its XLA graph (``xla``),
with no silent degradation, at the shapes and tolerances of
``tests/unittests/kernels/test_equivalence.py``: ``rtol=1e-5, atol=1e-7`` for
float32 features, ``rtol=1e-3, atol=1e-5`` for bfloat16 ones. The CUDA kernel
runs only on a card (``chip_smoke.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu import _kernels as K
from torchmetrics_tpu._kernels.dispatch import reset_degradations

lh = importlib.import_module("torchmetrics_tpu_torch._kernels.lpips_head")


@pytest.fixture(autouse=True)
def _clean_kernel_state(monkeypatch):
    reset_degradations()
    monkeypatch.delenv(K.KERNELS_ENV, raising=False)
    yield
    reset_degradations()


def _maps(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("shape", [(3, 13, 17, 64), (2, 7, 5, 35), (1, 33, 31, 256)])
def test_lpips_head_matches_jax(monkeypatch, mode, shape):
    monkeypatch.setenv(K.KERNELS_ENV, mode)
    f0, f1 = _maps(shape, seed=shape[-1])
    w = (np.random.default_rng(1).normal(size=(1, 1, shape[-1], 1)) * 0.3).astype(np.float32)
    want = K.lpips_head(jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(w))
    assert not K.degraded_kernels()
    got = lh.lpips_head(torch.from_numpy(f0), torch.from_numpy(f1), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_lpips_head_bf16_features(monkeypatch, mode):
    monkeypatch.setenv(K.KERNELS_ENV, mode)
    f0, f1 = _maps((2, 6, 9, 64), seed=2)
    f0, f1 = (np.array(jnp.asarray(f, jnp.bfloat16), np.float32) for f in (f0, f1))
    w = (np.random.default_rng(3).normal(size=(64,)) * 0.3).astype(np.float32)
    want = K.lpips_head(jnp.asarray(f0, jnp.bfloat16), jnp.asarray(f1, jnp.bfloat16), jnp.asarray(w))
    got = lh.lpips_head(torch.from_numpy(f0).bfloat16(), torch.from_numpy(f1).bfloat16(), torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-5)


def test_identical_maps_are_at_distance_zero():
    f0, _ = _maps((2, 5, 4, 48), seed=4)
    got = lh.lpips_head(torch.from_numpy(f0), torch.from_numpy(f0), torch.rand(48))
    assert torch.equal(got, torch.zeros(2))


@pytest.mark.parametrize("shape", [(3, 13, 17, 64), (50, 63, 63, 64)])
def test_cost_matches_jax(shape):
    want = K.lpips_head_cost(jnp.zeros(shape), jnp.zeros(shape), jnp.zeros((shape[-1],)))
    meta = torch.empty(shape, device="meta")
    got = lh.lpips_head_cost(meta, meta, torch.empty(shape[-1], device="meta"))
    assert (got.flops, got.bytes_accessed) == (want.flops, want.bytes_accessed)


def test_cpu_tensors_never_launch():
    f0, f1 = _maps((2, 3, 3, 8), seed=5)
    lh.lpips_head(torch.from_numpy(f0), torch.from_numpy(f1), torch.ones(8))
    assert lh.lpips_head.launches == 0


@pytest.mark.parametrize(
    ("args", "error"),
    [
        ((torch.zeros(2, 3, 3, 8), torch.zeros(2, 3, 3, 7), torch.ones(8)), ValueError),
        ((torch.zeros(2, 3, 3, 8), torch.zeros(2, 3, 3, 8), torch.ones(7)), ValueError),
        ((torch.zeros(2, 3, 8), torch.zeros(2, 3, 8), torch.ones(8)), ValueError),
        ((torch.zeros(2, 3, 3, 8, device="meta"), torch.zeros(2, 3, 3, 8, device="meta"), torch.ones(8, device="meta")), ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(args, error):
    with pytest.raises(error):
        lh.lpips_head(*args)
