"""The port's pairwise distances on the CPU, against the JAX package.

All five functions, with ``y`` and without, each ``zero_diagonal`` setting
and each ``reduction``, on the same seeded inputs, float32 and half
precision. Values agree within ``RTOL``/``ATOL``: float32 products and sums
of ``D`` terms in another order. One exception is stated where it is
checked: the diagonal of an euclidean matrix of ``x`` with itself is the
square root of the Gram identity's float32 cancellation residue, which is
noise of ~``sqrt(eps * ‖x‖²)`` in either package. Manhattan and Minkowski
are also held to themselves in row tiles smaller than N.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.pairwise as JP
import torchmetrics_tpu_torch.functional.pairwise as PP
from torchmetrics_tpu.utilities.compute import _safe_matmul as jax_safe_matmul
from torchmetrics_tpu_torch.utilities.compute import _safe_matmul

pdist = importlib.import_module("torchmetrics_tpu_torch.functional.pairwise.distances")

RTOL = 1e-5
ATOL = 2e-5
FUNCTIONS = [
    ("pairwise_cosine_similarity", {}),
    ("pairwise_euclidean_distance", {}),
    ("pairwise_linear_similarity", {}),
    ("pairwise_manhattan_distance", {}),
    ("pairwise_minkowski_distance", {"exponent": 3}),
    ("pairwise_minkowski_distance", {"exponent": 1.5}),
]
HALF = {"float16": (np.float16, torch.float16, jnp.float16), "bfloat16": (np.float32, torch.bfloat16, jnp.bfloat16)}


def data(seed, n=13, m=9, d=16):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(m, d)).astype(np.float32)


def run_both(name, x, y, **kwargs):
    got = getattr(PP, name)(torch.from_numpy(x), None if y is None else torch.from_numpy(y), **kwargs)
    want = getattr(JP, name)(jnp.asarray(x), None if y is None else jnp.asarray(y), **kwargs)
    return got, np.asarray(want)


@pytest.mark.parametrize(("name", "kwargs"), FUNCTIONS, ids=[f"{n}-{k}" for n, k in FUNCTIONS])
@pytest.mark.parametrize("with_y", [True, False])
@pytest.mark.parametrize("zero_diagonal", [None, True, False])
@pytest.mark.parametrize("reduction", [None, "none", "mean", "sum"])
def test_pairwise_matches_jax(name, kwargs, with_y, zero_diagonal, reduction):
    x, y = data(len(name))
    got, want = run_both(name, x, y if with_y else None, zero_diagonal=zero_diagonal, reduction=reduction, **kwargs)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    self_diagonal = not with_y and zero_diagonal is False
    if self_diagonal and name == "pairwise_euclidean_distance":
        # off the diagonal as everywhere; on it both are sqrt of a float32 residue of ~eps * ‖x‖² (~1e-6 * 16)
        if reduction in (None, "none"):
            off = ~np.eye(len(x), dtype=bool)
            np.testing.assert_allclose(got.numpy()[off], want[off], rtol=RTOL, atol=ATOL)
            assert np.abs(np.diagonal(got.numpy())).max() < 1e-2 and np.abs(np.diagonal(want)).max() < 1e-2
        return
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(("name", "kwargs"), FUNCTIONS, ids=[f"{n}-{k}" for n, k in FUNCTIONS])
@pytest.mark.parametrize("dtype", sorted(HALF))
def test_half_precision_inputs(name, kwargs, dtype):
    """Half inputs go up to float32 in both packages before any arithmetic."""
    x, y = data(3)
    np_dtype, torch_dtype, jax_dtype = HALF[dtype]
    got = getattr(PP, name)(torch.from_numpy(x).to(torch_dtype), torch.from_numpy(y).to(torch_dtype), **kwargs)
    want = getattr(JP, name)(jnp.asarray(x).astype(jax_dtype), jnp.asarray(y).astype(jax_dtype), **kwargs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", sorted(HALF))
def test_safe_matmul_half_in_half_out(dtype):
    """A half product is taken in float32 and rounded back once: equal to the JAX package's within half an ulp."""
    x, y = data(4)
    _, torch_dtype, jax_dtype = HALF[dtype]
    got = _safe_matmul(torch.from_numpy(x).to(torch_dtype), torch.from_numpy(y).to(torch_dtype))
    want = jax_safe_matmul(jnp.asarray(x).astype(jax_dtype), jnp.asarray(y).astype(jax_dtype))
    assert got.dtype == torch_dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32), rtol=1e-2 if dtype == "bfloat16" else 1e-3)


@pytest.mark.parametrize("name", ["pairwise_manhattan_distance", "pairwise_minkowski_distance"])
@pytest.mark.parametrize("rows", [1, 4, 13])
def test_row_tiles_do_not_change_the_result(monkeypatch, name, rows):
    x, y = data(5, n=13, m=11, d=7)
    whole = getattr(PP, name)(torch.from_numpy(x), torch.from_numpy(y))
    monkeypatch.setattr(pdist, "_TILE_BYTES", rows * 4 * 11 * 7)
    assert pdist._tile_rows(11, 7) == rows
    tiled = getattr(PP, name)(torch.from_numpy(x), torch.from_numpy(y))
    assert torch.equal(whole, tiled)
    _, want = run_both(name, x, y)
    np.testing.assert_allclose(tiled.numpy(), want, rtol=RTOL, atol=ATOL)


def test_zero_diagonal_of_a_wide_matrix():
    x, y = data(6, n=4, m=9)
    got, want = run_both("pairwise_linear_similarity", x, y, zero_diagonal=True)
    assert (np.diagonal(got.numpy()) == 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(("args", "error"), [
    (dict(x=np.ones((3,), np.float32)), "2D tensor"),
    (dict(x=np.ones((3, 2), np.float32), y=np.ones((3, 4), np.float32)), "same as the last dimension"),
    (dict(x=np.ones((3, 2), np.float32), reduction="max"), "reduction"),
])
def test_argument_errors(args, error):
    for module, conv in ((PP, torch.from_numpy), (JP, jnp.asarray)):
        kwargs = {k: conv(v) if isinstance(v, np.ndarray) else v for k, v in args.items()}
        with pytest.raises(ValueError, match=error):
            module.pairwise_linear_similarity(**kwargs)
    with pytest.raises(ValueError, match="exponent"):
        PP.pairwise_minkowski_distance(torch.ones(2, 2), exponent=0.5)
