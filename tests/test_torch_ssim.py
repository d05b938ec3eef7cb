"""The port's SSIM and MS-SSIM on the CPU, against the JAX package.

The same seeded numpy images go through the JAX functionals and classes
(``auto_compile=False``: their eager form, the one the port carries) and
through ``torchmetrics_tpu_torch`` with ``device="cpu"``. Pixels are drawn
uniform, as the JAX suite draws them. Tolerances, relative, measured:

- 1e-6 for 2-D SSIM means (seen: 6e-8);
- 1e-5 for per-pixel SSIM maps (seen: 6.5e-6). A window of 121 products is
  summed in another order by torch's CPU convolution (sequentially) than by
  XLA's, and ``E[x^2] - E[x]^2`` amplifies the difference by ``E[x^2] / var``
  (~4 here): each package is within 6e-6 of float64 per pixel;
- 2e-5 for MS-SSIM (seen: 1.02e-5; the port is 6.2e-6 above float64, the JAX
  package 4.1e-6 below, five scales of the same cancellation), and 1e-5 for
  each against float64;
- 2e-5 for volumetric SSIM: a 9x9x9 window sums 729 products.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu.functional.image as JF
import torchmetrics_tpu.image as JI
import torchmetrics_tpu_torch.functional.image as PF
import torchmetrics_tpu_torch.image as PI
from torchmetrics_tpu.collections import MetricCollection as JaxCollection
from torchmetrics_tpu.utilities.compute import _safe_pow as jax_safe_pow
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.functional.image import ssim as pssim
from torchmetrics_tpu_torch.utilities.compute import _safe_pow

RTOL = 1e-6
MAP_RTOL = 1e-5
MS_RTOL = 2e-5
F64_RTOL = 1e-5
VOLUME_RTOL = 2e-5


def _pair(seed, shape, noise=0.08):
    """Pixels drawn uniform in [0, 1], as the JAX suite and the golden specs draw them, and noisy copies of them."""
    rng = np.random.default_rng(seed)
    target = rng.random(shape)
    preds = np.clip(target + noise * rng.normal(size=shape), 0.0, 1.0)
    return preds.astype(np.float32), target.astype(np.float32)


def _smooth_pair(seed, shape, noise=0.08):
    """Smooth images (a coarse grid, upsampled) and noisy copies: local variances far below the squared means."""
    rng = np.random.default_rng(seed)
    coarse = rng.random(shape[:2] + tuple(max(2, s // 8) for s in shape[2:]))
    target = torch.nn.functional.interpolate(torch.from_numpy(coarse), size=shape[2:], mode="bilinear").numpy()
    preds = np.clip(target + noise * rng.normal(size=shape), 0.0, 1.0)
    return preds.astype(np.float32), target.astype(np.float32)


def _close(got, want, rtol, atol=0.0):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    want = np.asarray(want, dtype=np.float64)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy().astype(np.float64), want, rtol=rtol, atol=atol)


SSIM_CASES = {
    "gaussian": ((2, 3, 48, 40), {}),
    "data_range_1": ((2, 3, 48, 40), {"data_range": 1.0}),
    "data_range_tuple": ((2, 3, 48, 40), {"data_range": (0.1, 0.9)}),
    "uniform_7": ((2, 3, 48, 40), {"gaussian_kernel": False, "kernel_size": 7}),
    "sigma_pair": ((2, 1, 48, 40), {"sigma": (1.0, 2.0), "kernel_size": (7, 13)}),
    "k1_k2": ((2, 3, 48, 40), {"k1": 0.05, "k2": 0.1}),
    "sum": ((3, 2, 32, 32), {"reduction": "sum"}),
    "none": ((3, 2, 32, 32), {"reduction": "none"}),
    "full_image": ((2, 3, 32, 36), {"return_full_image": True, "reduction": "none"}),
    "contrast_sensitivity": ((2, 3, 32, 36), {"return_contrast_sensitivity": True}),
    # SSIM's default pad is 5: a side of 6 is the last one `F.pad(mode="reflect")` would take
    "reflect_limit": ((2, 2, 6, 24), {}),
    "reflect_past_limit": ((2, 2, 5, 24), {}),
}


@pytest.mark.parametrize(("shape", "kwargs"), list(SSIM_CASES.values()), ids=list(SSIM_CASES))
def test_ssim_functional_matches_jax(shape, kwargs):
    preds, target = _pair(1, shape)
    want = JF.structural_similarity_index_measure(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = PF.structural_similarity_index_measure(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    if kwargs.get("return_full_image"):
        _close(got[0], want[0], RTOL, atol=1e-7)
        _close(got[1], want[1], MAP_RTOL)
    else:
        _close(got, want, RTOL, atol=1e-7)


@pytest.mark.parametrize(
    "kwargs", [{"sigma": 1.0}, {"sigma": 1.0, "gaussian_kernel": False, "kernel_size": 5}],
    ids=["gaussian", "uniform"],
)
def test_volumetric_ssim_matches_jax(kwargs):
    preds, target = _pair(2, (2, 2, 14, 24, 24))
    want = JF.structural_similarity_index_measure(jnp.asarray(preds), jnp.asarray(target), reduction="none", **kwargs)
    got = PF.structural_similarity_index_measure(torch.from_numpy(preds), torch.from_numpy(target), reduction="none",
                                                 **kwargs)
    _close(got, want, VOLUME_RTOL)


MS_CASES = {
    "relu": ((2, 3, 180, 180), {}),
    "normalize_none": ((2, 3, 180, 180), {"normalize": None}),
    "three_betas": ((2, 1, 64, 72), {"betas": (0.2, 0.3, 0.5), "reduction": "none"}),
    "uniform_sum": ((2, 1, 64, 72), {"betas": (0.5, 0.5), "gaussian_kernel": False, "kernel_size": 7,
                                     "reduction": "sum", "data_range": 1.0}),
    "volumetric": ((2, 1, 16, 32, 32), {"betas": (0.5, 0.5), "sigma": 0.5, "kernel_size": 5}),
}


@pytest.mark.parametrize(("shape", "kwargs"), list(MS_CASES.values()), ids=list(MS_CASES))
def test_ms_ssim_functional_matches_jax(shape, kwargs):
    preds, target = _pair(3, shape, noise=0.15)
    want = JF.multiscale_structural_similarity_index_measure(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = PF.multiscale_structural_similarity_index_measure(torch.from_numpy(preds), torch.from_numpy(target),
                                                            **kwargs)
    _close(got, want, MS_RTOL)


def _ms_ssim_float64(preds, target, betas=(0.0448, 0.2856, 0.3001, 0.2363, 0.1333)):
    """MS-SSIM's arithmetic in float64: the port's ``_ssim_update`` on float64 tensors (the functional casts to float32)."""
    p, t = torch.from_numpy(preds).double(), torch.from_numpy(target).double()
    mcs = []
    for i in range(len(betas)):
        sim, cs = pssim._ssim_update(p, t, return_contrast_sensitivity=True)
        mcs.append(cs)
        if i < len(betas) - 1:
            p, t = torch.nn.functional.avg_pool2d(p, 2), torch.nn.functional.avg_pool2d(t, 2)
    mcs[-1] = sim
    return torch.prod(torch.relu(torch.stack(mcs)) ** torch.tensor(betas, dtype=torch.float64)[:, None], 0).mean()


def test_ms_ssim_both_packages_near_float64():
    preds, target = _pair(3, (2, 3, 180, 180), noise=0.15)
    ref = _ms_ssim_float64(preds, target).numpy()
    _close(PF.multiscale_structural_similarity_index_measure(torch.from_numpy(preds), torch.from_numpy(target)),
           ref, F64_RTOL)
    np.testing.assert_allclose(
        float(JF.multiscale_structural_similarity_index_measure(jnp.asarray(preds), jnp.asarray(target))), ref,
        rtol=F64_RTOL)


def test_ssim_on_smooth_images_is_as_near_float64_as_the_jax_package():
    """Where ``E[x^2] - E[x]^2`` cancels, two float32 evaluations part: the JAX package's eager and jitted SSIM
    differ by ~4e-6 here. Both packages are held to a float64 evaluation of the same arithmetic instead."""
    preds, target = _smooth_pair(1, (2, 3, 48, 40))
    ref = float(pssim._ssim_update(torch.from_numpy(preds).double(), torch.from_numpy(target).double()).mean())
    got = float(PF.structural_similarity_index_measure(torch.from_numpy(preds), torch.from_numpy(target)))
    want = float(JF.structural_similarity_index_measure(jnp.asarray(preds), jnp.asarray(target)))
    assert abs(got - ref) <= max(abs(want - ref), 1e-6 * abs(ref))


def test_ms_ssim_normalize_none_keeps_nan_for_negative_scales():
    """A negative contrast term to a fractional power is NaN under ``normalize=None``, as in the JAX package."""
    rng = np.random.default_rng(4)
    preds = rng.random((2, 1, 64, 64)).astype(np.float32)
    target = (1.0 - preds + 0.01 * rng.normal(size=preds.shape)).astype(np.float32)  # anti-correlated
    kwargs = {"betas": (0.5, 0.5), "normalize": None, "reduction": "none"}
    want = np.asarray(JF.multiscale_structural_similarity_index_measure(jnp.asarray(preds), jnp.asarray(target),
                                                                        **kwargs))
    got = PF.multiscale_structural_similarity_index_measure(torch.from_numpy(preds), torch.from_numpy(target),
                                                            **kwargs).numpy()
    assert np.isnan(want).all() and np.isnan(got).all()
    relu = PF.multiscale_structural_similarity_index_measure(torch.from_numpy(preds), torch.from_numpy(target),
                                                             betas=(0.5, 0.5), reduction="none")
    assert torch.equal(relu, torch.zeros(2))


def test_safe_pow_matches_jax():
    base = np.array([[-0.5, 0.0, 0.3, 1.0], [2.0, -1.0, 0.0, 0.7]], np.float32)
    exp = np.array([[0.5], [2.0]], np.float32)
    want = np.asarray(jax_safe_pow(jnp.asarray(base), jnp.asarray(exp)))
    got = _safe_pow(torch.from_numpy(base), torch.from_numpy(exp)).numpy()
    np.testing.assert_array_equal(got, want)
    x = torch.tensor([0.0, 0.25], requires_grad=True)
    _safe_pow(x, torch.tensor(0.5)).sum().backward()
    assert torch.isfinite(x.grad).all()  # 0 at the zero base, not inf


def _stream(seed, shape, n_updates):
    return [_pair(seed + i, shape) for i in range(n_updates)]


def _close_ssim(got, want, rtol=RTOL):
    """Values at ``rtol``; a ``return_full_image`` map at ``MAP_RTOL``."""
    if isinstance(want, tuple):
        _close(got[0], want[0], rtol, atol=1e-7)
        _close(got[1], want[1], MAP_RTOL)
    else:
        _close(got, want, rtol, atol=1e-7)


@pytest.mark.parametrize(
    "kwargs",
    [{"data_range": 1.0}, {"data_range": 1.0, "reduction": "sum"}, {"data_range": 1.0, "reduction": "none"},
     {"data_range": 1.0, "return_full_image": True}, {"data_range": (0.0, 1.0)}, {}],
    ids=["mean", "sum", "none", "full_image", "data_range_tuple", "data_range_none"],
)
def test_ssim_class_accumulates_like_the_functional(kwargs):
    batches = _stream(10, (2, 2, 32, 32), 3)
    port = PI.StructuralSimilarityIndexMeasure(device="cpu", **kwargs)
    jax_metric = JI.StructuralSimilarityIndexMeasure(auto_compile=False, **kwargs)
    for i, (p, t) in enumerate(batches):
        if i == 0:
            _close_ssim(port(torch.from_numpy(p), torch.from_numpy(t)), jax_metric(jnp.asarray(p), jnp.asarray(t)))
        else:
            port.update(torch.from_numpy(p), torch.from_numpy(t))
            jax_metric.update(jnp.asarray(p), jnp.asarray(t))
    got = port.compute()
    _close_ssim(got, jax_metric.compute())
    if "data_range" not in kwargs:
        return  # without a data range each update takes its own batch's range
    reduction = kwargs.get("reduction", "elementwise_mean")
    whole = PF.structural_similarity_index_measure(
        torch.from_numpy(np.concatenate([p for p, _ in batches])),
        torch.from_numpy(np.concatenate([t for _, t in batches])),
        reduction=reduction, **{k: v for k, v in kwargs.items() if k != "reduction"},
    )
    _close_ssim(got, tuple(w.numpy() for w in whole) if isinstance(whole, tuple) else whole.numpy())


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_ms_ssim_class_accumulates_like_the_functional(reduction):
    batches = _stream(20, (2, 1, 64, 64), 3)
    kwargs = {"betas": (0.3, 0.3, 0.4), "data_range": 1.0, "reduction": reduction}
    port = PI.MultiScaleStructuralSimilarityIndexMeasure(device="cpu", **kwargs)
    jax_metric = JI.MultiScaleStructuralSimilarityIndexMeasure(auto_compile=False, **kwargs)
    for p, t in batches:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        jax_metric.update(jnp.asarray(p), jnp.asarray(t))
    _close(port.compute(), jax_metric.compute(), MS_RTOL)
    whole = PF.multiscale_structural_similarity_index_measure(
        torch.from_numpy(np.concatenate([p for p, _ in batches])),
        torch.from_numpy(np.concatenate([t for _, t in batches])), **kwargs)
    _close(port.compute(), whole.numpy(), RTOL, atol=1e-7)


def test_ssim_and_ms_ssim_in_one_collection_stay_apart():
    """Their state names agree (``similarity``, ``total``); on data where the values differ they are two groups."""
    batches = _stream(30, (2, 1, 64, 64), 3)
    kwargs = {"data_range": 1.0}
    ms_kwargs = {"data_range": 1.0, "betas": (0.3, 0.3, 0.4)}
    port = MetricCollection({"ssim": PI.StructuralSimilarityIndexMeasure(device="cpu", **kwargs),
                             "ms_ssim": PI.MultiScaleStructuralSimilarityIndexMeasure(device="cpu", **ms_kwargs)})
    jax_col = JaxCollection({"ssim": JI.StructuralSimilarityIndexMeasure(auto_compile=False, **kwargs),
                             "ms_ssim": JI.MultiScaleStructuralSimilarityIndexMeasure(auto_compile=False, **ms_kwargs)})
    alone = PI.StructuralSimilarityIndexMeasure(device="cpu", **kwargs)
    for p, t in batches:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        jax_col.update(jnp.asarray(p), jnp.asarray(t))
        alone.update(torch.from_numpy(p), torch.from_numpy(t))
    assert sorted(sorted(g) for g in port.compute_groups.values()) == [["ms_ssim"], ["ssim"]]
    got, want = port.compute(), jax_col.compute()
    assert abs(float(got["ssim"]) - float(got["ms_ssim"])) > 1e-3
    for key in ("ssim", "ms_ssim"):
        _close(got[key], want[key], MS_RTOL if key == "ms_ssim" else RTOL)
    assert torch.equal(got["ssim"], alone.compute())


def test_ssim_rejects_what_the_jax_package_rejects():
    with pytest.raises(ValueError, match="BxCxHxW"):
        PF.structural_similarity_index_measure(torch.rand(3, 16, 16), torch.rand(3, 16, 16))
    with pytest.raises(ValueError, match="same shape"):
        PF.structural_similarity_index_measure(torch.rand(1, 1, 16, 16), torch.rand(1, 1, 16, 17))
    with pytest.raises(ValueError, match="larger than"):
        PF.multiscale_structural_similarity_index_measure(torch.rand(1, 1, 64, 64), torch.rand(1, 1, 64, 64))
    with pytest.raises(ValueError, match="reduction"):
        PI.StructuralSimilarityIndexMeasure(reduction="max", device="cpu")
    with pytest.raises(ValueError, match="normalize"):
        PI.MultiScaleStructuralSimilarityIndexMeasure(normalize="tanh", device="cpu")
