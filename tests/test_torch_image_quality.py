"""The port's PSNR, PSNR-B, UQI, SAM, ERGAS, RASE, RMSE-SW, TV, SCC, VIF and gradients on the CPU, against the JAX package.

The same seeded numpy images (pixels uniform in [0, 1], as the JAX suite
draws them) go through the JAX functionals and classes (``auto_compile=False``)
and through ``torchmetrics_tpu_torch`` with ``device="cpu"``. Tolerances,
relative: 1e-6 for float32 values, 1e-5 for VIF (log ratios of four scales of
window variances). The classes stream three updates and are held both to
the JAX class and to the port's functional over the concatenated batches.
Also: the pads against ``numpy.pad`` at and past the side (where
``F.pad(mode="reflect")`` refuses), the antialiased bilinear resize against
``jax.image.resize`` shrinking and growing, and every window sum in full
float32 whatever ``torch.backends.cudnn.allow_tf32`` says outside.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torchmetrics_tpu.functional.image as JF
import torchmetrics_tpu.image as JI
import torchmetrics_tpu_torch.functional.image as PF
import torchmetrics_tpu_torch.image as PI
from torchmetrics_tpu_torch.functional.image.d_s import _resize_bilinear
from torchmetrics_tpu_torch.functional.image.helper import _pad
from torchmetrics_tpu_torch.functional.image.psnr import _psnrb_compute_bef

RTOL = 1e-6
VIF_RTOL = 1e-5
RESIZE_ATOL = 3e-7  # seen 2.4e-7 on values in [0, 1]: the same weights, summed in another order
# per-pixel spectral angles: arccos turns a float32 ulp of a cosine near 1 (6e-8) into ~6e-8 / sin(angle) rad,
# ~1e-6 at the 0.05-0.3 rad of these pixels (seen 1.7e-6); the mean over pixels holds RTOL
SAM_MAP_ATOL = 5e-6


def _pair(seed, shape, noise=0.1, scale=1.0):
    rng = np.random.default_rng(seed)
    target = rng.random(shape)
    preds = np.clip(target + noise * rng.normal(size=shape), 0.0, 1.0)
    return (scale * preds).astype(np.float32), (scale * target).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=0.0):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    want = np.asarray(want, dtype=np.float64)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy().astype(np.float64), want, rtol=rtol, atol=atol)


FUNCTIONAL_CASES = {
    "psnr": ("peak_signal_noise_ratio", (2, 3, 16, 16), {}),
    "psnr_range": ("peak_signal_noise_ratio", (2, 3, 16, 16), {"data_range": 1.0, "base": 2.0}),
    "psnr_tuple_dim": ("peak_signal_noise_ratio", (2, 3, 16, 16),
                       {"data_range": (0.2, 0.8), "dim": (1, 2, 3), "reduction": "none"}),
    "psnr_dim_sum": ("peak_signal_noise_ratio", (2, 3, 16, 16), {"data_range": 1.0, "dim": 1, "reduction": "sum"}),
    "uqi": ("universal_image_quality_index", (2, 3, 32, 32), {}),
    "uqi_kernel": ("universal_image_quality_index", (2, 3, 32, 32),
                   {"kernel_size": (5, 7), "sigma": (1.0, 2.0), "reduction": "none"}),
    "uqi_reflect_limit": ("universal_image_quality_index", (2, 1, 6, 24), {}),
    "sam": ("spectral_angle_mapper", (2, 8, 16, 16), {}),
    "sam_none": ("spectral_angle_mapper", (2, 8, 16, 16), {"reduction": "none"}),
    "ergas": ("error_relative_global_dimensionless_synthesis", (2, 8, 16, 16), {}),
    "ergas_ratio": ("error_relative_global_dimensionless_synthesis", (2, 8, 16, 16), {"ratio": 2, "reduction": "sum"}),
    "rase": ("relative_average_spectral_error", (2, 4, 32, 32), {}),
    "rase_window": ("relative_average_spectral_error", (2, 4, 32, 32), {"window_size": 5}),
    "rmse_sw": ("root_mean_squared_error_using_sliding_window", (2, 3, 32, 32), {}),
    "rmse_sw_map": ("root_mean_squared_error_using_sliding_window", (2, 3, 32, 32),
                    {"window_size": 5, "return_rmse_map": True}),
    "scc": ("spatial_correlation_coefficient", (2, 3, 24, 24), {}),
    "scc_none_window": ("spatial_correlation_coefficient", (2, 3, 24, 24), {"window_size": 5, "reduction": "none"}),
    "scc_3d": ("spatial_correlation_coefficient", (2, 24, 24), {"reduction": "sum"}),
    "vif": ("visual_information_fidelity", (1, 3, 48, 48), {}),
    "vif_sigma": ("visual_information_fidelity", (1, 3, 48, 48), {"sigma_n_sq": 0.5}),
}


@pytest.mark.parametrize(("name", "shape", "kwargs"), list(FUNCTIONAL_CASES.values()), ids=list(FUNCTIONAL_CASES))
def test_functional_matches_jax(name, shape, kwargs):
    preds, target = _pair(1, shape)
    want = getattr(JF, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = getattr(PF, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    if kwargs.get("reduction") == "none" and name == "spectral_angle_mapper":
        _close(got, want, 0.0, atol=SAM_MAP_ATOL)
    else:
        _close(got, want, VIF_RTOL if name.startswith("visual") else RTOL, atol=1e-7)


def test_scc_with_a_high_pass_filter_of_its_own():
    preds, target = _pair(2, (2, 2, 20, 20))
    hp = np.array([[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0], [0.0, -1.0, 0.0], [0.0, 1.0, 0.0]], np.float32)  # 4x3
    want = JF.spatial_correlation_coefficient(jnp.asarray(preds), jnp.asarray(target), hp_filter=jnp.asarray(hp))
    got = PF.spatial_correlation_coefficient(torch.from_numpy(preds), torch.from_numpy(target),
                                             hp_filter=torch.from_numpy(hp))
    _close(got, want, RTOL, atol=1e-7)


def _blocky_pair(seed, shape, scale):
    """Smooth targets and predictions that carry an offset per 8x8 block, so the blocking term is not zero."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random(shape[:2] + (shape[2] // 4, shape[3] // 4)))
    target = torch.nn.functional.interpolate(coarse, size=shape[2:], mode="bilinear").numpy()
    offsets = np.kron(0.05 * rng.normal(size=shape[:2] + (shape[2] // 8, shape[3] // 8)), np.ones((8, 8)))
    return (scale * (target + offsets)).astype(np.float32), (scale * target).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 255.0], ids=["unit_range", "byte_range"])
def test_psnrb_matches_jax(scale):
    blocky, target = _blocky_pair(3, (2, 1, 24, 40), scale)
    want = JF.peak_signal_noise_ratio_with_blocked_effect(jnp.asarray(blocky), jnp.asarray(target))
    got = PF.peak_signal_noise_ratio_with_blocked_effect(torch.from_numpy(blocky), torch.from_numpy(target))
    _close(got, want)
    assert float(_psnrb_compute_bef(torch.from_numpy(blocky))) > 0  # the blocking term is in play


@pytest.mark.parametrize("reduction", ["sum", "mean", "none", None])
def test_total_variation_matches_jax(reduction):
    img = _pair(5, (3, 2, 20, 28))[0]
    _close(PF.total_variation(torch.from_numpy(img), reduction=reduction),
           JF.total_variation(jnp.asarray(img), reduction=reduction), RTOL)


def test_image_gradients_match_jax():
    img = np.random.default_rng(6).random((2, 3, 9, 13)).astype(np.float32)
    want = JF.image_gradients(jnp.asarray(img))
    got = PF.image_gradients(torch.from_numpy(img))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


CLASS_CASES = {
    "psnr": ("PeakSignalNoiseRatio", "peak_signal_noise_ratio", (2, 3, 16, 16), {"data_range": 1.0}),
    "psnr_dim": ("PeakSignalNoiseRatio", "peak_signal_noise_ratio", (2, 3, 16, 16),
                 {"data_range": 1.0, "dim": (1, 2, 3)}),
    "psnr_tuple": ("PeakSignalNoiseRatio", "peak_signal_noise_ratio", (2, 3, 16, 16), {"data_range": (0.1, 0.9)}),
    "uqi": ("UniversalImageQualityIndex", "universal_image_quality_index", (2, 3, 32, 32), {}),
    "sam": ("SpectralAngleMapper", "spectral_angle_mapper", (2, 8, 16, 16), {}),
    "ergas": ("ErrorRelativeGlobalDimensionlessSynthesis", "error_relative_global_dimensionless_synthesis",
              (2, 8, 16, 16), {}),
    "rase": ("RelativeAverageSpectralError", "relative_average_spectral_error", (2, 4, 32, 32), {}),
    "rmse_sw": ("RootMeanSquaredErrorUsingSlidingWindow", "root_mean_squared_error_using_sliding_window",
                (2, 3, 32, 32), {}),
    "scc": ("SpatialCorrelationCoefficient", "spatial_correlation_coefficient", (2, 3, 24, 24), {}),
    "vif": ("VisualInformationFidelity", "visual_information_fidelity", (1, 3, 48, 48), {}),
}


@pytest.mark.parametrize(("cls", "fn", "shape", "kwargs"), list(CLASS_CASES.values()), ids=list(CLASS_CASES))
def test_class_streams_like_the_jax_class_and_the_functional(cls, fn, shape, kwargs):
    batches = [_pair(10 + i, shape) for i in range(3)]
    port = getattr(PI, cls)(device="cpu", **kwargs)
    jax_metric = getattr(JI, cls)(auto_compile=False, **kwargs)
    rtol = VIF_RTOL if cls.startswith("Visual") else RTOL
    for i, (p, t) in enumerate(batches):
        if i == 0:
            _close(port(torch.from_numpy(p), torch.from_numpy(t)), jax_metric(jnp.asarray(p), jnp.asarray(t)), rtol,
                   atol=1e-7)
        else:
            port.update(torch.from_numpy(p), torch.from_numpy(t))
            jax_metric.update(jnp.asarray(p), jnp.asarray(t))
    got = port.compute()
    _close(got, jax_metric.compute(), rtol, atol=1e-7)
    preds = torch.from_numpy(np.concatenate([p for p, _ in batches]))
    target = torch.from_numpy(np.concatenate([t for _, t in batches]))
    _close(got, getattr(PF, fn)(preds, target, **kwargs).numpy(), rtol, atol=1e-7)


def test_psnr_without_a_data_range_tracks_the_target_extremes():
    batches = [_pair(20 + i, (2, 3, 8, 8)) for i in range(3)]
    batches[1] = (batches[1][0], batches[1][1] * 3.0 - 1.0)  # widen the range on one update only
    port = PI.PeakSignalNoiseRatio(device="cpu")
    jax_metric = JI.PeakSignalNoiseRatio(auto_compile=False)
    for p, t in batches:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        jax_metric.update(jnp.asarray(p), jnp.asarray(t))
    _close(port.compute(), jax_metric.compute())
    assert float(port.min_target) == float(np.min([t.min() for _, t in batches]))
    assert float(port.max_target) == float(np.max([t.max() for _, t in batches]))


@pytest.mark.parametrize("scale", [1.0, 255.0], ids=["unit_range", "byte_range"])
def test_psnrb_class_streams_like_the_jax_class(scale):
    batches = [_blocky_pair(30 + i, (2, 1, 16, 24), scale) for i in range(3)]
    port = PI.PeakSignalNoiseRatioWithBlockedEffect(device="cpu")
    jax_metric = JI.PeakSignalNoiseRatioWithBlockedEffect(auto_compile=False)
    for p, t in batches:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        jax_metric.update(jnp.asarray(p), jnp.asarray(t))
    _close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
def test_total_variation_class_streams_like_the_jax_class(reduction):
    batches = [_pair(40 + i, (2, 3, 12, 12))[0] for i in range(3)]
    port = PI.TotalVariation(device="cpu", reduction=reduction)
    jax_metric = JI.TotalVariation(auto_compile=False, reduction=reduction)
    for img in batches:
        port.update(torch.from_numpy(img))
        jax_metric.update(jnp.asarray(img))
    _close(port.compute(), jax_metric.compute())
    _close(port.compute(), PF.total_variation(torch.from_numpy(np.concatenate(batches)), reduction=reduction).numpy())


PAD_CASES = [((1, 2), (3, 0)), ((5, 5), (5, 5)), ((6, 6), (7, 7)), ((9, 11), (13, 2))]


@pytest.mark.parametrize("mode", ["symmetric", "reflect", "edge", "constant"])
@pytest.mark.parametrize("pads", PAD_CASES, ids=["short", "at_the_side", "past_the_side", "twice_the_side"])
def test_pad_modes_match_numpy(mode, pads):
    """A side of 6 (H) and 7 (W): a reflect pad of 5 is the widest ``F.pad`` takes; numpy reflects again past it."""
    x = np.random.default_rng(7).random((2, 3, 6, 7)).astype(np.float32)
    want = np.pad(x, ((0, 0), (0, 0)) + pads, mode=mode)
    np.testing.assert_array_equal(_pad(torch.from_numpy(x), pads, mode).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (0, 0)) + pads, mode=mode)), want)


@pytest.mark.parametrize(
    ("size", "out"),
    [((256, 256), (64, 64)), ((512, 384), (128, 96)), ((100, 60), (33, 17)), ((16, 16), (64, 64)),
     ((37, 29), (80, 50))],
    ids=["ppl_256_to_64", "d_s_4x", "odd_shrink", "grow_4x", "odd_grow"],
)
def test_antialiased_bilinear_resize_matches_jax(size, out):
    img = np.random.default_rng(8).random((2, 3) + size).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (2, 3) + out, method="bilinear"))
    got = _resize_bilinear(torch.from_numpy(img), out).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


WINDOW_SUMS = {
    "ssim": lambda p, t: PF.structural_similarity_index_measure(p, t),
    "ms_ssim": lambda p, t: PF.multiscale_structural_similarity_index_measure(p, t, betas=(0.5, 0.5)),
    "uqi": lambda p, t: PF.universal_image_quality_index(p, t),
    "scc": lambda p, t: PF.spatial_correlation_coefficient(p, t),
    "rmse_sw": lambda p, t: PF.root_mean_squared_error_using_sliding_window(p, t),
    "rase": lambda p, t: PF.relative_average_spectral_error(p, t),
    "vif": lambda p, t: PF.visual_information_fidelity(p, t),
    "d_s": lambda p, t: PF.spatial_distortion_index(p, t[..., ::4, ::4], t),
    "d_lambda": lambda p, t: PF.spectral_distortion_index(p, t),
}


@pytest.mark.parametrize("name", list(WINDOW_SUMS))
def test_every_window_sum_runs_in_full_float32(monkeypatch, name):
    """Each convolution runs with cuDNN's and cuBLAS's TF32 switched off, and the caller's switches come back."""
    seen = []
    for fn in ("conv2d", "conv3d"):
        real = getattr(torch.nn.functional, fn)

        def recording(*args, _real=real, **kwargs):
            seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
            return _real(*args, **kwargs)

        monkeypatch.setattr(torch.nn.functional, fn, recording)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    p, t = (torch.from_numpy(a) for a in _pair(9, (1, 2, 48, 48)))
    WINDOW_SUMS[name](p, t)
    assert seen and set(seen) == {(False, False)}
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_image_classes_default_to_cuda():
    """Built without ``device=``, a metric keeps its states on ``cuda``: where there is no GPU it raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    for cls in ("PeakSignalNoiseRatio", "StructuralSimilarityIndexMeasure", "VisualInformationFidelity",
                "SpatialDistortionIndex", "TotalVariation"):
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(PI, cls)()


def test_functional_modules_are_reachable_by_path():
    """``functional.image.ssim`` and friends are modules, as in the JAX package."""
    for name in ("helper", "ssim", "psnr", "misc", "vif", "gradients", "d_s", "qnr"):
        importlib.import_module(f"torchmetrics_tpu_torch.functional.image.{name}")
