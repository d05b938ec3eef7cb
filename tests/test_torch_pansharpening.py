"""The port's pan-sharpening metrics (D_lambda, D_s, QNR) on the CPU, against the JAX package.

Seeded numpy fused images, MS and PAN bands (pixels uniform in [0, 1], the
fused image a noisy upsampling of MS) go through the JAX functionals and
classes (``auto_compile=False``) and through ``torchmetrics_tpu_torch`` with
``device="cpu"``. D_s runs with and without ``pan_lr`` (without it, PAN is
degraded by an edge pad, a uniform filter and the antialiased bilinear
resize). Tolerance 1e-6 relative with an absolute floor of 1e-7: the values
are means of UQI differences, and UQI is held to 1e-6 in
``test_torch_image_quality.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu.functional.image as JF
import torchmetrics_tpu.image as JI
import torchmetrics_tpu_torch.functional.image as PF
import torchmetrics_tpu_torch.image as PI

RTOL = 1e-6
ATOL = 1e-7


def _scene(seed, n=2, c=4, side=32, ratio=4, pan_lr=False):
    """``(preds, ms, pan[, pan_lr])``: MS at ``side / ratio``, PAN and the fused image at ``side``."""
    rng = np.random.default_rng(seed)
    ms = rng.random((n, c, side // ratio, side // ratio))
    up = np.kron(ms, np.ones((ratio, ratio)))
    pan = np.repeat(up.mean(axis=1, keepdims=True), c, axis=1) + 0.05 * rng.normal(size=(n, c, side, side))
    preds = np.clip(up + 0.1 * rng.normal(size=up.shape), 0.0, 1.0)
    out = [preds, ms, pan]
    if pan_lr:
        out.append(pan.reshape(n, c, side // ratio, ratio, side // ratio, ratio).mean(axis=(3, 5)))
    return [a.astype(np.float32) for a in out]


def _close(got, want):
    want = np.asarray(want, dtype=np.float64)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy().astype(np.float64), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "kwargs", [{}, {"p": 2}, {"p": 3, "reduction": "sum"}], ids=["p1", "p2", "p3_sum"],
)
def test_d_lambda_matches_jax(kwargs):
    preds, ms, _ = _scene(1)
    want = JF.spectral_distortion_index(jnp.asarray(preds), jnp.asarray(ms), **kwargs)
    got = PF.spectral_distortion_index(torch.from_numpy(preds), torch.from_numpy(ms), **kwargs)
    _close(got, want)


@pytest.mark.parametrize(
    ("pan_lr", "kwargs"),
    [(False, {}), (True, {}), (False, {"norm_order": 2, "window_size": 3}), (True, {"reduction": "none"}),
     (False, {"reduction": "sum", "window_size": 5})],
    ids=["degraded", "pan_lr", "norm2_window3", "pan_lr_none", "sum_window5"],
)
def test_d_s_matches_jax(pan_lr, kwargs):
    arrays = _scene(2, pan_lr=pan_lr)
    want = JF.spatial_distortion_index(*[jnp.asarray(a) for a in arrays], **kwargs)
    got = PF.spatial_distortion_index(*[torch.from_numpy(a) for a in arrays], **kwargs)
    _close(got, want)


@pytest.mark.parametrize(
    ("pan_lr", "kwargs"),
    [(False, {}), (True, {}), (False, {"alpha": 0.5, "beta": 2.0, "norm_order": 2})],
    ids=["degraded", "pan_lr", "alpha_beta"],
)
def test_qnr_matches_jax(pan_lr, kwargs):
    arrays = _scene(3, pan_lr=pan_lr)
    want = JF.quality_with_no_reference(*[jnp.asarray(a) for a in arrays], **kwargs)
    got = PF.quality_with_no_reference(*[torch.from_numpy(a) for a in arrays], **kwargs)
    _close(got, want)


def _target(arrays, as_tensor):
    keys = ("ms", "pan", "pan_lr")
    return {k: as_tensor(a) for k, a in zip(keys, arrays[1:])}


@pytest.mark.parametrize(
    ("cls", "pan_lr"),
    [("SpatialDistortionIndex", False), ("SpatialDistortionIndex", True), ("QualityWithNoReference", False),
     ("QualityWithNoReference", True)],
    ids=["d_s", "d_s_pan_lr", "qnr", "qnr_pan_lr"],
)
def test_classes_stream_like_the_jax_classes_and_the_functional(cls, pan_lr):
    scenes = [_scene(10 + i, n=1, pan_lr=pan_lr) for i in range(3)]
    port = getattr(PI, cls)(device="cpu")
    jax_metric = getattr(JI, cls)(auto_compile=False)
    for i, arrays in enumerate(scenes):
        if i == 0:
            _close(port(torch.from_numpy(arrays[0]), _target(arrays, torch.from_numpy)),
                   jax_metric(jnp.asarray(arrays[0]), _target(arrays, jnp.asarray)))
        else:
            port.update(torch.from_numpy(arrays[0]), _target(arrays, torch.from_numpy))
            jax_metric.update(jnp.asarray(arrays[0]), _target(arrays, jnp.asarray))
    got = port.compute()
    _close(got, jax_metric.compute())
    whole = [torch.from_numpy(np.concatenate(parts)) for parts in zip(*scenes)]
    fn = PF.spatial_distortion_index if cls == "SpatialDistortionIndex" else PF.quality_with_no_reference
    _close(got, fn(*whole).numpy())


def test_d_lambda_class_streams_like_the_jax_class_and_the_functional():
    scenes = [_scene(20 + i, n=1)[:2] for i in range(3)]
    port = PI.SpectralDistortionIndex(device="cpu")
    jax_metric = JI.SpectralDistortionIndex(auto_compile=False)
    for preds, target in scenes:
        port.update(torch.from_numpy(preds), torch.from_numpy(np.kron(target, np.ones((4, 4)))))
        jax_metric.update(jnp.asarray(preds), jnp.asarray(np.kron(target, np.ones((4, 4)))))
    got = port.compute()
    _close(got, jax_metric.compute())
    preds = np.concatenate([p for p, _ in scenes])
    target = np.concatenate([np.kron(t, np.ones((4, 4))) for _, t in scenes])
    _close(got, PF.spectral_distortion_index(torch.from_numpy(preds), torch.from_numpy(target)).numpy())


def test_inputs_are_refused_as_the_jax_package_refuses_them():
    preds, ms, pan = (torch.from_numpy(a) for a in _scene(4))
    with pytest.raises(ValueError, match="multiples"):
        PF.spatial_distortion_index(preds, ms[..., :7, :7], pan)
    with pytest.raises(ValueError, match="window_size"):
        PF.spatial_distortion_index(preds, ms, pan, window_size=8)
    with pytest.raises(ValueError, match="norm_order"):
        PF.spatial_distortion_index(preds, ms, pan, norm_order=0)
    with pytest.raises(ValueError, match="spectral bands"):
        PF.spectral_distortion_index(preds[:, :1], ms[:, :1])
    with pytest.raises(ValueError, match="alpha"):
        PF.quality_with_no_reference(preds, ms, pan, alpha=-1)
    with pytest.raises(ValueError, match="`ms`"):
        PI.SpatialDistortionIndex(device="cpu").update(preds, {"pan": pan})
    with pytest.raises(ValueError, match="`p`"):
        PI.SpectralDistortionIndex(p=0, device="cpu")
