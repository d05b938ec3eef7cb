"""The port's audio metrics but SRMR on the CPU, against the JAX package.

The SNR family (SNR, SI-SDR, SI-SNR, C-SI-SNR from real and complex
spectra, SA-SDR) within ``SNR_ATOL`` dB: the same float32 formulas, sums in
another order. SDR within ``SDR_ATOL`` dB at filter lengths 128 and 512: a
float32 Toeplitz solve by LU on both sides, in another order (the JAX
suite's own tolerance against the reference). PIT within ``PIT_RTOL`` and ``PIT_ATOL`` and
with equal permutations, for 2-4 speakers in both modes and both
``eval_func``; the port's own Hungarian algorithm (7+ speakers) against
scipy's ``linear_sum_assignment``. The classes through ``forward``,
``update``, ``compute``, ``state_dict`` and ``reset``, and the PESQ/STOI
gates: neither backend is installed here, so only their errors are held.
The JAX metrics are built with ``auto_compile=False``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import torchmetrics_tpu.audio as JA
import torchmetrics_tpu.functional.audio as JF
import torchmetrics_tpu_torch.audio as PA
import torchmetrics_tpu_torch.functional.audio as PF
from torchmetrics_tpu_torch.utilities.imports import _PESQ_AVAILABLE, _PYSTOI_AVAILABLE, RequirementCache

SNR_ATOL = 1e-5  # dB
SDR_ATOL = 5e-2  # dB
PIT_RTOL = 1e-5  # relative: a float32 SI-SDR near -45 dB moves by ~1e-4 dB with the order of its sums
PIT_ATOL = 1e-5  # dB, near 0 dB
pit_mod = importlib.import_module("torchmetrics_tpu_torch.functional.audio.pit")


def pair(seed, shape=(4, 700), noise=0.6):
    rng = np.random.default_rng(seed)
    target = rng.standard_normal(shape).astype(np.float32)
    preds = (target + noise * rng.standard_normal(shape)).astype(np.float32)
    return preds, target


def both(name, *arrays, **kwargs):
    got = getattr(PF, name)(*[torch.from_numpy(a) for a in arrays], **kwargs)
    want = getattr(JF, name)(*[jnp.asarray(a) for a in arrays], **kwargs)
    return got, want


@pytest.mark.parametrize("zero_mean", [False, True])
@pytest.mark.parametrize(
    "name", ["signal_noise_ratio", "scale_invariant_signal_distortion_ratio", "source_aggregated_signal_distortion_ratio"]
)
def test_snr_family_matches_jax(name, zero_mean):
    preds, target = pair(len(name) + zero_mean, shape=(3, 2, 500))
    got, want = both(name, preds, target, zero_mean=zero_mean)
    assert got.dtype == torch.float32 and tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SNR_ATOL, rtol=0)


def test_si_snr_and_sa_sdr_without_scale_match_jax():
    preds, target = pair(5, shape=(3, 2, 300))
    got, want = both("scale_invariant_signal_noise_ratio", preds, target)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SNR_ATOL, rtol=0)
    got, want = both("source_aggregated_signal_distortion_ratio", preds, target, scale_invariant=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SNR_ATOL, rtol=0)


@pytest.mark.parametrize("zero_mean", [False, True])
def test_complex_si_snr_matches_jax_real_and_complex(zero_mean):
    preds, target = pair(7, shape=(2, 33, 20, 2))
    got, want = both("complex_scale_invariant_signal_noise_ratio", preds, target, zero_mean=zero_mean)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SNR_ATOL, rtol=0)
    as_complex = lambda a: a[..., 0] + 1j * a[..., 1]  # noqa: E731
    got_c = PF.complex_scale_invariant_signal_noise_ratio(
        torch.from_numpy(as_complex(preds).astype(np.complex64)), torch.from_numpy(as_complex(target).astype(np.complex64)),
        zero_mean=zero_mean,
    )
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want), atol=SNR_ATOL, rtol=0)


def test_complex_si_snr_shape_error_text():
    bad = torch.zeros(2, 10, 3)
    with pytest.raises(RuntimeError, match=r"expected to have the shape \(..., frequency, time, 2\)"):
        PF.complex_scale_invariant_signal_noise_ratio(bad, bad)
    with pytest.raises(RuntimeError, match="frequency, time, 2"):
        JF.complex_scale_invariant_signal_noise_ratio(jnp.zeros((2, 10, 3)), jnp.zeros((2, 10, 3)))


@pytest.mark.parametrize("filter_length", [128, 512])
@pytest.mark.parametrize("zero_mean", [False, True])
def test_sdr_matches_jax(filter_length, zero_mean):
    preds, target = pair(filter_length + zero_mean, shape=(3, 2000))
    got, want = both("signal_distortion_ratio", preds, target, filter_length=filter_length, zero_mean=zero_mean)
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SDR_ATOL, rtol=0)


def test_sdr_load_diag_and_toeplitz():
    preds, target = pair(3, shape=(2, 1500))
    got, want = both("signal_distortion_ratio", preds, target, filter_length=64, load_diag=1e-3, use_cg_iter=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SDR_ATOL, rtol=0)
    sdr = importlib.import_module("torchmetrics_tpu_torch.functional.audio.sdr")
    v = torch.arange(5.0)
    t = sdr._symmetric_toeplitz(v)
    assert torch.equal(t, t.T) and torch.equal(t[0], v) and torch.equal(t.diagonal(), torch.zeros(5))


@pytest.mark.parametrize("spk", [2, 3, 4])
@pytest.mark.parametrize("mode", ["speaker-wise", "permutation-wise"])
@pytest.mark.parametrize("eval_func", ["max", "min"])
def test_pit_matches_jax(spk, mode, eval_func):
    preds, target = pair(spk * 10 + len(mode), shape=(5, spk, 240), noise=1.5)
    metric = "scale_invariant_signal_distortion_ratio"
    got_m, got_p = PF.permutation_invariant_training(
        torch.from_numpy(preds), torch.from_numpy(target), getattr(PF, metric), mode=mode, eval_func=eval_func
    )
    want_m, want_p = JF.permutation_invariant_training(
        jnp.asarray(preds), jnp.asarray(target), getattr(JF, metric), mode=mode, eval_func=eval_func
    )
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=PIT_RTOL, atol=PIT_ATOL)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    permuted = PF.pit_permutate(torch.from_numpy(preds), got_p)
    np.testing.assert_array_equal(permuted.numpy(), np.asarray(JF.pit_permutate(jnp.asarray(preds), want_p)))


def test_pit_metric_kwargs_and_ties_take_the_first_permutation():
    preds, target = pair(11, shape=(3, 3, 200))
    got, want = (
        PF.permutation_invariant_training(torch.from_numpy(preds), torch.from_numpy(target), PF.signal_noise_ratio,
                                          zero_mean=True),
        JF.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target), JF.signal_noise_ratio, zero_mean=True),
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=PIT_RTOL, atol=PIT_ATOL)
    same = np.ones((2, 3, 50), dtype=np.float32)  # every permutation scores the same
    _, perm = PF.permutation_invariant_training(torch.from_numpy(same), torch.from_numpy(same), PF.signal_noise_ratio)
    assert perm.tolist() == [[0, 1, 2], [0, 1, 2]]


def test_pit_metric_errors_propagate():
    def broken(preds, target):
        raise KeyError("the metric's own error")

    x = torch.zeros(2, 2, 10)
    with pytest.raises(KeyError, match="own error"):
        PF.permutation_invariant_training(x, x, broken)


@pytest.mark.parametrize("n", [7, 8, 9, 10])
def test_hungarian_matches_scipy(n):
    rng = np.random.default_rng(n)
    for trial in range(20):
        m = rng.standard_normal((n, n))
        if trial % 5 == 0:
            m = np.round(m)  # ties
        for maximize in (False, True):
            cols = pit_mod._linear_sum_assignment(m, maximize)
            want = linear_sum_assignment(m, maximize)[1]
            assert sorted(cols) == list(range(n))
            np.testing.assert_allclose(m[np.arange(n), cols].sum(), m[np.arange(n), want].sum(), rtol=0, atol=1e-9)
            if trial % 5:
                np.testing.assert_array_equal(cols, want)  # a unique optimum: the same assignment


@pytest.mark.parametrize("eval_func", ["max", "min"])
def test_pit_eight_speakers_take_the_hungarian_route(eval_func):
    preds, target = pair(8, shape=(3, 8, 120), noise=1.0)
    metric = "scale_invariant_signal_distortion_ratio"
    got_m, got_p = PF.permutation_invariant_training(
        torch.from_numpy(preds), torch.from_numpy(target), getattr(PF, metric), eval_func=eval_func
    )
    want_m, want_p = JF.permutation_invariant_training(
        jnp.asarray(preds), jnp.asarray(target), getattr(JF, metric), eval_func=eval_func
    )
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=PIT_RTOL, atol=PIT_ATOL)


def test_pit_validation_errors():
    x = torch.zeros(2, 3, 10)
    with pytest.raises(RuntimeError, match="same shape at the batch and speaker"):
        PF.permutation_invariant_training(x, torch.zeros(2, 2, 10), PF.signal_noise_ratio)
    with pytest.raises(ValueError, match='eval_func can only be "max" or "min"'):
        PF.permutation_invariant_training(x, x, PF.signal_noise_ratio, eval_func="avg")
    with pytest.raises(ValueError, match="mode can only be"):
        PF.permutation_invariant_training(x, x, PF.signal_noise_ratio, mode="x")
    with pytest.raises(ValueError, match="Inputs must be of shape"):
        PF.permutation_invariant_training(torch.zeros(3), torch.zeros(3), PF.signal_noise_ratio)


CLASSES = [
    ("SignalNoiseRatio", {}, (4, 300)),
    ("SignalNoiseRatio", {"zero_mean": True}, (4, 300)),
    ("ScaleInvariantSignalNoiseRatio", {}, (4, 300)),
    ("ScaleInvariantSignalDistortionRatio", {"zero_mean": True}, (4, 300)),
    ("SourceAggregatedSignalDistortionRatio", {}, (4, 2, 300)),
    ("SourceAggregatedSignalDistortionRatio", {"scale_invariant": False}, (4, 2, 300)),
    ("ComplexScaleInvariantSignalNoiseRatio", {}, (2, 17, 10, 2)),
    ("SignalDistortionRatio", {"filter_length": 64}, (3, 800)),
]


@pytest.mark.parametrize(("cls", "kwargs", "shape"), CLASSES, ids=[f"{c}-{i}" for i, (c, _, _) in enumerate(CLASSES)])
def test_classes_match_jax(cls, kwargs, shape):
    port = getattr(PA, cls)(**kwargs, device="cpu")
    jax_metric = getattr(JA, cls)(**kwargs, auto_compile=False)
    atol = SDR_ATOL if cls == "SignalDistortionRatio" else SNR_ATOL
    for step in range(3):
        preds, target = pair(step + len(cls), shape=shape)
        if step == 0:
            got = port(torch.from_numpy(preds), torch.from_numpy(target))
            want = jax_metric(jnp.asarray(preds), jnp.asarray(target))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)
        else:
            port.update(torch.from_numpy(preds), torch.from_numpy(target))
            jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(jax_metric.compute()), atol=atol, rtol=0)
    assert port.total.dtype == torch.int64 and port.measure_sum.dtype == torch.float32
    assert int(port.total) == int(jax_metric.total)
    assert set(port.metric_state) == {"measure_sum", "total"}
    port.reset()
    assert int(port.total) == 0 and float(port.measure_sum) == 0.0


def test_pit_class_splits_base_and_metric_kwargs():
    preds, target = pair(4, shape=(3, 2, 300))
    port = PA.PermutationInvariantTraining(PF.signal_noise_ratio, eval_func="max", zero_mean=True, device="cpu")
    jax_metric = JA.PermutationInvariantTraining(JF.signal_noise_ratio, eval_func="max", zero_mean=True,
                                                 auto_compile=False)
    assert port.device == torch.device("cpu") and port.metric_kwargs == {"zero_mean": True}
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(jax_metric.compute()), rtol=PIT_RTOL, atol=PIT_ATOL)
    with pytest.raises(ValueError, match="eval_func"):
        PA.PermutationInvariantTraining(PF.signal_noise_ratio, eval_func="mean", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        PA.PermutationInvariantTraining(PF.signal_noise_ratio, mode="x", device="cpu")


def test_class_argument_validation():
    with pytest.raises(ValueError, match="zero_mean"):
        PA.SignalNoiseRatio(zero_mean=1, device="cpu")
    with pytest.raises(ValueError, match="scale_invariant"):
        PA.SourceAggregatedSignalDistortionRatio(scale_invariant=None, device="cpu")


def test_audio_classes_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        PA.SignalNoiseRatio()


def test_requirement_flags_probe_lazily():
    assert bool(RequirementCache("numpy")) and not bool(RequirementCache("no_such_package_here"))
    assert repr(RequirementCache("numpy")) == "RequirementCache(numpy=True)"


@pytest.mark.parametrize("absent", ["pesq", "stoi"])
def test_pesq_stoi_gates_raise_the_same_errors(absent):
    """Neither ``pesq`` nor ``pystoi`` is installed here: each entry point raises the JAX package's error."""
    flag = _PESQ_AVAILABLE if absent == "pesq" else _PYSTOI_AVAILABLE
    if bool(flag):
        pytest.skip(f"the {flag.module} package is installed")
    x = torch.zeros(8000)
    if absent == "pesq":
        calls = [
            (lambda: PF.perceptual_evaluation_speech_quality(x, x, 8000, "nb"),
             lambda: JF.perceptual_evaluation_speech_quality(jnp.zeros(8000), jnp.zeros(8000), 8000, "nb")),
            (lambda: PA.PerceptualEvaluationSpeechQuality(8000, "nb", device="cpu"),
             lambda: JA.PerceptualEvaluationSpeechQuality(8000, "nb")),
        ]
    else:
        calls = [
            (lambda: PF.short_time_objective_intelligibility(x, x, 8000),
             lambda: JF.short_time_objective_intelligibility(jnp.zeros(8000), jnp.zeros(8000), 8000)),
            (lambda: PA.ShortTimeObjectiveIntelligibility(8000, device="cpu"),
             lambda: JA.ShortTimeObjectiveIntelligibility(8000)),
        ]
    for port_call, jax_call in calls:
        with pytest.raises(ModuleNotFoundError) as got:
            port_call()
        with pytest.raises(ModuleNotFoundError) as want:
            jax_call()
        assert str(got.value) == str(want.value)


def test_pesq_checks_fs_then_mode_behind_the_gate(monkeypatch):
    """With the flag forced on, ``fs`` is checked before ``mode``, as in the JAX package (the backend is a stub)."""
    import sys
    import types

    pesq_mod = importlib.import_module("torchmetrics_tpu_torch.functional.audio.pesq")
    monkeypatch.setattr(pesq_mod, "_PESQ_AVAILABLE", True)
    monkeypatch.setitem(sys.modules, "pesq", types.SimpleNamespace(pesq=lambda fs, t, p, mode: float(len(t)) / fs))
    x = torch.zeros(2, 3, 800)
    with pytest.raises(ValueError, match="`fs` to either be 8000 or 16000"):
        pesq_mod.perceptual_evaluation_speech_quality(x, x, 44100, "xx")
    with pytest.raises(ValueError, match="`mode` to either be 'wb' or 'nb'"):
        pesq_mod.perceptual_evaluation_speech_quality(x, x, 8000, "xx")
    out = pesq_mod.perceptual_evaluation_speech_quality(x, x, 8000, "nb")
    assert out.shape == (2, 3) and torch.allclose(out, torch.full((2, 3), 0.1))
