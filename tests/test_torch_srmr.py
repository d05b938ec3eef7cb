"""SRMR and its IIR filterbanks (kernel S1's plain loop) on the CPU, against the JAX package and a scipy oracle.

``biquad_bank_plain`` is held to the JAX package's ``_biquad`` (a float32
``lax.scan``) within ``BIQUAD_RTOL`` of the output's scale on the gammatone
cascade: the same recurrence, but XLA may fuse a product and a sum into one
rounding where the loop rounds twice. The modulation bands' poles sit within
~4e-4 of the unit circle and amplify that difference, so there each band is
held to float64 ``lfilter`` no further than the JAX package's own is. SRMR, both paths and ``norm``, at 8 and 16 kHz,
within ``SRMR_RTOL`` of the JAX package and, at 8 kHz, of a float64 oracle
that runs scipy's ``lfilter`` and ``hilbert`` (the JAX suite's own oracle
and tolerance, ``tests/unittests/audio/test_srmr.py``); at 16 kHz, where
the float32 pipeline of both packages drifts further from float64, no
further from the oracle than the JAX package is, plus ``SRMR_RTOL``. The oracle lives here,
since that file imports JAX's metric classes; its filter design is the
port's, which is held equal to the JAX package's first.
"""

import importlib
from math import ceil, pi

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch

import torchmetrics_tpu.audio as JA
import torchmetrics_tpu.functional.audio as JF
import torchmetrics_tpu_torch.audio as PA
import torchmetrics_tpu_torch.functional.audio as PF
from torchmetrics_tpu.functional.audio import srmr as jsrmr
from torchmetrics_tpu_torch._kernels import biquad as kb

psrmr = importlib.import_module("torchmetrics_tpu_torch.functional.audio.srmr")

BIQUAD_RTOL = 1e-5
SRMR_RTOL = 5e-3


def _oracle_srmr(x, fs, n_cochlear_filters=23, low_freq=125.0, min_cf=4.0, max_cf=None, norm=False):
    """Float64 scipy SRMR (slow path): ``lfilter`` for every IIR stage, ``hilbert`` for the envelope."""
    x = np.atleast_2d(np.asarray(x, np.float64))
    num_batch, time = x.shape
    max_vals = np.abs(x).max(axis=-1, keepdims=True)
    x = x / np.where(max_vals > 1, max_vals, 1.0)
    nums, den, gain = psrmr._gammatone_coefs(fs, n_cochlear_filters, low_freq)
    n_filters = den.shape[0]
    gt = np.empty((num_batch, n_filters, time))
    for b in range(num_batch):
        for f in range(n_filters):
            y = x[b]
            for s in range(4):
                y = sig.lfilter(nums[s, f], den[f], y)
            gt[b, f] = y / gain[f]
    assert time % 16 == 0, "the oracle's hilbert equals the padded-FFT envelope only at multiples of 16"
    env = np.abs(sig.hilbert(gt, axis=-1))
    mfs = float(fs)
    w_length, w_inc = ceil(0.256 * mfs), ceil(0.064 * mfs)
    if max_cf is None:
        max_cf = 30.0 if norm else 128.0
    mod_num, mod_den, cutoffs = psrmr._modulation_filterbank(float(min_cf), float(max_cf), 8, mfs, 2.0)
    mod_out = np.empty((num_batch, n_filters, 8, time))
    for k in range(8):
        mod_out[:, :, k, :] = sig.lfilter(mod_num[k], mod_den[k], env, axis=-1)
    pad = max(ceil(time / w_inc) * w_inc - time, w_length - time)
    padded = np.pad(mod_out, [(0, 0)] * 3 + [(0, pad)])
    num_frames = 1 + (time - w_length) // w_inc
    window = 0.54 - 0.46 * np.cos(2.0 * pi * np.arange(w_length) / (w_length + 1))
    idx = np.arange(num_frames)[:, None] * w_inc + np.arange(w_length)[None, :]
    energy = ((padded[..., idx] * window) ** 2).sum(axis=-1)
    if norm:
        peak = energy.mean(axis=1, keepdims=True).max(axis=(2, 3), keepdims=True)
        energy = np.clip(energy, peak * 10.0 ** (-30.0 / 10.0), peak)
    erbs = np.flipud(psrmr._erb_bandwidths(psrmr._erb_centre_freqs(fs, n_cochlear_filters, low_freq)))
    avg_energy = energy.mean(axis=-1)
    scores = []
    for b in range(num_batch):
        ac_perc = avg_energy[b].sum(axis=1) * 100.0 / avg_energy[b].sum()
        bw = erbs[int(np.argmax(np.cumsum(ac_perc[::-1]) > 90.0))]
        if cutoffs[4] <= bw < cutoffs[5]:
            kstar = 5
        elif cutoffs[5] <= bw < cutoffs[6]:
            kstar = 6
        elif cutoffs[6] <= bw < cutoffs[7]:
            kstar = 7
        elif cutoffs[7] <= bw:
            kstar = 8
        else:
            raise ValueError("bw below the 5th band's lower cutoff")
        scores.append(avg_energy[b, :, :4].sum() / avg_energy[b, :, 4:kstar].sum())
    return np.asarray(scores)


def speechlike(seed, time, fs):
    """An amplitude-modulated multi-tone burst, with energy across the modulation bands."""
    rng = np.random.default_rng(seed)
    t = np.arange(time) / fs
    carrier = sum(np.sin(2 * pi * f * t + rng.uniform(0, 2 * pi)) for f in rng.uniform(200, 0.45 * fs, 5))
    am = 1.0 + 0.8 * np.sin(2 * pi * rng.uniform(3, 25) * t)
    return (carrier * am + 0.1 * rng.standard_normal(time)).astype(np.float32)


@pytest.mark.parametrize("fs", [8000, 16000])
def test_filter_design_equals_the_jax_package(fs):
    for got, want in zip(psrmr._gammatone_coefs(fs, 23, 125.0), jsrmr._gammatone_coefs(fs, 23, 125.0)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(psrmr._modulation_filterbank(4.0, 128.0, 8, float(fs), 2.0),
                         jsrmr._modulation_filterbank(4.0, 128.0, 8, float(fs), 2.0)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(psrmr._gtgram_fft_weights(512, fs, 23, 125.0, 257),
                                  jsrmr._gtgram_fft_weights(512, fs, 23, 125.0, 257))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("fs", [8000, 16000])
def test_plain_gammatone_cascade_matches_jax_biquad(fs):
    x = np.stack([speechlike(1, 3000, fs), np.random.default_rng(2).standard_normal(3000).astype(np.float32)])
    num, den, gain = psrmr._gammatone_coefs(fs, 23, 125.0)
    got = kb.biquad_bank_plain(torch.from_numpy(x), torch.from_numpy(num.astype(np.float32)),
                               torch.from_numpy(den.astype(np.float32)), torch.from_numpy(gain.astype(np.float32)))
    want = np.asarray(jsrmr._gammatone_filterbank(jnp.asarray(x), fs, 23, 125.0))
    assert got.shape == (2, 23, 3000) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < BIQUAD_RTOL


def test_plain_modulation_bank_matches_jax_biquad_and_float64():
    """The 4-128 Hz bands at 8 kHz have poles within ~4e-4 of the unit circle, which amplify a one-rounding
    difference ~1/(1 - |p|) times: both float32 recurrences sit up to ~5e-4 of the scale from float64 at the
    4 Hz band, and so from each other. Each band of the loop is held to float64 ``lfilter`` no further than the
    JAX package's own recurrence is (times 1.5, plus ``BIQUAD_RTOL``), and to the JAX package within 1e-3."""
    env = np.abs(np.random.default_rng(3).standard_normal((6, 4000))).astype(np.float32)
    num, den, _ = psrmr._modulation_filterbank(4.0, 128.0, 8, 8000.0, 2.0)
    b = (num / den[:, :1]).astype(np.float32)
    a = (den / den[:, :1]).astype(np.float32)
    got = kb.biquad_bank_plain(torch.from_numpy(env), torch.from_numpy(b)[None], torch.from_numpy(a)).numpy()
    want = np.asarray(jsrmr._biquad(jnp.broadcast_to(jnp.asarray(env)[:, None, :], (6, 8, 4000)), jnp.asarray(b)[None],
                                    jnp.asarray(a)[None]))
    assert got.shape == (6, 8, 4000)
    for k in range(8):
        ref = sig.lfilter(b[k].astype(np.float64), a[k].astype(np.float64), env.astype(np.float64), axis=-1)
        assert _rel(got[:, k], ref) <= 1.5 * _rel(want[:, k], ref) + BIQUAD_RTOL, k
        assert _rel(got[:, k], want[:, k]) < 1e-3, k


def test_biquad_bank_takes_the_plain_loop_on_cpu_and_checks_its_arguments():
    x = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    b = torch.tensor([[[0.2, 0.1, 0.0], [0.5, 0.0, -0.5]]])
    a = torch.tensor([[1.0, -0.3, 0.1], [1.0, 0.2, 0.05]])
    kb.biquad_bank.launches = 0
    got = kb.biquad_bank(x, b, a)
    assert kb.biquad_bank.launches == 0 and torch.equal(got, kb.biquad_bank_plain(x, b, a))
    # one biquad by its difference equation, in float64
    y = np.zeros(50)
    xd = x[1].double().numpy()
    for t in range(50):
        y[t] = 0.5 * xd[t] - 0.5 * (xd[t - 2] if t >= 2 else 0) - 0.2 * (y[t - 1] if t else 0) - 0.05 * (y[t - 2] if t >= 2 else 0)
    np.testing.assert_allclose(got[1, 1].double().numpy(), y, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="float32"):
        kb.biquad_bank(x.double(), b, a)
    with pytest.raises(ValueError, match="gain"):
        kb.biquad_bank(x, b, a, torch.ones(2))
    with pytest.raises(ValueError, match=r"\(S, K, 3\)"):
        kb.biquad_bank(x, b[:, :, :2], a)
    cost = kb.biquad_bank_cost(16, 23, 128_000, 4)
    assert cost.bytes_accessed == 4.0 * 128_000 * (16 + 16 * 23) and cost.flops == 16 * 23 * 128_000 * 37.0


CASES = [(fs, kw) for fs in (8000, 16000) for kw in ({}, {"norm": True}, {"fast": True})]


@pytest.mark.parametrize(("fs", "kwargs"), CASES, ids=[f"{fs}-{'-'.join(kw) or 'slow'}" for fs, kw in CASES])
def test_srmr_matches_jax_and_the_scipy_oracle(fs, kwargs):
    time = 8192  # 1 s at 8 kHz, 0.5 s at 16 kHz: five 0.256 s frames or more, a multiple of 16 for the oracle
    x = np.stack([speechlike(fs + len(kwargs), time, fs),
                  np.random.default_rng(fs).standard_normal(time).astype(np.float32)])
    got = PF.speech_reverberation_modulation_energy_ratio(torch.from_numpy(x), fs, **kwargs)
    with pytest.warns(UserWarning, match="experimental") if kwargs.get("fast") else _nothing():
        want = np.asarray(JF.speech_reverberation_modulation_energy_ratio(jnp.asarray(x), fs, **kwargs))
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=SRMR_RTOL)
    if not kwargs.get("fast"):
        oracle = _oracle_srmr(x, fs, norm=kwargs.get("norm", False))
        if fs == 8000:  # the JAX suite's own check
            np.testing.assert_allclose(got.numpy(), oracle, rtol=SRMR_RTOL)
        else:
            # at 16 kHz the 4 Hz band's poles sit twice as close to the unit circle, and the float32 pipeline of
            # both packages drifts further from float64 (~0.8% here): no further than the JAX package, + SRMR_RTOL
            assert np.all(np.abs(got.numpy() - oracle) <= np.abs(want - oracle) + SRMR_RTOL * oracle)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_srmr_fast_warns():
    with pytest.warns(UserWarning, match="experimental gammatonegram"):
        PF.speech_reverberation_modulation_energy_ratio(torch.from_numpy(speechlike(0, 8000, 8000)), 8000, fast=True)


def test_srmr_shapes_integer_input_and_custom_bands():
    x = speechlike(4, 8000, 8000)
    scaled = (x / np.abs(x).max() * 20000).astype(np.int16)  # 1-D: a score of shape (1,)
    got = PF.speech_reverberation_modulation_energy_ratio(torch.from_numpy(scaled), 8000)
    want = np.asarray(JF.speech_reverberation_modulation_energy_ratio(jnp.asarray(scaled), 8000))
    assert got.shape == want.shape == (1,)
    np.testing.assert_allclose(got.numpy(), want, rtol=SRMR_RTOL)
    kw = dict(n_cochlear_filters=15, low_freq=100.0, min_cf=2.0, max_cf=64.0)
    batch = np.stack([x, speechlike(5, 8000, 8000)]).reshape(2, 1, 8000)
    got = PF.speech_reverberation_modulation_energy_ratio(torch.from_numpy(batch), 8000, **kw)
    assert got.shape == (2, 1)
    want = np.asarray(JF.speech_reverberation_modulation_energy_ratio(jnp.asarray(batch), 8000, **kw))[:, 0]
    np.testing.assert_allclose(got.numpy()[:, 0], want, rtol=SRMR_RTOL)
    # the 2 Hz band's float32 recurrence puts both packages ~1.6% from float64 on these signals: the port is
    # held to the oracle no further than the JAX package is, plus SRMR_RTOL
    oracle = _oracle_srmr(batch[:, 0], 8000, **kw)
    assert np.all(np.abs(got.numpy()[:, 0] - oracle) <= np.abs(want - oracle) + SRMR_RTOL * oracle)


def test_srmr_argument_validation():
    x = torch.zeros(8000)
    for kwargs, match in [({"fs": 0}, "`fs`"), ({"fs": 8000, "n_cochlear_filters": 0}, "n_cochlear_filters"),
                          ({"fs": 8000, "low_freq": -1}, "low_freq"), ({"fs": 8000, "min_cf": 0}, "min_cf"),
                          ({"fs": 8000, "max_cf": -2}, "max_cf"), ({"fs": 8000, "norm": 1}, "norm"),
                          ({"fs": 8000, "fast": "yes"}, "fast")]:
        with pytest.raises(ValueError, match=match):
            PF.speech_reverberation_modulation_energy_ratio(x, **kwargs)


def test_srmr_class_matches_jax():
    port = PA.SpeechReverberationModulationEnergyRatio(8000, device="cpu")
    jax_metric = JA.SpeechReverberationModulationEnergyRatio(8000, auto_compile=False)
    for seed in range(2):
        x = np.stack([speechlike(10 + seed, 8000, 8000), speechlike(20 + seed, 8000, 8000)])
        port.update(torch.from_numpy(x))
        jax_metric.update(jnp.asarray(x))
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(jax_metric.compute()), rtol=SRMR_RTOL)
    assert int(port.total) == 4 and port.total.dtype == torch.int64
