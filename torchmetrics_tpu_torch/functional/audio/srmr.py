"""Speech-to-Reverberation Modulation energy Ratio (port of ``torchmetrics_tpu/functional/audio/srmr.py``).

Pipeline (slow path): a 23-channel gammatone ERB filterbank (four cascaded
biquads a cochlear channel) -> Hilbert envelope (FFT) -> 8-band modulation
filterbank (2nd-order band-passes, Q = 2) -> Hamming-windowed frame
energies -> the ratio of the low modulation bands' energy (1-4) to the high
ones' (5..k*), k* from the 90%-energy ERB bandwidth. The fast path replaces
the filterbank and envelope with an FFT-weight gammatonegram.

The filter coefficients are derived on the host in float64 and cached, as in
the JAX package. Both IIR stages run through kernel S1
(:func:`torchmetrics_tpu_torch._kernels.biquad.biquad_bank`) on a CUDA
tensor, its plain loop on a CPU one. The frame energies are one strided
correlation of the squared bands with the squared window (``conv1d`` in full
float32), so the ``(..., frames, window)`` gather of the JAX form is never
made: at 16 kHz and 8 s it would be ~400 MB a channel.
"""

from __future__ import annotations

from functools import lru_cache
from math import ceil, log2, pi
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from torchmetrics_tpu_torch._compile import device_constant
from torchmetrics_tpu_torch._kernels.biquad import biquad_bank
from torchmetrics_tpu_torch.utilities.checks import _in_compiled_step, _vmapped
from torchmetrics_tpu_torch.utilities.compute import full_fp32
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

# Glasberg & Moore (1990) ERB parameters, as the gammatone package uses them
_EAR_Q = 9.26449
_MIN_BW = 24.7


def _erb_centre_freqs(fs: int, n_filters: int, low_freq: float) -> np.ndarray:
    """ERB-spaced centre frequencies from ``fs/2`` down to ``low_freq`` (descending)."""
    c = _EAR_Q * _MIN_BW
    high = fs / 2.0
    k = np.arange(1, n_filters + 1, dtype=np.float64)
    return -c + np.exp(k * (np.log(low_freq + c) - np.log(high + c)) / n_filters) * (high + c)


def _erb_bandwidths(cfs: np.ndarray) -> np.ndarray:
    """ERB (Hz) at each centre frequency (order-1 Glasberg-Moore form)."""
    return cfs / _EAR_Q + _MIN_BW


def _slaney_sections(cfs: np.ndarray, fs: int) -> Tuple[np.ndarray, ...]:
    """Slaney (1993) gammatone algebra: ``(k11, k12, k13, k14, gain, b, arg)``, float64.

    The ``k1x`` are the four cascade sections' cos/sin zero factors, ``gain``
    the 4th-order passband gain, ``b`` the 1.019 * 2 pi * ERB damping and
    ``arg`` = 2 pi cf / fs.
    """
    t = 1.0 / fs
    b = 1.019 * 2.0 * pi * _erb_bandwidths(cfs)
    arg = 2.0 * cfs * pi * t
    vec = np.exp(2j * arg)

    rt_pos = np.sqrt(3.0 + 2.0**1.5)
    rt_neg = np.sqrt(3.0 - 2.0**1.5)
    k11 = np.cos(arg) + rt_pos * np.sin(arg)
    k12 = np.cos(arg) - rt_pos * np.sin(arg)
    k13 = np.cos(arg) + rt_neg * np.sin(arg)
    k14 = np.cos(arg) - rt_neg * np.sin(arg)

    gain_arg = np.exp(1j * arg - b * t)
    gain = np.abs(
        (vec - gain_arg * k11)
        * (vec - gain_arg * k12)
        * (vec - gain_arg * k13)
        * (vec - gain_arg * k14)
        * (t * np.exp(b * t) / (-1.0 / np.exp(b * t) + 1.0 + vec * (1.0 - np.exp(b * t)))) ** 4
    )
    return k11, k12, k13, k14, gain, b, arg


@lru_cache(maxsize=100)
def _gammatone_coefs(fs: int, n_filters: int, low_freq: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The 4th-order gammatone as four cascaded biquads: ``(numerators [4, N, 3], denominator [N, 3], gain [N])``, float64."""
    cfs = _erb_centre_freqs(fs, n_filters, low_freq)
    t = 1.0 / fs
    k11, k12, k13, k14, gain, b, arg = _slaney_sections(cfs, fs)
    common = -t * np.exp(-b * t)
    a0 = np.full_like(cfs, t)
    a2 = np.zeros_like(cfs)
    numerators = np.stack([np.stack([a0, common * k, a2], axis=-1) for k in (k11, k12, k13, k14)], axis=0)
    denominator = np.stack([np.ones_like(cfs), -2.0 * np.cos(arg) / np.exp(b * t), np.exp(-2.0 * b * t)], axis=-1)
    return numerators, denominator, gain


@lru_cache(maxsize=100)
def _modulation_filterbank(
    min_cf: float, max_cf: float, n: int, fs: float, q: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """2nd-order band-pass modulation filters (SRMRpy's design): ``(numerators [n, 3], denominators [n, 3], lower_cutoffs [n])``."""
    spacing = (max_cf / min_cf) ** (1.0 / (n - 1))
    cfs = min_cf * spacing ** np.arange(n, dtype=np.float64)
    w0 = 2.0 * pi * cfs / fs
    wt = np.tan(w0 / 2.0)
    b0 = wt / q
    numer = np.stack([b0, np.zeros_like(b0), -b0], axis=-1)
    denom = np.stack([1.0 + b0 + wt**2, 2.0 * wt**2 - 2.0, 1.0 - b0 + wt**2], axis=-1)
    lower_cutoffs = cfs - b0 * fs / (2.0 * pi)
    return numer, denom, lower_cutoffs


def _gammatone_filterbank(wave: Tensor, fs: int, n_filters: int, low_freq: float) -> Tensor:
    """Filter ``wave [B, T]`` into ``[B, N, T]`` cochlear channels (kernel S1, four sections, over the gain)."""
    numerators, denominator, gain = _gammatone_coefs(fs, n_filters, float(low_freq))
    as_f32 = lambda arr: torch.from_numpy(arr.astype(np.float32))  # noqa: E731
    return biquad_bank(wave.contiguous(), as_f32(numerators), as_f32(denominator), as_f32(gain))


def _hilbert_envelope(x: Tensor) -> Tensor:
    """|analytic signal| over the trailing axis, the FFT length padded to a multiple of 16 (as the reference's ``_hilbert``)."""
    time = x.shape[-1]
    n = time if time % 16 == 0 else ceil(time / 16) * 16  # always even
    x_fft = torch.fft.fft(x, n=n, dim=-1)
    h = np.zeros(n, dtype=np.float64)
    h[0] = h[n // 2] = 1.0
    h[1 : n // 2] = 2.0
    analytic = torch.fft.ifft(x_fft * device_constant(h.astype(np.float32), x.device), dim=-1)[..., :time]
    return torch.sqrt(analytic.real**2 + analytic.imag**2)


@lru_cache(maxsize=100)
def _gtgram_fft_weights(nfft: int, fs: int, n_filters: int, low_freq: float, maxlen: int) -> np.ndarray:
    """FFT-bin weights whose rows sample each gammatone's magnitude response (Ellis' gammatonegram)."""
    cfs = _erb_centre_freqs(fs, n_filters, low_freq)
    t = 1.0 / fs
    k11, k12, k13, k14, gain, b, arg = _slaney_sections(cfs, fs)
    ucirc = np.exp(2j * pi * np.arange(nfft // 2 + 1)[None, :] / nfft)
    common = -t * np.exp(-b * t)
    zros = -np.stack([common * k11, common * k12, common * k13, common * k14], axis=0)[:, :, None] / t
    pole = np.exp(1j * arg - b * t)[:, None]
    weights = (
        (t**4 / gain[:, None])
        * np.abs(ucirc - zros[0])
        * np.abs(ucirc - zros[1])
        * np.abs(ucirc - zros[2])
        * np.abs(ucirc - zros[3])
        * np.abs((pole - ucirc) * (pole.conj() - ucirc)) ** -4
    )
    full = np.zeros((n_filters, nfft), dtype=np.float64)
    full[:, : nfft // 2 + 1] = weights
    return full[:, :maxlen]


def _fft_gtgram(wave: Tensor, fs: int, n_filters: int, low_freq: float) -> Tensor:
    """Gammatonegram envelope ``[B, N, frames]`` of the fast path: a zero-phase half-Hann STFT (10 ms, 2.5 ms hop), weighted."""
    window_time, hop_time = 0.010, 0.0025
    # round half away from zero, as the gammatone package's fftweight does
    nwin = int(np.floor(window_time * fs + 0.5))
    nhop = int(np.floor(hop_time * fs + 0.5))
    nfft = int(2 ** ceil(log2(2 * nwin)))

    halflen = nwin // 2
    halff = nfft // 2
    acthalflen = min(halff, halflen)
    halfwin = 0.5 * (1.0 + np.cos(pi * np.arange(halflen + 1) / halflen))
    win = np.zeros(nfft)
    win[halff : halff + acthalflen] = halfwin[:acthalflen]
    win[halff : halff - acthalflen : -1] = halfwin[:acthalflen]

    frames = wave.unfold(-1, nfft, nhop)  # [B, cols, nfft]: starts 0, nhop, ... as the JAX gather
    spec = torch.fft.fft(frames * device_constant(win.astype(np.float32), wave.device), dim=-1)[..., : nfft // 2 + 1]
    weights = _gtgram_fft_weights(nfft, fs, n_filters, float(low_freq), nfft // 2 + 1)
    weights = device_constant(weights.astype(np.float32), wave.device)
    with full_fp32():
        return torch.einsum("nf,bcf->bnc", weights, torch.abs(spec)) / nfft


def _frame_energy(mod_out: Tensor, time: int, w_length: int, w_inc: int) -> Tensor:
    """Hamming-windowed frame energies ``[..., n_frames]`` of ``mod_out [..., T]``.

    The pad is computed against the waveform's length ``time``, as the
    reference does: on the fast path the envelope is far shorter, and a pad
    relative to it would add zero frames that move ``norm=True``'s clamp.
    """
    pad = max(ceil(time / w_inc) * w_inc - time, w_length - time, 0)
    padded_len = mod_out.shape[-1] + pad
    avail = 1 + (padded_len - w_length) // w_inc
    num_frames = max(min(1 + (time - w_length) // w_inc, avail), 0)
    lead = mod_out.shape[:-1]
    if num_frames == 0:
        return mod_out.new_zeros((*lead, 0))
    # periodic Hamming over w_length + 1 points, the last dropped (the reference's window)
    window = 0.54 - 0.46 * np.cos(2.0 * pi * np.arange(w_length) / (w_length + 1))
    w2 = device_constant(window.astype(np.float32) ** 2, mod_out.device)
    sq = F.pad(mod_out.reshape(-1, 1, mod_out.shape[-1]) ** 2, (0, pad))
    with full_fp32():  # sum_k (x w)^2 = sum_k x^2 w^2: one strided correlation, no (frames, window) gather
        energy = F.conv1d(sq, w2.reshape(1, 1, -1), stride=w_inc)[:, 0, :num_frames]
    return energy.reshape(*lead, num_frames)


def _normalize_energy(energy: Tensor, drange: float = 30.0) -> Tensor:
    """Clamp band energies into a ``drange``-dB window below the cross-filter peak."""
    peak = torch.amax(torch.mean(energy, dim=1, keepdim=True), dim=(2, 3), keepdim=True)
    floor = peak * 10.0 ** (-drange / 10.0)
    return torch.minimum(torch.maximum(energy, floor), peak)


def _srmr_arg_validate(
    fs: int,
    n_cochlear_filters: int,
    low_freq: float,
    min_cf: float,
    max_cf: Optional[float],
    norm: bool,
    fast: bool,
) -> None:
    if not (isinstance(fs, int) and fs > 0):
        raise ValueError(f"Expected argument `fs` to be an int larger than 0, but got {fs}")
    if not (isinstance(n_cochlear_filters, int) and n_cochlear_filters > 0):
        raise ValueError(
            f"Expected argument `n_cochlear_filters` to be an int larger than 0, but got {n_cochlear_filters}"
        )
    if not (isinstance(low_freq, (float, int)) and low_freq > 0):
        raise ValueError(f"Expected argument `low_freq` to be a float larger than 0, but got {low_freq}")
    if not (isinstance(min_cf, (float, int)) and min_cf > 0):
        raise ValueError(f"Expected argument `min_cf` to be a float larger than 0, but got {min_cf}")
    if max_cf is not None and not (isinstance(max_cf, (float, int)) and max_cf > 0):
        raise ValueError(f"Expected argument `max_cf` to be a float larger than 0, but got {max_cf}")
    if not isinstance(norm, bool):
        raise ValueError("Expected argument `norm` to be a bool value")
    if not isinstance(fast, bool):
        raise ValueError("Expected argument `fast` to be a bool value")


def speech_reverberation_modulation_energy_ratio(
    preds: Tensor,
    fs: int,
    n_cochlear_filters: int = 23,
    low_freq: float = 125,
    min_cf: float = 4,
    max_cf: Optional[float] = None,
    norm: bool = False,
    fast: bool = False,
) -> Tensor:
    """SRMR: a non-intrusive speech quality score from modulation energies.

    Args:
        preds: shape ``(..., time)``
        fs: sampling rate (Hz)
        n_cochlear_filters: gammatone filterbank size
        low_freq: lowest gammatone centre frequency
        min_cf: centre frequency of the first modulation band
        max_cf: centre frequency of the last modulation band (``None``: 30 Hz with ``norm``, else 128 Hz)
        norm: clamp modulation energies to a 30 dB dynamic range
        fast: the gammatonegram approximation instead of the filterbank (experimental, as in the reference)

    Returns:
        SRMR scores of shape ``preds.shape[:-1]`` (a 1-D input gives shape ``(1,)``).
    """
    _srmr_arg_validate(fs, n_cochlear_filters, low_freq, min_cf, max_cf, norm, fast)

    shape = preds.shape
    preds = preds.reshape(1, -1) if preds.ndim == 1 else preds.reshape(-1, shape[-1])
    time = preds.shape[-1]
    if not preds.is_floating_point():
        scale = torch.iinfo(preds.dtype).max if preds.dtype != torch.bool else 1
        preds = preds.to(torch.float32) / scale
    preds = preds.to(torch.float32)

    # into [-1, 1], as the reference normalises for its IIR backend (the ratio is scale-free but under `norm`)
    max_vals = torch.amax(torch.abs(preds), dim=-1, keepdim=True)
    preds = preds / torch.where(max_vals > 1, max_vals, torch.ones_like(max_vals))

    if fast:
        rank_zero_warn("`fast=True` is an experimental gammatonegram approximation of SRMR.")
        mfs = 400.0
        gt_env = _fft_gtgram(preds, fs, n_cochlear_filters, low_freq)
    else:
        mfs = float(fs)
        gt_env = _hilbert_envelope(_gammatone_filterbank(preds, fs, n_cochlear_filters, low_freq))

    w_length = ceil(0.256 * mfs)
    w_inc = ceil(0.064 * mfs)
    if max_cf is None:
        max_cf = 30.0 if norm else 128.0
    mod_num, mod_den, cutoffs = _modulation_filterbank(float(min_cf), float(max_cf), 8, mfs, 2.0)

    # one biquad a modulation band: 8 channels a cochlear channel (kernel S1, one section)
    num = torch.from_numpy((mod_num / mod_den[:, :1]).astype(np.float32))[None]  # a0 normalised to 1
    den = torch.from_numpy((mod_den / mod_den[:, :1]).astype(np.float32))
    b_sz, n_ch, t_env = gt_env.shape
    mod_out = biquad_bank(gt_env.reshape(b_sz * n_ch, t_env).contiguous(), num, den).reshape(b_sz, n_ch, 8, t_env)

    energy = _frame_energy(mod_out, time, w_length, w_inc)  # [B, N, 8, frames]
    del mod_out
    if norm:
        energy = _normalize_energy(energy)

    avg_energy = torch.mean(energy, dim=-1)  # [B, N, 8]
    total_energy = torch.sum(avg_energy, dim=(1, 2))
    ac_perc = torch.sum(avg_energy, dim=2) * 100.0 / total_energy[:, None]  # [B, N]
    cum_low_to_high = torch.cumsum(torch.flip(ac_perc, dims=(-1,)), dim=-1)
    # the first crossing of the monotone cumulative sum, as a count of the positions not crossed
    k90_idx = torch.sum((cum_low_to_high <= 90.0).to(torch.int64), dim=-1).clamp(max=n_ch - 1)

    erbs_ascending = np.flipud(_erb_bandwidths(_erb_centre_freqs(fs, n_cochlear_filters, low_freq))).copy()
    bw = device_constant(erbs_ascending.astype(np.float32), preds.device)[k90_idx]  # [B]

    # k* = the highest modulation band whose lower cutoff lies below the bandwidth (the reference's chained elifs)
    cuts = [float(np.float32(v)) for v in cutoffs]
    above = [(bw >= cuts[i]).to(torch.int64) for i in (5, 6, 7)]
    kstar = 5 + above[0] + above[0] * above[1] + above[0] * above[1] * above[2]
    # one host read an update, as in the JAX package, which skips it under a trace (a pool's lane among them)
    if not _in_compiled_step() and not _vmapped(bw) and bool(torch.any(bw < cuts[4])):
        raise ValueError("Something wrong with the cutoffs compared to bw values.")

    band_idx = torch.arange(8, device=preds.device)
    low_energy = torch.sum(avg_energy[:, :, :4], dim=(1, 2))
    high_mask = (band_idx[None, :] >= 4) & (band_idx[None, :] < kstar[:, None])  # [B, 8]
    high_energy = torch.sum(avg_energy * high_mask[:, None, :], dim=(1, 2))
    score = low_energy / high_energy
    return score.reshape(*shape[:-1]) if len(shape) > 1 else score
