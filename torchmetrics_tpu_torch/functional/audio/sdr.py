"""Signal-to-distortion ratio (port of ``torchmetrics_tpu/functional/audio/sdr.py``).

The optimal distortion filter solves a symmetric Toeplitz system built from
FFT auto- and cross-correlations: the rFFT correlations, the Toeplitz matrix
(a gather of its first row) and the dense solve all run on the tensor's
device. As in the JAX package the solve is float32 with a diagonal load of
1e-7 unless ``load_diag`` says otherwise; the reference's float64 upcast is
not taken, so the result is the JAX package's, not a closer one.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.compute import full_fp32


def _symmetric_toeplitz(vector: Tensor) -> Tensor:
    """Symmetric Toeplitz matrix from its first row, batched over leading dims.

    Example:
        >>> import torch
        >>> _symmetric_toeplitz(torch.tensor([0, 1, 2, 3]))
        tensor([[0, 1, 2, 3],
                [1, 0, 1, 2],
                [2, 1, 0, 1],
                [3, 2, 1, 0]])
    """
    v_len = vector.shape[-1]
    ar = torch.arange(v_len, device=vector.device)
    idx = (ar[:, None] - ar[None, :]).abs()
    return vector[..., idx]


def _compute_autocorr_crosscorr(target: Tensor, preds: Tensor, corr_len: int) -> Tuple[Tensor, Tensor]:
    """FFT autocorrelation of ``target`` and its cross-correlation with ``preds``, ``corr_len`` lags each."""
    n_fft = 2 ** math.ceil(math.log2(preds.shape[-1] + target.shape[-1] - 1))
    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    r_0 = torch.fft.irfft(t_fft.real**2 + t_fft.imag**2, n=n_fft)[..., :corr_len]
    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    b = torch.fft.irfft(torch.conj(t_fft) * p_fft, n=n_fft, dim=-1)[..., :corr_len]
    return r_0, b


def signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> Tensor:
    """SDR in dB: the target may pass a ``filter_length``-tap distortion filter.

    ``use_cg_iter`` is accepted and ignored, as in the JAX package: the dense
    solve is used either way.
    """
    _check_same_shape(preds, target)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)

    if zero_mean:
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
        target = target - torch.mean(target, dim=-1, keepdim=True)

    target = target / torch.clamp(torch.linalg.norm(target, dim=-1, keepdim=True), min=1e-6)
    preds = preds / torch.clamp(torch.linalg.norm(preds, dim=-1, keepdim=True), min=1e-6)

    r_0, b = _compute_autocorr_crosscorr(target, preds, corr_len=filter_length)
    if load_diag is None:
        load_diag = 1e-7  # float32 stabilisation in place of the reference's float64 upcast
    r_0 = r_0.clone()
    r_0[..., 0] += load_diag

    with full_fp32():
        sol = torch.linalg.solve(_symmetric_toeplitz(r_0), b)
    coh = torch.sum(b * sol, dim=-1)
    ratio = coh / (1 - coh)
    return 10.0 * torch.log10(ratio)
