"""Real-DFT helpers (counterpart of ``spatial_audio_framework_tpu/ops/fft.py``).

Conventions are the reference's: unnormalised forward transform, 1/N-scaled
inverse.  :func:`_rdft_mats` gives the DFT as matrices, which the plain
versions and the dense-DFT CUDA kernels take as inputs;
:func:`_fft256_twiddles` the twiddle table of the FFT-based kernels;
:func:`rfft_op` and :func:`irfft_op` run ``torch.fft``; so do the
reference's FFT helpers at the end (``saf_utility_fft.h``: the plain
transforms, ``fftconv``, ``fftfilt``, ``hilbert``), which take a tensor
(and return one on its device) or a numpy array (computed on the host,
returned as numpy).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _rdft_mats(n: int):
    """Real-DFT matmul operators for length n (numpy, float32).

    forward:  rfft(x)  = x @ C + 1j·(x @ S)           C,S: (n, n//2+1)
    backward: irfft(X) = X.re @ A + X.im @ B          A,B: (n//2+1, n)
    Matches numpy conventions (unnormalised forward, 1/n inverse; the
    imaginary parts of the DC/Nyquist bins do not contribute).
    """
    k = np.arange(n // 2 + 1)
    t = np.arange(n)
    ang = 2.0 * np.pi * np.outer(t, k) / n  # (n, k)
    C = np.cos(ang)
    S = -np.sin(ang)
    c = np.where((k == 0) | (k == n // 2), 1.0, 2.0)
    A = (c[:, None] * np.cos(ang).T) / n
    B = (-c[:, None] * np.sin(ang).T) / n
    return (C.astype(np.float32), S.astype(np.float32),
            A.astype(np.float32), B.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _fft256_twiddles() -> np.ndarray:
    """The twiddle table of the kernels' FFT-based 256-point rDFT / irDFT
    (``csrc/afstft_common.cuh``): W₂₅₆ᵏ = (cos, −sin)(2πk/256) for
    k = 0..255 as a (256, 2) float32 array, computed in float64.  The
    128-point FFT reads W₁₂₈ʲ = W₂₅₆²ʲ from it, the real/complex split
    W₂₅₆ᵏ for k < 128."""
    ang = 2.0 * np.pi * np.arange(256) / 256.0
    return np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)


def rfft_op(x: torch.Tensor, n: int) -> torch.Tensor:
    """Forward real DFT of the last axis (length n; shorter input is
    zero-padded), unnormalised."""
    return torch.fft.rfft(x, n=n, dim=-1)


def irfft_op(X: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse real DFT (1/n-scaled) of the last axis."""
    return torch.fft.irfft(X, n=n, dim=-1)


def _tensor(x):
    """(tensor, whether to return numpy)."""
    if isinstance(x, torch.Tensor):
        return x, False
    return torch.from_numpy(np.array(x)), True


def _out(y: torch.Tensor, to_numpy: bool):
    return y.numpy() if to_numpy else y


def get_uniform_freq_vector(fft_size: int, fs: float) -> np.ndarray:
    """Centre frequencies of rFFT bins (saf_utility_fft.h:67)."""
    return np.arange(fft_size // 2 + 1, dtype=np.float64) * fs / float(fft_size)


def rfft(x, n: int | None = None):
    """Real→complex forward FFT, unnormalised (saf_rfft_forward)."""
    t, np_out = _tensor(x)
    return _out(torch.fft.rfft(t, n=n, dim=-1), np_out)


def irfft(X, n: int):
    """Complex→real inverse FFT with 1/N scaling (saf_rfft_backward)."""
    t, np_out = _tensor(X)
    return _out(torch.fft.irfft(t, n=n, dim=-1), np_out)


def fft(x, n: int | None = None):
    """Complex forward FFT (saf_fft_forward)."""
    t, np_out = _tensor(x)
    return _out(torch.fft.fft(t, n=n, dim=-1), np_out)


def ifft(X, n: int | None = None):
    """Complex inverse FFT, 1/N scaled (saf_fft_backward)."""
    t, np_out = _tensor(X)
    return _out(torch.fft.ifft(t, n=n, dim=-1), np_out)


def fftconv(x, h, out_len: int | None = None):
    """Linear convolution via FFT (saf_utility_fft.h:86 ``fftconv``).

    x: (..., x_len), h: (..., h_len) → (..., x_len + h_len - 1) or out_len.
    """
    x, np_out = _tensor(x)
    h, _ = _tensor(h)
    h = h.to(x.device)
    full = x.shape[-1] + h.shape[-1] - 1
    nfft = int(2 ** np.ceil(np.log2(full)))
    y = torch.fft.irfft(torch.fft.rfft(x, n=nfft) * torch.fft.rfft(h, n=nfft),
                        n=nfft)[..., :full]
    if out_len is not None:
        y = y[..., :out_len]
    return _out(y, np_out)


def fftfilt(x, h):
    """'filter'-style convolution: same length as x (saf_utility_fft.h:107)."""
    return fftconv(x, h)[..., : x.shape[-1]]


def hilbert(x):
    """Analytic signal via FFT (saf_utility_fft.h:128 ``hilbert``)."""
    t, np_out = _tensor(x)
    n = t.shape[-1]
    X = torch.fft.fft(t, dim=-1)
    # slices, not elements: a scalar written to one element makes the host
    # wait for the card
    w = torch.zeros(n, dtype=X.dtype, device=X.device)
    w[1: (n + 1) // 2] = 2.0
    w[:1] = 1.0
    if n % 2 == 0:
        w[n // 2: n // 2 + 1] = 1.0
    return _out(torch.fft.ifft(X * w, dim=-1), np_out)
