"""Real-DFT helpers (counterpart of ``spatial_audio_framework_tpu/ops/fft.py``).

Conventions are the reference's: unnormalised forward transform, 1/N-scaled
inverse.  :func:`_rdft_mats` gives the DFT as matrices, which the plain
versions and the dense-DFT CUDA kernels take as inputs;
:func:`_fft256_twiddles` the twiddle table of the FFT-based kernels;
:func:`rfft_op` and :func:`irfft_op` run ``torch.fft``.
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
