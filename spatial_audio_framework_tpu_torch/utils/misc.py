"""Miscellaneous DSP helpers (counterpart of
``spatial_audio_framework_tpu/utils/misc.py``, ``saf_utility_misc``):
host numpy, the port's own copy."""
from __future__ import annotations

import numpy as np


def next_pow2(x: int) -> int:
    """Next power of two ≥ x (saf_utility_misc.h ``nextpow2``)."""
    return 1 if x <= 1 else int(2 ** np.ceil(np.log2(x)))


def matlab_fmod(x, y):
    """MATLAB-convention mod (result has the sign of y)
    (saf_utility_misc.h ``matlab_fmodf``)."""
    return x - np.floor(x / y) * y


def lagrange_weights(N: int, fractions: np.ndarray) -> np.ndarray:
    """Lagrange interpolation weights of order N for fractional delays
    (saf_utility_misc.h ``lagrangeWeights``).  fractions: (nF,) in [0, 1) →
    (N+1, nF); delay = n + fraction with n = N/2 integer part convention."""
    fractions = np.atleast_1d(np.asarray(fractions, np.float64))
    W = np.ones((N + 1, fractions.shape[0]))
    d = fractions + N / 2.0  # centre the interpolator
    for n in range(N + 1):
        for k in range(N + 1):
            if k != n:
                W[n] *= (d - k) / (n - k)
    return W.astype(np.float32)


def find_erb_partitions(centre_freqs: np.ndarray, max_bands: int | None = None):
    """Group bands into ERB partitions (saf_utility_misc.h:131
    ``findERBpartitions``): returns (erb_idx, erb_freqs) where erb_idx holds
    the first band index of each group (ending with nBands)."""
    f = np.asarray(centre_freqs, np.float64)
    erb_idx = [0]
    erb_freqs = [f[0]]
    while erb_idx[-1] < len(f) - 1:
        fc = erb_freqs[-1]
        erb = 24.7 + 0.108 * fc  # ERB bandwidth (Glasberg & Moore)
        next_f = fc + erb
        i = int(np.searchsorted(f, next_f))
        i = max(i, erb_idx[-1] + 1)
        if i >= len(f):
            i = len(f) - 1
            if i == erb_idx[-1]:
                break
        erb_idx.append(i)
        erb_freqs.append(f[i])
        if i == len(f) - 1:
            break
    if max_bands is not None and len(erb_idx) > max_bands:
        sel = np.linspace(0, len(erb_idx) - 1, max_bands).round().astype(int)
        erb_idx = list(np.asarray(erb_idx)[sel])
        erb_freqs = list(np.asarray(erb_freqs)[sel])
    return np.asarray(erb_idx, int), np.asarray(erb_freqs, np.float32)


def cxcorr(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Cross-correlation matching saf_utility_misc.c ``cxcorr``:
    x[j] = Σ_n a[n + j - (len(b)-1)] b[n]  (== np.correlate 'full')."""
    return np.correlate(a, b, mode="full")


def rand_perm(n: int, rng=None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    return rng.permutation(n)


def convd(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Polynomial/linear convolution (saf_utility_misc.h ``convd``/``convz``)."""
    return np.convolve(x, h)


def polyd_v(roots: np.ndarray) -> np.ndarray:
    """Polynomial coefficients from roots (``polyd_v``/``polyz_v``)."""
    return np.poly(roots)


def polyd_m(A: np.ndarray) -> np.ndarray:
    """Characteristic polynomial of a matrix (``polyd_m``)."""
    return np.poly(A)


def unique_i(x: np.ndarray):
    """Unique values + first-occurrence indices (saf_utility_misc.h:301)."""
    vals, idx = np.unique(np.asarray(x), return_index=True)
    return vals, idx


def combinations(n: int, k: int) -> np.ndarray:
    """All k-combinations of range(n) (saf_utility_misc.h:319)."""
    from itertools import combinations as _comb

    return np.asarray(list(_comb(range(n), k)), int)


def gexpm(A: np.ndarray) -> np.ndarray:
    """Matrix exponential (saf_utility_misc.h:354 ``gexpm``)."""
    from scipy.linalg import expm

    return expm(A)


def sort_cmplx_pairs(vals: np.ndarray) -> np.ndarray:
    """Pair up complex conjugates, ordered as (a±bi) pairs then reals
    (saf_utility_sort.h ``cmplxPairUp`` semantics via numpy)."""
    vals = np.asarray(vals)
    cplx = vals[np.abs(vals.imag) > 1e-12]
    real = vals[np.abs(vals.imag) <= 1e-12].real
    order = np.lexsort((np.sign(cplx.imag), np.abs(cplx.imag), cplx.real))
    return np.concatenate([cplx[order], np.sort(real).astype(vals.dtype)])


def factorial(n):
    """Exact factorial, vectorised (saf_utility_misc.h ``factorial``)."""
    from math import factorial as _f

    if np.isscalar(n):
        return float(_f(int(n)))
    return np.array([float(_f(int(v))) for v in np.ravel(n)]).reshape(
        np.shape(n))


def convz(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Complex polynomial/sequence convolution (saf_utility_misc.h ``convz``)."""
    return np.convolve(np.asarray(x, np.complex128),
                       np.asarray(h, np.complex128))


def polyz_v(roots: np.ndarray) -> np.ndarray:
    """Complex polynomial coefficients from roots (``polyz_v``)."""
    return np.poly(np.asarray(roots, np.complex128))


def rand_m1_1(shape, rng=None) -> np.ndarray:
    """Uniform random values in -1..1 (saf_utility_misc.h ``rand_m1_1``)."""
    rng = rng or np.random.default_rng()
    return rng.uniform(-1.0, 1.0, shape).astype(np.float32)


def rand_0_1(shape, rng=None) -> np.ndarray:
    """Uniform random values in 0..1 (``rand_0_1``)."""
    rng = rng or np.random.default_rng()
    return rng.uniform(0.0, 1.0, shape).astype(np.float32)


def saf_print_warning(msg: str) -> None:
    """Debug warning print (saf_utilities.h:120-142 ``saf_print_warning``)."""
    import warnings

    warnings.warn(f"SAF WARNING: {msg}", stacklevel=2)


def saf_print_error(msg: str) -> None:
    """Fatal error (``saf_print_error`` exits; here raises)."""
    raise RuntimeError(f"SAF ERROR: {msg}")


def saf_assert(cond, msg: str = "") -> None:
    """``saf_assert`` analogue."""
    if not cond:
        raise AssertionError(f"SAF ASSERT: {msg}")
