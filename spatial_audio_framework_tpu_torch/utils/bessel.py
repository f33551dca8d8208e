"""Bessel/Hankel functions (counterpart of
``spatial_audio_framework_tpu/utils/bessel.py``; ``saf_utility_bessel.h``).

Design-time (host) implementations via SciPy in float64; the reference's
``_ALL`` variants return all orders 0..N for a vector of arguments.  Both
cylindrical (Jn/Yn/Hn1/Hn2) and spherical (jn/yn/in/kn/h1n/h2n) kinds, with
derivatives.  Values are used to build modal coefficients / filters once per
re-init; the per-sample path never evaluates them on device.
"""
from __future__ import annotations

import numpy as np
from scipy import special as sp


def _all_orders(fn, N: int, z: np.ndarray, **kw) -> np.ndarray:
    z = np.asarray(z, np.float64)
    # z=0 legitimately yields ±inf for the Y/K families (and scipy's
    # derivative formulas then warn on inf-inf); the limits are correct and
    # DC is handled by the callers, so keep the edge silent.
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.stack([fn(n, z, **kw) for n in range(N + 1)],
                        axis=-1)  # (..., N+1)


_DC = 1e-15  # the C's z <= 1e-15 DC clamp (saf_utility_bessel.c:392 etc.)


def _zero_dc(z, *arrs, dc_rows=None):
    """Apply the C's DC branch: where z <= 1e-15, overwrite each array's
    order rows with dc_rows[i] (default all-zeros).  Every _ALL variant in
    saf_utility_bessel.c special-cases DC instead of evaluating (scipy
    returns J0(0)=1 / ±inf for the Y/K families there)."""
    m = np.asarray(z, np.float64) <= _DC
    if not np.any(m):
        return arrs if len(arrs) > 1 else arrs[0]
    out = []
    for i, a in enumerate(arrs):
        a = np.array(a)
        a[m] = 0.0 if dc_rows is None or dc_rows[i] is None else dc_rows[i]
        out.append(a)
    return tuple(out) if len(out) > 1 else out[0]


def _cplx(re: np.ndarray, im: np.ndarray) -> np.ndarray:
    """re + i*im built WITHOUT multiplying by 1j: y_n(0) = -inf, and
    1j*(-inf) would poison the real part with 0*inf = NaN (the source of
    RuntimeWarnings at the z=0 / DC-band edge).  The limit (re, ±inf·i) is
    the mathematically right value and what the C reference produces."""
    out = np.empty(np.broadcast(re, im).shape, np.complex128)
    out.real = re
    out.imag = im
    return out


# -- cylindrical -------------------------------------------------------------

def bessel_Jn_all(N: int, z) -> tuple[np.ndarray, np.ndarray]:
    """J_n(z) and dJ_n/dz for n=0..N (saf_utility_bessel.h bessel_Jn_ALL).
    Returns (vals, derivs), each (..., N+1).  DC (z <= 1e-15) → all zeros,
    as the C (even though J0(0) = 1 mathematically)."""
    return _zero_dc(z, _all_orders(sp.jv, N, z), _all_orders(sp.jvp, N, z))


def bessel_Yn_all(N: int, z) -> tuple[np.ndarray, np.ndarray]:
    return _zero_dc(z, _all_orders(sp.yv, N, z), _all_orders(sp.yvp, N, z))


def hankel_Hn1_all(N: int, z) -> tuple[np.ndarray, np.ndarray]:
    J, Jp = bessel_Jn_all(N, z)
    Y, Yp = bessel_Yn_all(N, z)
    return _cplx(J, Y), _cplx(Jp, Yp)


def hankel_Hn2_all(N: int, z) -> tuple[np.ndarray, np.ndarray]:
    """Cylindrical Hankel of the second kind H2_n = J_n − i·Y_n and its
    derivative (saf_utility_bessel.c ``hankel_Hn2_ALL``).

    NOTE: mirrors the reference's n=0 derivative EXACTLY, which computes
    0.5·[(J₁+iY₁)e^{−iπ} − (J₁−iY₁)] = −J₁ — i.e. it drops the +iY₁ term
    (the mathematically correct dH2₀ = −H2₁ = −J₁+iY₁).  The quirk feeds
    cylModalCoeffs' rigid n=0 coefficient (b₀ becomes i·Y₀), pinned by the
    mu_cyl_modal_rigid golden."""
    J, Jp = bessel_Jn_all(N, z)
    Y, Yp = bessel_Yn_all(N, z)
    dH = np.array(_cplx(Jp, -Yp))
    # The C computes J_1 explicitly for the n=0 quirk even when N == 0
    # (saf_utility_bessel.c calls Jn(1, z) unconditionally).
    J1 = np.asarray(J)[..., 1] if N >= 1 else sp.jv(1, np.asarray(z, np.float64))
    dH[..., 0] = -J1
    return _cplx(J, -Y), dH


# -- spherical ---------------------------------------------------------------

def _sph_dc_rows(N: int):
    """Spherical j/i DC rows (saf_utility_bessel.c:679-688): value [1,0..],
    derivative [0, 1/3, 0..]."""
    v = np.zeros(N + 1); v[0] = 1.0
    d = np.zeros(N + 1)
    if N > 0:
        d[1] = 1.0 / 3.0
    return v, d


def bessel_jn_all(N: int, z) -> tuple[np.ndarray, np.ndarray]:
    """Spherical j_n(z) and derivative, n=0..N (bessel_jn_ALL)."""
    return _zero_dc(z, _all_orders(sp.spherical_jn, N, z),
                    _all_orders(sp.spherical_jn, N, z, derivative=True),
                    dc_rows=_sph_dc_rows(N))


def bessel_yn_all(N: int, z) -> tuple[np.ndarray, np.ndarray]:
    return _zero_dc(z, _all_orders(sp.spherical_yn, N, z),
                    _all_orders(sp.spherical_yn, N, z, derivative=True))


def bessel_in_all(N: int, z) -> tuple[np.ndarray, np.ndarray]:
    """Modified spherical i_n (first kind)."""
    return _zero_dc(z, _all_orders(sp.spherical_in, N, z),
                    _all_orders(sp.spherical_in, N, z, derivative=True),
                    dc_rows=_sph_dc_rows(N))


def bessel_kn_all(N: int, z) -> tuple[np.ndarray, np.ndarray]:
    """Modified spherical k_n (second kind)."""
    return _zero_dc(z, _all_orders(sp.spherical_kn, N, z),
                    _all_orders(sp.spherical_kn, N, z, derivative=True))


def hankel_hn1_all(N: int, z) -> tuple[np.ndarray, np.ndarray]:
    """h1_n = j_n + i·y_n; DC → value [1, 0..] and derivative ALL zeros
    (the C zeroes dh even though dj[1] is 1/3, c:1028-1040)."""
    j, jp = bessel_jn_all(N, z)
    y, yp = bessel_yn_all(N, z)
    h, dh = _cplx(j, y), _cplx(jp, yp)
    dcv = np.zeros(N + 1, np.complex128); dcv[0] = 1.0
    return _zero_dc(z, h, dh, dc_rows=(dcv, np.zeros(N + 1, np.complex128)))


def hankel_hn2_all(N: int, z) -> tuple[np.ndarray, np.ndarray]:
    """Spherical Hankel of the second kind h2_n = j_n - i·y_n
    (hankel_hn2_ALL); DC as hankel_hn1_all."""
    j, jp = bessel_jn_all(N, z)
    y, yp = bessel_yn_all(N, z)
    h, dh = _cplx(j, -y), _cplx(jp, -yp)
    dcv = np.zeros(N + 1, np.complex128); dcv[0] = 1.0
    return _zero_dc(z, h, dh, dc_rows=(dcv, np.zeros(N + 1, np.complex128)))
