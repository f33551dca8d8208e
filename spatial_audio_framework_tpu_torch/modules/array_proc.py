"""Microphone-array processing: modal coefficients, simulators, SHT metrics.

Counterpart of ``spatial_audio_framework_tpu/modules/array_proc.py``, the
array-processing half of ``saf_sh`` (saf_sh.h:977-1229):
cylindrical/spherical modal coefficients for open/rigid/directional arrays,
scatterer variants, spatial-aliasing and noise-amplification limits, diffuse
coherence matrices, and plane-wave array simulators.  All design-time (host,
float64) — outputs feed per-band filters applied on device.
"""
from __future__ import annotations

import numpy as np

from spatial_audio_framework_tpu_torch.utils import bessel as _bessel

# ARRAY_CONSTRUCTION_TYPES (saf_sh.h)
ARRAY_OPEN = "open"
ARRAY_OPEN_DIRECTIONAL = "open_directional"
ARRAY_RIGID = "rigid"
ARRAY_RIGID_DIRECTIONAL = "rigid_directional"

_4PI = 4.0 * np.pi


def cyl_modal_coeffs(order: int, kr, array_type: str) -> np.ndarray:
    """Cylindrical-array modal coefficients (saf_sh.c ``cylModalCoeffs``).
    kr: (nBands,) → (nBands, order+1) complex."""
    kr = np.asarray(kr, np.float64)
    i_pow = (1j ** np.arange(order + 1))
    if array_type == ARRAY_OPEN:
        J, _ = _bessel.bessel_Jn_all(order, kr)
        return (i_pow * J).astype(np.complex128)
    if array_type == ARRAY_RIGID:
        J, Jp = _bessel.bessel_Jn_all(order, kr)
        H2, H2p = _bessel.hankel_Hn2_all(order, kr)
        with np.errstate(invalid="ignore", divide="ignore"):
            b = i_pow * (J - (Jp / H2p) * H2)
        b = np.where(kr[:, None] <= 1e-20, 0.0, b)
        b[:, 0] = np.where(kr <= 1e-20, 1.0, b[:, 0])
        return b
    raise ValueError(f"unsupported cylindrical array type {array_type}")


def sph_modal_coeffs(order: int, kr, array_type: str,
                     dir_coeff: float = 0.0) -> np.ndarray:
    """Spherical-array modal coefficients b_n(kr)
    (saf_sh.c ``sphModalCoeffs``).  kr: (nBands,) → (nBands, order+1)."""
    kr = np.asarray(kr, np.float64)
    i_pow = (1j ** np.arange(order + 1))
    if array_type == ARRAY_OPEN:
        j, _ = _bessel.bessel_jn_all(order, kr)
        return (_4PI * i_pow * j).astype(np.complex128)
    if array_type == ARRAY_OPEN_DIRECTIONAL:
        j, jp = _bessel.bessel_jn_all(order, kr)
        return (_4PI * i_pow * (dir_coeff * j - 1j * (1.0 - dir_coeff) * jp))
    if array_type in (ARRAY_RIGID, ARRAY_RIGID_DIRECTIONAL):
        j, jp = _bessel.bessel_jn_all(order, kr)
        h2, h2p = _bessel.hankel_hn2_all(order, kr)
        with np.errstate(invalid="ignore", divide="ignore"):
            b = _4PI * i_pow * (j - (jp / h2p) * h2)
        b = np.where(kr[:, None] <= 1e-20, 0.0, b)
        b[:, 0] = np.where(kr <= 1e-20, _4PI, b[:, 0])
        return b
    raise ValueError(array_type)


def sph_scatterer_modal_coeffs(order: int, kr, kR) -> np.ndarray:
    """Sensors at radius r around a rigid scatterer of radius R
    (saf_sh.c ``sphScattererModalCoeffs``)."""
    kr = np.asarray(kr, np.float64)
    kR = np.asarray(kR, np.float64)
    i_pow = (1j ** np.arange(order + 1))
    j, _ = _bessel.bessel_jn_all(order, kr)
    _, jp_R = _bessel.bessel_jn_all(order, kR)
    h2, _ = _bessel.hankel_hn2_all(order, kr)
    _, h2p_R = _bessel.hankel_hn2_all(order, kR)
    with np.errstate(invalid="ignore", divide="ignore"):
        b = _4PI * i_pow * (j - (jp_R / h2p_R) * h2)
    b = np.where(kr[:, None] <= 1e-20, 0.0, b)
    b[:, 0] = np.where(kr <= 1e-20, _4PI, b[:, 0])
    return b


def sph_scatterer_dir_modal_coeffs(order: int, kr, kR, dir_coeff: float) -> np.ndarray:
    """Directional sensors around a rigid scatterer
    (saf_sh.c ``sphScattererDirModalCoeffs``)."""
    kr = np.asarray(kr, np.float64)
    kR = np.asarray(kR, np.float64)
    i_pow = (1j ** np.arange(order + 1))
    j, jp = _bessel.bessel_jn_all(order, kr)
    _, jp_R = _bessel.bessel_jn_all(order, kR)
    h2, h2p = _bessel.hankel_hn2_all(order, kr)
    _, h2p_R = _bessel.hankel_hn2_all(order, kR)
    beta = dir_coeff
    with np.errstate(invalid="ignore", divide="ignore"):
        b = ((beta * j - 1j * (1.0 - beta) * jp)
             - (jp_R / h2p_R) * (beta * h2 - 1j * (1.0 - beta) * h2p))
        b = i_pow * b * (_4PI / beta)
    b = np.where(kr[:, None] <= 1e-20, 0.0, b)
    b[:, 0] = np.where(kr <= 1e-20, _4PI, b[:, 0])
    return b


def sph_array_alias_lim(r: float, c: float, max_n: int) -> float:
    """Spatial-aliasing frequency limit f = c·N/(2πr) (saf_sh.c)."""
    return c * max_n / (2.0 * np.pi * r)


def sph_array_noise_threshold(max_n: int, n_sensors: int, r: float, c: float,
                              array_type: str, dir_coeff: float,
                              max_g_db: float) -> np.ndarray:
    """Frequency limits below which noise amplification exceeds max_g_db per
    order (saf_sh.c ``sphArrayNoiseThreshold``).  Returns (max_n,)."""
    max_g = 10.0 ** (max_g_db / 10.0)
    f_lim = np.zeros(max_n)
    for n in range(1, max_n + 1):
        b = sph_modal_coeffs(n, np.array([1.0]), array_type, dir_coeff)[0, n]
        kR_lim = (max_g * n_sensors * (np.abs(b) / _4PI) ** 2) ** (
            -10.0 * np.log10(2.0) / (6.0 * n))
        f_lim[n - 1] = kR_lim * c / (2.0 * np.pi * r)
    return f_lim


def _legendre_poly_all(order: int, x: np.ndarray) -> np.ndarray:
    """P_n(x) for n=0..order; x: (...,) → (order+1, ...)."""
    out = [np.ones_like(x), x]
    for n in range(2, order + 1):
        out.append(((2 * n - 1) * x * out[n - 1] - (n - 1) * out[n - 2]) / n)
    return np.stack(out[: order + 1], axis=0)


def sph_diff_coh_mtx_theory(order: int, sensor_dirs_rad: np.ndarray,
                            array_type: str, dir_coeff: float, kr) -> np.ndarray:
    """Theoretical diffuse-field coherence matrix
    (saf_sh.c ``sphDiffCohMtxTheory``).  sensor_dirs_rad: (nS, 2) [azi, elev].
    → (nBands, nS, nS) real."""
    kr = np.asarray(kr, np.float64)
    b = sph_modal_coeffs(order, kr, ARRAY_OPEN if array_type == ARRAY_OPEN
                         else (ARRAY_OPEN_DIRECTIONAL if array_type == ARRAY_OPEN_DIRECTIONAL
                               else ARRAY_RIGID), dir_coeff)
    b2 = np.abs(b / _4PI) ** 2  # (nBands, order+1)
    u = np.stack([np.cos(sensor_dirs_rad[:, 1]) * np.cos(sensor_dirs_rad[:, 0]),
                  np.cos(sensor_dirs_rad[:, 1]) * np.sin(sensor_dirs_rad[:, 0]),
                  np.sin(sensor_dirs_rad[:, 1])], -1)
    cosang = np.clip(u @ u.T, -1.0, 1.0)  # (nS, nS)
    Pn = _legendre_poly_all(order, cosang)  # (order+1, nS, nS)
    w = (2.0 * np.arange(order + 1) + 1.0) * _4PI
    return np.einsum("bn,n,nij->bij", b2, w, Pn)


def simulate_sph_array(order: int, kr, sensor_dirs_rad: np.ndarray,
                       src_dirs_deg: np.ndarray, array_type: str,
                       dir_coeff: float = 1.0, kR=None) -> np.ndarray:
    """Simulate a spherical array's response to plane waves
    (saf_sh.c ``simulateSphArray``).  sensor_dirs_rad: (nS, 2) [azi, elev];
    src_dirs_deg: (nSrc, 2).  → (nBands, nS, nSrc) complex."""
    kr = np.asarray(kr, np.float64)
    if array_type == ARRAY_OPEN:
        b = sph_modal_coeffs(order, kr, ARRAY_OPEN, 1.0)
    elif array_type == ARRAY_OPEN_DIRECTIONAL:
        b = sph_modal_coeffs(order, kr, ARRAY_OPEN_DIRECTIONAL, dir_coeff)
    else:
        if kR is None:
            b = sph_modal_coeffs(order, kr, ARRAY_RIGID, 1.0)
        else:
            b = sph_scatterer_dir_modal_coeffs(order, kr, kR, dir_coeff)
    u_s = np.stack([np.cos(sensor_dirs_rad[:, 1]) * np.cos(sensor_dirs_rad[:, 0]),
                    np.cos(sensor_dirs_rad[:, 1]) * np.sin(sensor_dirs_rad[:, 0]),
                    np.sin(sensor_dirs_rad[:, 1])], -1)
    src_rad = np.radians(np.asarray(src_dirs_deg, np.float64))
    u_p = np.stack([np.cos(src_rad[:, 1]) * np.cos(src_rad[:, 0]),
                    np.cos(src_rad[:, 1]) * np.sin(src_rad[:, 0]),
                    np.sin(src_rad[:, 1])], -1)
    cosang = np.clip(u_s @ u_p.T, -1.0, 1.0)  # (nS, nSrc)
    Pn = _legendre_poly_all(order, cosang)  # (order+1, nS, nSrc)
    w = (2.0 * np.arange(order + 1) + 1.0) / _4PI
    return np.einsum("bn,n,nsp->bsp", b, w, Pn)


def simulate_cyl_array(order: int, kr, sensor_dirs_rad: np.ndarray,
                       src_dirs_deg: np.ndarray, array_type: str) -> np.ndarray:
    """Simulate a cylindrical array (saf_sh.c ``simulateCylArray``): angular
    dependency cos(n·Δazi) with doubling for n>0.  → (nBands, nS, nSrc)."""
    kr = np.asarray(kr, np.float64)
    b = cyl_modal_coeffs(order, kr, array_type)  # (nBands, order+1)
    azi_s = sensor_dirs_rad[:, 0][:, None]
    azi_p = np.radians(np.asarray(src_dirs_deg, np.float64))[:, 0][None, :]
    ang = azi_s - azi_p  # (nS, nSrc)
    n = np.arange(order + 1)
    cosn = np.cos(n[:, None, None] * ang[None])  # (order+1, nS, nSrc)
    scale = np.where(n == 0, 1.0, 2.0)
    return np.einsum("bn,n,nsp->bsp", b, scale, cosn)


def evaluate_sht_filters(M: np.ndarray, H_array: np.ndarray,
                         Y_grid: np.ndarray, w_grid=None):
    """Objective evaluation of SHT filters (saf_sh.c:2375
    ``evaluateSHTfilters``): per-band, PER-ORDER spatial correlation and
    level difference between the synthesised patterns (M H) and the ideal SH
    patterns.

    M: (nBands, nSH, nSensors); H_array: (nBands, nSensors, nGrid);
    Y_grid: (nSH, nGrid).  Returns (cSH, lSH): (nBands, order+1) each.

    Matches the C per-(n,m) recipe exactly: the correlation normalises by the
    reconstructed pattern's norm only (the ideal pattern's uniform-grid norm
    Σ|Y|²/nDirs = 1/4π is left implicit, as in the C), complex per-m
    correlations are summed before taking the magnitude, and levels are
    per-order means of w·‖y_rec‖².
    """
    nsh, n_grid = Y_grid.shape
    order = int(round(np.sqrt(nsh))) - 1
    w = (np.asarray(w_grid, np.float64) if w_grid is not None
         else np.full(n_grid, 1.0 / n_grid))
    y_rec = np.einsum("bsm,bmg->bsg", M, H_array)  # (nBands, nSH, nGrid)
    yy = np.einsum("bsg,g->bs", np.abs(y_rec) ** 2, w)           # w·‖y_rec‖²
    yid = np.einsum("bsg,g,sg->bs", y_rec, w, np.conj(Y_grid))
    c_nm = yid / (np.sqrt(yy.astype(complex)) + 2.23e-9)
    n_bands = M.shape[0]
    cSH = np.zeros((n_bands, order + 1))
    lSH = np.zeros((n_bands, order + 1))
    for n in range(order + 1):
        sl = slice(n * n, (n + 1) * (n + 1))
        cSH[:, n] = np.clip(np.abs(c_nm[:, sl].sum(-1)) / (2.0 * n + 1.0),
                            0.0, 1.0)
        lSH[:, n] = 10.0 * np.log10(yy[:, sl].sum(-1) / (2.0 * n + 1.0)
                                    + 2.23e-9)
    return cSH, lSH
