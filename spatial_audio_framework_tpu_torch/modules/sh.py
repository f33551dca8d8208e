"""Spherical-harmonic core for the design stack (counterpart of
``spatial_audio_framework_tpu/modules/sh.py``).  Host numpy, plus
``get_sh_real_torch`` for directions that live on the device (the
encoder's per-frame SH matrix) and ``get_sh_rot_mtx_real_torch`` for a
rotation matrix that lives there (head tracking, once per block).

Conventions match the reference (saf_sh.h):

* ``get_sh_real(order, dirs)`` — orthonormal real SH, ACN ordering,
  (azimuth, inclination) in radians, shape (nSH, nDirs) (saf_sh.c:190-253);
* ``get_rsh(order, dirs_deg)`` — (azi, elev) degrees, scaled by sqrt(4π)
  (saf_hoa.c:118-150);
* ``get_sh_complex`` — physics convention with Condon–Shortley phase
  (saf_sh.c:333-395);
* ``get_sh_rot_mtx_real`` — Ivanic & Ruedenberg recursion
  (saf_sh.c:506-590);
* the sector half: ``wigner_3j``, ``gaunt_mtx``, ``compute_vel_coeffs_mtx``,
  the velocity patterns and ``compute_sector_coeffs`` (saf_sh.c:594-700,
  saf_sh_internal.c:100), for the sector-based analysers (dirass).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


def order2nsh(order: int) -> int:
    return (order + 1) * (order + 1)


def norm_legendre_all(order: int, x):
    """Fully-normalised associated Legendre functions, no Condon–Shortley.

    N_n^m(x) = sqrt((2n+1)/(4π) (n-m)!/(n+m)!) P_n^m(x) for 0 ≤ m ≤ n ≤ order.
    x: (...,) → (order+1, order+1, ...) indexed [n, m]; entries with m > n
    are zero.  Stable m-diagonal + upward-n recursion.
    """
    x = np.asarray(x)
    s = np.sqrt(np.maximum(1.0 - x * x, 0.0))
    out = np.zeros((order + 1, order + 1) + x.shape, dtype=x.dtype)
    nmm = np.full(x.shape, 1.0 / math.sqrt(4.0 * math.pi), dtype=x.dtype)
    out[0, 0] = nmm
    for m in range(1, order + 1):
        nmm = nmm * math.sqrt((2.0 * m + 1.0) / (2.0 * m)) * s
        out[m, m] = nmm
    for m in range(0, order + 1):
        if m + 1 <= order:
            out[m + 1, m] = x * math.sqrt(2.0 * m + 3.0) * out[m, m]
        for n in range(m + 2, order + 1):
            a = math.sqrt((4.0 * n * n - 1.0) / (n * n - m * m))
            b = math.sqrt(((2.0 * n + 1.0) * (n - 1.0 - m) * (n - 1.0 + m))
                          / ((2.0 * n - 3.0) * (n * n - m * m)))
            out[n, m] = a * x * out[n - 1, m] - b * out[n - 2, m]
    return out


def unnorm_legendre(n: int, x):
    """Unnormalised P_n^m with Condon–Shortley phase (saf_sh.c:53-128
    ``unnorm_legendreP``).  x: (...,) → (n+1, ...)."""
    x = np.asarray(x, dtype=np.float64)
    N = norm_legendre_all(n, x)[n]  # (n+1, ...), no CS phase
    out = []
    for m in range(n + 1):
        scale = math.sqrt(4.0 * math.pi / (2.0 * n + 1.0)
                          * math.factorial(n + m) / math.factorial(n - m))
        out.append(((-1.0) ** m) * scale * N[m])
    return np.stack(out, axis=0)


def get_sh_real(order: int, dirs_rad):
    """Orthonormal real SH.  dirs_rad: (nDirs, 2) [azi, inclination] →
    (nSH, nDirs)  (saf_sh.c:190 ``getSHreal``)."""
    dirs_rad = np.asarray(dirs_rad)
    azi, incl = dirs_rad[..., 0], dirs_rad[..., 1]
    N = norm_legendre_all(order, np.cos(incl))  # (order+1, order+1, nDirs)
    rows = []
    for n in range(order + 1):
        for m in range(-n, n + 1):
            am = abs(m)
            base = N[n, am]
            if m < 0:
                rows.append(math.sqrt(2.0) * base * np.sin(am * azi))
            elif m == 0:
                rows.append(base)
            else:
                rows.append(math.sqrt(2.0) * base * np.cos(am * azi))
    return np.stack(rows, axis=0)


def get_sh_real_torch(order: int, dirs_rad: torch.Tensor) -> torch.Tensor:
    """:func:`get_sh_real` on a tensor, in the same op order (the JAX
    package's traced branch): dirs_rad (nDirs, 2) [azi, inclination] →
    (nSH, nDirs) on dirs_rad's device, in its dtype."""
    azi, incl = dirs_rad[..., 0], dirs_rad[..., 1]
    x = torch.cos(incl)
    s = torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0))
    N = {}
    nmm = torch.full_like(x, 1.0 / math.sqrt(4.0 * math.pi))
    N[0, 0] = nmm
    for m in range(1, order + 1):
        nmm = nmm * math.sqrt((2.0 * m + 1.0) / (2.0 * m)) * s
        N[m, m] = nmm
    for m in range(0, order + 1):
        if m + 1 <= order:
            N[m + 1, m] = x * math.sqrt(2.0 * m + 3.0) * N[m, m]
        for n in range(m + 2, order + 1):
            a = math.sqrt((4.0 * n * n - 1.0) / (n * n - m * m))
            b = math.sqrt(((2.0 * n + 1.0) * (n - 1.0 - m) * (n - 1.0 + m))
                          / ((2.0 * n - 3.0) * (n * n - m * m)))
            N[n, m] = a * x * N[n - 1, m] - b * N[n - 2, m]
    rows = []
    for n in range(order + 1):
        for m in range(-n, n + 1):
            am = abs(m)
            if m < 0:
                rows.append(math.sqrt(2.0) * N[n, am] * torch.sin(am * azi))
            elif m == 0:
                rows.append(N[n, 0])
            else:
                rows.append(math.sqrt(2.0) * N[n, am] * torch.cos(am * azi))
    return torch.stack(rows, dim=0)


def get_rsh(order: int, dirs_deg):
    """Real SH for (azi, elev) in degrees, scaled by sqrt(4π)
    (saf_hoa.c:118 ``getRSH``).  → (nSH, nDirs)."""
    dirs_deg = np.asarray(dirs_deg)
    d = math.pi / 180.0
    dirs_rad = np.stack([dirs_deg[..., 0] * d,
                         math.pi / 2.0 - dirs_deg[..., 1] * d], axis=-1)
    return get_sh_real(order, dirs_rad) * math.sqrt(4.0 * math.pi)


def get_sh_complex(order: int, dirs_rad):
    """Complex SH, physics convention with Condon–Shortley phase
    (saf_sh.c:333 ``getSHcomplex``).  dirs_rad: (nDirs, 2) [azi, incl] →
    (nSH, nDirs) complex."""
    dirs_rad = np.asarray(dirs_rad)
    azi, incl = dirs_rad[..., 0], dirs_rad[..., 1]
    N = norm_legendre_all(order, np.cos(incl))
    rows = []
    for n in range(order + 1):
        for m in range(-n, n + 1):
            am = abs(m)
            base = N[n, am]
            if m >= 0:
                rows.append(((-1.0) ** am) * base * np.exp(1j * am * azi))
            else:
                rows.append(base * np.exp(-1j * am * azi))
    return np.stack(rows, axis=0)


def complex2real_sh_mtx(order: int) -> np.ndarray:
    """Transform T s.t. Y_real = Re{conj(T) @ Y_complex}
    (saf_sh.c:397 ``complex2realSHMtx``).  (nSH, nSH) complex."""
    nsh = order2nsh(order)
    T = np.zeros((nsh, nsh), np.complex128)
    T[0, 0] = 1.0
    q = 1
    for n in range(1, order + 1):
        idx = q + 2 * n + 1
        for p, m in enumerate(range(-n, n + 1)):
            if m < 0:
                T[q, q] = 1j / math.sqrt(2.0)
                T[idx - p - 1, q] = 1.0 / math.sqrt(2.0)
            elif m == 0:
                T[q, q] = 1.0
            else:
                T[q, q] = ((-1.0) ** m) / math.sqrt(2.0)
                T[idx - p - 1, q] = -1j * ((-1.0) ** m) / math.sqrt(2.0)
            q += 1
    return T


def real2complex_sh_mtx(order: int) -> np.ndarray:
    """Inverse transform (saf_sh.c ``real2complexSHMtx``): unitary, so it is
    the conjugate transpose of complex2real_sh_mtx."""
    return complex2real_sh_mtx(order).conj().T


def complex2real_coeffs(order: int, C):
    """Convert complex SH coefficients to real (saf_sh.c
    ``complex2realCoeffs``).  C: (nSH, K) complex → (nSH, K) real:
    Re{conj(T_c2r) @ C}."""
    return (complex2real_sh_mtx(order).conj() @ np.asarray(C)).real


def get_sh_rot_mtx_real(R, order: int):
    """Real-SH rotation matrix from a 3×3 rotation matrix
    (saf_sh.c:506 ``getSHrotMtxReal``; Ivanic & Ruedenberg 1996/1998),
    vectorised per order band.  R: (3, 3) → (nSH, nSH) in R's dtype.
    """
    R = np.asarray(R)
    dtype = R.dtype
    # band-1 permutation of R (saf_sh.c:533-543); rows/cols ordered m=-1,0,1
    R1 = np.stack([
        np.stack([R[1, 1], R[1, 2], R[1, 0]], -1),
        np.stack([R[2, 1], R[2, 2], R[2, 0]], -1),
        np.stack([R[0, 1], R[0, 2], R[0, 0]], -1),
    ], -2)
    blocks = [np.ones((1, 1), dtype=dtype), R1]
    R_lm1 = R1
    for l in range(2, order + 1):
        ms = np.arange(-l, l + 1)
        d = (ms == 0).astype(np.float64)
        denom = np.empty((2 * l + 1, 2 * l + 1))
        for j, n in enumerate(ms):
            denom[:, j] = (2 * l) * (2 * l - 1) if abs(n) == l else (l * l - n * n)
        am = np.abs(ms)[:, None].astype(np.float64)
        u_c = np.sqrt((l * l - ms[:, None] ** 2) / denom)
        v_c = (np.sqrt((1 + d[:, None]) * (l + am - 1) * (l + am) / denom)
               * (1 - 2 * d[:, None]) * 0.5)
        w_c = (np.sqrt(np.maximum((l - am - 1) * (l - am), 0.0) / denom)
               * (1 - d[:, None]) * (-0.5))

        # P_i(a, b) built from R_lm1 (saf_sh_internal.c:151-179 ``getP``)
        def P(i):
            ri1, ri0, rim1 = R1[i + 1, 2], R1[i + 1, 1], R1[i + 1, 0]
            left = ri1 * R_lm1[:, :1] + rim1 * R_lm1[:, -1:]
            right = ri1 * R_lm1[:, -1:] - rim1 * R_lm1[:, :1]
            mid = ri0 * R_lm1
            return np.concatenate([left, mid, right], axis=1)  # (2l-1, 2l+1)

        P0, P1, Pm1 = P(0), P(1), P(-1)

        def row(Pmat, a_vals):
            idx = np.clip(np.asarray(a_vals) + l - 1, 0, 2 * l - 2)
            return Pmat[idx, :]

        # U (saf_sh_internal.c:182): P0 at a=m
        U = row(P0, ms)
        # V (saf_sh_internal.c:197-233)
        d1 = (np.abs(ms) == 1).astype(np.float64)[:, None]
        v_pos = (row(P1, ms - 1) * np.sqrt(1 + d1) - row(Pm1, -ms + 1) * (1 - d1))
        v_neg = (row(P1, ms + 1) * (1 - d1) + row(Pm1, -ms - 1) * np.sqrt(1 + d1))
        v_zero = row(P1, np.ones_like(ms)) + row(Pm1, -np.ones_like(ms))
        mpos = (ms > 0)[:, None]
        mzero = (ms == 0)[:, None]
        V = np.where(mzero, v_zero, np.where(mpos, v_pos, v_neg))
        # W (saf_sh_internal.c:236-263)
        w_pos = row(P1, ms + 1) + row(Pm1, -ms - 1)
        w_neg = row(P1, ms - 1) - row(Pm1, -ms + 1)
        W = np.where(mpos, w_pos, w_neg)

        R_l = (u_c.astype(dtype) * U + v_c.astype(dtype) * V
               + w_c.astype(dtype) * W)
        blocks.append(R_l)
        R_lm1 = R_l

    nsh = order2nsh(order)
    out = np.zeros((nsh, nsh), dtype=dtype)
    i0 = 0
    for b in blocks:
        k = b.shape[0]
        out[i0:i0 + k, i0:i0 + k] = b
        i0 += k
    return out


@functools.lru_cache(maxsize=None)
def _sh_rot_tables(order: int, device: torch.device, dtype: torch.dtype):
    """Per band l = 2..order of the Ivanic–Ruedenberg recursion: (rows,
    coef).  Band l is a sum of five row-gathers from the stacked
    P_{-1}, P_0, P_1 (each (2l-1, 2l+1), saf_sh_internal.c:151-263), one for
    U and two each for V and W; ``rows`` (5·(2l+1),) int64 indexes the
    (3·(2l-1))-row stack and ``coef`` (5, 2l+1, 2l+1) holds u, v and w with
    the m-dependent factors (√(1+δ_{|m|,1}), 1-δ, the signs) multiplied in.
    They depend on ``order`` only: built once in float64 on the host and kept
    as tensors on ``device``."""
    tables = []
    for l in range(2, order + 1):
        ms = np.arange(-l, l + 1)
        d = (ms == 0).astype(np.float64)[:, None]
        denom = np.empty((2 * l + 1, 2 * l + 1))
        for j, n in enumerate(ms):
            denom[:, j] = ((2 * l) * (2 * l - 1) if abs(n) == l
                           else (l * l - n * n))
        am = np.abs(ms)[:, None].astype(np.float64)
        u_c = np.sqrt((l * l - ms[:, None] ** 2) / denom)
        v_c = (np.sqrt((1 + d) * (l + am - 1) * (l + am) / denom)
               * (1 - 2 * d) * 0.5)
        w_c = (np.sqrt(np.maximum((l - am - 1) * (l - am), 0.0) / denom)
               * (1 - d) * (-0.5))
        d1 = (np.abs(ms) == 1).astype(np.float64)
        pos, neg = ms > 0, ms < 0
        one = np.ones_like(d1)
        # (which P: 0 → P_{-1}, 1 → P_0, 2 → P_1; row a per m; factor per m)
        terms = [
            (1, ms, one, u_c),
            (2, np.where(pos, ms - 1, np.where(neg, ms + 1, 1)),
             np.where(pos, np.sqrt(1 + d1), np.where(neg, 1 - d1, 1.0)), v_c),
            (0, np.where(pos, -ms + 1, np.where(neg, -ms - 1, -1)),
             np.where(pos, -(1 - d1), np.where(neg, np.sqrt(1 + d1), 1.0)),
             v_c),
            (2, np.where(pos, ms + 1, ms - 1), one, w_c),
            (0, np.where(pos, -ms - 1, -ms + 1), np.where(pos, 1.0, -1.0),
             w_c),
        ]
        rows = np.concatenate([
            which * (2 * l - 1) + np.clip(a + l - 1, 0, 2 * l - 2)
            for which, a, _, _ in terms])
        coef = np.stack([f[:, None] * c for _, _, f, c in terms])
        tables.append((torch.tensor(rows, dtype=torch.int64, device=device),
                       torch.tensor(coef, dtype=dtype, device=device)))
    return tuple(tables)


def get_sh_rot_mtx_real_torch(R: torch.Tensor, order: int) -> torch.Tensor:
    """:func:`get_sh_rot_mtx_real` on a tensor: R (..., 3, 3) → (..., nSH,
    nSH) on R's device, in its dtype, with device ops only (no host read of
    R, no tensor made from host data once the per-order tables are cached),
    so a head tracker's rotation can change every block without making the
    host wait for the device."""
    # band-1 permutation of R (saf_sh.c:533-543): rows/cols ordered m=-1,0,1
    R1 = torch.roll(R, shifts=(-1, -1), dims=(-2, -1))
    nsh = order2nsh(order)
    out = torch.zeros(R.shape[:-2] + (nsh, nsh), dtype=R.dtype,
                      device=R.device)
    # fill_ on the view: assigning a Python scalar to a fully indexed
    # (0-dim) element synchronises the host with the card
    out[..., 0, 0].fill_(1.0)
    if order >= 1:
        out[..., 1:4, 1:4] = R1
    r_m1, r_0, r_p1 = (R1[..., :, None, k:k + 1] for k in range(3))
    R_lm1 = R1
    for l, (rows, coef) in enumerate(
            _sh_rot_tables(order, R.device, R.dtype), start=2):
        prev = R_lm1[..., None, :, :]          # (..., 1, 2l-1, 2l-1)
        first, last = prev[..., :1], prev[..., -1:]
        # P_i for i = -1, 0, 1 at once: (..., 3, 2l-1, 2l+1)
        P = torch.cat([r_p1 * first + r_m1 * last, r_0 * prev,
                       r_p1 * last - r_m1 * first], dim=-1)
        g = P.flatten(-3, -2).index_select(-2, rows)
        R_l = (g.unflatten(-2, (5, 2 * l + 1)) * coef).sum(dim=-3)
        i0 = l * l
        out[..., i0:i0 + 2 * l + 1, i0:i0 + 2 * l + 1] = R_l
        R_lm1 = R_l
    return out


def beam_weights_cardioid(order: int) -> np.ndarray:
    """(order+1,) b_n for a cardioid (saf_sh.c
    ``beamWeightsCardioid2Spherical``)."""
    N = order
    b = np.zeros(N + 1)
    for n in range(N + 1):
        b[n] = (math.sqrt(4.0 * math.pi * (2 * n + 1))
                * math.factorial(N) * math.factorial(N + 1)
                / (math.factorial(N + n + 1) * math.factorial(N - n)) / (N + 1))
    return b.astype(np.float32)


def beam_weights_hypercardioid(order: int) -> np.ndarray:
    """b_n for a hypercardioid / plane-wave-decomposition beam
    (saf_sh.c ``beamWeightsHypercardioid2Spherical``)."""
    N = order
    Y0 = get_sh_real(N, np.array([[0.0, 0.0]]))[:, 0]
    b = np.zeros(N + 1)
    for n in range(N + 1):
        b[n] = Y0[(n + 1) * (n + 1) - n - 1] * 4.0 * math.pi / ((N + 1) ** 2)
    return b.astype(np.float32)


def beam_weights_max_ev(order: int) -> np.ndarray:
    """Max energy-vector weights (saf_sh.c ``beamWeightsMaxEV``)."""
    N = order
    x = math.cos(2.4068 / (N + 1.51))
    b = np.zeros(N + 1)
    norm = 0.0
    for n in range(N + 1):
        Pn = unnorm_legendre(n, np.array([x]))[0, 0]
        b[n] = math.sqrt((2 * n + 1) / (4.0 * math.pi)) * Pn
        norm += math.sqrt((2 * n + 1) / (4.0 * math.pi)) * b[n]
    return (b / norm).astype(np.float32)


def check_cond_number_sht_real(order: int, dirs_rad: np.ndarray,
                               w: np.ndarray | None = None) -> np.ndarray:
    """Condition numbers of the least-squares SHT per order 0..N
    (saf_sh.c ``checkCondNumberSHTReal``): cond(YₙᵀWYₙ) =
    max(singular values)/min(...) of the order-truncated Gram matrix.

    dirs_rad: (nDirs, 2) [azi, INCLINATION] radians; w: optional (nDirs,)
    integration weights.  → (order+1,)."""
    Y = get_sh_real(order, np.asarray(dirs_rad, np.float64))
    cond = np.zeros(order + 1, np.float64)
    for n in range(order + 1):
        Yn = Y[: (n + 1) ** 2].T                   # (nDirs, nSH_n)
        G = Yn.T @ (Yn * np.asarray(w)[:, None]) if w is not None else Yn.T @ Yn
        s = np.linalg.svd(G, compute_uv=False)
        cond[n] = s.max() / (s.min() + 2.23e-7)
    return cond


def rotate_axis_coeffs_complex(order: int, c_n, theta_0: float, phi_0: float):
    """Axisymmetric pattern c_n steered to (incl θ0, azi φ0) → complex SH
    coeffs (saf_sh.c ``rotateAxisCoeffsComplex``):
    c_nm = sqrt(4π/(2n+1)) c_n conj(Y_n^m)."""
    c_n = np.asarray(c_n)
    Y = get_sh_complex(order, np.asarray([[phi_0, theta_0]]))[:, 0]
    scale = np.concatenate([
        np.full(2 * n + 1, math.sqrt(4.0 * math.pi / (2 * n + 1)))
        for n in range(order + 1)])
    cn_full = np.concatenate([
        np.broadcast_to(c_n[n], (2 * n + 1,)) for n in range(order + 1)])
    return np.conj(Y) * scale.astype(Y.real.dtype) * cn_full


def rotate_axis_coeffs_real(order: int, c_n, theta_0: float, phi_0: float):
    """Real-SH version (saf_sh.c ``rotateAxisCoeffsReal``)."""
    c_nm = rotate_axis_coeffs_complex(order, c_n, theta_0, phi_0)
    return complex2real_coeffs(order, c_nm[:, None])[:, 0]


def wigner_3j(j1: int, j2: int, j3: int, m1: int, m2: int, m3: int) -> float:
    """Wigner 3j symbol via the Racah formula (saf_sh_internal ``wigner_3j``),
    float64 factorials (exact for the small orders used here)."""
    if (m1 + m2 + m3 != 0 or j3 < abs(j1 - j2) or j3 > j1 + j2
            or abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3):
        return 0.0
    f = math.factorial
    pre = math.sqrt(f(j1 + j2 - j3) * f(j1 - j2 + j3) * f(-j1 + j2 + j3)
                    / f(j1 + j2 + j3 + 1)
                    * f(j1 - m1) * f(j1 + m1) * f(j2 - m2) * f(j2 + m2)
                    * f(j3 - m3) * f(j3 + m3))
    t_min = max(0, j2 - j3 - m1, j1 - j3 + m2)
    t_max = min(j1 + j2 - j3, j1 - m1, j2 + m2)
    s = 0.0
    for t in range(t_min, t_max + 1):
        s += ((-1.0) ** t) / (f(t) * f(j3 - j2 + t + m1) * f(j3 - j1 + t - m2)
                              * f(j1 + j2 - j3 - t) * f(j1 - t - m1)
                              * f(j2 - t + m2))
    return ((-1.0) ** (j1 - j2 - m3)) * pre * s


def gaunt_mtx(N1: int, N2: int, N: int) -> np.ndarray:
    """Gaunt coefficients (integrals of three complex SH)
    (saf_sh_internal.c:100 ``gaunt_mtx``).  → (D1, D2, D3)."""
    D1, D2, D3 = order2nsh(N1), order2nsh(N2), order2nsh(N)
    A = np.zeros((D1, D2, D3))
    for n in range(N + 1):
        for m in range(-n, n + 1):
            q = n * (n + 1) + m
            for n1 in range(N1 + 1):
                for m1 in range(-n1, n1 + 1):
                    q1 = n1 * (n1 + 1) + m1
                    for n2 in range(N2 + 1):
                        for m2 in range(-n2, n2 + 1):
                            if n < abs(n1 - n2) or n > n1 + n2:
                                continue
                            q2 = n2 * (n2 + 1) + m2
                            A[q1, q2, q] = ((-1.0) ** m
                                            * math.sqrt((2 * n1 + 1) * (2 * n2 + 1)
                                                        * (2 * n + 1) / (4 * math.pi))
                                            * wigner_3j(n1, n2, n, m1, m2, -m)
                                            * wigner_3j(n1, n2, n, 0, 0, 0))
    return A


def compute_vel_coeffs_mtx(sector_order: int) -> np.ndarray:
    """Matrices converting sector patterns to their velocity (dipole-weighted)
    patterns (saf_sh.c:594 ``computeVelCoeffsMtx``).
    → A_xyz ((Ns+2)², (Ns+1)², 3) complex."""
    Ns = sector_order
    Nxyz = Ns + 1
    x1 = math.sqrt(2.0 * math.pi / 3.0)
    x3 = -x1
    y1 = y3 = math.sqrt(2.0 * math.pi / 3.0)
    z2 = math.sqrt(4.0 * math.pi / 3.0)
    G = gaunt_mtx(Ns, 1, Nxyz)  # (nC_s, 4, nC_xyz)
    A = np.zeros((order2nsh(Nxyz), order2nsh(Ns), 3), np.complex128)
    A[..., 0] = (x1 * G[:, 1, :] + x3 * G[:, 3, :]).T
    A[..., 1] = 1j * (y1 * G[:, 1, :] + y3 * G[:, 3, :]).T
    A[..., 2] = (z2 * G[:, 2, :]).T
    return A


def beam_weights_velocity_patterns_complex(order: int, b_n, azi_rad: float,
                                           elev_rad: float,
                                           A_xyz: np.ndarray) -> np.ndarray:
    """Velocity-pattern coefficients for a steered axisymmetric beam
    (saf_sh.c ``beamWeightsVelocityPatternsComplex``).
    → ((order+2)², 3) complex."""
    c_nm = rotate_axis_coeffs_complex(order, b_n, np.pi / 2.0 - elev_rad, azi_rad)
    return np.einsum("isd,s->id", A_xyz, np.asarray(c_nm))


def beam_weights_velocity_patterns_real(order: int, b_n, azi_rad: float,
                                        elev_rad: float,
                                        A_xyz: np.ndarray) -> np.ndarray:
    """Real-SH variant (saf_sh.c ``beamWeightsVelocityPatternsReal``)."""
    vel_c = beam_weights_velocity_patterns_complex(order, b_n, azi_rad,
                                                   elev_rad, A_xyz)
    return complex2real_coeffs(order + 1, vel_c)


# ACN/N3D → WXYZ (FuMa-style B-format) conversion (saf_sh.c:42 wxyzCoeffs)
WXYZ_COEFFS = np.array([
    [3.544907701811032, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 2.046653415892977],
    [0.0, 2.046653415892977, 0.0, 0.0],
    [0.0, 0.0, 2.046653415892977, 0.0]], np.float32)

SECTOR_PATTERN_PWD = "pwd"
SECTOR_PATTERN_MAXRE = "maxre"
SECTOR_PATTERN_CARDIOID = "cardioid"


def _sector_b_n(order: int, pattern: str):
    if pattern == SECTOR_PATTERN_PWD:
        b = beam_weights_hypercardioid(order)
        Q = float((order + 1) ** 2)
    elif pattern == SECTOR_PATTERN_MAXRE:
        b = beam_weights_max_ev(order)
        Q = 4.0 * math.pi / float(b @ b)
    elif pattern == SECTOR_PATTERN_CARDIOID:
        b = beam_weights_cardioid(order)
        Q = 2.0 * order + 1.0
    else:
        raise ValueError(pattern)
    return b, Q


def compute_sector_coeffs(order_sec: int, pattern: str,
                          sec_dirs_deg: np.ndarray,
                          energy_preserving: bool = True):
    """Sector coefficients (W, X, Y, Z beams per sector)
    (saf_sh.c ``computeSectorCoeffsEP``/``AP``).

    → (sectorCoeffs (nSec, 4, (order_sec+2)²) float32, normSec).
    """
    sec_dirs_deg = np.atleast_2d(np.asarray(sec_dirs_deg, np.float64))
    n_sec = sec_dirs_deg.shape[0]
    if order_sec == 0:
        return WXYZ_COEFFS.reshape(1, 4, 4).copy(), 1.0
    nsh = (order_sec + 2) ** 2
    b_n, Q = _sector_b_n(order_sec, pattern)
    norm_sec = (Q / n_sec) if energy_preserving else (order_sec + 1) / n_sec
    gain = math.sqrt(norm_sec) if energy_preserving else norm_sec
    A_xyz = compute_vel_coeffs_mtx(order_sec)
    out = np.zeros((n_sec, 4, nsh), np.float32)
    for ns, (azi_d, elev_d) in enumerate(sec_dirs_deg):
        azi, elev = math.radians(azi_d), math.radians(elev_d)
        c_nm = rotate_axis_coeffs_real(order_sec, b_n, np.pi / 2.0 - elev, azi)
        xyz_nm = beam_weights_velocity_patterns_real(order_sec, b_n, azi, elev,
                                                     A_xyz)
        out[ns, 0, : c_nm.shape[0]] = gain * np.asarray(c_nm)
        out[ns, 1:, :] = gain * np.asarray(xyz_nm).T
    return out, norm_sec
