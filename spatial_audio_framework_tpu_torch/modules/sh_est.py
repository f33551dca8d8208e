"""SH-domain DoA estimators and activity maps (counterpart of
``spatial_audio_framework_tpu/modules/sh_est.py``; the estimator half of
``saf_sh``: saf_sh.h:691-952).

* The complex maps (``generate_*_map``) and the grid-search estimators
  (``sph_pwd``, ``sph_music``, ``sph_esprit``) are host numpy, as the
  reference runs them.
* The ``*_ri`` maps take a covariance as an (re, im) pair of tensors and
  REAL steering (nSH, nGrid), batched over leading axes, and run on its
  device through ``ops/herm_ri`` (the powermap, sldoa and dirass paths).
"""
from __future__ import annotations

import numpy as np
import torch

from spatial_audio_framework_tpu_torch.modules import sh as _sh
from spatial_audio_framework_tpu_torch.ops import herm_ri as H
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul


# ---------------------------------------------------------------------------
# Activity maps (saf_sh.h:842-952), host numpy
# ---------------------------------------------------------------------------

def generate_pwd_map(Cx, Y_grid):
    """Plane-wave-decomposition powermap: real(diag(Yᵀ Cx Y))
    (saf_sh.c ``generatePWDmap``).  Cx: (..., nSH, nSH); Y_grid: (nSH, nGrid)."""
    return np.real(np.einsum("sg,...st,tg->...g", Y_grid, Cx, Y_grid))


def generate_mvdr_map(Cx, Y_grid, reg_par: float = 8.0, return_weights=False):
    """MVDR powermap (saf_sh.c ``generateMVDRmap``).  reg_par scales the
    mean-trace diagonal loading."""
    nsh = Y_grid.shape[0]
    tr = np.real(np.trace(Cx, axis1=-2, axis2=-1)) / nsh
    Cx_d = Cx + (reg_par * tr)[..., None, None] * np.eye(nsh, dtype=Cx.dtype)
    invCx_Y = np.linalg.solve(Cx_d, np.broadcast_to(
        Y_grid, Cx.shape[:-2] + Y_grid.shape))
    denom = np.einsum("sg,...sg->...g", Y_grid, np.conj(invCx_Y))
    w = invCx_Y / denom[..., None, :]
    pmap = np.real(np.einsum("...sg,...st,...tg->...g", w, Cx, w))
    return (pmap, w) if return_weights else pmap


def generate_cropac_lcmv_map(Cx, Y_grid, reg_par: float = 8.0,
                             lambda_floor: float = 0.0):
    """Cross-pattern-coherence LCMV map (saf_sh.c ``generateCroPaCLCMVmap``;
    Delikaris-Manias et al.)."""
    Cx = np.asarray(Cx)
    Y = np.asarray(Y_grid)
    nsh, n_grid = Y.shape
    mvdr_map, w_mvdr = generate_mvdr_map(Cx, Y, reg_par, return_weights=True)
    Cx_Y = Cx @ Y
    tr = np.real(np.trace(Cx)) / nsh
    Cx_d = Cx + reg_par * tr * np.eye(nsh, dtype=Cx.dtype)
    d = np.diag(Cx)
    w_out = np.array(w_mvdr, complex)
    for g in range(n_grid):
        A = np.stack([Y[:, g], Y[:, g] * d], -1)  # (nSH, 2)
        invCxd_A = np.linalg.solve(Cx_d, A)
        M2 = A.conj().T @ invCxd_A.conj()
        w_lcmv = np.linalg.solve(M2, invCxd_A.T)  # (2, nSH)
        wo = w_lcmv.T @ np.array([1.0, 0.0])      # (nSH,)
        xspec = wo @ Cx_Y[:, g]
        S = min(abs(xspec), mvdr_map[g])
        G = max(lambda_floor, np.sqrt(S / (mvdr_map[g] + 2.23e-10)))
        w_out[:, g] *= G
    return generate_pwd_map(Cx, w_out)


def _noise_subspace(Cx, n_sources: int):
    nsh = Cx.shape[-1]
    n_sources = min(n_sources, nsh // 2)
    _, V = np.linalg.eigh(Cx)       # ascending
    V = V[..., ::-1]                # descending (utility_cseig sortDecFLAG)
    return V[..., n_sources:]


def generate_music_map(Cx, Y_grid, n_sources: int, log_scale: bool = False):
    """MUSIC pseudo-spectrum (saf_sh.c ``generateMUSICmap``)."""
    Vn = _noise_subspace(Cx, n_sources)  # (..., nSH, nSH-K)
    VnY = np.einsum("...sk,sg->...kg", Vn, Y_grid.astype(Vn.dtype))
    p = 1.0 / (np.sum(np.abs(VnY) ** 2, axis=-2) + 2.23e-10)
    return np.log(p) if log_scale else p


def generate_minnorm_map(Cx, Y_grid, n_sources: int, log_scale: bool = False):
    """Minimum-norm pseudo-spectrum (saf_sh.c ``generateMinNormMap``)."""
    Vn = _noise_subspace(Cx, n_sources)
    Vn1 = Vn[..., 0, :]  # first row
    un = np.einsum("...sk,...k->...s", Vn, np.conj(Vn1))
    un = un / (np.einsum("...k,...k->...", Vn1, Vn1) + 2.23e-9)[..., None]
    UnY = np.einsum("...s,sg->...g", np.conj(un), Y_grid.astype(un.dtype))
    p = 1.0 / (np.abs(UnY) ** 2 + 2.23e-9)
    return np.log(p) if log_scale else p


# ---------------------------------------------------------------------------
# Activity maps in split real/imaginary arithmetic on tensors.  Cx_ri is an
# (A, B) = (re, im) pair; Y_grid is REAL SH steering (nSH, nGrid).  Same
# math as the complex versions above via the Hermitian real embedding.
# ---------------------------------------------------------------------------

def _loaded(A: torch.Tensor, reg_par: float) -> torch.Tensor:
    """A + reg_par·(mean trace)·I: the MVDR diagonal loading."""
    nsh = A.shape[-1]
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / nsh
    eye = torch.eye(nsh, dtype=A.dtype, device=A.device)
    return A + (reg_par * tr)[..., None, None] * eye


def generate_pwd_map_ri(Cx_ri, Y_grid):
    """PWD map with real steering: only Re(Cx) contributes."""
    return H.herm_quadform_real(Cx_ri, Y_grid)


def generate_mvdr_map_ri(Cx_ri, Y_grid, reg_par: float = 8.0,
                         return_weights=False):
    """generate_mvdr_map on an (re, im) covariance pair."""
    A, B = Cx_ri
    Yb = Y_grid.expand(A.shape[:-2] + Y_grid.shape)
    X = H.herm_solve((_loaded(A, reg_par), B),
                     (Yb, torch.zeros_like(Yb)))         # invCx_d @ Y
    # denom = yᵀ conj(X) per column
    with fp32_matmul():
        den = (torch.einsum("sg,...sg->...g", Y_grid, X[0]),
               -torch.einsum("sg,...sg->...g", Y_grid, X[1]))
    w = H.cdiv((X[0], X[1]), (den[0][..., None, :], den[1][..., None, :]))
    pmap = H.quadform_trans((A, B), w)
    return (pmap, w) if return_weights else pmap


def generate_music_map_ri(Cx_ri, Y_grid, n_sources: int,
                          log_scale: bool = False):
    """MUSIC pseudo-spectrum on an (re, im) covariance pair: the noise-
    subspace quadratic form from one real eigh of the 2n×2n embedding."""
    nsh = Cx_ri[0].shape[-1]
    n_sources = min(n_sources, nsh // 2)
    q = H.signal_subspace_quadform(Cx_ri, n_sources, Y_grid)
    p = 1.0 / (q + 2.23e-10)
    return torch.log(p) if log_scale else p


def generate_minnorm_map_ri(Cx_ri, Y_grid, n_sources: int,
                            log_scale: bool = False):
    """Minimum-norm pseudo-spectrum on an (re, im) pair.  The minimum-norm
    vector is expressed through the noise projector: u_n = P_n e₁ / (e₁ᵀ P_n
    e₁) (Hermitian normalisation; the reference's no-conj dot depends on
    LAPACK eigenvector phases and only changes the map's global scale)."""
    nsh = Cx_ri[0].shape[-1]
    n_sources = min(n_sources, nsh // 2)
    Pre, Pim = H.noise_projector(Cx_ri, n_sources)
    scale = Pre[..., 0, 0][..., None] + 2.23e-9
    un = (Pre[..., :, 0] / scale, Pim[..., :, 0] / scale)  # (..., nSH)
    # |conj(un)ᵀ y|² = (un_reᵀ y)² + (un_imᵀ y)²
    with fp32_matmul():
        re = torch.einsum("...s,sg->...g", un[0], Y_grid)
        im = torch.einsum("...s,sg->...g", un[1], Y_grid)
    p = 1.0 / (re ** 2 + im ** 2 + 2.23e-9)
    return torch.log(p) if log_scale else p


def generate_cropac_lcmv_map_ri(Cx_ri, Y_grid, reg_par: float = 8.0,
                                lambda_floor: float = 0.0):
    """Cross-pattern-coherence LCMV map on an (re, im) pair, batched over
    the grid (the reference's per-direction loop, saf_sh.c
    ``generateCroPaCLCMVmap``, becomes batched 2×2 solves)."""
    A, B = Cx_ri
    nsh, n_grid = Y_grid.shape
    mvdr_map, w_mvdr = generate_mvdr_map_ri(Cx_ri, Y_grid, reg_par,
                                            return_weights=True)
    with fp32_matmul():
        CxY = (A @ Y_grid, B @ Y_grid)                   # (..., nSH, g)
    d = torch.diagonal(A, dim1=-2, dim2=-1)             # real diag
    # steering pair per grid direction: columns [y_g, y_g*d], both REAL
    Ag = torch.stack([Y_grid.expand(A.shape[:-2] + Y_grid.shape),
                      d[..., :, None] * Y_grid], dim=-1)  # (..., nSH, g, 2)
    Af = Ag.reshape(Ag.shape[:-2] + (n_grid * 2,))
    X = H.herm_solve((_loaded(A, reg_par), B), (Af, torch.zeros_like(Af)))
    Xre = X[0].reshape(A.shape[:-1] + (n_grid, 2))
    Xim = X[1].reshape(A.shape[:-1] + (n_grid, 2))
    with fp32_matmul():
        # M2 = Aᴴ conj(invCxd_A): A real → M2 = Aᵀ conj(X)  (..., g, 2, 2)
        M2 = (torch.einsum("...sgi,...sgj->...gij", Ag, Xre),
              -torch.einsum("...sgi,...sgj->...gij", Ag, Xim))
    # w_lcmv = M2⁻¹ Xᵀ, the [1, 0] combination → first row of M2⁻¹ Xᵀ
    e1 = torch.zeros(M2[0].shape[:-2] + (2, 1), dtype=A.dtype,
                     device=A.device)
    e1[..., 0, 0].fill_(1.0)
    s = H.herm_solve(M2, (e1, torch.zeros_like(e1)))    # (..., g, 2, 1)
    s0, s1 = s[0][..., 0], s[1][..., 0]
    with fp32_matmul():
        # wo_j = Σ_i conj(s_i) X_{ji}  (the reference's w_lcmv.T @ [1,0])
        wo = (torch.einsum("...sgi,...gi->...sg", Xre, s0)
              + torch.einsum("...sgi,...gi->...sg", Xim, s1),
              torch.einsum("...sgi,...gi->...sg", Xim, s0)
              - torch.einsum("...sgi,...gi->...sg", Xre, s1))
    # cross-spectrum: woᵀ (Cx y_g)
    xs = H.ceinsum("...sg,...sg->...g", wo, CxY)
    S = torch.minimum(torch.sqrt(H.cabs2(xs)), mvdr_map)
    G = torch.clamp_min(torch.sqrt(S / (mvdr_map + 2.23e-10)), lambda_floor)
    w_sc = (w_mvdr[0] * G[..., None, :], w_mvdr[1] * G[..., None, :])
    # pwd with the scaled complex weights (reference NO_CONJ convention)
    return H.quadform_trans(Cx_ri, w_sc)


# ---------------------------------------------------------------------------
# Grid-search DoA estimators with von-Mises peak masking (saf_sh.h:691-769)
# ---------------------------------------------------------------------------

def find_peaks_vonmises(p_spec: np.ndarray, grid_dirs_deg: np.ndarray,
                        n_peaks: int, kappa: float = 50.0) -> np.ndarray:
    """Iterative peak finding, masking each found peak with an inverse
    von-Mises kernel (sphPWD_compute / sphMUSIC_compute)."""
    from spatial_audio_framework_tpu_torch.utils.geometry import unit_sph2cart

    u = np.asarray(unit_sph2cart(np.asarray(grid_dirs_deg, np.float64),
                                 degrees=True))
    scale = kappa / (2.0 * np.pi * np.exp(kappa) - np.exp(-kappa))
    p = np.array(p_spec, np.float64, copy=True)
    peaks = np.zeros(n_peaks, int)
    for k in range(n_peaks):
        peaks[k] = int(np.argmax(p))
        if k == n_peaks - 1:
            break
        vm = scale * np.exp(kappa * (u @ u[peaks[k]]))
        p = p * (1.0 / (1e-5 + vm))
    return peaks


def _grid_sh(Cx, grid_dirs_deg):
    dirs_rad = np.stack([np.radians(grid_dirs_deg[:, 0]),
                         np.pi / 2 - np.radians(grid_dirs_deg[:, 1])], -1)
    return _sh.get_sh_real(int(np.sqrt(Cx.shape[-1])) - 1, dirs_rad)


def sph_pwd(Cx, grid_dirs_deg, n_sources: int):
    """sphPWD: steered-response power + peak finding → (peak_idx, p_spec)."""
    Y = _grid_sh(Cx, grid_dirs_deg)
    p = np.asarray(generate_pwd_map(Cx, Y.astype(Cx.dtype)))
    return find_peaks_vonmises(p, grid_dirs_deg, n_sources), p


def sph_music(Cx, grid_dirs_deg, n_sources: int):
    """sphMUSIC: subspace pseudo-spectrum + peak finding."""
    Y = _grid_sh(Cx, grid_dirs_deg)
    p = np.asarray(generate_music_map(Cx, Y.astype(Cx.dtype), n_sources))
    return find_peaks_vonmises(p, grid_dirs_deg, n_sources), p


# ---------------------------------------------------------------------------
# sphESPRIT (saf_sh.h:798-823; Jo & Choi 2018)
# ---------------------------------------------------------------------------

def _nm_grid(order):
    n = np.concatenate([[nn] * (2 * nn + 1) for nn in range(order)])
    m = np.concatenate([np.arange(-nn, nn + 1) for nn in range(order)])
    return n.astype(float), m.astype(float)


def _w_nimu(order, mm, ni, mu):
    n, m = _nm_grid(order)
    if mm == 1:
        n2, m2 = n + ni, m + mu
    else:
        n2, m2 = n + ni, -m + mu
    return np.sqrt((n2 - m2 - 1.0) * (n2 - m2) / ((2 * n2 - 1.0) * (2 * n2 + 1.0)))


def _v_nimu(order, ni, mu):
    n, m = _nm_grid(order)
    n2, m2 = n + ni, m + mu
    return np.sqrt((n2 - m2) * (n2 + m2) / ((2 * n2 - 1.0) * (2 * n2 + 1.0)))


def _muni2q(order, ni, mu):
    n, m = _nm_grid(order)
    n, m = n.astype(int), m.astype(int)
    n2, m2 = n + ni, m + mu
    valid = np.abs(m2) <= n2
    q_nm = (n * n + n + m)[valid]
    q_nimu = (n2 * n2 + n2 + m2)[valid]
    return q_nm, q_nimu  # (dest rows in the (order)² set, source ACN rows)


def sph_esprit(Us: np.ndarray) -> np.ndarray:
    """Estimate K DoAs from the complex-SH signal subspace Us (nSH, K)
    (saf_sh.c ``sphESPRIT_estimateDirs``; Jo & Choi 2018).

    Convention: Us must be in the basis SAF feeds it, real-SH signals
    transformed by conj(real2complexSHMtx) (test__sh_module.c:632-647),
    which equals CONJUGATED physics-convention complex SH.  The recurrence
    uses rows up to (order-1)², K ≤ order² sources.  → (K, 2) [azi, elev]
    rad."""
    from scipy.linalg import eig as geig

    nsh, K = Us.shape
    order = int(np.sqrt(nsh)) - 1  # recurrence operates on rows 0..order²-1
    NN = order * order
    Us = np.asarray(Us, np.complex128)

    def sel(ni, mu):
        dst, src = _muni2q(order, ni, mu)
        out = np.zeros((NN, K), np.complex128)
        out[dst] = Us[src]
        return out

    W0 = _w_nimu(order, 1, 1, -1)
    W1 = _w_nimu(order, -1, 0, 0)
    W2 = _w_nimu(order, -1, 1, -1)
    W3 = _w_nimu(order, 1, 0, 0)
    V4 = _v_nimu(order, 0, 0)
    V5 = _v_nimu(order, 1, 0)

    # the first product uses WVnimu[0]ᵀ (CblasTrans in the reference); all
    # matrices are diagonal so the transpose is a no-op
    lam_xy_p = W0[:, None] * sel(1, -1) - W1[:, None] * sel(-1, -1)
    lam_xy_m = -(W2[:, None] * sel(1, 1)) + W3[:, None] * sel(-1, 1)
    lam_z = V4[:, None] * sel(-1, 0) + V5[:, None] * sel(1, 0)

    pinv_Us = np.linalg.pinv(Us[:NN])
    psi_xy_p = pinv_Us @ lam_xy_p
    psi_xy_m = pinv_Us @ lam_xy_m
    psi_z = pinv_Us @ lam_z

    # joint diagonalisation: generalized eig of (PsiXYp, PsiZ)
    _, V = geig(psi_xy_p, psi_z)
    Vinv = np.linalg.inv(V)
    phi_xy_p = np.diag(Vinv @ psi_xy_p @ V)
    phi_xy_m = np.diag(Vinv @ psi_xy_m @ V)
    phi_z = np.diag(Vinv @ psi_z @ V)

    phi_x = (phi_xy_p.real + phi_xy_m.real) / 2.0
    phi_y = ((phi_xy_p - phi_xy_m) / 2j).real
    azi = np.arctan2(phi_y, phi_x)
    elev = np.minimum(np.arctan2(phi_z.real, np.sqrt(phi_x ** 2 + phi_y ** 2)),
                      np.pi / 2)
    return np.stack([azi, elev], -1)
