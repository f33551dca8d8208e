"""Higher-order Ambisonics: loudspeaker and binaural decoders (counterpart
of ``spatial_audio_framework_tpu/modules/hoa.py``).  Host numpy: decoders
are designed once per configuration, as the reference's initCodec does.

Ported decoders (saf_hoa.h:413,447; internals saf_hoa_internal.c):

* loudspeaker: SAD, MMD, EPAD, AllRAD (AllRAD through ``modules/vbap.py``)
* binaural:    LS, LS-diffEQ, SPR, TA, MagLS, and the diffuse-field
  covariance matching applied on top of any of them
"""
from __future__ import annotations

import numpy as np
import torch

from spatial_audio_framework_tpu_torch.modules import sh as _sh
from spatial_audio_framework_tpu_torch.utils import presets as _presets

# Channel-order conventions (saf_hoa.h HOA_CH_ORDER)
HOA_CH_ORDER_ACN = 0
HOA_CH_ORDER_FUMA = 1
# Normalisation conventions (saf_hoa.h HOA_NORM)
HOA_NORM_N3D = 0
HOA_NORM_SN3D = 1
HOA_NORM_FUMA = 2
# Loudspeaker decoder methods (saf_hoa.h LOUDSPEAKER_AMBI_DECODER_METHODS)
LOUDSPEAKER_DECODER_DEFAULT = "default"
LOUDSPEAKER_DECODER_SAD = "sad"
LOUDSPEAKER_DECODER_MMD = "mmd"
LOUDSPEAKER_DECODER_EPAD = "epad"
LOUDSPEAKER_DECODER_ALLRAD = "allrad"
# Binaural decoder methods (saf_hoa.h BINAURAL_AMBI_DECODER_METHODS)
BINAURAL_DECODER_DEFAULT = "default"
BINAURAL_DECODER_LS = "ls"
BINAURAL_DECODER_LSDIFFEQ = "lsdiffeq"
BINAURAL_DECODER_SPR = "spr"
BINAURAL_DECODER_TA = "ta"
BINAURAL_DECODER_MAGLS = "magls"

_4PI = 4.0 * np.pi


def convert_hoa_channel_convention(sig, order: int, in_conv: int,
                                   out_conv: int):
    """sig: (..., nSH, T), numpy or a tensor.  FuMa↔ACN first-order swaps;
    FuMa limited to order 1, higher channels zeroed (saf_hoa.c:40-70)."""
    if order == 0 or in_conv == out_conv:
        return sig
    if in_conv == HOA_CH_ORDER_FUMA and out_conv == HOA_CH_ORDER_ACN:
        perm = [0, 2, 3, 1]  # WXYZ → WYZX
    elif in_conv == HOA_CH_ORDER_ACN and out_conv == HOA_CH_ORDER_FUMA:
        perm = [0, 3, 1, 2]
    else:
        raise ValueError((in_conv, out_conv))
    nsh = sig.shape[-2]
    first4 = sig[..., perm, :]
    if nsh <= 4:
        return first4[..., :nsh, :]
    if isinstance(sig, torch.Tensor):
        return torch.cat([first4, torch.zeros_like(sig[..., 4:, :])], dim=-2)
    return np.concatenate([first4, np.zeros_like(sig[..., 4:, :])], axis=-2)


def norm_gains(order: int, in_norm: int, out_norm: int) -> np.ndarray:
    """Per-channel gains applying the normalisation conversion
    (saf_hoa.c:72-116 ``convertHOANormConvention``).  Shape (nSH,)."""
    nsh = _sh.order2nsh(order)
    g = np.ones(nsh, np.float64)
    ns = np.concatenate([[n] * (2 * n + 1) for n in range(order + 1)])
    if in_norm == out_norm:
        return g.astype(np.float32)
    if in_norm == HOA_NORM_N3D and out_norm == HOA_NORM_SN3D:
        g = 1.0 / np.sqrt(2.0 * ns + 1.0)
    elif in_norm == HOA_NORM_SN3D and out_norm == HOA_NORM_N3D:
        g = np.sqrt(2.0 * ns + 1.0)
    elif in_norm == HOA_NORM_N3D and out_norm == HOA_NORM_FUMA:
        g[0] = 1.0 / np.sqrt(2.0)
        g[1:4] = 1.0 / np.sqrt(3.0)
    elif in_norm == HOA_NORM_FUMA and out_norm == HOA_NORM_N3D:
        g[0] = np.sqrt(2.0)
        g[1:4] = np.sqrt(3.0)
    elif in_norm == HOA_NORM_SN3D and out_norm == HOA_NORM_FUMA:
        g[0] = 1.0 / np.sqrt(2.0)
    elif in_norm == HOA_NORM_FUMA and out_norm == HOA_NORM_SN3D:
        g[0] = np.sqrt(2.0)
    else:
        raise ValueError((in_norm, out_norm))
    return g.astype(np.float32)


def convert_hoa_norm_convention(sig, order: int, in_norm: int,
                                out_norm: int):
    """sig: (..., nSH, T), numpy or a tensor, scaled per channel."""
    g = norm_gains(order, in_norm, out_norm)
    if isinstance(sig, torch.Tensor):
        g = torch.as_tensor(g, dtype=sig.dtype, device=sig.device)
    return sig * g[:, None]


def get_max_re_weights(order: int) -> np.ndarray:
    """Per-channel max-rE weights a_n, shape (nSH,)
    (saf_hoa.c:363 ``getMaxREweights``): P_n(cos(137.9°/(order+1.51)))."""
    x = np.cos(np.float32(137.9) * (np.pi / 180.0) / (order + np.float32(1.51)))
    out = []
    for n in range(order + 1):
        pn = float(_sh.unnorm_legendre(n, np.array([float(x)]))[0, 0])
        out += [pn] * (2 * n + 1)
    return np.asarray(out, np.float32)


def _sph_modal_coeffs_rigid(order: int, kr) -> np.ndarray:
    """Rigid-sphere modal coefficients b_n(kr), (nBands, order+1)
    (saf_sh.c ``sphModalCoeffs``, ARRAY_SPHERICAL rigid), with the C's DC
    branch: b = [4π, 0, ...] where kr <= 1e-20."""
    from scipy import special as sp

    kr = np.asarray(kr, np.float64)
    ns = np.arange(order + 1)
    dc = kr <= 1e-20
    z = np.where(dc, 1.0, kr)[:, None]   # any finite argument: DC rows reset
    with np.errstate(invalid="ignore", divide="ignore"):
        j = sp.spherical_jn(ns, z)
        jp = sp.spherical_jn(ns, z, derivative=True)
        y = sp.spherical_yn(ns, z)
        yp = sp.spherical_yn(ns, z, derivative=True)
        h2 = j - 1j * y
        h2p = jp - 1j * yp
        b = _4PI * (1j ** ns) * (j - (jp / h2p) * h2)
    b = np.where(kr[:, None] <= 1e-20, 0.0, b)
    b[:, 0] = np.where(kr <= 1e-20, _4PI, b[:, 0])
    return b


def truncation_eq(w_n: np.ndarray, order_truncated: int, order_target: int,
                  kr: np.ndarray, soft_threshold_db: float = 12.0) -> np.ndarray:
    """Order-truncation EQ gains per band (saf_hoa.c:388 ``truncationEQ``;
    Hold et al. 2019).  w_n: per-ORDER weights (order_truncated+1,) of the
    truncated decode (e.g. maxRE); kr: (nBands,).  Returns (nBands,) gain."""
    kr = np.asarray(kr, np.float64)
    b_target = _sph_modal_coeffs_rigid(order_target, kr)  # (nBands, Nt+1)
    b_trunc = _sph_modal_coeffs_rigid(order_truncated, kr)
    ns_t = 2.0 * np.arange(order_target + 1) + 1.0
    ns_r = 2.0 * np.arange(order_truncated + 1) + 1.0
    w = np.asarray(w_n, np.float64)[: order_truncated + 1]
    p_target = np.sqrt(np.sum(ns_t * np.abs(b_target) ** 2, -1)) / (4.0 * np.pi)
    p_trunc = np.sqrt(np.sum(w * ns_r * np.abs(b_trunc) ** 2, -1)) / (4.0 * np.pi)
    gain = p_target / (p_trunc + 2.23e-13)
    # soft clip to limit maximum gain (saf_hoa.c:429-436)
    clip = 10.0 ** (soft_threshold_db / 20.0)
    g = gain / clip
    g = np.where(g > 1.0, 1.0 + np.tanh(g - 1.0), g)
    return (g * clip).astype(np.float32)


# --------------------------------------------------------------------------
# Loudspeaker decoders
# --------------------------------------------------------------------------

def _get_epad(order: int, ls_dirs_deg: np.ndarray) -> np.ndarray:
    """EPAD (saf_hoa_internal.c:40 ``getEPAD``)."""
    n_ls = ls_dirs_deg.shape[0]
    nsh = _sh.order2nsh(order)
    Y = _sh.get_rsh(order, ls_dirs_deg) / np.sqrt(_4PI)  # == getSHreal
    U, _, Vt = np.linalg.svd(Y, full_matrices=True)
    V = Vt.T
    if nsh > n_ls:
        dec = V @ U[:, :n_ls].T
    else:
        dec = V[:, :nsh] @ U.T
    return (dec * np.sqrt(_4PI / n_ls)).astype(np.float32)


def _get_allrad(order: int, ls_dirs_deg: np.ndarray,
                rand_stream=None) -> np.ndarray:
    """AllRAD (saf_hoa_internal.c:100 ``getAllRAD``): VBAP gains of a dense
    t-design (degree 100, 5100 points) times its SH matrix / nDirs."""
    from spatial_audio_framework_tpu_torch.modules.vbap import \
        generate_vbap_gain_table_3d_srcs

    t_dirs = _presets.tdesign(100)
    G = generate_vbap_gain_table_3d_srcs(t_dirs, ls_dirs_deg,
                                         rand_stream=rand_stream)  # (nTD, nLS)
    Y_td = _sh.get_rsh(order, t_dirs) / np.sqrt(_4PI)   # (nSH, nTD)
    dec = (G.T @ Y_td.T) * (_4PI / t_dirs.shape[0])
    return dec.astype(np.float32)


def get_loudspeaker_decoder_mtx(ls_dirs_deg: np.ndarray, method: str, order: int,
                                enable_max_re_weighting: bool = False,
                                rand_stream=None) -> np.ndarray:
    """Ambisonic loudspeaker decoder, (nLS, nSH)
    (saf_hoa.c ``getLoudspeakerDecoderMtx``).  ``rand_stream``: the glibc
    ``rand()`` stream AllRAD's triangulation draws its jitter from
    (``utils/convhull3d.glibc_rand``; a fresh one if None)."""
    ls_dirs_deg = np.asarray(ls_dirs_deg, np.float64)
    n_ls = ls_dirs_deg.shape[0]
    method = method.lower()
    Y_ls = _sh.get_rsh(order, ls_dirs_deg) / np.sqrt(_4PI)
    if method in (LOUDSPEAKER_DECODER_DEFAULT, LOUDSPEAKER_DECODER_SAD):
        dec = _4PI * Y_ls.T / n_ls
    elif method == LOUDSPEAKER_DECODER_MMD:
        dec = np.linalg.pinv(Y_ls)
    elif method == LOUDSPEAKER_DECODER_EPAD:
        dec = _get_epad(order, ls_dirs_deg)
    elif method == LOUDSPEAKER_DECODER_ALLRAD:
        dec = _get_allrad(order, ls_dirs_deg, rand_stream=rand_stream)
    else:
        raise ValueError(method)
    if enable_max_re_weighting:
        dec = dec * get_max_re_weights(order)[None, :]
    return dec.astype(np.float32)


# --------------------------------------------------------------------------
# Binaural decoders — hrtfs: (nBands, 2, nDirs) complex
# --------------------------------------------------------------------------

def _prep(hrtf_dirs_deg, order, weights):
    n_dirs = hrtf_dirs_deg.shape[0]
    Y = _sh.get_rsh(order, np.asarray(hrtf_dirs_deg, np.float64))  # (nSH, nDirs)
    w = (np.asarray(weights, np.float64) if weights is not None
         else np.full(n_dirs, 1.0 / n_dirs))
    YW = Y * w[None, :]
    A = YW @ Y.T  # (nSH, nSH)
    return Y, w, YW, A


def _ls_solve(A, YW, H):
    """B = A⁻¹ (YW Hᴴ) per band; returns decMtx (nBands, 2, nSH) = Bᴴ."""
    rhs = np.einsum("sd,bed->bse", YW, H.conj())
    B = np.linalg.solve(A[None], rhs)  # (nBands, nSH, 2)
    return np.conj(np.swapaxes(B, -1, -2))


def get_bin_decoder_ls(hrtfs, hrtf_dirs_deg, order, weights=None):
    """Least-squares binaural decoder (saf_hoa_internal.c:162)."""
    _, _, YW, A = _prep(hrtf_dirs_deg, order, weights)
    return _ls_solve(A, YW, np.asarray(hrtfs)).astype(np.complex64)


def get_bin_decoder_lsdiffeq(hrtfs, hrtf_dirs_deg, order, weights=None):
    """LS + diffuse-field EQ (saf_hoa_internal.c:230)."""
    Y, w, YW, A = _prep(hrtf_dirs_deg, order, weights)
    H = np.asarray(hrtfs)
    dec = _ls_solve(A, YW, H)  # (nBands, 2, nSH)
    H_ls = dec @ Y  # (nBands, 2, nDirs)
    c_ref = np.einsum("bed,d,bfd->bef", H, w, H.conj())
    c_ls = np.einsum("bed,d,bfd->bef", H_ls, w, H_ls.conj())
    Gh = 0.5 * (np.sqrt(c_ref[:, 0, 0].real / (c_ls[:, 0, 0].real + 2.23e-7))
                + np.sqrt(c_ref[:, 1, 1].real / (c_ls[:, 1, 1].real + 2.23e-7)))
    return (dec * Gh[:, None, None]).astype(np.complex64)


def check_cond_number_sht_real(order, dirs_rad, weights=None):
    """Condition number of the weighted SH Gram matrix per order 0..order
    (saf_sh.c ``checkCondNumberSHTReal``): the sh module's."""
    return _sh.check_cond_number_sht_real(order, dirs_rad, weights)


def get_bin_decoder_spr(hrtfs, hrtf_dirs_deg, order, weights=None):
    """Subspace-pattern-recovery decoder (saf_hoa_internal.c:332):
    interpolate HRTFs onto a 2N t-design via a high-order SHT, then SAD."""
    H = np.asarray(hrtfs)
    n_dirs = hrtf_dirs_deg.shape[0]
    nsh = _sh.order2nsh(order)
    w = (np.asarray(weights, np.float64) / _4PI if weights is not None
         else np.full(n_dirs, 1.0 / n_dirs))
    nh_max = min(int(np.sqrt(n_dirs) - 1), 20)
    dirs_rad = np.stack([np.radians(hrtf_dirs_deg[:, 0]),
                         np.pi / 2 - np.radians(hrtf_dirs_deg[:, 1])], -1)
    cond = check_cond_number_sht_real(nh_max, dirs_rad, weights)
    Nh = 0
    for i in range(nh_max + 1):
        if cond[i] < 100.0:
            Nh = i
    if Nh < order:
        raise ValueError("input order exceeds the modal order of the spatial grid")
    Y_nh = _sh.get_rsh(Nh, np.asarray(hrtf_dirs_deg, np.float64))  # (nSH_nh, nDirs)
    t_dirs = _presets.tdesign(2 * order)
    K = t_dirs.shape[0]
    Y_td = _sh.get_rsh(Nh, t_dirs)  # (nSH_nh, K)
    M_interp = (Y_nh.T @ Y_td) * w[:, None]  # (nDirs, K)
    H_td = np.einsum("bed,dk->bek", H, M_interp)
    B = np.einsum("sk,bek->bse", Y_td[:nsh].astype(np.complex128), H_td.conj())
    return (np.conj(np.swapaxes(B, -1, -2)) / K).astype(np.complex64)


def _cutoff_band(freq_vector, cutoff=1500.0):
    return int(np.argmin(np.abs(np.asarray(freq_vector) - cutoff)))


def get_bin_decoder_ta(hrtfs, hrtf_dirs_deg, order, freq_vector, itds=None,
                       weights=None):
    """Time-alignment decoder (saf_hoa_internal.c:432).  As in the
    reference, the phase-modification term above the cutoff band evaluates
    to exp(0), so above cutoff the HRTFs are frozen at the cutoff band."""
    _, _, YW, A = _prep(hrtf_dirs_deg, order, weights)
    H = np.array(hrtfs, copy=True)
    bc = _cutoff_band(freq_vector)
    H[bc:] = H[bc]
    return _ls_solve(A, YW, H).astype(np.complex64)


def get_bin_decoder_magls(hrtfs, hrtf_dirs_deg, order, freq_vector, weights=None):
    """Magnitude-least-squares decoder (saf_hoa_internal.c:525; Schörkhuber
    et al. 2018).  Below 1.5 kHz: complex LS; above: per-band sequential
    phase-propagation solve (a host loop, run once per design)."""
    Y, _, YW, A = _prep(hrtf_dirs_deg, order, weights)
    H = np.asarray(hrtfs)
    n_bands = H.shape[0]
    bc = _cutoff_band(freq_vector)
    dec = np.zeros((n_bands, 2, _sh.order2nsh(order)), np.complex128)
    lu_A = np.linalg.inv(A)  # small (nSH×nSH), reused every band
    for band in range(n_bands):
        if band <= bc:
            rhs = YW @ H[band].conj().T  # (nSH, 2)
        else:
            H_mod = dec[band - 1] @ Y  # (2, nDirs)
            H_mod = np.abs(H[band]) * np.exp(1j * np.angle(H_mod))
            rhs = YW @ H_mod.conj().T
        B = lu_A @ rhs
        dec[band] = B.conj().T
    return dec.astype(np.complex64)


def get_binaural_ambi_decoder_mtx(hrtfs, hrtf_dirs_deg, method: str, order: int,
                                  freq_vector=None, itds=None, weights=None,
                                  enable_diff_cov_matching: bool = False,
                                  enable_max_re_weighting: bool = False):
    """Dispatch (saf_hoa.c:394 ``getBinauralAmbiDecoderMtx``).
    hrtfs: (nBands, 2, nDirs) → decMtx (nBands, 2, nSH) complex64."""
    method = method.lower()
    if method in (BINAURAL_DECODER_DEFAULT, BINAURAL_DECODER_LS):
        dec = get_bin_decoder_ls(hrtfs, hrtf_dirs_deg, order, weights)
    elif method == BINAURAL_DECODER_LSDIFFEQ:
        dec = get_bin_decoder_lsdiffeq(hrtfs, hrtf_dirs_deg, order, weights)
    elif method == BINAURAL_DECODER_SPR:
        dec = get_bin_decoder_spr(hrtfs, hrtf_dirs_deg, order, weights)
    elif method == BINAURAL_DECODER_TA:
        dec = get_bin_decoder_ta(hrtfs, hrtf_dirs_deg, order, freq_vector, itds, weights)
    elif method == BINAURAL_DECODER_MAGLS:
        dec = get_bin_decoder_magls(hrtfs, hrtf_dirs_deg, order, freq_vector, weights)
    else:
        raise ValueError(method)
    if enable_diff_cov_matching:
        dec = apply_diff_cov_matching(hrtfs, hrtf_dirs_deg, order, dec, weights)
    if enable_max_re_weighting:
        dec = dec * get_max_re_weights(order)[None, None, :]
    return dec.astype(np.complex64)


def apply_diff_cov_matching(hrtfs, hrtf_dirs_deg, order, dec_mtx, weights=None):
    """Diffuse-field covariance matching (saf_hoa.c:520
    ``applyDiffCovMatching``): per band (excl. Nyquist) correct the 2×2
    diffuse covariance of the decode to match the HRTF set's."""
    Y, w, _, _ = _prep(hrtf_dirs_deg, order, weights)
    H = np.asarray(hrtfs)
    dec = np.array(dec_mtx, np.complex128, copy=True)
    n_bands = H.shape[0]
    for band in range(n_bands - 1):  # skip Nyquist
        c_ref = (H[band] * w[None, :]) @ H[band].conj().T
        np.fill_diagonal(c_ref, c_ref.diagonal().real)
        X = np.linalg.cholesky(c_ref).conj().T  # upper: Xᴴ X = C_ref
        H_ambi = dec[band] @ Y
        c_ambi = (H_ambi * w[None, :]) @ H_ambi.conj().T
        np.fill_diagonal(c_ambi, c_ambi.diagonal().real)
        X_ambi = np.linalg.cholesky(c_ambi).conj().T
        U, _, Vt = np.linalg.svd(X_ambi.conj().T @ X)
        V = Vt.conj().T
        M = np.linalg.solve(X_ambi, V @ U.conj().T @ X)
        dec[band] = M.conj().T @ dec[band]
    return dec.astype(np.complex64)
