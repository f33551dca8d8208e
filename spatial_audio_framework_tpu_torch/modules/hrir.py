"""HRIR/HRTF processing for the design stack (counterpart of
``spatial_audio_framework_tpu/modules/hrir.py``).  Host numpy/scipy.

The default dataset (``default_hrirs()``) is the JAX package's synthesised
rigid-sphere set of 836 dirs × 2 ears × 256 taps @48 kHz, read by path;
other sets load from SOFA files (``modules/sofa.py``); sets at another
sample rate than the configuration's are resampled as the reference does
(``utils/speex.py``).
"""
from __future__ import annotations

import functools

import numpy as np

from spatial_audio_framework_tpu_torch import data_path
from spatial_audio_framework_tpu_torch.modules import sofa as _sofa
from spatial_audio_framework_tpu_torch.ops import afstft as _afstft
from spatial_audio_framework_tpu_torch.utils.misc import saf_print_warning


@functools.lru_cache(maxsize=None)
def default_hrirs() -> tuple[np.ndarray, np.ndarray, int]:
    """Returns (hrirs (836, 2, 256) float32, dirs_deg (836, 2), fs)."""
    with np.load(data_path("default_hrirs.npz")) as z:
        return z["hrirs"].copy(), z["dirs_deg"].copy(), int(z["fs"])


def load_hrirs(sofa_filepath=None, use_default: bool = False):
    """Load an HRIR set from a SOFA file with the reference's graceful
    fallback (ambi_bin.c:209-218 and the equivalent block in every binaural
    example): if the file cannot be opened, is not a SOFA file, or does not
    contain exactly 2 receivers, a warning is printed and the DEFAULT set is
    used instead — design never fails on a bad path.

    → (hrirs (N, 2, len) f32, dirs_deg (N, 2), fs, used_default_flag)."""
    if not use_default and sofa_filepath is not None:
        try:
            c = _sofa.sofa_open(str(sofa_filepath), usecase=_sofa.USECASE_HRIR)
            return (np.asarray(c.data_ir, np.float32), c.source_dirs_deg(),
                    int(c.data_sampling_rate), False)
        except _sofa.SofaError:
            saf_print_warning(
                "Unable to load the specified SOFA file, or it contained "
                "something other than 2 channels. Using default HRIR data "
                "instead.")
    h, d, fs = default_hrirs()
    return h, d, fs, True


def resample_hrirs(hrirs: np.ndarray, fs_in: int, fs_out: int,
                   pad_to_next_pow2: bool = False) -> tuple[np.ndarray, int]:
    """``resampleHRIRs`` (saf_hrir.c:365-465): speex resampler at
    QUALITY_MAX with skip_zeros, zero-fed until the output buffer — of
    length ceilf(len·fs_out/fs_in), pow2-padded when requested — is full
    (so a pow2 "pad" region carries real filter tail, not zeros).
    Numerics via the reimplementation in utils/speex.py.
    hrirs: (..., len) → (resampled (..., out_len) float32, out_len)."""
    from spatial_audio_framework_tpu_torch.utils.speex import SpeexResampler

    if fs_in == fs_out:
        return hrirs.astype(np.float32), hrirs.shape[-1]
    # New HRIR length, in the C's f32 arithmetic (saf_hrir.c:393-395)
    factor = np.float32(np.float32(fs_out) / np.float32(fs_in))
    out_len = int(np.ceil(np.float32(hrirs.shape[-1]) * factor))
    out_ld = (int(2 ** np.ceil(np.log2(out_len))) if pad_to_next_pow2
              else out_len)
    rs = SpeexResampler(int(fs_in), int(fs_out), quality=10)
    out = rs.resample(np.asarray(hrirs, np.float32), out_ld)
    return out, out_ld


def estimate_itds(hrirs: np.ndarray, fs: float) -> np.ndarray:
    """Estimate inter-aural time differences per direction
    (saf_hrir.c:40-108 ``estimateITDs``): 750 Hz 2nd-order Butterworth-style
    LPF, then the lag of the L/R cross-correlation peak, clamped to
    ±sqrt(2)/2000 s.  hrirs: (nDirs, 2, len) → (nDirs,) seconds."""
    from scipy.signal import lfilter

    n_dirs, _, hrir_len = hrirs.shape
    fc, Q = 750.0, 0.7071
    K = np.tan(np.pi * fc / fs)
    KK = K * K
    D = KK * Q + K + Q
    b = np.array([KK * Q / D, 2.0 * KK * Q / D, KK * Q / D])
    a = np.array([1.0, 2.0 * Q * (KK - 1.0) / D, (KK * Q - K + Q) / D])
    lpf = lfilter(b, a, hrirs.astype(np.float64), axis=-1)
    itd_bounds = np.sqrt(2.0) / 2e3
    itds = np.zeros(n_dirs)
    for i in range(n_dirs):
        xc = np.correlate(lpf[i, 0], lpf[i, 1], "full")
        itds[i] = (hrir_len - 1.0 - np.argmax(xc)) / fs
    return np.clip(itds, -itd_bounds, itd_bounds).astype(np.float32)


def hrirs_to_hrtfs_afstft(hrirs: np.ndarray, hop: int = 128,
                          low_delay: bool = False,
                          hybrid: bool = True) -> np.ndarray:
    """HRIRs → afSTFT filterbank coefficients (saf_hrir.c ``HRIRs2HRTFs_afSTFT``).
    hrirs: (nDirs, 2, len) → (nBands, 2, nDirs) complex64."""
    return _afstft.fir_to_filterbank_coeffs(hrirs, hop, low_delay, hybrid)


def hrirs_to_hrtfs(hrirs: np.ndarray, fft_size: int) -> np.ndarray:
    """HRIRs → DFT-domain HRTFs (saf_hrir.c ``HRIRs2HRTFs``).
    → (fft_size//2+1, 2, nDirs) complex64."""
    n_dirs, n_ears, hrir_len = hrirs.shape
    buf = np.zeros((n_dirs, n_ears, fft_size), np.float32)
    buf[..., : min(fft_size, hrir_len)] = hrirs[..., : min(fft_size, hrir_len)]
    H = np.fft.rfft(buf, axis=-1)
    return H.transpose(2, 1, 0).astype(np.complex64)


def diffuse_field_equalise_hrtfs(hrtfs: np.ndarray, itds_s=None,
                                 centre_freqs=None, weights=None,
                                 apply_eq: bool = True,
                                 apply_phase: bool = False) -> np.ndarray:
    """Diffuse-field EQ and/or phase simplification
    (saf_hrir.c:175-244 ``diffuseFieldEqualiseHRTFs``).

    hrtfs: (nBands, 2, nDirs) complex; weights: (nDirs,) summing to 4π.
    Phase simplification replaces measured phase with ±IPD/2 from the ITDs.
    """
    H = np.array(hrtfs, np.complex128, copy=True)
    n_bands, _, n_dirs = H.shape
    if apply_eq:
        w = (np.asarray(weights, np.float64) if weights is not None
             else np.full(n_dirs, 4.0 * np.pi / n_dirs))
        diff = np.sqrt(np.maximum(
            np.einsum("bed,d->be", np.abs(H) ** 2, w / (4.0 * np.pi)), 1e-5))
        H = H / (diff[..., None] + 2.23e-8)
    if apply_phase:
        ipd = _ipd_f32(itds_s, centre_freqs)   # C f32 wrap (saf_hrir.c:228)
        H = np.abs(H) * np.exp(1j * np.stack([ipd, -ipd], axis=1))
    return H.astype(np.complex64)


def _ipd_f32(itds_s, freq_vector) -> np.ndarray:
    """ipd = (matlab_fmodf(2π·f·itd + π, 2π) − π)/2 in the C's exact f32
    arithmetic and op order (saf_hrir.c:224-231 and :302-303): near a wrap
    boundary the last f32 ULP decides the sign.  → (nBands, nDirs) float64."""
    f32 = np.float32
    PI, TWO_PI = f32(np.pi), f32(2.0) * f32(np.pi)
    fx = (np.asarray(freq_vector, np.float32)[:, None]
          * np.asarray(itds_s, np.float32)[None, :])    # sgemm, f32
    x = TWO_PI * fx + PI
    m = np.fmod(x, TWO_PI)
    m = np.where(m >= 0.0, m, m + TWO_PI)               # matlab_fmodf
    return ((m - PI) / f32(2.0)).astype(np.float64)


def interp_hrtfs(hrtfs: np.ndarray, interp_table: np.ndarray, itds=None,
                 freq_vector=None) -> np.ndarray:
    """Interpolate HRTFs at new directions from amplitude-normalised VBAP
    weights (saf_hrir.c:246-330 ``interpHRTFs``).

    hrtfs: (nBands, 2, nDirs); interp_table: (nInterp, nDirs).
    With itds+freq_vector: magnitudes and ITDs interpolate separately and the
    phase is re-synthesised as ±IPD/2; otherwise complex interpolation.
    → (nBands, 2, nInterp) complex64.
    """
    H = np.asarray(hrtfs)
    T = np.asarray(interp_table, np.float64)
    if itds is None or freq_vector is None:
        return np.einsum("bed,nd->ben", H, T).astype(np.complex64)
    mags_i = np.einsum("bed,nd->ben", np.abs(H), T)
    itd_i32 = (np.asarray(interp_table, np.float32)
               @ np.asarray(itds, np.float32))  # sgemm, f32 (nInterp,)
    ipd = _ipd_f32(itd_i32, freq_vector)  # the C's f32 wrap: see _ipd_f32
    phase = np.stack([ipd, -ipd], axis=1)  # (nBands, 2, nInterp)
    return (mags_i * np.exp(1j * phase)).astype(np.complex64)


def binaural_diffuse_coherence(hrtfs: np.ndarray, itds: np.ndarray,
                               freq_vector: np.ndarray) -> np.ndarray:
    """Binaural diffuse-field coherence per band
    (saf_hrir.c:333-374 ``binauralDiffuseCoherence``).  → (nBands,)."""
    H = np.asarray(hrtfs)
    f = np.asarray(freq_vector, np.float64)
    ipd = np.mod(2.0 * np.pi * f[:, None] * np.asarray(itds)[None, :] + np.pi,
                 2.0 * np.pi) - np.pi
    coh = (np.exp(1j * ipd) * np.abs(H[:, 0, :]) * np.abs(H[:, 1, :])).mean(-1)
    out = np.maximum(coh.real, 0.0)
    out[0] = 1.0
    return out.astype(np.float32)
