"""Filter design and application (counterpart of
``spatial_audio_framework_tpu/utils/filters.py``; ``saf_utility_filters``).

Design functions are host-side NumPy/SciPy in float64; the run-time paths
use scipy (host) or the log-depth linear recurrence of ``ops/iir``
(:meth:`FafIIRFilterbank.apply_device`).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import signal as sps

from spatial_audio_framework_tpu_torch import default_device
from spatial_audio_framework_tpu_torch.ops.iir import iir_filter

# WINDOWING_FUNCTION_TYPES (saf_utility_filters.h:90-100)
WINDOWING_FUNCTION_RECTANGULAR = "rectangular"
WINDOWING_FUNCTION_HAMMING = "hamming"
WINDOWING_FUNCTION_HANN = "hann"
WINDOWING_FUNCTION_BARTLETT = "bartlett"
WINDOWING_FUNCTION_BLACKMAN = "blackman"
WINDOWING_FUNCTION_NUTTALL = "nuttall"
WINDOWING_FUNCTION_BLACKMAN_NUTTALL = "blackman_nuttall"
WINDOWING_FUNCTION_BLACKMAN_HARRIS = "blackman_harris"

# BIQUAD_FILTER_TYPES (saf_utility_filters.h:51-63)
BIQUAD_FILTER_LPF = "lpf"
BIQUAD_FILTER_LPF_EQCB = "lpf_eqcb"
BIQUAD_FILTER_HPF = "hpf"
BIQUAD_FILTER_HPF_EQCB = "hpf_eqcb"
BIQUAD_FILTER_PEAK = "peak"
BIQUAD_FILTER_PEAK_EQCB = "peak_eqcb"
BIQUAD_FILTER_LOW_SHELF = "low_shelf"
BIQUAD_FILTER_LOW_SHELF_EQCB = "low_shelf_eqcb"
BIQUAD_FILTER_HI_SHELF = "hi_shelf"
BIQUAD_FILTER_HI_SHELF_EQCB = "hi_shelf_eqcb"


def get_windowing_function(win_type: str, winlength: int) -> np.ndarray:
    """Window weights (saf_utility_filters.c ``getWindowingFunction``).
    Symmetric if winlength is odd, periodic-style if even — matching the
    reference's N convention (saf_utility_filters.c:40-108).

    Note: the reference's Blackman-Nuttall and Blackman-Harris sum their
    third cosine term at 4π instead of 6π (saf_utility_filters.c:89-106) —
    reproduced for parity.
    """
    n = np.arange(winlength, dtype=np.float64)
    N = winlength - 1 if winlength % 2 else winlength
    w2 = np.cos(2.0 * np.pi * n / N)
    w4 = np.cos(4.0 * np.pi * n / N)
    if win_type == WINDOWING_FUNCTION_RECTANGULAR:
        w = np.ones(winlength)
    elif win_type == WINDOWING_FUNCTION_HAMMING:
        w = 0.54 - 0.46 * w2
    elif win_type == WINDOWING_FUNCTION_HANN:
        w = 0.5 - 0.5 * w2
    elif win_type == WINDOWING_FUNCTION_BARTLETT:
        w = 1.0 - 2.0 * np.abs(n - N / 2.0) / N
    elif win_type == WINDOWING_FUNCTION_BLACKMAN:
        w = 0.42659 - 0.49656 * w2 + 0.076849 * w4
    elif win_type == WINDOWING_FUNCTION_NUTTALL:
        w6 = np.cos(6.0 * np.pi * n / N)
        w = 0.355768 - 0.487396 * w2 + 0.144232 * w4 - 0.012604 * w6
    elif win_type == WINDOWING_FUNCTION_BLACKMAN_NUTTALL:
        w = 0.3635819 - 0.4891775 * w2 + 0.1365995 * w4 + 0.0106411 * w4
    elif win_type == WINDOWING_FUNCTION_BLACKMAN_HARRIS:
        w = 0.35875 - 0.48829 * w2 + 0.14128 * w4 + 0.01168 * w4
    else:
        raise ValueError(win_type)
    return w.astype(np.float32)


def get_octave_band_cutoff_freqs(centre_freqs: np.ndarray) -> np.ndarray:
    """Octave band cut-offs from centres (saf_utility_filters.h:156)."""
    c = np.asarray(centre_freqs, np.float64)
    return np.sqrt(c[:-1] * c[1:]).astype(np.float32)


def biquad_coeffs(filter_type: str, fc: float, fs: float, Q: float,
                  gain_db: float = 0.0):
    """Biquad coefficients (saf_utility_filters.c ``biQuadCoeffs``), DAFx and
    EQ-cookbook variants.  Returns (b (3,), a (3,)) with a[0]=1."""
    b = np.zeros(3)
    a = np.zeros(3)
    a[0] = 1.0
    if filter_type == BIQUAD_FILTER_LPF:
        K = np.tan(np.pi * fc / fs)
        KK = K * K
        D = KK * Q + K + Q
        b[:] = [KK * Q / D, 2 * KK * Q / D, KK * Q / D]
        a[1:] = [2 * Q * (KK - 1) / D, (KK * Q - K + Q) / D]
    elif filter_type == BIQUAD_FILTER_HPF:
        K = np.tan(np.pi * fc / fs)
        KK = K * K
        D = KK * Q + K + Q
        b[:] = [Q / D, -2 * Q / D, Q / D]
        a[1:] = [2 * Q * (KK - 1) / D, (KK * Q - K + Q) / D]
    elif filter_type in (BIQUAD_FILTER_LPF_EQCB, BIQUAD_FILTER_HPF_EQCB):
        w0 = 2 * np.pi * fc / fs
        alpha = np.sin(w0) / (2 * Q)
        a0 = 1 + alpha
        if filter_type == BIQUAD_FILTER_LPF_EQCB:
            b[:] = [(1 - np.cos(w0)) / 2, 1 - np.cos(w0), (1 - np.cos(w0)) / 2]
        else:
            b[:] = [(1 + np.cos(w0)) / 2, -(1 + np.cos(w0)), (1 + np.cos(w0)) / 2]
        a[1:] = [-2 * np.cos(w0), 1 - alpha]
        b /= a0
        a[1:] /= a0
    elif filter_type == BIQUAD_FILTER_LOW_SHELF or filter_type == BIQUAD_FILTER_HI_SHELF:
        # DAFx (2nd ed) p64 shelving designs
        K = np.tan(np.pi * fc / fs)
        V0 = 10.0 ** (gain_db / 20.0)
        if V0 < 1.0:
            V0 = 1.0 / V0
        KK = K * K
        rt2 = np.sqrt(2.0)
        if filter_type == BIQUAD_FILTER_LOW_SHELF:
            if gain_db > 0:
                D = 1 + rt2 * K + KK
                b[:] = [(1 + np.sqrt(2 * V0) * K + V0 * KK) / D,
                        2 * (V0 * KK - 1) / D,
                        (1 - np.sqrt(2 * V0) * K + V0 * KK) / D]
                a[1:] = [2 * (KK - 1) / D, (1 - rt2 * K + KK) / D]
            else:
                D = V0 + np.sqrt(2 * V0) * K + KK
                b[:] = [V0 * (1 + rt2 * K + KK) / D, 2 * V0 * (KK - 1) / D,
                        V0 * (1 - rt2 * K + KK) / D]
                a[1:] = [2 * (KK - V0) / D, (V0 - np.sqrt(2 * V0) * K + KK) / D]
        else:  # HI_SHELF (DAFx p64)
            if gain_db > 0:
                D = 1 + rt2 * K + KK
                b[:] = [(V0 + np.sqrt(2 * V0) * K + KK) / D,
                        2 * (KK - V0) / D,
                        (V0 - np.sqrt(2 * V0) * K + KK) / D]
                a[1:] = [2 * (KK - 1) / D, (1 - rt2 * K + KK) / D]
            else:
                D = 1 + np.sqrt(2.0 / V0) * K + KK / V0
                b[:] = [(1 + rt2 * K + KK) / D, 2 * (KK - 1) / D,
                        (1 - rt2 * K + KK) / D]
                a[1:] = [2 * (KK / V0 - 1) / D,
                         (1 - np.sqrt(2 / V0) * K + KK / V0) / D]
    elif filter_type in (BIQUAD_FILTER_LOW_SHELF_EQCB, BIQUAD_FILTER_HI_SHELF_EQCB):
        A = 10.0 ** (gain_db / 40.0)
        w0 = 2 * np.pi * fc / fs
        alpha = np.sin(w0) / (2 * Q)
        cw = np.cos(w0)
        sA = 2 * np.sqrt(A) * alpha
        if filter_type == BIQUAD_FILTER_LOW_SHELF_EQCB:
            b[:] = [A * ((A + 1) - (A - 1) * cw + sA),
                    2 * A * ((A - 1) - (A + 1) * cw),
                    A * ((A + 1) - (A - 1) * cw - sA)]
            a0 = (A + 1) + (A - 1) * cw + sA
            a[1:] = [-2 * ((A - 1) + (A + 1) * cw), (A + 1) + (A - 1) * cw - sA]
        else:
            b[:] = [A * ((A + 1) + (A - 1) * cw + sA),
                    -2 * A * ((A - 1) + (A + 1) * cw),
                    A * ((A + 1) + (A - 1) * cw - sA)]
            a0 = (A + 1) - (A - 1) * cw + sA
            a[1:] = [2 * ((A - 1) - (A + 1) * cw), (A + 1) - (A - 1) * cw - sA]
        b /= a0
        a[1:] /= a0
    elif filter_type == BIQUAD_FILTER_PEAK:
        # DAFx (2nd ed) p66
        K = np.tan(np.pi * fc / fs)
        V0 = 10.0 ** (gain_db / 20.0)
        KK = K * K
        if gain_db > 0:
            D = 1 + K / Q + KK
            b[:] = [(1 + V0 * K / Q + KK) / D, 2 * (KK - 1) / D,
                    (1 - V0 * K / Q + KK) / D]
            a[1:] = [2 * (KK - 1) / D, (1 - K / Q + KK) / D]
        else:
            D = 1 + K / (V0 * Q) + KK
            b[:] = [(1 + K / Q + KK) / D, 2 * (KK - 1) / D,
                    (1 - K / Q + KK) / D]
            a[1:] = [2 * (KK - 1) / D, (1 - K / (V0 * Q) + KK) / D]
    elif filter_type == BIQUAD_FILTER_PEAK_EQCB:
        A = 10.0 ** (gain_db / 40.0)
        w0 = 2 * np.pi * fc / fs
        alpha = np.sin(w0) / (2 * Q)
        a0 = 1 + alpha / A
        b[:] = [(1 + alpha * A) / a0, -2 * np.cos(w0) / a0, (1 - alpha * A) / a0]
        a[1:] = [-2 * np.cos(w0) / a0, (1 - alpha / A) / a0]
    else:
        raise ValueError(filter_type)
    return b.astype(np.float64), a.astype(np.float64)


def eval_iir_transfer_function(b, a, freqs, fs: float,
                               mag_db: bool = True):
    """Evaluate an IIR transfer function at given frequencies
    (saf_utility_filters.h:263 ``evalBiQuadTransferFunction`` and
    ``evalIIRTransferFunction``).  Returns (mag, phase)."""
    w = 2.0 * np.pi * np.asarray(freqs, np.float64) / fs
    _, h = sps.freqz(b, a, worN=w)
    mag = np.abs(h)
    if mag_db:
        mag = 20.0 * np.log10(np.maximum(mag, 1e-12))
    return mag.astype(np.float32), np.angle(h).astype(np.float32)


def apply_iir(x, b, a, zi=None):
    """Host-side IIR application (scipy lfilter; saf ``applyIIR``)."""
    if zi is None:
        return sps.lfilter(b, a, x, axis=-1)
    return sps.lfilter(b, a, x, axis=-1, zi=zi)


def butter_coeffs(filter_type: str, order: int, cutoff1: float,
                  cutoff2: float, fs: float):
    """Butterworth digital filter (saf_utility_filters.c ``butterCoeffs`` ==
    MATLAB/scipy butter)."""
    if filter_type == "lpf":
        return sps.butter(order, cutoff1, "lowpass", fs=fs)
    if filter_type == "hpf":
        return sps.butter(order, cutoff1, "highpass", fs=fs)
    if filter_type == "bpf":
        return sps.butter(order, [cutoff1, cutoff2], "bandpass", fs=fs)
    if filter_type == "bsf":
        return sps.butter(order, [cutoff1, cutoff2], "bandstop", fs=fs)
    raise ValueError(filter_type)


def fir_coeffs(filter_type: str, order: int, cutoff1: float, cutoff2: float,
               fs: float, win_type: str = WINDOWING_FUNCTION_HAMMING) -> np.ndarray:
    """Windowed-sinc FIR design (saf_utility_filters.c ``FIRCoeffs``).
    order must be even; returns (order+1,) taps."""
    assert order % 2 == 0
    N = order + 1
    n = np.arange(N) - order / 2.0
    w = get_windowing_function(win_type, N).astype(np.float64)

    def sinc_lp(fc):
        return 2.0 * fc / fs * np.sinc(2.0 * fc / fs * n)

    if filter_type == "lpf":
        h = sinc_lp(cutoff1)
    elif filter_type == "hpf":
        h = -sinc_lp(cutoff1)
        h[order // 2] += 1.0
    elif filter_type == "bpf":
        h = sinc_lp(cutoff2) - sinc_lp(cutoff1)
    elif filter_type == "bsf":
        h = sinc_lp(cutoff1) - sinc_lp(cutoff2)
        h[order // 2] += 1.0
    else:
        raise ValueError(filter_type)
    return (h * w).astype(np.float32)


def fir_filterbank(order: int, cutoffs: np.ndarray, fs: float,
                   win_type: str = WINDOWING_FUNCTION_HAMMING) -> np.ndarray:
    """FIR filterbank: LPF, BPFs, HPF (saf_utility_filters.c ``FIRFilterbank``).
    → (len(cutoffs)+1, order+1)."""
    cutoffs = np.asarray(cutoffs, np.float64)
    nc = len(cutoffs)
    if nc == 1:
        return np.stack([fir_coeffs("lpf", order, cutoffs[0], 0, fs, win_type),
                         fir_coeffs("hpf", order, cutoffs[0], 0, fs, win_type)])
    bank = [fir_coeffs("lpf", order, cutoffs[0], 0, fs, win_type)]
    for i in range(nc - 1):
        bank.append(fir_coeffs("bpf", order, cutoffs[i], cutoffs[i + 1], fs, win_type))
    bank.append(fir_coeffs("hpf", order, cutoffs[-1], 0, fs, win_type))
    return np.stack(bank)


# ---------------------------------------------------------------------------
# Favrot & Faller power-complementary IIR filterbank
# (saf_utility_filters.c faf_IIRFilterbank_*)
# ---------------------------------------------------------------------------

class FafIIRFilterbank:
    """Design-time container: LPF/HPF coefficient pairs per cut-off.

    The band topology matches faf_IIRFilterbank_apply
    (saf_utility_filters.c): band 0 = all LPFs in cascade; band b = HPF[b-1]
    then LPFs b..end, with allpass (LPF+HPF sum) correction stages; last band
    = allpass chain + HPF[end].
    """

    def __init__(self, order: int, cutoffs: np.ndarray, fs: float):
        assert order in (1, 3), "only orders 1 and 3 are supported"
        self.order = order
        self.fs = fs
        self.cutoffs = np.asarray(cutoffs, np.float64)
        self.n_filters = len(self.cutoffs)
        self.n_bands = self.n_filters + 1
        self.b_lpf = np.zeros((self.n_filters, order + 1))
        self.a_lpf = np.zeros((self.n_filters, order + 1))
        self.b_hpf = np.zeros((self.n_filters, order + 1))
        self.a_hpf = np.zeros((self.n_filters, order + 1))
        for f, fc in enumerate(self.cutoffs):
            b_lp, a_lp = sps.butter(order, fc, "lowpass", fs=fs)
            b_hp = self._power_complementary_hpf(b_lp, a_lp, order)
            self.b_lpf[f], self.a_lpf[f] = b_lp, a_lp
            self.b_hpf[f], self.a_hpf[f] = b_hp, a_lp

    @staticmethod
    def _power_complementary_hpf(b, a, order):
        """IIR power-complementary high-pass via coupled allpass
        decomposition (saf_utility_filters.c:faf create; Favrot & Faller)."""
        n = order + 1
        r = (np.convolve(b[::-1], b) - np.convolve(a, a[::-1]))
        q = np.zeros(n)
        q[0] = np.sqrt(-r[0] / -1.0)
        q[1] = -r[1] / (2.0 * -1.0 * q[0])
        if order == 3:
            q[3] = -q[0]
            q[2] = -q[1]
        q = b - q
        z = np.roots(q / q[0])
        d1 = np.array([1.0 + 0j])
        d2 = np.array([1.0 + 0j])
        for zi in z:
            if np.abs(zi) < 1.0:
                d2 = np.convolve(d2, [1.0, -zi])
            else:
                d1 = np.convolve(d1, [1.0, -1.0 / np.conj(zi)])
        num = (np.convolve(np.conj(d1[::-1]), d2)
               - np.convolve(np.conj(d2[::-1]), d1))
        return (-0.5 * num[::-1].real)[:n]

    def _sos(self, b, a) -> np.ndarray:
        """(b, a) → second-order sections, fixed count per filter order.
        The f32 log-depth scan IIR loses ~0.25 abs error on a direct
        order-3 transfer function over 2k samples (poles near |z|=1); the
        SOS cascade keeps it <1e-4."""
        sos = sps.tf2sos(b, a)
        n_sec = (self.order + 1) // 2 + (1 if self.order % 2 == 0 else 0)
        if sos.shape[0] < n_sec:  # pad with identity sections
            pad = np.tile([1.0, 0, 0, 1.0, 0, 0], (n_sec - sos.shape[0], 1))
            sos = np.vstack([sos, pad])
        return sos

    def _device_ops(self):
        """Static stage list for the jit path: ('f', band, sos, slot) = plain
        filter in place; ('apc', band, sos_lp, sos_hp, slot_lp, slot_hp) =
        allpass correction (LPF+HPF of the same input, summed)."""
        ops = []
        slot = 0
        nf = self.n_filters
        lp = [self._sos(self.b_lpf[j], self.a_lpf[j]) for j in range(nf)]
        hp = [self._sos(self.b_hpf[j], self.a_hpf[j]) for j in range(nf)]

        def take():
            nonlocal slot
            s = slot
            slot += 1
            return s

        for j in range(nf):                       # band 0: all LPFs
            ops.append(("f", 0, lp[j], take()))
        if self.n_bands > 1:                      # band 1: HPF0 then LPFs 1..
            ops.append(("f", 1, hp[0], take()))
            for j in range(1, nf):
                ops.append(("f", 1, lp[j], take()))
        for band in range(2, self.n_bands):       # allpass corrections
            for j in range(band - 1):
                ops.append(("apc", band, lp[j], hp[j], take(), take()))
        for band in range(2, self.n_bands - 1):   # HPF[band-1] then LPFs
            ops.append(("f", band, hp[band - 1], take()))
            for j in range(band, nf):
                ops.append(("f", band, lp[j], take()))
        if self.n_bands > 2:                      # last band: HPF[end]
            ops.append(("f", self.n_bands - 1, hp[-1], take()))
        return ops, slot

    @property
    def n_state_slots(self) -> int:
        return self._device_ops()[1]

    @property
    def n_sections(self) -> int:
        return self._sos(self.b_lpf[0], self.a_lpf[0]).shape[0]

    def init_device_state(self, batch_shape=(),
                          device: torch.device | str | None = None):
        """Zero state of :meth:`apply_device` on ``device`` (default: the
        card)."""
        device = default_device() if device is None else device
        return torch.zeros((self.n_state_slots, self.n_sections)
                           + tuple(batch_shape) + (2,), dtype=torch.float32,
                           device=device)

    def apply_device(self, x: torch.Tensor, zi: torch.Tensor):
        """The filterbank on tensors: x (..., T) → ((n_bands, ..., T), zi').

        Same band topology as :meth:`apply`, built from biquad cascades on
        ``ops.iir.iir_filter``; zi: (n_slots, n_sections, ..., 2) carried
        across blocks.
        """
        def run_sos(sos, y, z):
            zs = []
            for k, sec in enumerate(sos):
                y, zk = iir_filter(sec[:3], sec[3:], y, zi=z[k])
                zs.append(zk)
            return y, torch.stack(zs)

        ops, _ = self._device_ops()
        bands = [x for _ in range(self.n_bands)]
        new_zi = [None] * zi.shape[0]
        for op in ops:
            if op[0] == "f":
                _, band, sos, s = op
                bands[band], new_zi[s] = run_sos(sos, bands[band], zi[s])
            else:
                _, band, sos_lp, sos_hp, s1, s2 = op
                lo, new_zi[s1] = run_sos(sos_lp, bands[band], zi[s1])
                hi, new_zi[s2] = run_sos(sos_hp, bands[band], zi[s2])
                bands[band] = lo + hi
        return torch.stack(bands), torch.stack(new_zi)

    def apply(self, x: np.ndarray) -> np.ndarray:
        """x: (T,) → (n_bands, T) (host, scipy)."""
        T = x.shape[-1]
        out = np.tile(x, (self.n_bands, 1)).astype(np.float64)
        nf = self.n_filters
        # band 0: cascade of all LPFs
        for j in range(nf):
            out[0] = sps.lfilter(self.b_lpf[j], self.a_lpf[j], out[0])
        # band 1: HPF[0] then LPFs 1..
        out[1] = sps.lfilter(self.b_hpf[0], self.a_hpf[0], out[1])
        for j in range(1, nf):
            out[1] = sps.lfilter(self.b_lpf[j], self.a_lpf[j], out[1])
        # allpass correction stages for bands 2..N-1
        for band in range(2, self.n_bands):
            for j in range(band - 1):
                lp = sps.lfilter(self.b_lpf[j], self.a_lpf[j], out[band])
                hp = sps.lfilter(self.b_hpf[j], self.a_hpf[j], out[band])
                out[band] = lp + hp
        # bands 2..N-2: HPF[band-1] then LPFs band..
        for band in range(2, self.n_bands - 1):
            out[band] = sps.lfilter(self.b_hpf[band - 1], self.a_hpf[band - 1],
                                    out[band])
            for j in range(band, nf):
                out[band] = sps.lfilter(self.b_lpf[j], self.a_lpf[j], out[band])
        # last band
        if self.n_bands > 2:
            out[-1] = sps.lfilter(self.b_hpf[-1], self.a_hpf[-1], out[-1])
        return out.astype(np.float32)


def interpolate_filters_h(H_in: np.ndarray, in_fft_size: int,
                          out_fft_size: int) -> np.ndarray:
    """Resample complex filter spectra onto a new FFT size exactly as the C
    (saf_utility_filters.c ``interpolateFiltersH``): inverse rFFT of each
    filter, half-length rotate ("flip"), forward rFFT at the new size.
    H_in: (..., inFFTsize/2+1) → (..., outFFTsize/2+1) complex64.

    Mirrors the C's buffer semantics for mismatched sizes: reads past the
    input IR (into the calloc'd zero region) read zeros, and rotated
    samples written past outFFTsize are dropped by the forward transform.
    """
    H = np.asarray(H_in)
    n_bins_out = out_fft_size // 2 + 1
    ir = np.fft.irfft(H, n=in_fft_size, axis=-1)  # 1/N-scaled like saf_rfft
    buflen = max(in_fft_size, out_fft_size) + out_fft_size // 2
    src = np.zeros(H.shape[:-1] + (buflen,))
    src[..., :in_fft_size] = ir
    fl = np.zeros_like(src)
    half_in, half_out = in_fft_size // 2, out_fft_size // 2
    # the C's flip loop aliases on UPSAMPLE (outFFT > inFFT): its first
    # statement at iteration j overwrites what the second wrote at j-half_in,
    # so fl[half_out:half_in+half_out] of the second half survives but the
    # overlap belongs to the rotate — reproduce by assigning the second
    # region FIRST and letting the rotate win on the overlap
    fl[..., half_in:half_in + half_out] = src[..., :half_out]
    fl[..., :half_out] = src[..., half_in:half_in + half_out]
    out = np.fft.rfft(fl[..., :out_fft_size], axis=-1)
    return out[..., :n_bins_out].astype(np.complex64)
