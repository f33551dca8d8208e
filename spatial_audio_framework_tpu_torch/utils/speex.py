"""Numerically faithful reimplementation of the speexdsp resampler's
floating-point path (the port's own copy of
``spatial_audio_framework_tpu/utils/speex.py``, which is plain numpy), as configured by the reference's ``resampleHRIRs``
(``saf_hrir.c:365-465``: quality = SPEEX_RESAMPLER_QUALITY_MAX = 10,
``skip_zeros`` before processing, zeros fed after the input until the
requested output length is filled).

The reference vendors speexdsp (``framework/resources/speex_resampler/
resample.c``); this module reproduces its numerics rather than its
streaming machinery:

* the quality table ``quality_map`` (resample.c:237-248) and the Kaiser
  window polynomial tables (resample.c:159-205);
* ``sinc()`` / ``compute_func()`` bit-faithfully in float32/float64 mixed
  precision as the C computes them (resample.c:251-310);
* ``update_filter()``'s cutoff/filter-length/oversample/table-mode
  selection (resample.c:625-720), including ``multiply_frac`` integer
  arithmetic and the multiple-of-8 rounding;
* both kernel variants the float build dispatches between —
  ``resampler_basic_direct_double`` (full per-phase sinc table;
  resample.c:407-455) and ``resampler_basic_interpolate_double``
  (oversampled table + cubic phase interpolation; resample.c:520-580) —
  with the double-precision accumulators quality > 8 selects.

Because speex's chunked buffering (process_float → process_native,
resample.c:898-990) is exactly state-preserving across chunk boundaries,
feeding the whole padded stream at once yields bit-identical sample
positions: output k reads the stream slice
``s[last_k : last_k + N]`` with ``last_k = N/2 + k*int_advance +
carries(frac)`` where ``s = [zeros(N-1) | x | zeros(tail)]`` (the N-1
zeros are the initial filter memory and N/2 is ``skip_zeros``'s
latency skip, resample.c:1220-1226).

Everything here is host-side design-time code (HRIR preparation), so it
is plain NumPy; the per-output gathers are vectorised.
"""
from __future__ import annotations

from math import gcd

import numpy as np

# Kaiser window lookup tables (resample.c:159-205).  Values are the C's
# doubles verbatim.
_KAISER12_TABLE = np.array([
    0.99859849, 1.00000000, 0.99859849, 0.99440475, 0.98745105, 0.97779076,
    0.96549770, 0.95066529, 0.93340547, 0.91384741, 0.89213598, 0.86843014,
    0.84290116, 0.81573067, 0.78710866, 0.75723148, 0.72629970, 0.69451601,
    0.66208321, 0.62920216, 0.59606986, 0.56287762, 0.52980938, 0.49704014,
    0.46473455, 0.43304576, 0.40211431, 0.37206735, 0.34301800, 0.31506490,
    0.28829195, 0.26276832, 0.23854851, 0.21567274, 0.19416736, 0.17404546,
    0.15530766, 0.13794294, 0.12192957, 0.10723616, 0.09382272, 0.08164178,
    0.07063950, 0.06075685, 0.05193064, 0.04409466, 0.03718069, 0.03111947,
    0.02584161, 0.02127838, 0.01736250, 0.01402878, 0.01121463, 0.00886058,
    0.00691064, 0.00531256, 0.00401805, 0.00298291, 0.00216702, 0.00153438,
    0.00105297, 0.00069463, 0.00043489, 0.00025272, 0.00013031, 0.0000527734,
    0.00001000, 0.00000000], np.float64)
_KAISER10_TABLE = np.array([
    0.99537781, 1.00000000, 0.99537781, 0.98162644, 0.95908712, 0.92831446,
    0.89005583, 0.84522401, 0.79486424, 0.74011713, 0.68217934, 0.62226347,
    0.56155915, 0.50119680, 0.44221549, 0.38553619, 0.33194107, 0.28205962,
    0.23636152, 0.19515633, 0.15859932, 0.12670280, 0.09935205, 0.07632451,
    0.05731132, 0.04193980, 0.02979584, 0.02044510, 0.01345224, 0.00839739,
    0.00488951, 0.00257636, 0.00115101, 0.00035515, 0.00000000, 0.00000000],
    np.float64)
_KAISER8_TABLE = np.array([
    0.99635258, 1.00000000, 0.99635258, 0.98548012, 0.96759014, 0.94302200,
    0.91223751, 0.87580811, 0.83439927, 0.78875245, 0.73966538, 0.68797126,
    0.63451750, 0.58014482, 0.52566725, 0.47185369, 0.41941150, 0.36897272,
    0.32108304, 0.27619388, 0.23465776, 0.19672670, 0.16255380, 0.13219758,
    0.10562887, 0.08273982, 0.06335451, 0.04724088, 0.03412321, 0.02369490,
    0.01563093, 0.00959968, 0.00527363, 0.00233883, 0.00050000, 0.00000000],
    np.float64)
_KAISER6_TABLE = np.array([
    0.99733006, 1.00000000, 0.99733006, 0.98935595, 0.97618418, 0.95799003,
    0.93501423, 0.90755855, 0.87598009, 0.84068475, 0.80211977, 0.76076565,
    0.71712752, 0.67172623, 0.62508937, 0.57774224, 0.53019925, 0.48295561,
    0.43647969, 0.39120616, 0.34752997, 0.30580127, 0.26632152, 0.22934058,
    0.19505503, 0.16360756, 0.13508755, 0.10953262, 0.08693120, 0.06722600,
    0.05031820, 0.03607231, 0.02432151, 0.01487334, 0.00752000, 0.00000000],
    np.float64)

_KAISER12 = (_KAISER12_TABLE, 64)
_KAISER10 = (_KAISER10_TABLE, 32)
_KAISER8 = (_KAISER8_TABLE, 32)
_KAISER6 = (_KAISER6_TABLE, 32)

# quality_map (resample.c:237-248):
# (base_length, oversample, downsample_bw, upsample_bw, window)
_QUALITY_MAP = [
    (8, 4, 0.830, 0.860, _KAISER6),     # Q0
    (16, 4, 0.850, 0.880, _KAISER6),    # Q1
    (32, 4, 0.882, 0.910, _KAISER6),    # Q2
    (48, 8, 0.895, 0.917, _KAISER8),    # Q3
    (64, 8, 0.921, 0.940, _KAISER8),    # Q4
    (80, 16, 0.922, 0.940, _KAISER10),  # Q5
    (96, 16, 0.940, 0.945, _KAISER10),  # Q6
    (128, 16, 0.950, 0.950, _KAISER10),  # Q7
    (160, 16, 0.960, 0.960, _KAISER10),  # Q8
    (192, 32, 0.968, 0.968, _KAISER12),  # Q9
    (256, 32, 0.975, 0.975, _KAISER12),  # Q10
]

_F32 = np.float32


def _compute_func(x: np.ndarray, window) -> np.ndarray:
    """resample.c:251-269 ``compute_func``: cubic interpolation of the
    window table.  ``x`` float32; interpolation in float64 with a float32
    ``frac``, exactly as the C's mixed types."""
    table, oversample = window
    y = _F32(x) * _F32(oversample)          # float y = x*func->oversample
    ind = np.floor(y).astype(np.int64)      # (int)floor(y)
    frac = _F32(y - ind).astype(np.float64)  # float frac, used in dbl exprs
    f3 = frac * frac * frac
    interp3 = -0.1666666667 * frac + 0.1666666667 * f3
    interp2 = frac + 0.5 * (frac * frac) - 0.5 * f3
    interp0 = (-0.3333333333 * frac + 0.5 * (frac * frac)
               - 0.1666666667 * f3)
    interp1 = np.float64(_F32(1.0)) - interp3 - interp2 - interp0
    return (interp0 * table[ind] + interp1 * table[ind + 1]
            + interp2 * table[ind + 2] + interp3 * table[ind + 3])


def _sinc(cutoff: np.float32, x: np.ndarray, N: int, window) -> np.ndarray:
    """resample.c:299-310 float ``sinc``: windowed sinc, float32 ops with
    the window polynomial evaluated in float64 then cast back."""
    x = np.asarray(x, _F32)
    xx = x * _F32(cutoff)
    pi = _F32(np.pi)
    # guard the |x|<1e-6 division (value replaced below)
    safe = np.where(np.abs(x) < 1e-6, _F32(1.0), pi * xx)
    core = (_F32(cutoff) * np.sin(pi * xx, dtype=_F32) / safe).astype(_F32)
    win = _compute_func(np.abs(_F32(2.0) * x / _F32(N)).astype(_F32),
                        window).astype(_F32)
    out = (core * win).astype(_F32)
    out = np.where(np.abs(x) < 1e-6, _F32(cutoff), out)
    return np.where(np.abs(x) > 0.5 * N, _F32(0.0), out).astype(_F32)


def _cubic_coef(frac: np.ndarray):
    """resample.c:329-340 float ``cubic_coef``."""
    frac = np.asarray(frac, _F32)
    f2 = (frac * frac).astype(_F32)
    f3 = (f2 * frac).astype(_F32)
    i0 = (_F32(-0.16667) * frac + _F32(0.16667) * f3).astype(_F32)
    i1 = (frac + _F32(0.5) * f2 - _F32(0.5) * f3).astype(_F32)
    i3 = (_F32(-0.33333) * frac + _F32(0.5) * f2
          - _F32(0.16667) * f3).astype(_F32)
    i2 = (_F32(1.0) - i0 - i1 - i3).astype(_F32)
    return i0, i1, i2, i3


def _multiply_frac(value: int, num: int, den: int) -> int:
    """resample.c ``multiply_frac``: value*num/den in the C's exact integer
    grouping (remainder and major parts separately)."""
    major, remain = value // den, value % den
    return remain * num // den + major * num


class SpeexResampler:
    """Filter-design state of ``speex_resampler_init(1ch, in_rate,
    out_rate, quality)`` (resample.c:814-886 + update_filter)."""

    def __init__(self, in_rate: int, out_rate: int, quality: int = 10):
        if not (0 <= quality <= 10):
            raise ValueError("quality must be 0..10")
        in_rate, out_rate = int(in_rate), int(out_rate)
        g = gcd(in_rate, out_rate)
        self.num_rate = in_rate // g
        self.den_rate = out_rate // g
        self.quality = quality
        base_length, oversample, down_bw, up_bw, window = _QUALITY_MAP[
            quality]
        self.int_advance = self.num_rate // self.den_rate
        self.frac_advance = self.num_rate % self.den_rate

        if self.num_rate > self.den_rate:   # down-sampling
            # float cutoff = down_bw * den_rate / num_rate  (f32 chain)
            self.cutoff = _F32(_F32(_F32(down_bw) * _F32(self.den_rate))
                               / _F32(self.num_rate))
            filt_len = _multiply_frac(base_length, self.num_rate,
                                      self.den_rate)
            filt_len = ((filt_len - 1) & ~0x7) + 8   # multiple of 8
            if 2 * self.den_rate < self.num_rate:
                oversample >>= 1
            if 4 * self.den_rate < self.num_rate:
                oversample >>= 1
            if 8 * self.den_rate < self.num_rate:
                oversample >>= 1
            if 16 * self.den_rate < self.num_rate:
                oversample >>= 1
            oversample = max(oversample, 1)
        else:                                # up-sampling (or 1:1)
            self.cutoff = _F32(up_bw)
            filt_len = base_length
        self.filt_len = int(filt_len)
        self.oversample = int(oversample)

        N = self.filt_len
        self.use_direct = N * self.den_rate <= N * self.oversample + 8
        if self.use_direct:
            # sinc_table[i, j] = sinc(cutoff, (j - N/2 + 1) - i/den, N)
            i = np.arange(self.den_rate, dtype=np.int64)
            j = np.arange(N, dtype=np.int64)
            x = ((j[None, :] - N // 2 + 1).astype(_F32)
                 - (i[:, None].astype(_F32) / _F32(self.den_rate)))
            self.sinc_table = _sinc(self.cutoff, x, N, window)  # (den, N)
        else:
            # sinc_table[i+4] = sinc(cutoff, i/oversample - N/2, N),
            # i in [-4, oversample*N + 4)
            i = np.arange(-4, self.oversample * N + 4, dtype=np.int64)
            x = (i.astype(_F32) / _F32(self.oversample)).astype(_F32) \
                - _F32(N // 2)
            self.sinc_table = _sinc(self.cutoff, x, N, window)
        # quality > 8 → the double-precision-accumulator kernels
        self.double_accum = quality > 8

    # -- whole-stream application (state machine collapsed; see module
    # docstring for why this is exact) -----------------------------------
    def resample(self, x: np.ndarray, n_out: int,
                 skip_zeros: bool = True) -> np.ndarray:
        """Resample channel-major ``x`` (..., n_in) to exactly ``n_out``
        output samples per channel, zero-feeding past the end of the input
        as resampleHRIRs does (saf_hrir.c:441-456)."""
        x = np.asarray(x, _F32)
        n_in = x.shape[-1]
        N = self.filt_len
        last0 = N // 2 if skip_zeros else 0

        k = np.arange(n_out, dtype=np.int64)
        fr = k * self.frac_advance          # samp_frac_num before wrap
        last = last0 + k * self.int_advance + fr // self.den_rate
        frac_num = fr % self.den_rate

        need = int(last[-1]) + N
        lead = N - 1                         # initial (zero) filter memory
        flat = x.reshape(-1, n_in)
        s = np.zeros((flat.shape[0], max(need, lead + n_in)), _F32)
        s[:, lead:lead + n_in] = flat
        winv = np.lib.stride_tricks.sliding_window_view(s, N, axis=-1)
        acc_dtype = np.float64 if self.double_accum else _F32

        if self.use_direct:
            taps = self.sinc_table[frac_num].astype(acc_dtype)  # (n_out, N)
        else:
            ov = self.oversample
            offset = (frac_num * ov) // self.den_rate
            fracf = ((frac_num * ov) % self.den_rate).astype(_F32) \
                / _F32(self.den_rate)
            # tap index for phase m (0..3): 4 + (j+1)*ov - offset + (m-2)
            j = np.arange(N, dtype=np.int64)
            base = 4 + (j[None, :] + 1) * ov - offset[:, None] - 2
            idx = base[:, :, None] + np.arange(4)[None, None, :]
            taps = self.sinc_table[idx].astype(acc_dtype)   # (n_out, N, 4)
            i0, i1, i2, i3 = _cubic_coef(fracf)

        # the (C, n_out, N) gather is large (836x2 HRIR sets -> ~1 GB), so
        # sweep the channel axis in bounded-memory chunks
        out = np.empty((flat.shape[0], n_out), _F32)
        step = max(1, int(2 ** 25) // max(n_out * N, 1))
        for c0 in range(0, flat.shape[0], step):
            win = winv[c0:c0 + step, last, :].astype(acc_dtype)
            if self.use_direct:
                out[c0:c0 + step] = np.einsum("ckn,kn->ck", win,
                                              taps).astype(_F32)
            else:
                accum = np.einsum("ckn,knm->ckm", win, taps)  # (c, n_out, 4)
                out[c0:c0 + step] = (
                    i0.astype(np.float64) * accum[..., 0]
                    + i1.astype(np.float64) * accum[..., 1]
                    + i2.astype(np.float64) * accum[..., 2]
                    + i3.astype(np.float64) * accum[..., 3]).astype(_F32)
        return out.reshape(x.shape[:-1] + (n_out,))

    @property
    def output_latency(self) -> int:
        """resample.c:1215-1218 ``speex_resampler_get_output_latency``."""
        return ((self.filt_len // 2) * self.den_rate
                + (self.num_rate >> 1)) // self.num_rate
