"""Decorrelators (counterpart of ``spatial_audio_framework_tpu/utils/decor.py``;
``saf_utility_decor``): random-delay assignment, synthesised noise reverb,
the lattice all-pass decorrelator and the transient ducker.

The lattice decorrelator's per-(band, channel) all-pass IIRs run along the
hop-time axis in the exact block form (``ops.iir.iir_filter_batched_block``:
dense Toeplitz and state products, their matrices cached on the device)
instead of the reference's per-sample triple loop (saf_utility_decor.c:
300-383).  The design is host numpy, as in the JAX package;
:func:`lattice_design_on_device` adds the two tensors the per-call path
reads (each (band, channel)'s delay as a window start, and the filtered-band
mask), made once per design and device.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import data_path, default_device
from spatial_audio_framework_tpu_torch.ops.iir import (
    iir_filter_batched_block as iir_filter_batched)
from spatial_audio_framework_tpu_torch.utils import filters as _filters
from spatial_audio_framework_tpu_torch.utils.convhull3d import RAND_MAX


@functools.lru_cache(maxsize=None)
def _lattice_tables() -> dict:
    with np.load(data_path("lattice_coeffs.npz")) as z:
        return {k: z[k].copy() for k in z.keys()}


def lattice_coeffs(order: int, ch: int, lookup_offset: int = 0) -> np.ndarray:
    """Numerator coefficients row for a given order/channel
    (saf_utility_latticeCoeffs.c __lattice_coeffs_oN, 256 rows each)."""
    return _lattice_tables()[f"lattice_coeffs_o{order}"][ch + lookup_offset]


def get_decorrelation_delays(n_channels: int, freqs: np.ndarray, fs: float,
                             max_tf_delay: int, hop_size: int,
                             rng=None) -> np.ndarray:
    """Random inter-channel decorrelation delays in time slots
    (saf_utility_decor.c:71 ``getDecorrelationDelays``).  → (nFreqs, nCH) int."""
    rng = rng or np.random.default_rng(0)
    freqs = np.asarray(freqs, np.float64)
    n_freqs = freqs.shape[0]
    max_ms = min(80.0, (max_tf_delay - 1.0) * hop_size / fs * 1000.0)
    rng_max = np.maximum(7.0, np.minimum(max_ms, 50.0 * 1000.0 / (freqs + 2.23e-9)))
    rng_min = np.maximum(3.0, np.minimum(20.0, 10.0 * 1000.0 / (freqs + 2.23e-9)))
    d = (np.arange(n_channels) / n_channels
         + rng.uniform(0, 1, (n_freqs, n_channels)) / n_channels)
    for band in range(n_freqs):
        d[band] = d[band, rng.permutation(n_channels)]
    d = d * (rng_max - rng_min)[:, None] + rng_min[:, None]
    return np.maximum((d / 1000.0 * fs / hop_size + 0.5).astype(int) - 1, 0)


def c_randperm(n: int, rand_stream) -> np.ndarray:
    """Bit-exact ``randperm`` (saf_utility_misc.c:156): Fisher-Yates with
    j = rand() % (n-i) + i drawn from an emulated glibc rand() stream."""
    p = list(range(n))
    for i in range(n):
        j = next(rand_stream) % (n - i) + i
        p[i], p[j] = p[j], p[i]
    return np.asarray(p)


def get_decorrelation_delays_c(n_channels: int, freqs: np.ndarray, fs: float,
                               max_tf_delay: int, hop_size: int,
                               rand_stream) -> np.ndarray:
    """Bit-exact C ``getDecorrelationDelays`` (saf_utility_decor.c:71-118):
    jitters drawn band-major from the given glibc-rand() stream
    (utils/convhull3d.glibc_rand), then a randperm per band, all arithmetic
    in float32 as the C.  With the stream at the same position as a C
    process, the integer slot delays match the C exactly."""
    f = np.float32
    freqs32 = np.asarray(freqs, np.float32)
    n_freqs = freqs32.shape[0]
    nchf = f(n_channels)
    max_ms = min(f(80.0), f(f(f(max_tf_delay - 1.0) * f(hop_size)) / f(fs))
                 * f(1000.0))
    rng_max = np.maximum(
        f(7.0), np.minimum(max_ms, f(50.0 * 1000.0)
                           / (freqs32 + f(2.23e-9))))
    rng_min = np.maximum(
        f(3.0), np.minimum(f(20.0), f(10.0 * 1000.0)
                           / (freqs32 + f(2.23e-9))))
    d = np.empty((n_freqs, n_channels), np.float32)
    for band in range(n_freqs):
        for ch in range(n_channels):
            d[band, ch] = f(ch) / nchf + (f(next(rand_stream))
                                          / f(RAND_MAX)) / nchf
    for band in range(n_freqs):
        d[band] = d[band][c_randperm(n_channels, rand_stream)]
    d = d * (rng_max - rng_min)[:, None] + rng_min[:, None]
    slots = (d / f(1000.0) * f(fs) / f(hop_size) + f(0.5)).astype(np.int32)
    return np.maximum(slots - 1, 0)


def synthesise_noise_reverb(n_ch: int, fs: float, t60: np.ndarray,
                            fcen_oct: np.ndarray, flatten: bool = False,
                            rng=None) -> np.ndarray:
    """Exponentially-decaying band-shaped noise 'reverb tails'
    (saf_utility_decor.c:121 ``synthesiseNoiseReverb``).  → (nCH, rir_len)."""
    from scipy.signal import fftconvolve

    rng = rng or np.random.default_rng(0)
    t60 = np.asarray(t60, np.float64)
    fcen = np.asarray(fcen_oct, np.float64)
    n_bands = t60.shape[0]
    order = 800
    rir_len = int(max(t60) * fs + 0.5)
    lout = rir_len + order // 2
    t = np.arange(rir_len) / fs
    env = np.exp(-t[None, :] * (3.0 * np.log(10.0) / t60)[:, None])
    noise = rng.uniform(-1, 1, (n_ch, n_bands, rir_len))
    rir = np.zeros((n_ch, n_bands, lout))
    rir[..., :rir_len] = noise * env[None]
    cutoffs = _filters.get_octave_band_cutoff_freqs(fcen)
    bank = _filters.fir_filterbank(order, cutoffs, fs)  # (nBands, order+1)
    out = np.zeros((n_ch, lout))
    for b in range(n_bands):
        out += fftconvolve(rir[:, b], bank[b][None], axes=-1)[:, :lout]
    if flatten:
        out = np.stack([flatten_minphase(o) for o in out])
    return out[:, order // 2: order // 2 + rir_len].astype(np.float32)


def flatten_minphase(x: np.ndarray) -> np.ndarray:
    """Equalise with the inverse minimum-phase response
    (saf_utility_filters ``flattenMinphase``): divide by the min-phase
    spectrum derived from the cepstrum."""
    n = x.shape[-1]
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    X = np.fft.fft(x, nfft)
    logmag = np.log(np.abs(X) + 1e-9)
    cep = np.fft.ifft(logmag).real
    w = np.zeros(nfft)
    w[0] = w[nfft // 2] = 1.0
    w[1: nfft // 2] = 2.0
    minph = np.exp(np.fft.fft(cep * w))
    y = np.fft.ifft(X / minph)[:n].real
    return y.astype(np.float32)


# ---------------------------------------------------------------------------
# Lattice all-pass decorrelator
# ---------------------------------------------------------------------------

class LatticeDecorState(NamedTuple):
    delay_buf: torch.Tensor   # (nBands, nCH, maxDelay) complex: recent history
    iir_state: torch.Tensor   # (nBands, nCH, maxOrder) complex DF2T state
    in_energy: torch.Tensor   # (nBands, nCH)
    out_energy: torch.Tensor  # (nBands, nCH)


class LatticeDecorStateRI(NamedTuple):
    """:class:`LatticeDecorState` with the complex halves split on an axis of
    their own, before (band, channel); any leading axes (streams) come
    first."""
    delay_buf: torch.Tensor   # (..., 2, nBands, nCH, maxDelay) [re; im]
    iir_state: torch.Tensor   # (..., 2, nBands, nCH, maxOrder)
    in_energy: torch.Tensor   # (..., nBands, nCH)
    out_energy: torch.Tensor  # (..., nBands, nCH)


@dataclass(frozen=True)
class LatticeDecorrelator:
    """saf_utility_decor.h:161 ``latticeDecorrelator_*``.

    orders/freq_cutoffs assign an all-pass order per frequency region (bands
    above the last cutoff pass through unfiltered); each channel draws a
    different coefficient row from the lattice table.
    """
    fs: float
    hop_size: int
    n_ch: int
    orders: tuple
    freq_cutoffs: tuple
    max_delay: int = 12
    lookup_offset: int = 0
    en_comp_coeff: float = 0.9

    def design(self, freq_vector: np.ndarray, rng=None, c_rand_stream=None):
        """→ dict of host-side numpy design data (the JAX package's keys).
        Pass ``c_rand_stream`` (a utils/convhull3d.glibc_rand generator at
        the C process's rand() position) to reproduce the reference's
        delays bit-exactly."""
        freqs = np.asarray(freq_vector, np.float64)
        n_bands = freqs.shape[0]
        if c_rand_stream is not None:
            delays = get_decorrelation_delays_c(
                self.n_ch, freqs, self.fs, self.max_delay, self.hop_size,
                c_rand_stream)
        else:
            delays = get_decorrelation_delays(self.n_ch, freqs, self.fs,
                                              self.max_delay, self.hop_size,
                                              rng)
        max_order = max(self.orders)
        # per-(band, ch) padded numerator/denominator (identity passthrough
        # where no filtering is assigned)
        b = np.zeros((n_bands, self.n_ch, max_order))
        b[..., 0] = 1.0
        a = np.zeros((n_bands, self.n_ch, max_order))
        a[..., 0] = 1.0
        filtered = np.zeros(n_bands, bool)
        for band in range(n_bands):
            f_idx = next((o for o, fc in enumerate(self.freq_cutoffs)
                          if freqs[band] < fc), -1)
            if f_idx < 0:
                continue
            filtered[band] = True
            order = self.orders[f_idx]
            for ch in range(self.n_ch):
                num = lattice_coeffs(order, ch, self.lookup_offset)
                # implemented structure (saf_utility_decor.c:335-383):
                # numerator = num[0..order-1], denominator = [1, num[::-1][1:]]
                b[band, ch, :order] = num
                a[band, ch, 1:order] = num[::-1][1:order]
        return {"b": b, "a": a, "delays": delays, "filtered": filtered,
                "max_delay_slots": int(delays.max())}

    def init_state(self, design: dict, n_bands: int,
                   device: torch.device | str | None = None
                   ) -> LatticeDecorState:
        device = default_device() if device is None else device
        md = design["max_delay_slots"] + 1
        mo = max(self.orders) - 1
        c = dict(dtype=torch.complex64, device=device)
        f = dict(dtype=torch.float32, device=device)
        return LatticeDecorState(
            delay_buf=torch.zeros((n_bands, self.n_ch, md), **c),
            iir_state=torch.zeros((n_bands, self.n_ch, mo), **c),
            in_energy=torch.zeros((n_bands, self.n_ch), **f),
            out_energy=torch.zeros((n_bands, self.n_ch), **f))

    def apply(self, design: dict, state: LatticeDecorState,
              frame: torch.Tensor, aliased_energy: bool = False):
        """frame: (nBands, nCH, T) complex → (decorrelated frame, state).

        ``aliased_energy`` mirrors an upstream C quirk: when the caller
        passes the SAME buffer as inFrame and decorFrame
        (decorrelator.c:199, the transient-ducker path), the delay stage
        overwrites "inFrame" before the filter loop reads it for the
        input-energy EWMA, so in_energy tracks the DELAYED signal.  With
        distinct buffers (decorrelator.c:202, spreader.c:470) it tracks the
        pre-delay input.  Computed on the (re, im) halves: the lattice and
        one-pole coefficients are real."""
        st = LatticeDecorStateRI(
            delay_buf=_split(state.delay_buf), iir_state=_split(state.iir_state),
            in_energy=state.in_energy, out_energy=state.out_energy)
        (yre, yim), st = lattice_apply_ri(self, design, st, frame.real,
                                          frame.imag, aliased_energy)
        return torch.complex(yre, yim), LatticeDecorState(
            delay_buf=torch.complex(st.delay_buf[0], st.delay_buf[1]),
            iir_state=torch.complex(st.iir_state[0], st.iir_state[1]),
            in_energy=st.in_energy, out_energy=st.out_energy)


def _split(z: torch.Tensor) -> torch.Tensor:
    return torch.stack([z.real, z.imag], dim=0)


def lattice_design_on_device(design: dict,
                             device: torch.device | str | None = None) -> dict:
    """The design with the per-call device data added, made once per
    device and kept in the dict: ``"start"`` (nBands, nCH, 1, 1) int64, each
    delay's window start in [delay_buf | frame], and ``"filtered_mask"``
    (nBands, 1, 1) bool.  Takes the JAX package's design dict as well."""
    device = torch.device(default_device() if device is None else device)
    cache = design.setdefault("_device", {})
    key = str(device)
    if key not in cache:
        md = design["max_delay_slots"] + 1
        start = md - np.asarray(design["delays"], np.int64)
        cache[key] = {
            "start": torch.tensor(start[..., None, None], device=device),
            "filtered_mask": torch.tensor(
                np.asarray(design["filtered"], bool)[:, None, None],
                device=device)}
    return cache[key]


def lattice_init_state_ri(dec: LatticeDecorrelator, design: dict,
                          n_bands: int, lead: tuple = (),
                          device: torch.device | str | None = None
                          ) -> LatticeDecorStateRI:
    """Zero (re, im) lattice state with leading axes ``lead`` (e.g. the
    streams), on ``device`` (default: the card)."""
    device = default_device() if device is None else device
    md = design["max_delay_slots"] + 1
    mo = max(dec.orders) - 1
    lead = tuple(lead)

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=torch.float32, device=device)

    return LatticeDecorStateRI(
        delay_buf=zeros(2, n_bands, dec.n_ch, md),
        iir_state=zeros(2, n_bands, dec.n_ch, mo),
        in_energy=zeros(n_bands, dec.n_ch),
        out_energy=zeros(n_bands, dec.n_ch))


def lattice_apply_ri(dec: LatticeDecorrelator, design: dict,
                     state: LatticeDecorStateRI, fre: torch.Tensor,
                     fim: torch.Tensor, aliased_energy: bool = False):
    """LatticeDecorrelator.apply on an (re, im) pair: (..., nBands, nCH, T)
    each → ((yre, yim), state); any leading axes (streams) are batched.
    ``aliased_energy`` as in LatticeDecorrelator.apply (the C's in-place
    call sites)."""
    dev = lattice_design_on_device(design, fre.device)
    x2 = torch.stack([fre, fim], dim=-4)             # (..., 2, nB, nCH, T)
    T = x2.shape[-1]
    md = state.delay_buf.shape[-1]
    full = torch.cat([state.delay_buf, x2], dim=-1)
    # 1) fixed per-(band, ch) delays: the window of T slots starting at
    #    md - delay, one gather with a start index made once per design
    windows = full.unfold(-1, T, 1)                  # (..., md+1, T) views
    start = dev["start"].expand(windows.shape[:-2] + (1, T))
    delayed = windows.gather(-2, start).squeeze(-2)
    new_delay_buf = full[..., -md:]
    # 2) all-pass lattice IIR along hop-time (exact block form)
    y2, new_iir = iir_filter_batched(design["b"], design["a"], delayed,
                                     zi=state.iir_state)
    # 3) energy compensation: EWMA of |x|² and |y|² (one-pole recurrences)
    lam = dec.en_comp_coeff
    one_pole = np.array([1.0 - lam, 0.0])
    den = np.array([1.0, -lam])
    if aliased_energy:   # C in-place call: in_energy sees the DELAYED signal
        pin = delayed.select(-4, 0) ** 2 + delayed.select(-4, 1) ** 2
    else:
        pin = fre * fre + fim * fim
    pout = y2.select(-4, 0) ** 2 + y2.select(-4, 1) ** 2
    ein, zin = iir_filter_batched(one_pole, den, pin,
                                  zi=state.in_energy[..., None])
    eout, zout = iir_filter_batched(one_pole, den, pout,
                                    zi=state.out_energy[..., None])
    comp = torch.clamp_max(torch.sqrt(ein / (eout + 2.23e-9)), 1.0)
    # the C compensates only where a lattice filter exists: bands above the
    # last cutoff output the bare delayed signal (latticeDecorrelator_apply)
    comp = torch.where(dev["filtered_mask"], comp, 1.0)
    y2 = y2 * comp.unsqueeze(-4)
    return ((y2.select(-4, 0), y2.select(-4, 1)),
            LatticeDecorStateRI(delay_buf=new_delay_buf, iir_state=new_iir,
                                in_energy=zin[..., 0],
                                out_energy=zout[..., 0]))


# ---------------------------------------------------------------------------
# Transient ducker
# ---------------------------------------------------------------------------

class TransientDuckerState(NamedTuple):
    d1: torch.Tensor  # (..., nBands, nCH)
    d2: torch.Tensor


def transient_ducker_init(n_bands: int, n_ch: int, lead: tuple = (),
                          device: torch.device | str | None = None
                          ) -> TransientDuckerState:
    device = default_device() if device is None else device
    shape = tuple(lead) + (n_bands, n_ch)
    return TransientDuckerState(
        d1=torch.zeros(shape, dtype=torch.float32, device=device),
        d2=torch.zeros(shape, dtype=torch.float32, device=device))


def _ducker_eq(state: TransientDuckerState, e: torch.Tensor, alpha: float,
               beta: float):
    """The detector's slot recursion (transientDucker_apply), sequential as
    in the JAX package's scan: e (..., T) → (eq (..., T), state)."""
    d1, d2 = state
    eqs = []
    for t in range(e.shape[-1]):
        d1 = torch.maximum(d1 * alpha, e[..., t])
        d2 = torch.minimum(d2 * beta + (1.0 - beta) * d1, d1)
        eqs.append(torch.clamp_max(4.0 * d2 / (d1 + 2.23e-9), 1.0))
    return torch.stack(eqs, dim=-1), TransientDuckerState(d1=d1, d2=d2)


def transient_ducker_apply(state: TransientDuckerState, frame: torch.Tensor,
                           alpha: float = 0.95, beta: float = 0.995):
    """Split a TF frame into residual + transient parts
    (saf_utility_decor.c ``transientDucker_apply``).

    frame: (nBands, nCH, T) complex → (residual, transient, state)."""
    eq, state = _ducker_eq(state, frame.real ** 2 + frame.imag ** 2, alpha,
                           beta)
    return frame * eq, frame * (1.0 - eq), state


def transient_ducker_apply_ri(state: TransientDuckerState, fre: torch.Tensor,
                              fim: torch.Tensor, alpha: float = 0.95,
                              beta: float = 0.995):
    """transient_ducker_apply on an (re, im) pair (any leading axes) →
    ((res_re, res_im), (tr_re, tr_im), state)."""
    eq, state = _ducker_eq(state, fre * fre + fim * fim, alpha, beta)
    return ((fre * eq, fim * eq), (fre * (1 - eq), fim * (1 - eq)), state)
