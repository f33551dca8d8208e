"""SMB phase-vocoder pitch shifter (counterpart of
``spatial_audio_framework_tpu/ops/pitch.py`` and of ``saf_utility_pitch``,
the classic smbPitchShift algorithm).

The phase accumulators are a true sequential dependency, so the frames are
a Python loop over hops, each batched over channels: windowed
``torch.fft.rfft`` → phase-vocoder reassignment (two scatters over bins) →
the C's inverse → overlap-add.  The shift factor may be a tensor on the
device and may change every call: the bin indices are computed on the
device, and nothing in the loop reads the device back.

The C's inverse is not an ``irfft``: it zeroes the negative-frequency bins
WITHOUT conjugate symmetrisation and takes the real part of the unscaled
complex inverse of the one-sided spectrum (saf_utility_pitch.c:352-357),
U(n) = Re Σ_{k=0}^{N/2} S_k e^{+i2πkn/N} = N · Re(ifft(S zero-padded to N)).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import default_device, f32_tensor


class SmbPitchShiftState(NamedTuple):
    in_fifo: torch.Tensor     # (nCH, N - step) input history
    out_accum: torch.Tensor   # (nCH, N) overlap-add accumulator
    last_phase: torch.Tensor  # (nCH, N//2+1)
    sum_phase: torch.Tensor   # (nCH, N//2+1)
    out_fifo: torch.Tensor    # (nCH, step) pending output (one-hop latency,
    #                           gOutFIFO in saf_utility_pitch.c:245 — hop j's
    #                           synthesis is emitted while hop j+1 is
    #                           collected)


@functools.lru_cache(maxsize=None)
def _consts(fft_size: int, device: torch.device) -> dict:
    """The Hann window and the bin indices k on ``device``, once per
    device."""
    N = fft_size
    win = -0.5 * np.cos(2.0 * np.pi * np.arange(N) / N) + 0.5
    return {"win": f32_tensor(win, device),
            "k": torch.arange(N // 2 + 1, dtype=torch.float32, device=device),
            "k_int": torch.arange(N // 2 + 1, dtype=torch.int64,
                                  device=device)}


def wrap_phase(tmp: torch.Tensor) -> torch.Tensor:
    """The C's phase wrap (the qpd idiom, saf_utility_pitch.c ~283-287):
    truncate tmp/π toward zero, make it even away from zero, subtract that
    many π.  It differs from round() only at exact odd multiples of π,
    which float32 reaches at the DC bin."""
    qpd = (tmp / np.pi).to(torch.int32)
    qpd = qpd + torch.where(qpd >= 0, qpd & 1, -(qpd & 1))
    return tmp - np.pi * qpd.to(tmp.dtype)


def scatter_indices(k: torch.Tensor, k_int: torch.Tensor, shift, N: int):
    """The two scatters' column indices for bins k (float32) and a shift
    factor (a tensor or a number) → (idx_mag, idx_freq), int64.

    The C writes bin k to index = (int)(k·shift) and SKIPS indices above
    N/2 (saf_utility_pitch.c:310-316).  ``idx_mag`` (for the magnitude's
    sum) sends them to column N/2+1, which the caller slices off.  The
    frequency is last-k-wins on duplicates; idx is monotone in k, so
    keeping the last k of each run leaves every valid index once, and
    ``idx_freq`` sends every other k to a column of its own past N/2+1
    (column N/2+2+k): no index repeats, so the scatter is deterministic on
    the card."""
    half = N // 2 + 1
    idx = torch.floor(k * shift).to(torch.int64)
    idx_mag = torch.where(idx <= (N // 2), idx, half)
    last_of_run = torch.cat([idx_mag[:-1] != idx_mag[1:],
                             torch.ones(1, dtype=torch.bool, device=k.device)])
    idx_freq = torch.where(last_of_run, idx_mag, half + 1 + k_int)
    return idx_mag, idx_freq


@dataclass(frozen=True)
class SmbPitchShift:
    fs: float = 48000.0
    n_ch: int = 1
    fft_size: int = 8192     # smb_pitchShift_create defaults (pitch_shifter.c)
    osamp: int = 16

    @property
    def step(self) -> int:
        return self.fft_size // self.osamp

    @property
    def latency(self) -> int:
        return self.fft_size - self.step

    def init_state(self, device: torch.device | str | None = None
                   ) -> SmbPitchShiftState:
        """Zero state on ``device`` (default: the card)."""
        device = default_device() if device is None else device
        N, half = self.fft_size, self.fft_size // 2 + 1
        z = functools.partial(torch.zeros, dtype=torch.float32, device=device)
        return SmbPitchShiftState(
            in_fifo=z((self.n_ch, N - self.step)), out_accum=z((self.n_ch, N)),
            last_phase=z((self.n_ch, half)), sum_phase=z((self.n_ch, half)),
            out_fifo=z((self.n_ch, self.step)))

    def state_from_numpy(self, state, device: torch.device | str | None = None
                         ) -> SmbPitchShiftState:
        """A state (e.g. the JAX package's, as numpy arrays) on ``device``
        (default: the card)."""
        return SmbPitchShiftState(*(f32_tensor(a, device) for a in state))

    def design(self, device: torch.device | str | None = None) -> dict:
        """The device constants the frame loop reads (window, bin indices)
        on ``device`` (default: the card); cached per device.  The fft
        size must be a power of two (the C's smbFft has the same
        constraint)."""
        N = self.fft_size
        if N <= 0 or N & (N - 1):
            raise ValueError(f"fft_size must be a power of two, got {N}")
        return _consts(N, torch.device(default_device() if device is None
                                       else device))

    def apply(self, state: SmbPitchShiftState, x: torch.Tensor, shift_factor,
              mats: Optional[dict] = None):
        """x: (nCH, T) with T a multiple of step → ((nCH, T), state).
        shift_factor: a number or a (0-dim) tensor on x's device.
        mats: optional :meth:`design` output."""
        N, step, osamp = self.fft_size, self.step, self.osamp
        half = N // 2 + 1
        c = mats if mats is not None else self.design(x.device)
        win, k, k_int = c["win"], c["k"], c["k_int"]
        freq_per_bin = self.fs / N
        expct = 2.0 * np.pi * step / N
        nch = x.shape[0]
        idx_mag, idx_freq = scatter_indices(k, k_int, shift_factor, N)
        fifo, accum, last_ph, sum_ph, out_fifo = state
        outs = []
        for j in range(x.shape[-1] // step):
            # emit the PREVIOUS frame's synthesis while collecting this hop
            # (the gOutFIFO one-hop latency, saf_utility_pitch.c:245)
            outs.append(out_fifo)
            buf = torch.cat([fifo, x[:, j * step:(j + 1) * step]], dim=-1)
            spec = torch.fft.rfft(buf * win, dim=-1)
            magn = 2.0 * torch.sqrt(spec.real ** 2 + spec.imag ** 2)
            phase = torch.atan2(spec.imag, spec.real)
            # phase difference → true frequency (smb analysis)
            tmp = wrap_phase(phase - last_ph - k * expct)
            true_freq = (k * freq_per_bin
                         + (osamp * tmp / (2 * np.pi)) * freq_per_bin)
            # reassign bins (see scatter_indices)
            syn_mag = torch.zeros((nch, half + 1), dtype=magn.dtype,
                                  device=x.device).index_add_(
                1, idx_mag, magn)[:, :half]
            syn_freq = torch.zeros((nch, 2 * half + 1), dtype=magn.dtype,
                                   device=x.device).index_copy_(
                1, idx_freq, true_freq * shift_factor)[:, :half]
            # synthesis phases
            tmp2 = ((syn_freq - k * freq_per_bin) / freq_per_bin
                    ) * 2.0 * np.pi / osamp + k * expct
            sum_ph = sum_ph + tmp2
            S = torch.complex(syn_mag * torch.cos(sum_ph),
                              syn_mag * torch.sin(sum_ph))
            U = N * torch.fft.ifft(S, n=N, dim=-1).real
            # the accumulation is 2·win·U/(N·osamp) (kissFFT backward is 1/N)
            accum = accum + 2.0 * win * U / (N * osamp)
            out_fifo = accum[:, :step]
            accum = torch.cat([accum[:, step:], torch.zeros_like(out_fifo)],
                              dim=-1)
            fifo = buf[:, step:]
            last_ph = phase
        y = torch.cat(outs, dim=-1) if outs else x[:, :0]
        return y, SmbPitchShiftState(fifo, accum, last_ph, sum_ph, out_fifo)
