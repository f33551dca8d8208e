"""Basic STFT with overlap-add (counterpart of
``spatial_audio_framework_tpu/ops/stft.py`` and of ``saf_stft_*`` in
saf_utility_fft.h:150-204): rectangular window when hop == winsize (LTI
operation), Hann analysis window otherwise; FFT size = 2·winsize
(zero-padded ×2); inverse = 1/N irFFT + overlap-add.  The transforms are
``torch.fft.rfft`` / ``irfft``."""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch

from spatial_audio_framework_tpu_torch import default_device, f32_tensor
from spatial_audio_framework_tpu_torch.utils.filters import (
    WINDOWING_FUNCTION_HANN, get_windowing_function)


class STFTState(NamedTuple):
    in_tail: torch.Tensor   # (n_ch_in, winsize - hop)
    ola_tail: torch.Tensor  # (n_ch_out, 2*winsize - hop)


@functools.lru_cache(maxsize=None)
def _window(winsize: int, hopsize: int, device: torch.device) -> torch.Tensor:
    """The analysis window on ``device``, made once per device."""
    if winsize == hopsize:
        return torch.ones(winsize, dtype=torch.float32, device=device)
    return f32_tensor(get_windowing_function(WINDOWING_FUNCTION_HANN,
                                             winsize), device)


@dataclass(frozen=True)
class STFT:
    winsize: int
    hopsize: int
    n_ch_in: int = 1
    n_ch_out: int = 1

    @property
    def n_bands(self) -> int:
        return self.winsize + 1

    @property
    def fftsize(self) -> int:
        return 2 * self.winsize

    def init_state(self, device: torch.device | str | None = None
                   ) -> STFTState:
        """Zero state on ``device`` (default: the card)."""
        device = default_device() if device is None else device
        return STFTState(
            in_tail=torch.zeros((self.n_ch_in, self.winsize - self.hopsize),
                                dtype=torch.float32, device=device),
            ola_tail=torch.zeros((self.n_ch_out, self.fftsize - self.hopsize),
                                 dtype=torch.float32, device=device))

    def state_from_numpy(self, in_tail, ola_tail,
                         device: torch.device | str | None = None
                         ) -> STFTState:
        """A state (e.g. the JAX package's) from numpy arrays."""
        return STFTState(f32_tensor(in_tail, device),
                         f32_tensor(ola_tail, device))

    def forward(self, state: STFTState, x: torch.Tensor):
        """x: (n_ch, H*hop) → ((n_bands, n_ch, H) complex, state)."""
        win, hop = self.winsize, self.hopsize
        n_ch = x.shape[0]
        H = x.shape[1] // hop
        buf = torch.cat([state.in_tail, x], dim=-1)
        hops = buf.reshape(n_ch, (win - hop) // hop + H, hop)
        k_hops = win // hop
        seg = torch.stack([hops[:, k: k + H] for k in range(k_hops)], dim=2)
        frames = seg.reshape(n_ch, H, win) * _window(win, hop, x.device)
        spec = torch.fft.rfft(frames, n=self.fftsize, dim=-1)
        return (spec.permute(2, 0, 1),
                state._replace(in_tail=buf[:, H * hop:]))

    def backward(self, state: STFTState, Y: torch.Tensor):
        """Y: (n_bands, n_ch, H) complex → ((n_ch, H*hop), state)."""
        hop, nfft = self.hopsize, self.fftsize
        Y = Y.permute(1, 2, 0)
        n_ch, H = Y.shape[:2]
        frames = torch.fft.irfft(Y, n=nfft, dim=-1)   # (n_ch, H, nfft)
        k_hops = nfft // hop
        acc = torch.zeros((n_ch, H + k_hops - 1, hop), dtype=frames.dtype,
                          device=frames.device)
        fr = frames.reshape(n_ch, H, k_hops, hop)
        for k in range(k_hops):
            acc[:, k: k + H] += fr[:, :, k]
        flat = acc.reshape(n_ch, -1)
        flat[:, : nfft - hop] += state.ola_tail
        return flat[:, : H * hop], state._replace(ola_tail=flat[:, H * hop:])
