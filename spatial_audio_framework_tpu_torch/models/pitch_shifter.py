"""pitch_shifter — SMB phase-vocoder wrapper (counterpart of
``spatial_audio_framework_tpu/models/pitch_shifter.py`` and of the
reference's ``examples/src/pitch_shifter``)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.ops.pitch import (SmbPitchShift,
                                                         SmbPitchShiftState)

# PITCH_SHIFTER_FFTSIZE / OSAMP options (pitch_shifter.h)
FFT_SIZES = (512, 1024, 2048, 4096, 8192, 16384)
OSAMPS = (2, 4, 8, 16, 32)


@dataclass(frozen=True)
class PitchShifterConfig:
    fs: float = 48000.0
    n_ch: int = 1
    fft_size: int = 8192
    osamp: int = 16

    @property
    def op(self) -> SmbPitchShift:
        return SmbPitchShift(fs=self.fs, n_ch=self.n_ch,
                             fft_size=self.fft_size, osamp=self.osamp)

    @property
    def latency(self) -> int:
        return self.op.latency

    def __post_init__(self):
        C.validate_config(self)


def init_state(cfg: PitchShifterConfig,
               device: torch.device | str | None = None) -> SmbPitchShiftState:
    """Zero state on ``device`` (default: the card)."""
    return cfg.op.init_state(device)


def state_from_numpy(cfg: PitchShifterConfig, state,
                     device: torch.device | str | None = None
                     ) -> SmbPitchShiftState:
    """A state (e.g. the JAX package's) from numpy arrays."""
    return cfg.op.state_from_numpy(state, device)


def design(cfg: PitchShifterConfig, device: torch.device | str | None = None):
    """The device constants of the frame loop (window, bin indices) on
    ``device`` (default: the card); see SmbPitchShift.design."""
    return cfg.op.design(device)


def process(cfg: PitchShifterConfig, state: SmbPitchShiftState,
            x: torch.Tensor, shift_factor, mats=None):
    """x: (nCH, T), T multiple of fft_size/osamp; shift_factor a number or
    a (0-dim) tensor on x's device in [0.5, 2] → ((nCH, T), state)."""
    return cfg.op.apply(state, x, shift_factor, mats=mats)
