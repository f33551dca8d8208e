"""beamformer — static SH-domain beamformers (counterpart of
``spatial_audio_framework_tpu/models/beamformer.py``;
``examples/src/beamformer``): cardioid / hypercardioid / max-EV patterns
steered at arbitrary directions, with per-frame crossfade of the weights.
The design is host numpy; ``process`` is two matrix products and the
crossfade on the state's device (no filterbank, none of the kernels).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import default_device, f32_tensor
from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.modules import sh
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul

BEAM_CARDIOID = "cardioid"
BEAM_HYPERCARDIOID = "hypercardioid"
BEAM_MAX_EV = "max_ev"


@dataclass(frozen=True)
class BeamformerConfig:
    order: int = 1
    n_beams: int = 1
    beam_type: str = BEAM_HYPERCARDIOID
    ch_ordering: str = C.CH_ACN
    norm: str = C.NORM_SN3D
    frame_size: int = 128

    @property
    def nsh(self) -> int:
        return (self.order + 1) ** 2

    def __post_init__(self):
        C.validate_config(self)


class BeamformerState(NamedTuple):
    prev_W: torch.Tensor   # (nBeams, nSH)
    prev_x: torch.Tensor   # (nSH, T)


def design(cfg: BeamformerConfig, beam_dirs_deg: np.ndarray,
           device: torch.device | str | None = None) -> torch.Tensor:
    """Beamforming weights (nBeams, nSH) on ``device``: axisymmetric pattern
    b_n steered to each direction via rotateAxisCoeffsReal
    (beamformer_internal.c)."""
    b_n = {BEAM_CARDIOID: sh.beam_weights_cardioid,
           BEAM_HYPERCARDIOID: sh.beam_weights_hypercardioid,
           BEAM_MAX_EV: sh.beam_weights_max_ev}[cfg.beam_type](cfg.order)
    W = np.zeros((cfg.n_beams, cfg.nsh), np.float32)
    for i, (azi, elev) in enumerate(np.atleast_2d(beam_dirs_deg)[: cfg.n_beams]):
        W[i] = sh.rotate_axis_coeffs_real(
            cfg.order, b_n, np.pi / 2.0 - np.radians(elev), np.radians(azi))
    conv_in = C.input_conversion_mtx(cfg.order, cfg.ch_ordering, cfg.norm)
    return f32_tensor(W @ conv_in, device)


def state_from_numpy(prev_W: np.ndarray, prev_x: np.ndarray,
                     device: torch.device | str | None = None
                     ) -> BeamformerState:
    """A state (e.g. the JAX package's) from numpy arrays."""
    return BeamformerState(prev_W=f32_tensor(prev_W, device),
                           prev_x=f32_tensor(prev_x, device))


def init_state(cfg: BeamformerConfig,
               device: torch.device | str | None = None) -> BeamformerState:
    device = default_device() if device is None else device
    return BeamformerState(
        prev_W=torch.zeros((cfg.n_beams, cfg.nsh), dtype=torch.float32,
                           device=device),
        prev_x=torch.zeros((cfg.nsh, cfg.frame_size), dtype=torch.float32,
                           device=device))


def process(cfg: BeamformerConfig, W: torch.Tensor, state: BeamformerState,
            x: torch.Tensor):
    """x: (nSH, T) → ((nBeams, T), state); crossfades W against the previous
    frame's weights on the previous frame (one-frame latency)."""
    T = x.shape[-1]
    fade_in = (torch.arange(1, T + 1, dtype=x.dtype, device=x.device)
               / T)[None, :]
    with fp32_matmul():
        out_new = W @ state.prev_x
        out_old = state.prev_W @ state.prev_x
    out = out_new * fade_in + out_old * (1.0 - fade_in)
    return out, BeamformerState(prev_W=W, prev_x=x)
