"""ambi_enc — Ambisonic (SH) encoder (counterpart of
``spatial_audio_framework_tpu/models/ambi_enc.py``;
``examples/src/ambi_enc``).

Encodes source signals at given directions into SH signals with a linear
crossfade between the previous and current encoding matrices each frame
(ambi_enc.c process: interpolator_fadeIn/fadeOut), carrying the previous
frame's encoding matrix in the state.  As the reference, it encodes the
*previous* frame's input (one-frame latency, ambi_enc.c prev_inputFrameTD).

It has no filterbank: per frame the SH matrix of the directions
(``modules/sh.get_sh_real_torch``, on the device), two matrix products, the
crossfade and the output-convention conversion, all ``torch`` ops on the
state's device.  ``state_from_numpy`` takes the JAX package's state as numpy
arrays, so both packages can run on identical inputs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import default_device, f32_tensor
from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.modules import sh
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul


@dataclass(frozen=True)
class AmbiEncConfig:
    order: int = 1
    n_sources: int = 1
    ch_ordering: str = C.CH_ACN
    norm: str = C.NORM_SN3D
    enable_post_scaling: bool = True
    frame_size: int = 128

    @property
    def nsh(self) -> int:
        return (self.order + 1) ** 2

    def __post_init__(self):
        C.validate_config(self)


class AmbiEncState(NamedTuple):
    prev_Y: torch.Tensor   # (nSH, nSrc) previous encoding matrix
    prev_x: torch.Tensor   # (nSrc, T) previous input frame


def encoding_mtx(cfg: AmbiEncConfig, src_dirs_deg) -> np.ndarray:
    """Y = getRSH(order, dirs): (nSH, nSrc), N3D/ACN, host numpy
    (ambi_enc.c getRSH_recur)."""
    return sh.get_rsh(cfg.order, src_dirs_deg)


def design(cfg: AmbiEncConfig,
           device: torch.device | str | None = None) -> torch.Tensor:
    """Output-convention conversion matrix (ACN/N3D → cfg conventions) on
    ``device`` (default: the card)."""
    return f32_tensor(
        C.output_conversion_mtx(cfg.order, cfg.ch_ordering, cfg.norm), device)


def state_from_numpy(prev_Y: np.ndarray, prev_x: np.ndarray,
                     device: torch.device | str | None = None) -> AmbiEncState:
    """A state (e.g. the JAX package's) from numpy arrays."""
    return AmbiEncState(prev_Y=f32_tensor(prev_Y, device),
                        prev_x=f32_tensor(prev_x, device))


def init_state(cfg: AmbiEncConfig, src_dirs_deg: Optional[np.ndarray] = None,
               device: torch.device | str | None = None) -> AmbiEncState:
    """Zero input frame; the previous encoding matrix is that of
    ``src_dirs_deg`` (host, float64 inside) or zeros."""
    device = default_device() if device is None else device
    Y0 = (sh.get_rsh(cfg.order, np.asarray(src_dirs_deg, np.float64))
          if src_dirs_deg is not None
          else np.zeros((cfg.nsh, cfg.n_sources), np.float32))
    return AmbiEncState(
        prev_Y=f32_tensor(Y0, device),
        prev_x=torch.zeros((cfg.n_sources, cfg.frame_size),
                           dtype=torch.float32, device=device))


def process(cfg: AmbiEncConfig, out_conv: torch.Tensor, state: AmbiEncState,
            x: torch.Tensor, src_dirs_deg: torch.Tensor,
            src_gains: Optional[torch.Tensor] = None):
    """x: (nSrc, T); src_dirs_deg: (nSrc, 2) degrees, on the state's device.
    → ((nSH, T), state)."""
    T = x.shape[-1]
    if src_gains is not None:
        x = x * src_gains[:, None]
    d = math.pi / 180.0
    dirs_rad = torch.stack([src_dirs_deg[:, 0] * d,
                            math.pi / 2 - src_dirs_deg[:, 1] * d], -1)
    Y = (sh.get_sh_real_torch(cfg.order, dirs_rad)
         * math.sqrt(4.0 * math.pi)).to(x.dtype)
    # encode previous frame with both matrices, crossfade (ambi_enc.c:439-470)
    fade_in = (torch.arange(1, T + 1, dtype=x.dtype, device=x.device)
               / T)[None, :]
    with fp32_matmul():
        out_new = Y @ state.prev_x
        out_old = state.prev_Y @ state.prev_x
        out = out_new * fade_in + out_old * (1.0 - fade_in)
        if cfg.enable_post_scaling:
            out = out / math.sqrt(cfg.n_sources)
        out = out_conv @ out
    return out, AmbiEncState(prev_Y=Y, prev_x=x)
