"""ambi_roomsim — IMS shoebox → SH-receiver room simulator (counterpart of
``spatial_audio_framework_tpu/models/ambi_roomsim.py``;
``examples/src/ambi_roomsim``).

Design (host): the shoebox scene with the default wall absorptions
(ambi_roomsim.c:30), echograms at the given reflection order and broadband
SH RIRs per (receiver, source) pair (``modules/reverb``).  Process: the
source signals through the RIR matrix on the partitioned
``ops/matrix_conv.MatrixConv`` — the equivalent of the reference's
per-image-source applicator (``ims_shoebox_applyEchogramTD``): once the RIR
is rendered the outputs are the same, since the reference's TD path is a
tap accumulation of the same echogram.  ``process_ri`` takes leading
instance axes (state from ``w.conv.init_state_ri(batch=...)``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.modules import reverb
from spatial_audio_framework_tpu_torch.ops.matrix_conv import (
    MatrixConv, MatrixConvState, design_from_numpy)

DEFAULT_ABS_WALL = np.array([0.341055, 0.431295, 0.351295, 0.344335,
                             0.401775, 0.482095], np.float32)  # ambi_roomsim.c:30


@dataclass(frozen=True)
class AmbiRoomSimConfig:
    sh_order: int = 1
    n_sources: int = 1
    n_receivers: int = 1
    refl_order: int = 3
    fs: float = 48000.0
    room_dims: tuple = (10.0, 7.0, 4.0)
    hop: int = 128

    @property
    def nsh(self) -> int:
        return (self.sh_order + 1) ** 2

    def __post_init__(self):
        C.validate_config(self)


class AmbiRoomSimWeights(NamedTuple):
    Hf: object          # partitioned RIR spectra: complex, or an (re, im) pair
    conv: MatrixConv


def rirs(cfg: AmbiRoomSimConfig, src_positions: np.ndarray,
         rec_positions: np.ndarray,
         abs_wall: np.ndarray = DEFAULT_ABS_WALL) -> np.ndarray:
    """The RIR matrix (nRec·nSH, nSrc, L) on the host.  src_positions:
    (nSrc, 3); rec_positions: (nRec, 3) in room coordinates."""
    room = reverb.ShoeboxRoom(np.asarray(cfg.room_dims), abs_wall[None, :],
                              fs=cfg.fs)
    for p in np.atleast_2d(src_positions)[: cfg.n_sources]:
        room.add_source(p)
    for p in np.atleast_2d(rec_positions)[: cfg.n_receivers]:
        room.add_receiver_sh(cfg.sh_order, p)
    room.compute_echograms(max_order=cfg.refl_order)
    rendered = room.render_rirs()
    L = max(r.shape[-1] for r in rendered.values())
    n_out = cfg.n_receivers * cfg.nsh
    H = np.zeros((n_out, cfg.n_sources, L), np.float32)
    for (rid, sid), r in rendered.items():
        H[rid * cfg.nsh:(rid + 1) * cfg.nsh, sid, : r.shape[-1]] = r
    return H


def _conv(cfg: AmbiRoomSimConfig, L: int) -> MatrixConv:
    return MatrixConv(hop=cfg.hop, length_h=L, n_in=cfg.n_sources,
                      n_out=cfg.n_receivers * cfg.nsh)


def design(cfg: AmbiRoomSimConfig, src_positions: np.ndarray,
           rec_positions: np.ndarray,
           abs_wall: np.ndarray = DEFAULT_ABS_WALL,
           device: torch.device | str | None = None) -> AmbiRoomSimWeights:
    """src_positions: (nSrc, 3); rec_positions: (nRec, 3) in room coords.
    Complex partition spectra on ``device`` (default: the card)."""
    H = rirs(cfg, src_positions, rec_positions, abs_wall)
    conv = _conv(cfg, H.shape[-1])
    return AmbiRoomSimWeights(Hf=conv.design(H, device), conv=conv)


def design_ri(cfg: AmbiRoomSimConfig, src_positions, rec_positions,
              abs_wall: np.ndarray = DEFAULT_ABS_WALL,
              device: torch.device | str | None = None) -> AmbiRoomSimWeights:
    """design() for the (re, im) path: the RIR partition spectra as a
    float32 pair; use with init_state_ri / process_ri."""
    H = rirs(cfg, src_positions, rec_positions, abs_wall)
    conv = _conv(cfg, H.shape[-1])
    return AmbiRoomSimWeights(Hf=conv.design_ri(H, device), conv=conv)


def weights_from_numpy(cfg: AmbiRoomSimConfig, Hf,
                       device: torch.device | str | None = None
                       ) -> AmbiRoomSimWeights:
    """Weights (e.g. the JAX package's) from numpy: ``Hf`` the (P, nOut,
    nSrc, hop+1) complex spectra or their (re, im) pair."""
    shape = (Hf[0] if isinstance(Hf, (tuple, list)) else Hf).shape
    return AmbiRoomSimWeights(Hf=design_from_numpy(Hf, device),
                              conv=_conv(cfg, shape[0] * cfg.hop))


def init_state_ri(cfg: AmbiRoomSimConfig, w: AmbiRoomSimWeights,
                  batch: tuple = (),
                  device: torch.device | str | None = None
                  ) -> MatrixConvState:
    return w.conv.init_state_ri(batch, device)


def process_ri(cfg: AmbiRoomSimConfig, w: AmbiRoomSimWeights,
               state: MatrixConvState, x: torch.Tensor):
    """process() on the (re, im) partitioned convolver: x (..., nSrc, T)
    → ((..., nRec·nSH, T), state)."""
    return w.conv.apply_block_ri(w.Hf, state, x)


def init_state(cfg: AmbiRoomSimConfig, w: AmbiRoomSimWeights,
               device: torch.device | str | None = None) -> MatrixConvState:
    return w.conv.init_state(device=device)


def process(cfg: AmbiRoomSimConfig, w: AmbiRoomSimWeights,
            state: MatrixConvState, x: torch.Tensor):
    """x: (nSrc, T) → ((nRec·nSH, T), state)."""
    return w.conv.apply_block(w.Hf, state, x)
