"""matrixconv / multiconv / tvconv example renderers (counterparts of
``spatial_audio_framework_tpu/models/conv_examples.py``;
``examples/src/{matrixconv,multiconv,tvconv}``).

The reference examples wrap the saf_utility_matrixConv engines in a FIFO
that re-frames arbitrary host buffer sizes into hops (matrixconv.c:132-146);
the block ops of ``ops/matrix_conv`` take any multiple of the hop, so these
wrappers add only the example-level configuration: filter loading, the
partitioning flag, and tvconv's listener position.  Plain torch: no kernel
serves these paths, as none does in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import f32_tensor
from spatial_audio_framework_tpu_torch.ops.matrix_conv import (MatrixConv,
                                                               MatrixConvState,
                                                               MultiConv,
                                                               TVConv,
                                                               TVConvState)


@dataclass(frozen=True)
class MatrixConvExample:
    """examples/src/matrixconv: nCHout×nCHin filter matrix convolver."""
    hop: int = 128
    partitioned: bool = True  # matrixconv.h enablePartitionedConv

    def _conv(self, H: np.ndarray) -> MatrixConv:
        n_out, n_in, L = H.shape
        return MatrixConv(hop=self.hop, length_h=L, n_in=n_in, n_out=n_out,
                          partitioned=self.partitioned)

    def design(self, H: np.ndarray,
               device: torch.device | str | None = None):
        conv = self._conv(H)
        return conv, conv.design(H, device)

    def init_state(self, conv: MatrixConv,
                   device: torch.device | str | None = None
                   ) -> MatrixConvState:
        return conv.init_state(device=device)

    def process(self, conv: MatrixConv, Hf, state, x):
        return conv.apply_block(Hf, state, x)

    # (re, im) form (partitioned mode: the RI path's assert fires for
    # partitioned=False instead of silently taking the default)
    def design_ri(self, H: np.ndarray,
                  device: torch.device | str | None = None):
        conv = self._conv(H)
        return conv, conv.design_ri(H, device)

    def init_state_ri(self, conv: MatrixConv, batch: tuple = (),
                      device: torch.device | str | None = None
                      ) -> MatrixConvState:
        return conv.init_state_ri(batch, device)

    def process_ri(self, conv: MatrixConv, H_ri, state, x):
        """x: (..., n_in, T); leading axes run independent instances."""
        return conv.apply_block_ri(H_ri, state, x)


@dataclass(frozen=True)
class MultiConvExample:
    """examples/src/multiconv: per-channel (no matrixing) convolver."""
    hop: int = 128
    partitioned: bool = True

    def _conv(self, H: np.ndarray) -> MultiConv:
        n_ch, L = H.shape
        return MultiConv(hop=self.hop, length_h=L, n_ch=n_ch,
                         partitioned=self.partitioned)

    def design(self, H: np.ndarray,
               device: torch.device | str | None = None):
        conv = self._conv(H)
        return conv, conv.design(H, device)

    def init_state(self, conv: MultiConv,
                   device: torch.device | str | None = None
                   ) -> MatrixConvState:
        return conv.init_state(device=device)

    def process(self, conv: MultiConv, Hf, state, x):
        return conv.apply_block(Hf, state, x)

    def design_ri(self, H: np.ndarray,
                  device: torch.device | str | None = None):
        conv = self._conv(H)
        return conv, conv.design_ri(H, device)

    def init_state_ri(self, conv: MultiConv, batch: tuple = (),
                      device: torch.device | str | None = None
                      ) -> MatrixConvState:
        return conv.init_state_ri(batch, device)

    def process_ri(self, conv: MultiConv, H_ri, state, x):
        return conv.apply_block_ri(H_ri, state, x)


@dataclass(frozen=True)
class TVConvExample:
    """examples/src/tvconv: time-varying convolver keyed on the listener's
    position.  The example maps a 3-D listener position onto the nearest
    stored position (tvconv_internal ``tvconv_findNearestNeigbour``); here
    that lookup is an ``argmin`` on the device, so positions stream per
    block without a host read."""
    hop: int = 128

    @staticmethod
    def _conv(irs: np.ndarray, hop: int) -> TVConv:
        n_pos, n_ch, L = irs.shape
        return TVConv(hop=hop, length_h=L, n_out=n_ch, n_irs=n_pos)

    def design(self, irs: np.ndarray, positions: np.ndarray,
               device: torch.device | str | None = None):
        """irs: (nPos, nCH, L); positions: (nPos, 3) → (conv, spectra,
        positions on the device)."""
        conv = self._conv(irs, self.hop)
        return conv, conv.design(irs, device), f32_tensor(positions, device)

    def init_state(self, conv: TVConv, init_idx: int = 0, batch: tuple = (),
                   device: torch.device | str | None = None) -> TVConvState:
        return conv.init_state(init_idx, batch, device)

    @staticmethod
    def nearest_position(positions: torch.Tensor,
                         listener_pos: torch.Tensor) -> torch.Tensor:
        """Nearest stored position: listener_pos (..., 3) → (...,) int32
        (``argmin`` on the device; the first of equal distances, as
        jnp.argmin)."""
        d = ((positions - listener_pos[..., None, :]) ** 2).sum(-1)
        return torch.argmin(d, dim=-1).to(torch.int32)

    def process(self, conv: TVConv, Hf, state: TVConvState, x: torch.Tensor,
                listener_pos: torch.Tensor, positions: torch.Tensor):
        """x: (..., T); listener_pos (..., 3) → ((..., nCH, T), state).
        Leading axes run independent instances (state from
        init_state(batch=...))."""
        idx = self.nearest_position(positions, listener_pos)
        n_hops = x.shape[-1] // self.hop
        return conv.apply_block(Hf, state, x,
                                idx[..., None].expand(idx.shape + (n_hops,)))

    def design_ri(self, irs: np.ndarray, positions: np.ndarray,
                  device: torch.device | str | None = None):
        conv = self._conv(irs, self.hop)
        return conv, conv.design_ri(irs, device), f32_tensor(positions, device)

    def init_state_ri(self, conv: TVConv, init_idx: int = 0,
                      batch: tuple = (),
                      device: torch.device | str | None = None
                      ) -> TVConvState:
        return conv.init_state_ri(init_idx, batch, device)

    def process_ri(self, conv: TVConv, H_ri, state: TVConvState,
                   x: torch.Tensor, listener_pos: torch.Tensor,
                   positions: torch.Tensor):
        """As :meth:`process` on the (re, im) form.  One position a call,
        so the const-index path (filters gathered once, the crossfade rows
        only at the block's start: ``apply_block_ri_const``)."""
        idx = self.nearest_position(positions, listener_pos)
        return conv.apply_block_ri_const(H_ri, state, x, idx)
