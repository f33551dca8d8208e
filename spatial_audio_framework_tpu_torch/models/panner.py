"""panner — frequency-dependent VBAP loudspeaker panner (counterpart of
``spatial_audio_framework_tpu/models/panner.py``;
``examples/src/panner``).

``design`` builds the VBAP gain table on the host (1°×1° by default, with
omitLargeTriangles and dummies, panner_internal.c:77-82; a planar layout
takes the 2-D pairwise table, :62-95) and the per-band p-value exponents
(Laitinen et al. 2014), and puts both on the device.
``process_ri_batched`` renders a chunk for many streams at once, all on the
device: optional rotation of the source directions (one rotation matrix
per stream), nearest-grid lookup of each source's gains, per-band p-norm
renormalisation, then the real per-stream gain matrices as the mixing
matrices of ``ops/afstft_ri.render_tf_matrix_ri`` scaled by 1/√nSrc
(panner.c:212-314).  With ``fused=True`` up to 16 sources run the one-pass
``render_full_ri`` kernel with per-stream taps.

``weights_from_numpy`` takes the JAX package's ``PannerWeights`` as numpy
arrays, so both packages can run on identical tables; the batched state
goes through ``state_from_numpy``.  ``init_state`` / ``process`` pan one
stream's block on the complex ``AfSTFT`` with the same lookup and p-norm
(none of the kernels, as in the JAX package); their state goes through
``state_complex_from_numpy``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import f32_tensor
from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.models.binauraliser import (  # noqa: F401
    mix_complex, rotate_dirs, state_complex_from_numpy, state_from_numpy)
from spatial_audio_framework_tpu_torch.modules import vbap
from spatial_audio_framework_tpu_torch.ops import afstft_ri as ri
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT, AfSTFTState


@dataclass(frozen=True)
class PannerConfig:
    n_sources: int = 1
    n_loudspeakers: int = 2
    fs: float = 48000.0
    dtt: float = 0.5                  # panner.c:58 (0: anechoic .. 1: room)
    spread_deg: float = 0.0
    azi_res: int = 1                  # panner_internal.c:77-78
    elev_res: int = 1
    hop: int = 128

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True)

    def __post_init__(self):
        C.validate_config(self)


class PannerWeights(NamedTuple):
    """The design as float32 tensors on one device."""
    gtable: torch.Tensor      # (nElev*nAzi, nLS), or (nAzi, nLS) if planar
    p_values: torch.Tensor    # (nBands,)


def weights_from_numpy(gtable, p_values,
                       device: torch.device | str | None = None
                       ) -> PannerWeights:
    """Weights from numpy arrays (e.g. the fields of the JAX package's
    ``PannerWeights``) → tensors on ``device`` (default: the card)."""
    return PannerWeights(gtable=f32_tensor(gtable, device),
                         p_values=f32_tensor(p_values, device))


def design(cfg: PannerConfig, ls_dirs_deg: np.ndarray,
           device: torch.device | str | None = None) -> PannerWeights:
    """Gain table and p-values for a loudspeaker layout (nLS, 2) [azi,
    elev] degrees → weights on ``device``."""
    ls = np.asarray(ls_dirs_deg, np.float64)
    # dimensionality: planar layouts (sum |elev| < 0.01) take the 2-D
    # pairwise tangent-law path (panner_internal.c:62-95); _table_lookup
    # dispatches on the table's row count
    if np.abs(ls[:, 1]).sum() < 0.01:
        gtable = vbap.generate_vbap_gain_table_2d(ls, cfg.azi_res)
    else:
        gtable = vbap.generate_vbap_gain_table_3d(
            ls, cfg.azi_res, cfg.elev_res,
            omit_large_triangles=True, enable_dummies=True,
            spread=cfg.spread_deg)
    p = vbap.get_p_values(cfg.dtt, cfg.afstft.centre_freqs(cfg.fs))
    return weights_from_numpy(gtable, p, device)


def init_state_batched(cfg: PannerConfig, n_streams: int, n_ls: int,
                       device: torch.device | str | None = None
                       ) -> ri.AfSTFTStateBatched:
    return ri.init_state_batched(cfg.afstft, n_streams, cfg.n_sources, n_ls,
                                 device=device)


def _table_lookup(cfg: PannerConfig, gtable: torch.Tensor,
                  dirs_deg: torch.Tensor) -> torch.Tensor:
    """Nearest-grid lookup (panner.c:242-246 / :282-284 for the 2-D table):
    dirs_deg (..., nSrc, 2) → gains (..., nSrc, nLS).  Table rows are
    elevation-major with azimuths -180..180; a 2-D table (row count ==
    nAzi) is azimuth-only.  The row goes through
    :func:`models._common.table_row`: a direction outside the table gets
    NaN gains, as ``jnp.take`` fills them, and no direction can raise."""
    n_azi = int(360.0 / cfg.azi_res + 0.5) + 1
    row = C.round_half_up(
        torch.remainder(dirs_deg[..., 0] + 180.0, 360.0) / cfg.azi_res)
    if gtable.shape[0] != n_azi:      # 3-D table
        elev_idx = C.round_half_up((dirs_deg[..., 1] + 90.0) / cfg.elev_res)
        row = elev_idx * n_azi + row
    row, outside = C.table_row(row, gtable.shape[0])
    return torch.where(outside[..., None], math.nan, gtable[row])


def process_ri_batched(cfg: PannerConfig, weights: PannerWeights,
                       state: ri.AfSTFTStateBatched, x: torch.Tensor,
                       src_dirs_deg: torch.Tensor,
                       ypr: Optional[torch.Tensor] = None,
                       fused: bool = True):
    """Stream-batched process: x (S, nSrc, T), src_dirs_deg (S, nSrc, 2),
    ypr (S, 3) or None → ((S, nLS, T), state).  Every input lies on the
    weights' device.

    The frequency-dependent VBAP gains (real, per band) are the per-stream
    mixing matrices of :func:`ops.afstft_ri.render_tf_matrix_ri`:
    ``fused=True`` runs its kernel route, ``fused=False`` its plain path."""
    G = _band_gains(cfg, weights, src_dirs_deg, ypr)
    # G: (S, nBands, nSrc, nLS) → mixing (S, nBands, nLS, nSrc);
    # 1/sqrt(nSources) master scaling (panner.c:312-314)
    G = (G.transpose(-1, -2) / math.sqrt(cfg.n_sources)).contiguous()
    return ri.render_tf_matrix_ri(cfg.afstft, state, x, G, None, fused=fused)


def _band_gains(cfg: PannerConfig, weights: PannerWeights,
                src_dirs_deg: torch.Tensor,
                ypr: Optional[torch.Tensor]) -> torch.Tensor:
    """Optional rotation, table lookup and the per-band p-norm: src_dirs_deg
    (..., nSrc, 2), ypr (..., 3) or None → gains (..., nBands, nSrc, nLS)."""
    if ypr is not None:
        src_dirs_deg = rotate_dirs(src_dirs_deg, ypr)  # rows × Rzyx (c:220)
    g = _table_lookup(cfg, weights.gtable, src_dirs_deg)[..., None, :, :]
    p = weights.p_values
    # a source whose gains are all zero has norm 0 and keeps the JAX
    # package's g / 2.23e-9
    gp = g.clamp_min(0.0) ** p[:, None, None]
    norm = gp.sum(-1) ** (1.0 / (p[:, None] + 2.23e-9))
    return torch.where((torch.abs(p - 2.0) > 1e-6)[:, None, None],
                       g / (norm[..., None] + 2.23e-9), g)


def init_state(cfg: PannerConfig,
               device: torch.device | str | None = None) -> AfSTFTState:
    return cfg.afstft.init_state(cfg.n_sources, cfg.n_loudspeakers,
                                 device=device)


def process(cfg: PannerConfig, weights: PannerWeights, state: AfSTFTState,
            x: torch.Tensor, src_dirs_deg: torch.Tensor,
            ypr: Optional[torch.Tensor] = None):
    """One stream's block: x (nSrc, T), src_dirs_deg (nSrc, 2) degrees, ypr
    (3,) radians or None, on the weights' device → ((nLS, T), state)."""
    G = _band_gains(cfg, weights, src_dirs_deg, ypr)  # (nBands, nSrc, nLS)
    return mix_complex(cfg.afstft, state, x, G.transpose(-1, -2),
                       1.0 / math.sqrt(cfg.n_sources))
