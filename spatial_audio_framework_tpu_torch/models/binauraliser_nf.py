"""binauraliser_nf — near-field binauraliser (counterpart of
``spatial_audio_framework_tpu/models/binauraliser_nf.py``;
``examples/src/binauraliser_nf``): the far-field binauraliser plus
per-source per-ear DVF high-shelf responses (``utils/dvf.py``) evaluated at
the band centre frequencies and applied as complex per-band gains
(binauraliser_nf.c:287-330).

Design and state are the binauraliser's.  ``process_ri_batched`` computes
the shelves per chunk on the device from per-(stream, source) distances, so
distances stream like directions do; the product of the interpolated HRTFs
and the DVF gains is the per-stream mixing matrix of
``ops/afstft_ri.render_tf_matrix_ri`` (``fused=True``: ``render_full_ri``
with per-stream taps up to 16 sources, the (d, g) pair above).  ``design``
/ ``init_state`` / ``process`` are one listener's complex entry points on
the same shelves and lookup (none of the kernels, as in the JAX package).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.models import binauraliser as B
from spatial_audio_framework_tpu_torch.models.binauraliser import (  # noqa: F401
    state_complex_from_numpy, state_from_numpy, weights_complex_from_numpy,
    weights_from_numpy)
from spatial_audio_framework_tpu_torch.ops import afstft_ri as ri
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFTState
from spatial_audio_framework_tpu_torch.utils import dvf as _dvf

@dataclass(frozen=True)
class BinauraliserNFConfig(B.BinauraliserConfig):
    head_radius: float = 0.09096        # binauraliser_nf.c:73
    # distances below this are clamped (the setter's floor, where the DVF
    # shelves stay stable — binauraliser_nf.c:77,378)
    nearfield_limit_m: float = 0.15

    @property
    def far_field_thresh_m(self) -> float:
        """Sources at/beyond this bypass the DVF entirely — derived from
        head_radius like the C (binauraliser_nf.c:75: head_radius·34)."""
        return self.head_radius * 34.0

    def __post_init__(self):
        C.validate_config(self)


def design_ri(cfg: BinauraliserNFConfig, *args, **kw) -> B.BinauraliserWeightsRI:
    """The binauraliser's design (same arguments, ``device=`` included)."""
    return B.design_ri(cfg, *args, **kw)


def init_state_batched(cfg: BinauraliserNFConfig, n_streams: int,
                       device: torch.device | str | None = None
                       ) -> ri.AfSTFTStateBatched:
    return B.init_state_batched(cfg, n_streams, device=device)


def _dvf_band_gains_ri(cfg: BinauraliserNFConfig, freqs: torch.Tensor,
                       src_dirs_deg: torch.Tensor,
                       src_dists_m: torch.Tensor):
    """Per-source per-ear band gains from the DVF shelves, in real
    arithmetic: H(e^{-jw}) = (b0 + b1 z)/(1 + a1 z), z = cos w − j sin w.
    src_dirs_deg (..., nSrc, 2), src_dists_m (..., nSrc) → (re, im), each
    (..., nBands, 2, nSrc).

    Mirrors the reference, including two quirks (binauraliser_nf.c:304-341):
    the per-band scale is (|H|, arg H) used as (re, im) — the C constructs
    cmplxf(dvfmags, dvfphases) despite its "apply magnitude & phase"
    comment — and sources at ≥ far_field_thresh_m bypass the DVF."""
    alpha_lr, _ = _dvf.doa_to_ipsi_interaural(src_dirs_deg[..., 0],
                                              src_dirs_deg[..., 1])
    # the C clamps the DISTANCE to nearfield_limit_m in its setter
    # (binauraliser_nf.c:378), not rho to 1
    src_dists_m = src_dists_m.clamp_min(cfg.nearfield_limit_m)
    rho = (src_dists_m / cfg.head_radius).clamp_min(1.0)[..., None]
    b, a = _dvf.calc_dvf_coeffs(alpha_lr, rho, cfg.fs)  # (..., nSrc, 2, 2)
    # bands ahead of (nSrc, 2): (..., nBands, nSrc, 2)
    b0, b1, a1 = (t[..., None, :, :] for t in (b[..., 0], b[..., 1],
                                               a[..., 1]))
    wv = 2.0 * math.pi * freqs / cfg.fs
    c = torch.cos(wv)[:, None, None]
    s = torch.sin(wv)[:, None, None]
    nr = b0 + b1 * c
    ni = -b1 * s
    dr = 1.0 + a1 * c
    di = -a1 * s
    d2 = dr * dr + di * di
    Hre = (nr * dr + ni * di) / d2
    Him = (ni * dr - nr * di) / d2
    mag = torch.sqrt(Hre * Hre + Him * Him)
    ph = torch.atan2(Him, Hre)
    far = (src_dists_m >= cfg.far_field_thresh_m)[..., None, :, None]
    mag = torch.where(far, 1.0, mag)
    ph = torch.where(far, 0.0, ph)
    return mag.transpose(-1, -2), ph.transpose(-1, -2)


def process_ri_batched(cfg: BinauraliserNFConfig, w: B.BinauraliserWeightsRI,
                       state: ri.AfSTFTStateBatched, x: torch.Tensor,
                       src_dirs_deg: torch.Tensor, src_dists_m: torch.Tensor,
                       src_gains: Optional[torch.Tensor] = None,
                       ypr: Optional[torch.Tensor] = None,
                       fused: bool = True):
    """Stream-batched near-field binauraliser: x (S, nSrc, T), src_dirs_deg
    (S, nSrc, 2), src_dists_m (S, nSrc) metres, src_gains (S, nSrc) or
    None, ypr (S, 3) or None (used when ``cfg.enable_rotation``)
    → ((S, 2, T), state).  Every input lies on the weights' device; w from
    :func:`design_ri`.  Distances are head-centric: rotation moves the
    directions only."""
    if src_gains is not None:
        x = x * src_gains[..., None]
    if cfg.enable_rotation and ypr is not None:
        src_dirs_deg = B.rotate_dirs(src_dirs_deg, ypr)
    Are, Aim = B.interp_hrtfs_ri(cfg, w, src_dirs_deg)  # (S, nBands, 2, nSrc)
    Bre, Bim = _dvf_band_gains_ri(cfg, w.freqs, src_dirs_deg, src_dists_m)
    Hre = Are * Bre - Aim * Bim
    Him = Are * Bim + Aim * Bre
    y, state = ri.render_tf_matrix_ri(cfg.afstft, state, x, Hre, Him,
                                      fused=fused)
    return y / math.sqrt(cfg.n_sources), state


def design(cfg: BinauraliserNFConfig, *args, **kw) -> B.BinauraliserWeights:
    """The binauraliser's complex design (same arguments)."""
    return B.design(cfg, *args, **kw)


def init_state(cfg: BinauraliserNFConfig,
               device: torch.device | str | None = None) -> AfSTFTState:
    return B.init_state(cfg, device=device)


def _dvf_band_gains(cfg: BinauraliserNFConfig, freqs: torch.Tensor,
                    src_dirs_deg: torch.Tensor,
                    src_dists_m: torch.Tensor) -> torch.Tensor:
    """:func:`_dvf_band_gains_ri` as one complex tensor (nBands, 2, nSrc):
    the reference's scale |H| + j·arg H."""
    return torch.complex(*_dvf_band_gains_ri(cfg, freqs, src_dirs_deg,
                                             src_dists_m))


def process(cfg: BinauraliserNFConfig, w: B.BinauraliserWeights,
            state: AfSTFTState, x: torch.Tensor, src_dirs_deg: torch.Tensor,
            src_dists_m: torch.Tensor,
            src_gains: Optional[torch.Tensor] = None,
            ypr: Optional[torch.Tensor] = None):
    """One listener's block: x (nSrc, T), src_dirs_deg (nSrc, 2),
    src_dists_m (nSrc,) metres, on the weights' device → ((2, T), state)."""
    if src_gains is not None:
        x = x * src_gains[:, None]
    if cfg.enable_rotation and ypr is not None:
        src_dirs_deg = B.rotate_dirs(src_dirs_deg, ypr)
    H = B.interp_hrtfs(cfg, w, src_dirs_deg)            # (nBands, 2, nSrc)
    H = H * _dvf_band_gains(cfg, w.freqs, src_dirs_deg, src_dists_m)
    return B.mix_complex(cfg.afstft, state, x, H,
                         1.0 / math.sqrt(cfg.n_sources))
