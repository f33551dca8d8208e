"""roombinauraliser — multi-source BRIR renderer (counterpart of
``spatial_audio_framework_tpu/models/roombinauraliser.py``; the fork's
``examples/src/roombinauraliser``).

Renders each input source through its own set of binaural room impulse
responses (BRIRs, one grid of 2-ear IRs per source), with
head-rotation-driven interpolation over the BRIR measurement grid.

``design_ri`` runs on the host (roombinauraliser_internal.c:129-446
``initHRTFsAndGainTables``): per-source ITDs (on 1000-tap truncations) →
optional resampling → a 2°×5° compressed VBAP interpolation table over the
grid (a 2-D pairwise table when the grid has no elevation diversity,
:327-345) → afSTFT-domain BRTFs → optional diffuse-field EQ, one of three
modes (roombinauraliser.h:62-72):

* ``DIFF_EQ_FABIAN_CTF`` — every band times the filterbank coefficients of
  the FABIAN dummy-head common transfer function (``data/fabian_ctf.npz``;
  roombinauraliser_internal.c:372-396);
* ``DIFF_EQ_BRIR_CTF`` — diffuse-field equalisation computed from the
  loaded BRIR data itself, Voronoi-weighted when the grid is small enough
  (:398-436);
* ``DIFF_EQ_OWN_FILTER`` — a user-supplied CTF impulse response, applied
  like the FABIAN filter;

then puts every table on the device.  ``process_ri_batched``
(roombinauraliser.c:196-289) renders a chunk for many streams at once, all
on the device: per-source gains (solo and mute are gain vectors) → the
fixed reference frame [1, 0, 0] rotated by each stream's head rotation →
ALL sources' BRTFs interpolated at that one direction per stream (BRIRs
bake in the true source positions, so only listener rotation moves the
lookup) → the per-stream mixing matrices of
``ops/afstft_ri.render_tf_matrix_ri``, scaled by 1/√nSrc.  With
``fused=True`` up to 16 sources run ``render_full_ri`` with per-stream
taps, more the (d, g) pair.

``weights_from_numpy`` takes the JAX package's ``design_ri`` weights as
numpy arrays; the batched state goes through ``state_from_numpy``.
``design`` / ``init_state`` / ``interp_hrtfs`` / ``process`` are one
listener's complex entry points on the same lookup (the complex ``AfSTFT``,
none of the kernels, as in the JAX package), with
``weights_complex_from_numpy`` / ``state_complex_from_numpy`` for the JAX
package's weights and state.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import (data_path, default_device,
                                               f32_tensor)
from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.models.binauraliser import (  # noqa: F401
    mix_complex, state_complex_from_numpy, state_from_numpy)
from spatial_audio_framework_tpu_torch.modules import hrir as hrir_mod, vbap
from spatial_audio_framework_tpu_torch.ops import afstft_ri as ri
from spatial_audio_framework_tpu_torch.ops.afstft import (
    AfSTFT, AfSTFTState, fir_to_filterbank_coeffs)
from spatial_audio_framework_tpu_torch.utils import geometry as geo

INTERP_TRI = "tri"
INTERP_TRI_PS = "tri_ps"

# DIFF_EQ_MODES (roombinauraliser.h:68-72)
DIFF_EQ_FABIAN_CTF = "fabian_ctf"
DIFF_EQ_BRIR_CTF = "brir_ctf"
DIFF_EQ_OWN_FILTER = "own_filter"

# REINIT_MODES (roombinauraliser.h:75-80): granularity hints for re-running
# design(); a full re-run is always correct, the names are kept for parity
REINIT_NONE = "none"
REINIT_RESAMPLE = "resample"
REINIT_FULL = "full"


@dataclass(frozen=True)
class RoomBinauraliserConfig:
    n_sources: int = 1
    fs: float = 48000.0
    interp_mode: str = INTERP_TRI
    enable_rotation: bool = True
    enable_hrir_diff_eq: bool = True
    diff_eq_mode: str = DIFF_EQ_BRIR_CTF
    hop: int = 128
    azi_res: int = 2                 # roombinauraliser_internal.c:320-321
    elev_res: int = 5
    vbap_3d: bool = True             # set by design_ri from the grid's extent
    # roombinauraliser_setEnablePartConv (roombinauraliser.h:192): stored
    # but never read by the reference's processing path; kept for API
    # parity with identical (non-)behaviour
    enable_part_conv: bool = False

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True)

    def __post_init__(self):
        C.validate_config(self)


class RoomBinauraliserWeightsRI(NamedTuple):
    """The design as float32 tensors (the indices int64) on one device; the
    BRTF filterbank split into (re, im)."""
    hrtf_re: torch.Tensor    # (nSrc, nBands, 2, nDirs)
    hrtf_im: torch.Tensor
    hrtf_mag: torch.Tensor
    itds: torch.Tensor       # (nSrc, nDirs) seconds
    table_w: torch.Tensor    # (nTable, 3) interpolation weights
    table_idx: torch.Tensor  # (nTable, 3) grid indices
    freqs: torch.Tensor      # (nBands,)


class RoomBinauraliserWeights(NamedTuple):
    """The design with the BRTF filterbank complex, for :func:`process`."""
    hrtf_fb: torch.Tensor    # (nSrc, nBands, 2, nDirs) complex64
    hrtf_mag: torch.Tensor   # (nSrc, nBands, 2, nDirs)
    itds: torch.Tensor       # (nSrc, nDirs)
    table_w: torch.Tensor    # (nTable, 3)
    table_idx: torch.Tensor  # (nTable, 3)
    freqs: torch.Tensor      # (nBands,)

    def as_ri(self) -> RoomBinauraliserWeightsRI:
        """The same tables with the filterbank as (re, im) views."""
        return RoomBinauraliserWeightsRI(self.hrtf_fb.real, self.hrtf_fb.imag,
                                         *self[1:])


def fabian_ctf_ir() -> np.ndarray:
    """The FABIAN dummy-head CTF impulse response (256 taps @48 kHz,
    roombinauraliser_internal.h:192 ``fabian_ir``)."""
    with np.load(data_path("fabian_ctf.npz")) as z:
        return z["cir"].astype(np.float32)


def _ctf_filterbank(ir: np.ndarray, hop: int) -> np.ndarray:
    """CTF IR → per-band complex coeffs (nBands,)
    (roombinauraliser_internal.c:384)."""
    return fir_to_filterbank_coeffs(
        np.asarray(ir, np.float32)[None, None, :], hop)[:, 0, 0]


def _design_host(cfg: RoomBinauraliserConfig, brirs, brir_dirs_deg, brir_fs,
                 own_ctf_ir, sofa_filepath=None):
    """Host-side codec init → (cfg', hrtf_fb (nSrc, nBands, 2, nDirs)
    complex, itds (nSrc, nDirs), compressed table weights, table indices,
    band frequencies)."""
    if brirs is None:
        # a SOFA file tiled across sources, or the reference's fallback:
        # the default HRIR set (roombinauraliser_internal.c:154-158)
        h, brir_dirs_deg, brir_fs, _ = hrir_mod.load_hrirs(sofa_filepath)
        brirs = np.broadcast_to(h, (cfg.n_sources,) + h.shape)
    brirs = np.asarray(brirs, np.float32)
    if brirs.shape[0] != cfg.n_sources:
        raise ValueError(f"expected {cfg.n_sources} BRIR sets, "
                         f"got {brirs.shape[0]}")
    # wrap azimuths to -180..180 (roombinauraliser_internal.c:253)
    brir_dirs_deg = np.array(brir_dirs_deg, np.float64, copy=True)
    brir_dirs_deg[:, 0] = (brir_dirs_deg[:, 0] + 180.0) % 360.0 - 180.0
    n_dirs = brir_dirs_deg.shape[0]

    # per-source ITDs on 1000-tap truncations, before any resampling
    # (roombinauraliser_internal.c:263)
    itds = np.stack([hrir_mod.estimate_itds(brirs[s, :, :, :1000], brir_fs)
                     for s in range(cfg.n_sources)])

    if brir_fs != cfg.fs:
        brirs = np.stack([
            hrir_mod.resample_hrirs(brirs[s], brir_fs, int(cfg.fs))[0]
            for s in range(cfg.n_sources)])

    # 2-D vs 3-D interpolation table (roombinauraliser_internal.c:327-345)
    elev = brir_dirs_deg[:, 1]
    vbap_3d = bool(abs(elev.max() - elev.min()) / 180.0 >= 1e-6)
    if vbap_3d:
        gtable = vbap.generate_vbap_gain_table_3d(
            brir_dirs_deg, cfg.azi_res, cfg.elev_res,
            omit_large_triangles=True, enable_dummies=False)
    else:
        gtable = vbap.generate_vbap_gain_table_2d(brir_dirs_deg, cfg.azi_res)
    comp, idx = vbap.compress_vbap_gain_table_3d(gtable)
    cfg = replace(cfg, vbap_3d=vbap_3d)

    # BRIRs → afSTFT-domain coefficients (roombinauraliser_internal.c:365-368)
    hrtf_fb = np.stack([hrir_mod.hrirs_to_hrtfs_afstft(brirs[s], cfg.hop)
                        for s in range(cfg.n_sources)])
    freqs = cfg.afstft.centre_freqs(cfg.fs)

    if cfg.enable_hrir_diff_eq:
        if cfg.diff_eq_mode in (DIFF_EQ_FABIAN_CTF, DIFF_EQ_OWN_FILTER):
            ir = (fabian_ctf_ir() if cfg.diff_eq_mode == DIFF_EQ_FABIAN_CTF
                  else np.asarray(own_ctf_ir, np.float32))
            ctf = _ctf_filterbank(ir, cfg.hop)          # (nBands,)
            hrtf_fb = hrtf_fb * ctf[None, :, None, None]
        elif cfg.diff_eq_mode == DIFF_EQ_BRIR_CTF:
            weights = (geo.get_voronoi_weights(brir_dirs_deg)
                       if (vbap_3d and n_dirs <= 3600) else None)
            hrtf_fb = np.stack([
                hrir_mod.diffuse_field_equalise_hrtfs(
                    hrtf_fb[s], itds[s], freqs, weights,
                    apply_eq=True, apply_phase=False)
                for s in range(cfg.n_sources)])
        else:
            raise ValueError(f"unknown diff_eq_mode {cfg.diff_eq_mode!r}")
    return cfg, hrtf_fb, itds, comp, idx, freqs


def weights_from_numpy(hrtf_re, hrtf_im, hrtf_mag, itds, table_w, table_idx,
                       freqs, device: torch.device | str | None = None
                       ) -> RoomBinauraliserWeightsRI:
    """Weights from numpy arrays (e.g. the fields of the JAX package's
    ``RoomBinauraliserWeightsRI``) → tensors on ``device`` (default: the
    card)."""
    device = default_device() if device is None else device
    return RoomBinauraliserWeightsRI(
        hrtf_re=f32_tensor(hrtf_re, device), hrtf_im=f32_tensor(hrtf_im, device),
        hrtf_mag=f32_tensor(hrtf_mag, device), itds=f32_tensor(itds, device),
        table_w=f32_tensor(table_w, device),
        table_idx=torch.tensor(np.asarray(table_idx, np.int64), device=device),
        freqs=f32_tensor(freqs, device))


def weights_complex_from_numpy(hrtf_re, hrtf_im, hrtf_mag, itds, table_w,
                               table_idx, freqs,
                               device: torch.device | str | None = None
                               ) -> RoomBinauraliserWeights:
    """:func:`weights_from_numpy` for the complex entry points (the complex
    filterbank as its (re, im) numpy parts)."""
    w = weights_from_numpy(hrtf_re, hrtf_im, hrtf_mag, itds, table_w,
                           table_idx, freqs, device)
    return RoomBinauraliserWeights(torch.complex(w.hrtf_re, w.hrtf_im),
                                   *w[2:])


def design(cfg: RoomBinauraliserConfig, brirs=None, brir_dirs_deg=None,
           brir_fs=None, own_ctf_ir=None, reinit: str = REINIT_FULL,
           sofa_filepath: Optional[str] = None,
           device: torch.device | str | None = None
           ) -> Tuple[RoomBinauraliserConfig, RoomBinauraliserWeights]:
    """:func:`design_ri` with the filterbank complex, for :func:`process`.
    With no ``brirs``, ``sofa_filepath`` (if given) is loaded and tiled
    across sources; an unloadable file falls back, with a warning, to the
    default HRIR set.  ``reinit`` is accepted for parity: the whole design
    always runs."""
    del reinit
    cfg, hrtf_fb, itds, comp, idx, freqs = _design_host(
        cfg, brirs, brir_dirs_deg, brir_fs, own_ctf_ir, sofa_filepath)
    return cfg, weights_complex_from_numpy(
        hrtf_fb.real, hrtf_fb.imag, np.abs(hrtf_fb), itds, comp, idx, freqs,
        device)


def design_ri(cfg: RoomBinauraliserConfig, brirs=None, brir_dirs_deg=None,
              brir_fs=None, own_ctf_ir=None,
              device: torch.device | str | None = None
              ) -> Tuple[RoomBinauraliserConfig, RoomBinauraliserWeightsRI]:
    """Codec init → (cfg', weights on ``device``).  brirs: (nSrc, nDirs, 2,
    irLen), one BRIR grid per source, with its directions (nDirs, 2)
    degrees and sample rate; None takes the default HRIR set for every
    source.  cfg' has ``vbap_3d`` resolved from the grid's elevation
    extent."""
    cfg, hrtf_fb, itds, comp, idx, freqs = _design_host(
        cfg, brirs, brir_dirs_deg, brir_fs, own_ctf_ir)
    return cfg, weights_from_numpy(hrtf_fb.real, hrtf_fb.imag,
                                   np.abs(hrtf_fb), itds, comp, idx, freqs,
                                   device)


def solo_gains(n_sources: int, src_idx: Optional[int]) -> np.ndarray:
    """Gain vector for soloing one source / un-soloing (src_idx None)
    (roombinauraliser_setSourceSolo/setUnSolo, roombinauraliser.c:452-469)."""
    if src_idx is None:
        return np.ones(n_sources, np.float32)
    g = np.zeros(n_sources, np.float32)
    g[src_idx] = 1.0
    return g


def mute_gains(gains: np.ndarray, src_idx: int, mute: bool) -> np.ndarray:
    """Mute/unmute one source in a gain vector
    (roombinauraliser_setSourceMute, roombinauraliser.c:445-450)."""
    g = np.asarray(gains, np.float32).copy()
    g[src_idx] = 0.0 if mute else 1.0
    return g


def rotation_lookup_dir(ypr: torch.Tensor) -> torch.Tensor:
    """Head rotation ypr (..., 3) radians → grid-lookup direction (..., 2)
    [azi, elev] degrees on ypr's device: the fixed reference frame
    [1, 0, 0] as a row vector times Rzyx (roombinauraliser.c:239-249)."""
    v = geo.yaw_pitch_roll2_rzyx_torch(ypr)[..., 0, :]
    hyp = torch.sqrt(v[..., 0] ** 2 + v[..., 1] ** 2)
    return torch.rad2deg(torch.stack([torch.atan2(v[..., 1], v[..., 0]),
                                      torch.atan2(v[..., 2], hyp)], dim=-1))


def interp_hrtfs_ri(cfg: RoomBinauraliserConfig, w: RoomBinauraliserWeightsRI,
                    rot_deg: torch.Tensor):
    """Every source's BRTF set interpolated at ONE direction per stream
    (roombinauraliser_interpHRTFs, roombinauraliser_internal.c:46-127) in
    split real/imaginary arithmetic on the weights' device: rot_deg
    (..., 2) [azi, elev] degrees → (Hre, Him), each (..., nSrc, nBands, 2).

    The table row goes through :func:`models._common.table_row` (a NaN row
    is row 0, a negative row counts from the table's end, a row outside
    the table gives NaN weights, as the JAX package's ``jnp.take``), and
    every gather index is clamped into its table."""
    n_azi = int(360.0 / cfg.azi_res + 0.5) + 1
    n_dirs = w.hrtf_re.shape[-1]
    row = C.round_half_up(
        torch.remainder(rot_deg[..., 0] + 180.0, 360.0) / cfg.azi_res)
    if cfg.vbap_3d:    # a 2-D table has one elevation row
        # (roombinauraliser_internal.c:69-70)
        row = C.round_half_up((rot_deg[..., 1] + 90.0) / cfg.elev_res) \
            * n_azi + row
    row, outside = C.table_row(row, w.table_w.shape[0])
    # index_select, not table[row]: for one listener ``row`` is 0-dim, and
    # indexing by a 0-dim tensor reads it back to the host
    flat = row.reshape(-1)
    w3 = torch.where(outside[..., None], math.nan,
                     w.table_w.index_select(0, flat).reshape(row.shape + (3,)))
    i3 = w.table_idx.index_select(0, flat).reshape(
        row.shape + (3,)).clamp(0, n_dirs - 1)                      # (..., 3)
    w3b = w3[..., None, None, None, :]               # over (nSrc, nBands, 2)

    def gather(table):   # (nSrc, nBands, 2, nDirs) → (..., nSrc, nBands, 2, 3)
        return table[..., i3].movedim((0, 1, 2), (-4, -3, -2))

    if cfg.interp_mode == INTERP_TRI:
        return ((gather(w.hrtf_re) * w3b).sum(-1),
                (gather(w.hrtf_im) * w3b).sum(-1))
    # TRI_PS: interpolate magnitudes and ITDs, synthesise the IPD below
    # 1.5 kHz
    mag = (gather(w.hrtf_mag) * w3b).sum(-1)         # (..., nSrc, nBands, 2)
    itd = (w.itds[:, i3].movedim(0, -2) * w3[..., None, :]).sum(-1)
    ipd = (torch.remainder(2.0 * math.pi * w.freqs * itd[..., None] + math.pi,
                           2.0 * math.pi) - math.pi) / 2.0
    ipd = torch.where(w.freqs < 1.5e3, ipd, 0.0)     # (..., nSrc, nBands)
    phase = torch.stack([ipd, -ipd], dim=-1)
    return mag * torch.cos(phase), mag * torch.sin(phase)


def init_state_batched(cfg: RoomBinauraliserConfig, n_streams: int,
                       device: torch.device | str | None = None
                       ) -> ri.AfSTFTStateBatched:
    return ri.init_state_batched(cfg.afstft, n_streams, cfg.n_sources,
                                 C.NUM_EARS, device=device)


def process_ri_batched(cfg: RoomBinauraliserConfig,
                       w: RoomBinauraliserWeightsRI,
                       state: ri.AfSTFTStateBatched, x: torch.Tensor,
                       src_gains: Optional[torch.Tensor] = None,
                       ypr: Optional[torch.Tensor] = None,
                       fused: bool = True):
    """Stream-batched process: x (S, nSrc, T), src_gains (S, nSrc) or None,
    ypr (S, 3) or None (used when ``cfg.enable_rotation``) → ((S, 2, T),
    state).  Every input lies on the weights' device.  With no rotation
    the lookup direction is (0, 0)."""
    S = x.shape[0]
    if src_gains is not None:
        x = x * src_gains[..., None]
    if cfg.enable_rotation and ypr is not None:
        rot_deg = rotation_lookup_dir(ypr)               # (S, 2)
    else:
        rot_deg = torch.zeros((S, 2), dtype=x.dtype, device=x.device)
    Hre, Him = interp_hrtfs_ri(cfg, w, rot_deg)
    # (S, nSrc, nBands, 2) → per-stream mixing (S, nBands, 2, nSrc)
    y, state = ri.render_tf_matrix_ri(cfg.afstft, state, x,
                                      Hre.movedim(1, -1), Him.movedim(1, -1),
                                      fused=fused)
    return y / math.sqrt(cfg.n_sources), state


def init_state(cfg: RoomBinauraliserConfig,
               device: torch.device | str | None = None) -> AfSTFTState:
    return cfg.afstft.init_state(cfg.n_sources, C.NUM_EARS, device=device)


def interp_hrtfs(cfg: RoomBinauraliserConfig, w: RoomBinauraliserWeights,
                 rot_deg: torch.Tensor) -> torch.Tensor:
    """:func:`interp_hrtfs_ri` as one complex tensor: rot_deg (2,) [azi,
    elev] degrees → (nSrc, nBands, 2) complex64."""
    return torch.complex(*interp_hrtfs_ri(cfg, w.as_ri(), rot_deg))


def process(cfg: RoomBinauraliserConfig, w: RoomBinauraliserWeights,
            state: AfSTFTState, x: torch.Tensor,
            src_gains: Optional[torch.Tensor] = None,
            ypr: Optional[torch.Tensor] = None):
    """One listener's block (roombinauraliser.c:196-289): x (nSrc, T),
    src_gains (nSrc,) or None, ypr (3,) radians or None (used when
    ``cfg.enable_rotation``), on the weights' device → ((2, T), state)."""
    if src_gains is not None:
        x = x * src_gains[:, None]
    if cfg.enable_rotation and ypr is not None:
        rot_deg = rotation_lookup_dir(ypr)
    else:
        rot_deg = torch.zeros(2, dtype=x.dtype, device=x.device)
    H = interp_hrtfs(cfg, w, rot_deg)                # (nSrc, nBands, 2)
    return mix_complex(cfg.afstft, state, x, H.permute(1, 2, 0),
                       1.0 / math.sqrt(cfg.n_sources))
