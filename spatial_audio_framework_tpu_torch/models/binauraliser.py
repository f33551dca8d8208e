"""binauraliser — multi-source HRTF renderer (counterpart of
``spatial_audio_framework_tpu/models/binauraliser.py``;
``examples/src/binauraliser``).

``design_ri`` runs the initCodec pipeline on the host (binauraliser_
internal.c:186-249): HRIRs (the default set, or a SOFA file with the
reference's fallback to the default set) → ITDs → afSTFT-domain HRTFs
(+ diffuse-field EQ) and a compressed 2°×5° VBAP interpolation table over
the HRTF grid, then puts every table on the device.  ``process_ri_batched``
renders a chunk for many streams at once, all on the device: per-source
gains, optional head-tracked rotation of the source directions (one
rotation matrix per stream), per-source HRTF interpolation (complex 'tri'
or magnitude/ITD phase-synthesis 'tri_ps'), then the per-stream HRTFs as
the mixing matrices of ``ops/afstft_ri.render_tf_matrix_ri``, scaled by
1/√nSrc (binauraliser.c:191-275).  With ``fused=True`` at hop 128 the
rotation, the interpolation and the collapse to decode taps are one kernel,
``hrtf_taps_ri``, whose taps up to 16 sources feed the one-pass
``render_full_ri`` kernel and more the two-kernel ``analysis_front_dg_ri``
→ ``render_decode_synthesis_dg_ri`` pipeline.

``weights_from_numpy`` / ``state_from_numpy`` take the JAX package's
``design_ri`` weights and batched state as numpy arrays, so both packages
can run on identical inputs.

``design`` / ``init_state`` / ``process`` are the single-stream complex
entry points (one listener, the complex ``AfSTFT``, none of the kernels, as
in the JAX package); they share the lookup, the rotation and the
interpolation with the batched path, and ``weights_complex_from_numpy`` /
``state_complex_from_numpy`` take the JAX package's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import default_device, f32_tensor
from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.modules import hrir as hrir_mod, vbap
from spatial_audio_framework_tpu_torch.ops import afstft, afstft_ri as ri
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT, AfSTFTState
from spatial_audio_framework_tpu_torch.ops.afstft_kernels import (
    _KERNEL_HOP, _check_hop, _check_inputs, decode_taps, kernel)
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul
from spatial_audio_framework_tpu_torch.utils import geometry as geo
from spatial_audio_framework_tpu_torch.utils.profiling import spanned

INTERP_TRI = "tri"
INTERP_TRI_PS = "tri_ps"

@dataclass(frozen=True)
class BinauraliserConfig:
    n_sources: int = 1
    fs: float = 48000.0
    interp_mode: str = INTERP_TRI
    enable_rotation: bool = False
    enable_hrir_diff_eq: bool = True
    hop: int = 128
    azi_res: int = 2                 # binauraliser_internal.c:210-211
    elev_res: int = 5

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True)

    def __post_init__(self):
        C.validate_config(self)


class BinauraliserWeightsRI(NamedTuple):
    """The design as float32 tensors (the indices int64) on one device."""
    hrtf_re: torch.Tensor    # (nBands, 2, nDirs)
    hrtf_im: torch.Tensor
    hrtf_mag: torch.Tensor
    itds: torch.Tensor       # (nDirs,) seconds
    table_w: torch.Tensor    # (nTable, 3) interpolation weights
    table_idx: torch.Tensor  # (nTable, 3) HRTF-direction indices
    freqs: torch.Tensor      # (nBands,) band centre frequencies
    # the HRTFs direction-major, the tables ``hrtf_taps_ri`` reads (made by
    # weights_from_numpy): (nDirs, 2, nBands, 2) (hrtf_re, hrtf_im) pairs,
    # and (nDirs, 2, nBands) hrtf_mag
    hrtf_ri_by_dir: Optional[torch.Tensor] = None
    hrtf_mag_by_dir: Optional[torch.Tensor] = None


class BinauraliserWeights(NamedTuple):
    """The design with the HRTF filterbank complex, for :func:`process`."""
    hrtf_fb: torch.Tensor    # (nBands, 2, nDirs) complex64
    hrtf_mag: torch.Tensor   # (nBands, 2, nDirs)
    itds: torch.Tensor       # (nDirs,)
    table_w: torch.Tensor    # (nTable, 3) interpolation weights
    table_idx: torch.Tensor  # (nTable, 3) HRTF-direction indices
    freqs: torch.Tensor      # (nBands,)

    def as_ri(self) -> BinauraliserWeightsRI:
        """The same tables with the filterbank as (re, im) views."""
        return BinauraliserWeightsRI(self.hrtf_fb.real, self.hrtf_fb.imag,
                                     *self[1:])


def _design_host(cfg: BinauraliserConfig, hrirs: Optional[np.ndarray] = None,
                 hrir_dirs_deg: Optional[np.ndarray] = None,
                 hrir_fs: Optional[int] = None,
                 sofa_filepath: Optional[str] = None, rand_stream=None):
    """Host-side initCodec pipeline → (hrtf_fb (nBands, 2, nDirs) complex64,
    itds, compressed table weights, table indices, band frequencies)."""
    if hrirs is None:
        # SOFA path with the reference's bad-file → default-set fallback
        # (binauraliser_internal.c: same block as ambi_bin.c:209-218)
        hrirs, hrir_dirs_deg, hrir_fs, _ = hrir_mod.load_hrirs(sofa_filepath)
    if hrir_fs != cfg.fs:
        hrirs, _ = hrir_mod.resample_hrirs(hrirs, hrir_fs, int(cfg.fs))
    freqs = cfg.afstft.centre_freqs(cfg.fs)
    itds = hrir_mod.estimate_itds(hrirs, cfg.fs)
    hrtf_fb = hrir_mod.hrirs_to_hrtfs_afstft(hrirs, cfg.hop)
    weights = (geo.get_voronoi_weights(hrir_dirs_deg)
               if hrir_dirs_deg.shape[0] <= 1000 else None)
    if cfg.enable_hrir_diff_eq:
        hrtf_fb = hrir_mod.diffuse_field_equalise_hrtfs(
            hrtf_fb, itds, freqs, weights, apply_eq=True, apply_phase=False)
    gtable = vbap.generate_vbap_gain_table_3d(
        np.asarray(hrir_dirs_deg, np.float64), cfg.azi_res, cfg.elev_res,
        omit_large_triangles=True, enable_dummies=False,
        rand_stream=rand_stream)
    comp, idx = vbap.compress_vbap_gain_table_3d(gtable)
    return hrtf_fb, itds, comp, idx, freqs


def weights_from_numpy(hrtf_re, hrtf_im, hrtf_mag, itds, table_w, table_idx,
                       freqs, device: torch.device | str | None = None
                       ) -> BinauraliserWeightsRI:
    """Weights from numpy arrays (e.g. the fields of the JAX package's
    ``BinauraliserWeightsRI``) → tensors on ``device`` (default: the
    card)."""
    device = default_device() if device is None else device
    re, im, mag = (f32_tensor(a, device) for a in (hrtf_re, hrtf_im,
                                                   hrtf_mag))
    return BinauraliserWeightsRI(
        hrtf_re=re, hrtf_im=im, hrtf_mag=mag, itds=f32_tensor(itds, device),
        table_w=f32_tensor(table_w, device),
        table_idx=torch.tensor(np.asarray(table_idx, np.int64), device=device),
        freqs=f32_tensor(freqs, device),
        hrtf_ri_by_dir=torch.stack([re, im], -1).permute(2, 1, 0, 3)
        .contiguous(),
        hrtf_mag_by_dir=mag.permute(2, 1, 0).contiguous())


def weights_complex_from_numpy(hrtf_re, hrtf_im, hrtf_mag, itds, table_w,
                               table_idx, freqs,
                               device: torch.device | str | None = None
                               ) -> BinauraliserWeights:
    """:func:`weights_from_numpy` for the complex entry points (the complex
    filterbank as its (re, im) numpy parts)."""
    w = weights_from_numpy(hrtf_re, hrtf_im, hrtf_mag, itds, table_w,
                           table_idx, freqs, device)
    return BinauraliserWeights(torch.complex(w.hrtf_re, w.hrtf_im),
                               *(getattr(w, f) for f in
                                 BinauraliserWeights._fields[1:]))


state_complex_from_numpy = afstft.state_from_numpy


def state_from_numpy(in_tail: np.ndarray, ola_tail: np.ndarray,
                     device: torch.device | str | None = None
                     ) -> ri.AfSTFTStateBatched:
    """A batched state (e.g. the JAX package's) from numpy arrays."""
    return ri.AfSTFTStateBatched(in_tail=f32_tensor(in_tail, device),
                                 ola_tail=f32_tensor(ola_tail, device))


def design_ri(cfg: BinauraliserConfig, hrirs: Optional[np.ndarray] = None,
              hrir_dirs_deg: Optional[np.ndarray] = None,
              hrir_fs: Optional[int] = None,
              sofa_filepath: Optional[str] = None, rand_stream=None,
              device: torch.device | str | None = None) -> BinauraliserWeightsRI:
    """The initCodec pipeline → weights on ``device``.  Pass an HRIR set via
    (hrirs, hrir_dirs_deg, hrir_fs), a SOFA path, or nothing for the
    default set; ``rand_stream`` as in ``vbap.find_ls_triplets``."""
    hrtf_fb, itds, comp, idx, freqs = _design_host(
        cfg, hrirs, hrir_dirs_deg, hrir_fs, sofa_filepath, rand_stream)
    return weights_from_numpy(hrtf_fb.real, hrtf_fb.imag, np.abs(hrtf_fb),
                              itds, comp, idx, freqs, device)


def design(cfg: BinauraliserConfig, hrirs: Optional[np.ndarray] = None,
           hrir_dirs_deg: Optional[np.ndarray] = None,
           hrir_fs: Optional[int] = None,
           sofa_filepath: Optional[str] = None, rand_stream=None,
           device: torch.device | str | None = None) -> BinauraliserWeights:
    """:func:`design_ri` with the filterbank complex, for :func:`process`."""
    hrtf_fb, itds, comp, idx, freqs = _design_host(
        cfg, hrirs, hrir_dirs_deg, hrir_fs, sofa_filepath, rand_stream)
    return weights_complex_from_numpy(hrtf_fb.real, hrtf_fb.imag,
                                      np.abs(hrtf_fb), itds, comp, idx, freqs,
                                      device)


def init_state(cfg: BinauraliserConfig,
               device: torch.device | str | None = None) -> AfSTFTState:
    return cfg.afstft.init_state(cfg.n_sources, C.NUM_EARS, device=device)


def init_state_batched(cfg: BinauraliserConfig, n_streams: int,
                       device: torch.device | str | None = None
                       ) -> ri.AfSTFTStateBatched:
    return ri.init_state_batched(cfg.afstft, n_streams, cfg.n_sources,
                                 C.NUM_EARS, device=device)


def _gather(table: torch.Tensor, i3: torch.Tensor) -> torch.Tensor:
    """(nBands, 2, nDirs) table at directions i3 (..., nSrc, 3) →
    (..., nBands, 2, nSrc, 3)."""
    return table[:, :, i3].movedim((0, 1), (-4, -3))


def _interp_hrtfs_ri(cfg: BinauraliserConfig, w: BinauraliserWeightsRI,
                     dirs_deg: torch.Tensor):
    """Per-source HRTF interpolation (binauraliser_interpHRTFs) in split
    real/imaginary arithmetic on the weights' device: dirs_deg (..., nSrc,
    2) → (Hre, Him), each (..., nBands, 2, nSrc).

    The table row is C's (int)(x + 0.5f) of the azimuth taken modulo 360
    (floor-mod, as jnp.mod) and of the elevation, converted and clamped by
    :func:`models._common.table_row` as the JAX package converts and
    gathers it: a NaN row is row 0, a negative row counts from the table's
    end, and a row outside the table gives the source NaN weights
    (jnp.take's fill), hence NaN HRTFs.  Every gather index is clamped into
    its table, so no direction can make the card assert."""
    n_azi = int(360.0 / cfg.azi_res + 0.5) + 1
    n_dirs = w.hrtf_re.shape[-1]
    azi_idx = C.round_half_up(
        torch.remainder(dirs_deg[..., 0] + 180.0, 360.0) / cfg.azi_res)
    elev_idx = C.round_half_up((dirs_deg[..., 1] + 90.0) / cfg.elev_res)
    row, outside = C.table_row(elev_idx * n_azi + azi_idx,
                               w.table_w.shape[0])        # (..., nSrc)
    w3 = torch.where(outside[..., None], math.nan,
                     w.table_w[row])                  # (..., nSrc, 3)
    i3 = w.table_idx[row].clamp(0, n_dirs - 1)
    w3b = w3[..., None, None, :, :]                   # over (nBands, 2)
    if cfg.interp_mode == INTERP_TRI:
        return ((_gather(w.hrtf_re, i3) * w3b).sum(-1),
                (_gather(w.hrtf_im, i3) * w3b).sum(-1))
    # TRI_PS: interpolate magnitudes and ITDs, synthesise the IPD below
    # 1.5 kHz, in the JAX package's op order (binauraliser.py:176-184)
    mag = (_gather(w.hrtf_mag, i3) * w3b).sum(-1)     # (..., nBands, 2, nSrc)
    itd = (w3 * w.itds[i3]).sum(-1)                   # (..., nSrc)
    f = w.freqs[:, None]
    ipd = (torch.remainder(2.0 * math.pi * f * itd[..., None, :] + math.pi,
                           2.0 * math.pi) - math.pi) / 2.0
    ipd = torch.where(f < 1.5e3, ipd, 0.0)            # (..., nBands, nSrc)
    phase = torch.stack([ipd, -ipd], dim=-2)          # (..., nBands, 2, nSrc)
    return mag * torch.cos(phase), mag * torch.sin(phase)


interp_hrtfs_ri = spanned("ops.interp_hrtfs")(_interp_hrtfs_ri)


def interp_hrtfs(cfg: BinauraliserConfig, w: BinauraliserWeights,
                 dirs_deg: torch.Tensor) -> torch.Tensor:
    """:func:`interp_hrtfs_ri` as one complex tensor: dirs_deg (nSrc, 2) →
    (nBands, 2, nSrc) complex64."""
    return torch.complex(*interp_hrtfs_ri(cfg, w.as_ri(), dirs_deg))


def _rotate_dirs(src_dirs_deg: torch.Tensor, ypr: torch.Tensor
                 ) -> torch.Tensor:
    """Source directions (..., nSrc, 2) degrees after the listener's head
    rotation ypr (..., 3) [yaw, pitch, roll] radians (one per stream on the
    batched path, one in all for a single listener), on the device.  C uses
    row vectors: src_rot = src_row @ Rzyx, i.e. Rzyx^T acting on column
    vectors (binauraliser.c:238-241)."""
    R = geo.yaw_pitch_roll2_rzyx_torch(ypr)           # (..., 3, 3)
    u = geo.unit_sph2cart_torch(src_dirs_deg)         # (..., nSrc, 3)
    with fp32_matmul():
        u = torch.einsum("...sj,...ji->...si", u, R)
    return geo.unit_cart2sph_torch(u)


rotate_dirs = spanned("ops.rotate_dirs")(_rotate_dirs)


def hrtf_taps_ri_reference(cfg: BinauraliserConfig, w: BinauraliserWeightsRI,
                           dirs_deg: torch.Tensor,
                           ypr: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`hrtf_taps_ri` (same contract, any
    hop, any device): the chain :func:`rotate_dirs` →
    :func:`interp_hrtfs_ri` → ``decode_taps``, unchanged and in its op
    order, without the chain's spans (it runs inside this entry's)."""
    if cfg.enable_rotation and ypr is not None:
        dirs_deg = _rotate_dirs(dirs_deg, ypr)
    return decode_taps(*_interp_hrtfs_ri(cfg, w, dirs_deg), hybrid=True)


@kernel(hrtf_taps_ri_reference)
def hrtf_taps_ri(cfg: BinauraliserConfig, w: BinauraliserWeightsRI,
                 dirs_deg: torch.Tensor,
                 ypr: torch.Tensor | None = None) -> torch.Tensor:
    """The per-stream decode taps of a block:
    ``decode_taps(*interp_hrtfs_ri(cfg, w, rotate_dirs(dirs_deg, ypr)))``,
    the rotation only when ``cfg.enable_rotation`` and ``ypr`` is given, in
    one CUDA kernel (``csrc/hrtf_taps_ri.cu``).

    cfg at hop 128; dirs_deg (S, nSrc, 2) degrees; ypr (S, 3) radians or
    None.  → taps (S, nSrc, 2, 4, 129), the per-stream taps of
    ``render_full_ri`` and ``render_decode_synthesis_dg_ri``.  The kernel
    reads the weights' direction-major tables ``w.hrtf_ri_by_dir`` and
    ``w.hrtf_mag_by_dir``."""
    what = "hrtf_taps_ri"
    _check_hop(what, cfg.hop)
    if w.hrtf_ri_by_dir is None or w.hrtf_mag_by_dir is None:
        raise ValueError(f"{what}: the weights carry no direction-major "
                         "tables; make them with binauraliser."
                         "weights_from_numpy or design_ri")
    if dirs_deg.ndim != 3 or dirs_deg.shape[-1] != 2:
        raise ValueError(f"{what}: dirs_deg must be (S, nSrc, 2), got "
                         f"{tuple(dirs_deg.shape)}")
    S, n_src = dirs_deg.shape[:2]
    n_dirs, n_table = w.hrtf_mag_by_dir.shape[0], w.table_w.shape[0]
    nb = _KERNEL_HOP + 5
    rotate = cfg.enable_rotation and ypr is not None
    _check_inputs(what, dirs_deg, {
        "hrtf_ri_by_dir": (w.hrtf_ri_by_dir, (n_dirs, 2, nb, 2)),
        "hrtf_mag_by_dir": (w.hrtf_mag_by_dir, (n_dirs, 2, nb)),
        "table_w": (w.table_w, (n_table, 3)), "itds": (w.itds, (n_dirs,)),
        "freqs": (w.freqs, (nb,))})
    # the controls are read a float at a time: a block's slice of a longer
    # control buffer need not start on a 16-byte boundary
    controls = {"dirs_deg": (dirs_deg, (S, n_src, 2))}
    if rotate:
        controls["ypr"] = (ypr, (S, 3))
    _check_inputs(what, dirs_deg, controls, align=4)
    idx = w.table_idx
    if (idx.device != dirs_deg.device or idx.dtype != torch.int64
            or tuple(idx.shape) != (n_table, 3) or not idx.is_contiguous()):
        raise ValueError(f"{what}: table_idx must be a contiguous int64 "
                         f"({n_table}, 3) tensor on {dirs_deg.device}")
    taps = torch.empty((S, n_src, 2, 4, _KERNEL_HOP + 1),
                       dtype=torch.float32, device=dirs_deg.device)
    n_azi = int(360.0 / cfg.azi_res + 0.5) + 1
    return taps, (dirs_deg, ypr if rotate else None, w.hrtf_ri_by_dir,
                  w.hrtf_mag_by_dir, w.table_w, idx, w.itds, w.freqs, taps,
                  S, n_src, n_dirs, n_table, n_azi, float(cfg.azi_res),
                  float(cfg.elev_res), cfg.interp_mode == INTERP_TRI_PS)


def mix_complex(bank: AfSTFT, state: AfSTFTState, x: torch.Tensor,
                H: torch.Tensor, scale: float):
    """The single-stream render shared by the complex ``process`` of the
    renderers: analysis → per-band mixing matrix H (nBands, nOut, nIn)
    complex → ``scale`` → synthesis.  x (nIn, T) → ((nOut, T), state)."""
    spec, state = bank.analysis(state, x)             # (nBands, nIn, H)
    with fp32_matmul():
        out = torch.einsum("bes,bsh->beh", H.to(spec.dtype), spec)
    return bank.synthesis(state, out * scale)


def process(cfg: BinauraliserConfig, w: BinauraliserWeights,
            state: AfSTFTState, x: torch.Tensor, src_dirs_deg: torch.Tensor,
            src_gains: Optional[torch.Tensor] = None,
            ypr: Optional[torch.Tensor] = None):
    """One listener's block: x (nSrc, T), src_dirs_deg (nSrc, 2) degrees,
    src_gains (nSrc,) or None, ypr (3,) radians or None (used when
    ``cfg.enable_rotation``), all on the weights' device → ((2, T), state).
    """
    if src_gains is not None:
        x = x * src_gains[:, None]
    if cfg.enable_rotation and ypr is not None:
        src_dirs_deg = rotate_dirs(src_dirs_deg, ypr)
    H = interp_hrtfs(cfg, w, src_dirs_deg)            # (nBands, 2, nSrc)
    return mix_complex(cfg.afstft, state, x, H,
                       1.0 / math.sqrt(cfg.n_sources))


@spanned("models.binauraliser.process_ri_batched")
def process_ri_batched(cfg: BinauraliserConfig, w: BinauraliserWeightsRI,
                       state: ri.AfSTFTStateBatched, x: torch.Tensor,
                       src_dirs_deg: torch.Tensor,
                       src_gains: Optional[torch.Tensor] = None,
                       ypr: Optional[torch.Tensor] = None,
                       fused: bool = True):
    """Stream-batched process: x (S, nSrc, T), src_dirs_deg (S, nSrc, 2),
    src_gains (S, nSrc) or None, ypr (S, 3) or None (used when
    ``cfg.enable_rotation``) → ((S, 2, T), state).  Every input lies on
    the weights' device.

    The per-stream interpolated HRTFs are the per-stream mixing matrices of
    :func:`ops.afstft_ri.render_tf_matrix_ri`: ``fused=True`` runs its
    kernel route, ``fused=False`` its plain path.  On the kernel route (hop
    128) the rotation, the interpolation and the collapse to decode taps are
    one call, :func:`hrtf_taps_ri`, whose taps go straight to
    :func:`ops.afstft_ri.render_tf_matrix_fused`."""
    if src_gains is not None:
        x = x * src_gains[..., None]
    rotate = cfg.enable_rotation and ypr is not None
    bank = cfg.afstft
    if fused and ri.takes_fused_route(bank, C.NUM_EARS, cfg.n_sources):
        taps = hrtf_taps_ri(cfg, w, src_dirs_deg.contiguous(),
                            ypr.contiguous() if rotate else None)
        y, state = ri.render_tf_matrix_fused(bank, state, x, taps=taps)
    else:
        if rotate:
            src_dirs_deg = rotate_dirs(src_dirs_deg, ypr)
        Hre, Him = interp_hrtfs_ri(cfg, w, src_dirs_deg)  # (S, B, 2, nSrc)
        y, state = ri.render_tf_matrix_ri(bank, state, x, Hre, Him,
                                          fused=fused)
    return y / math.sqrt(cfg.n_sources), state
