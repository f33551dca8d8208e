"""ambi_bin — binaural Ambisonic decoder (counterpart of
``spatial_audio_framework_tpu/models/ambi_bin.py``, batched RI path).

``design_ri`` runs the initCodec pipeline on the host (HRIRs → ITDs →
afSTFT filterbank HRTFs → Voronoi weights → diffuse-field EQ → binaural
decoder → truncation EQ) and folds the input-convention conversion into the
per-band decode matrix.  ``process_ri_batched`` renders a chunk for many
streams at once through ``ops/afstft_ri.render_tf_matrix_ri``: with
``fused=True`` on the decode kernels (the one-pass ``render_full_ri`` up to
order 3, the two-kernel ``analysis_front_dg_ri`` →
``render_decode_synthesis_dg_ri`` pipeline for orders 4 to 7), with
``fused=False`` through the plain analysis → einsum → synthesis path.

``process`` (complex) and ``process_ri`` (split real/imaginary) render one
listener's block on the single-stream filterbank, and are the entry points
that rotate the sound field: with ``cfg.enable_rotation`` the SH rotation
matrix of ``ypr`` (a tensor of yaw, pitch, roll in radians on the device) is
built on the device every block (``sh.get_sh_rot_mtx_real_torch``) and
multiplied into the decoder, so a head tracker can change it per block
without the host waiting for the device.  As in the JAX package, none of
the kernels serves these paths and the batched path does not rotate.

``weights_from_numpy`` / ``state_from_numpy`` take the JAX package's
``design_ri`` weights and batched state as numpy arrays, so both packages
can run on identical inputs; ``weights_complex_from_numpy`` /
``state_complex_from_numpy`` / ``state_ri_from_numpy`` do the same for the
single-stream entry points.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import f32_tensor
from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.modules import hoa, hrir as hrir_mod, sh
from spatial_audio_framework_tpu_torch.ops import afstft, afstft_ri as ri
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT, AfSTFTState
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul
from spatial_audio_framework_tpu_torch.utils import geometry as geo
from spatial_audio_framework_tpu_torch.utils.profiling import spanned

# HRIR_PREPROC_OPTIONS (ambi_bin.h)
PREPROC_OFF = "off"
PREPROC_EQ = "eq"
PREPROC_PHASE = "phase"
PREPROC_ALL = "all"


@dataclass(frozen=True)
class AmbiBinConfig:
    order: int = 1                      # ambi_bin.c:78 (the flagship uses 3)
    fs: float = 48000.0
    method: str = "magls"               # ambi_bin.c:77 DECODING_METHOD_MAGLS
    hrir_preproc: str = PREPROC_EQ      # ambi_bin.c:63
    ch_ordering: str = C.CH_ACN
    norm: str = C.NORM_SN3D             # ambi_bin.c:65
    enable_max_re: bool = True
    enable_diff_cov_matching: bool = False
    enable_truncation_eq: bool = True   # only active for the LS method
    enable_rotation: bool = False
    hop: int = 128
    # precision mode of the process path ('default'|'high'|'highest';
    # None = 'high'); the port computes every mode in full fp32
    # (ops/precision.py)
    mxu_precision: Optional[str] = None

    @property
    def nsh(self) -> int:
        return (self.order + 1) ** 2

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True, low_delay=False)

    def __post_init__(self):
        C.validate_config(self)


class AmbiBinWeights(NamedTuple):
    M_dec: torch.Tensor  # (nBands, 2, nSH) complex64, conventions folded in


def _design_host(cfg: AmbiBinConfig, hrirs: Optional[np.ndarray] = None,
                 hrir_dirs_deg: Optional[np.ndarray] = None,
                 hrir_fs: Optional[int] = None,
                 sofa_filepath: Optional[str] = None) -> np.ndarray:
    """Host-side initCodec pipeline → decode matrix (nBands, 2, nSH) as
    numpy complex."""
    if hrirs is None:
        hrirs, hrir_dirs_deg, hrir_fs, _ = hrir_mod.load_hrirs(sofa_filepath)
    if hrir_fs != cfg.fs:
        hrirs, _ = hrir_mod.resample_hrirs(hrirs, hrir_fs, int(cfg.fs))
    n_dirs = hrirs.shape[0]
    bank = cfg.afstft
    freq_vector = bank.centre_freqs(cfg.fs)

    itds = hrir_mod.estimate_itds(hrirs, cfg.fs)
    hrtf_fb = hrir_mod.hrirs_to_hrtfs_afstft(hrirs, cfg.hop)
    weights = (geo.get_voronoi_weights(hrir_dirs_deg) if n_dirs <= 1000 else None)
    hrtf_fb = hrir_mod.diffuse_field_equalise_hrtfs(
        hrtf_fb, itds, freq_vector, weights,
        apply_eq=cfg.hrir_preproc in (PREPROC_EQ, PREPROC_ALL),
        apply_phase=cfg.hrir_preproc in (PREPROC_PHASE, PREPROC_ALL))

    # the reference passes the Voronoi areas (sum 4π) straight through as
    # integration weights (ambi_bin.c:261-307)
    dec = hoa.get_binaural_ambi_decoder_mtx(
        hrtf_fb, hrir_dirs_deg, cfg.method, cfg.order,
        freq_vector=freq_vector, itds=itds, weights=weights,
        enable_diff_cov_matching=cfg.enable_diff_cov_matching,
        enable_max_re_weighting=cfg.enable_max_re)

    # truncation EQ (ambi_bin.c:310-364): LS method only, no phase preproc
    if (cfg.enable_truncation_eq and cfg.method == "ls"
            and cfg.hrir_preproc not in (PREPROC_PHASE, PREPROC_ALL)):
        r, c, order_target = 0.085, 343.0, 42
        kr = 2.0 * np.pi / c * freq_vector.astype(np.float64) * r
        if cfg.enable_max_re:
            b = sh.beam_weights_max_ev(cfg.order).astype(np.float64)
            ns = np.arange(cfg.order + 1)
            w_n = b / np.sqrt((2 * ns + 1) / (4.0 * np.pi))
            w_n = w_n / w_n[0]
        else:
            w_n = np.ones(cfg.order + 1)
        gain = hoa.truncation_eq(w_n, cfg.order, order_target, kr,
                                 soft_threshold_db=9.0)
        dec = dec * gain[:, None, None]

    # fold the input channel-order/normalisation conversion into the
    # decoder, except for FuMa ordering: its channel permutation does not
    # commute with the SH rotation, and the C converts the signal first
    # (ambi_bin.c:420-455), so FuMa is converted in process
    if cfg.ch_ordering == C.CH_FUMA:
        return dec
    conv = C.input_conversion_mtx(cfg.order, cfg.ch_ordering, cfg.norm)
    return np.einsum("bes,st->bet", dec, conv)


@functools.lru_cache(maxsize=None)
def _fuma_conv(order: int, ch_ordering: str, norm: str,
               device: torch.device) -> Optional[torch.Tensor]:
    """The input conversion NOT folded at design time (FuMa only), on
    ``device``; made once per (order, convention, device), since a
    host-to-device copy per chunk would make the host wait for the
    device."""
    if ch_ordering != C.CH_FUMA:
        return None
    return f32_tensor(C.input_conversion_mtx(order, ch_ordering, norm), device)


def weights_from_numpy(M_re: np.ndarray, M_im: np.ndarray,
                       device: torch.device | str | None = None):
    """(M_re, M_im) numpy arrays (e.g. the JAX package's ``design_ri``
    output) → float32 tensors on ``device``."""
    return f32_tensor(M_re, device), f32_tensor(M_im, device)


def state_from_numpy(in_tail: np.ndarray, ola_tail: np.ndarray,
                     device: torch.device | str | None = None
                     ) -> ri.AfSTFTStateBatched:
    """A batched state (e.g. the JAX package's) from numpy arrays."""
    return ri.AfSTFTStateBatched(in_tail=f32_tensor(in_tail, device),
                                 ola_tail=f32_tensor(ola_tail, device))


def weights_complex_from_numpy(M_re: np.ndarray, M_im: np.ndarray,
                               device: torch.device | str | None = None
                               ) -> AmbiBinWeights:
    """The complex decoder (e.g. the JAX package's ``design`` output) from
    its (re, im) numpy parts."""
    return AmbiBinWeights(M_dec=torch.complex(f32_tensor(M_re, device),
                                              f32_tensor(M_im, device)))


state_complex_from_numpy = afstft.state_from_numpy


state_ri_from_numpy = ri.state_ri_from_numpy


def design(cfg: AmbiBinConfig, hrirs: Optional[np.ndarray] = None,
           hrir_dirs_deg: Optional[np.ndarray] = None,
           hrir_fs: Optional[int] = None,
           sofa_filepath: Optional[str] = None,
           device: torch.device | str | None = None) -> AmbiBinWeights:
    """The initCodec pipeline (ambi_bin.c:167-380) → the complex decoder on
    ``device``.  Pass a loaded set via (hrirs, hrir_dirs_deg, hrir_fs), a
    ``sofa_filepath`` (falls back to the default set on failure, like the
    reference), or neither."""
    dec = _design_host(cfg, hrirs, hrir_dirs_deg, hrir_fs, sofa_filepath)
    return weights_complex_from_numpy(dec.real, dec.imag, device)


def design_ri(cfg: AmbiBinConfig, hrirs: Optional[np.ndarray] = None,
              hrir_dirs_deg: Optional[np.ndarray] = None,
              hrir_fs: Optional[int] = None,
              sofa_filepath: Optional[str] = None,
              device: torch.device | str | None = None):
    """The initCodec pipeline (ambi_bin.c:167-380) → (M_re, M_im), each a
    (nBands, 2, nSH) float32 tensor on ``device``.  Pass an HRIR set via
    (hrirs, hrir_dirs_deg, hrir_fs), or nothing for the default set."""
    dec = _design_host(cfg, hrirs, hrir_dirs_deg, hrir_fs, sofa_filepath)
    return weights_from_numpy(dec.real, dec.imag, device)


def init_state(cfg: AmbiBinConfig,
               device: torch.device | str | None = None) -> AfSTFTState:
    return cfg.afstft.init_state(cfg.nsh, C.NUM_EARS, device=device)


def _rotation(cfg: AmbiBinConfig, ypr: Optional[torch.Tensor]) -> torch.Tensor:
    """(nSH, nSH) float32 SH rotation of ``ypr`` (yaw, pitch, roll in
    radians, on the device), built with device ops only."""
    if ypr is None:
        raise ValueError("enable_rotation is set: pass ypr, a tensor of "
                         "(yaw, pitch, roll) in radians")
    R = geo.yaw_pitch_roll2_rzyx_torch(ypr)
    return sh.get_sh_rot_mtx_real_torch(R.to(torch.float32), cfg.order)


def process(cfg: AmbiBinConfig, weights: AmbiBinWeights, state: AfSTFTState,
            x: torch.Tensor, ypr: Optional[torch.Tensor] = None):
    """Process a block (ambi_bin.c:382-480).

    x: (nSH, T) SH signals, T a multiple of hop; ypr: (3,) radians (yaw,
    pitch, roll) on x's device if cfg.enable_rotation.  → ((2, T), state).
    """
    bank = cfg.afstft
    M = weights.M_dec
    with fp32_matmul():
        if cfg.enable_rotation and cfg.order > 0:
            M = torch.einsum("bes,st->bet", M, _rotation(cfg, ypr).to(M.dtype))
        cv = _fuma_conv(cfg.order, cfg.ch_ordering, cfg.norm, M.device)
        if cv is not None:
            M = torch.einsum("bes,st->bet", M, cv.to(M.dtype))
        spec, state = bank.analysis(state, x)           # (nBands, nSH, H)
        out = torch.einsum("bes,bsh->beh", M, spec)
    return bank.synthesis(state, out)                   # (2, T)


# -- split real/imaginary pipeline -------------------------------------------

def weights_ri(weights: AmbiBinWeights):
    """The decode matrix as an (re, im) float32 pair for process_ri."""
    return (weights.M_dec.real.contiguous(), weights.M_dec.imag.contiguous())


def init_state_ri(cfg: AmbiBinConfig,
                  device: torch.device | str | None = None
                  ) -> ri.AfSTFTStateRI:
    return ri.init_state_ri(cfg.afstft, cfg.nsh, C.NUM_EARS, device=device)


def process_ri(cfg: AmbiBinConfig, w_ri, state: ri.AfSTFTStateRI,
               x: torch.Tensor, ypr: Optional[torch.Tensor] = None):
    """:func:`process` in split real/imaginary arithmetic: w_ri = (M_re,
    M_im) from :func:`weights_ri` or :func:`design_ri`; the complex per-band
    decode becomes four real einsums."""
    bank = cfg.afstft
    Mre, Mim = w_ri
    with fp32_matmul():
        if cfg.enable_rotation and cfg.order > 0:
            M_rot = _rotation(cfg, ypr)
            Mre = torch.einsum("bes,st->bet", Mre, M_rot)
            Mim = torch.einsum("bes,st->bet", Mim, M_rot)
        cv = _fuma_conv(cfg.order, cfg.ch_ordering, cfg.norm, Mre.device)
        if cv is not None:
            Mre = torch.einsum("bes,st->bet", Mre, cv)
            Mim = torch.einsum("bes,st->bet", Mim, cv)
        (sre, sim), state = ri.analysis_ri(bank, state, x)
        out_re = (torch.einsum("bes,bsh->beh", Mre, sre)
                  - torch.einsum("bes,bsh->beh", Mim, sim))
        out_im = (torch.einsum("bes,bsh->beh", Mre, sim)
                  + torch.einsum("bes,bsh->beh", Mim, sre))
    return ri.synthesis_ri(bank, state, (out_re, out_im))


def init_state_batched(cfg: AmbiBinConfig, n_streams: int,
                       device: torch.device | str | None = None
                       ) -> ri.AfSTFTStateBatched:
    return ri.init_state_batched(cfg.afstft, n_streams, cfg.nsh, C.NUM_EARS,
                                 device=device)


@spanned("models.ambi_bin.process_ri_batched")
def process_ri_batched(cfg: AmbiBinConfig, w_ri, state: ri.AfSTFTStateBatched,
                       x: torch.Tensor, fused: bool = True):
    """Stream-batched render: x (S, nSH, T) → ((S, 2, T), state), by
    :func:`ops.afstft_ri.render_tf_matrix_ri`, which picks the route:
    ``fused=True`` the kernel path (the CUDA kernels on CUDA tensors), the
    one-pass kernel for nSH ≤ 16 (order ≤ 3), the two-kernel (d, g)
    pipeline above; ``fused=False`` the plain reference path.
    """
    Mre, Mim = w_ri
    cv = _fuma_conv(cfg.order, cfg.ch_ordering, cfg.norm, Mre.device)
    if cv is not None:  # FuMa: conversion not folded at design time
        with fp32_matmul():
            Mre = torch.einsum("bes,st->bet", Mre, cv)
            Mim = torch.einsum("bes,st->bet", Mim, cv)
    return ri.render_tf_matrix_ri(cfg.afstft, state, x, Mre, Mim, fused=fused)
