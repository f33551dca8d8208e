"""ambi_dec — frequency-dependent Ambisonic loudspeaker decoder (counterpart
of ``spatial_audio_framework_tpu/models/ambi_dec.py``).

The reference's per-band machinery — dual decoders below/above the
transition frequency (ambi_dec.c:523), per-band decoding order, optional
max-rE weighting and amplitude/energy-preserving normalisation
(ambi_dec.c:255-345) — is static configuration, so ``design_ri`` folds it,
with the input-convention conversion, into ONE real (nBands, nLS, nSH)
matrix on the host.  ``process_ri_batched`` renders a chunk for many
streams through ``ops/afstft_ri.render_tf_matrix_ri``: with nLS·nSH > 128
that is analysis → per-band einsum → synthesis, on the CUDA kernels
``analysis_front_ri`` and ``synthesis_back_ri`` when ``fused=True``.

The headphone preview (``binauralise_ls``) interpolates HRTFs at the
loudspeaker directions with the binauraliser's TRI_PS mode
(ambi_dec_internal.c:59-115), scales them by 1/√nLS and folds them into
the decoder on the host: the batched path then renders nSH → 2 ears with a
complex matrix (2·nSH ≤ 128: the decode kernels).  ``design`` /
``init_state`` / ``process`` are the single-stream complex entry points.

``weights_from_numpy`` / ``state_from_numpy`` take the JAX package's
``design_ri`` weights and batched state as numpy arrays, so both packages
can run on identical inputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import f32_tensor
from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.models import binauraliser as _bin
from spatial_audio_framework_tpu_torch.modules import hoa, sh
from spatial_audio_framework_tpu_torch.ops import afstft_ri as ri
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT, AfSTFTState
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul
from spatial_audio_framework_tpu_torch.utils import presets
from spatial_audio_framework_tpu_torch.utils.convhull3d import glibc_rand
from spatial_audio_framework_tpu_torch.utils.profiling import spanned

AMPLITUDE_PRESERVING = 0  # ambi_dec.h AMBI_DEC_DIFFUSE_FIELD_EQ_APPROACH
ENERGY_PRESERVING = 1


@dataclass(frozen=True)
class AmbiDecConfig:
    master_order: int = 1
    fs: float = 48000.0
    dec_method: tuple = ("allrad", "allrad")      # (low, high)
    re_weight: tuple = (True, True)                # ambi_dec.c:69-70
    diff_eq_mode: tuple = (ENERGY_PRESERVING, ENERGY_PRESERVING)
    transition_freq: float = 800.0                 # ambi_dec.c:73
    ch_ordering: str = C.CH_ACN
    norm: str = C.NORM_SN3D
    binauralise_ls: bool = False
    hop: int = 128

    @property
    def nsh(self) -> int:
        return (self.master_order + 1) ** 2

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True)

    def __post_init__(self):
        C.validate_config(self)


class AmbiDecWeights(NamedTuple):
    """Weights of the single-stream complex path."""
    M: torch.Tensor                 # (nBands, nLS, nSH) complex64
    H_bin: Optional[torch.Tensor]   # (nBands, 2, nLS) complex64, or None


class AmbiDecWeightsRI(NamedTuple):
    """Weights of the batched path: the real dual-band decoder, or (with
    binauralise_ls) the H_bin·M fold as an (re, im) pair."""
    M_re: torch.Tensor              # (nBands, nOut, nSH)
    M_im: Optional[torch.Tensor]    # None for the loudspeaker decode


def _norm_factors(M_dec: np.ndarray, order: int) -> tuple[float, float]:
    """Amplitude/energy preservation factors from a t-design sweep
    (ambi_dec.c:305-335).  The C fires plane waves through getSHreal
    (ORTHONORMAL real SH, no sqrt(4π)); getRSH would shrink the factors by
    sqrt(4π)."""
    grid = presets.tdesign(30)
    dirs_rad = np.stack([np.radians(grid[:, 0]),
                         np.pi / 2 - np.radians(grid[:, 1])], -1)
    Y = sh.get_sh_real(order, dirs_rad)  # (nSH, nGrid) orthonormal
    g = M_dec @ Y  # (nLS, nGrid)
    a_avg = g.sum(0).mean()
    e_avg = (g ** 2).sum(0).mean()
    return 1.0 / (a_avg + 2.23e-6), float(np.sqrt(1.0 / (e_avg + 2.23e-6)))


def design_host(cfg: AmbiDecConfig, ls_dirs_deg: np.ndarray,
                order_per_band: Optional[np.ndarray] = None,
                rand_stream=None) -> np.ndarray:
    """The initCodec decoder design (ambi_dec.c:255-345, 520-540) → the
    per-band loudspeaker decoder (nBands, nLS, nSH) as float64 numpy, with
    the input conversion to (ACN, N3D) folded in.  ``rand_stream``: the
    design's glibc ``rand()`` stream (a fresh one when None); the two AllRAD
    hulls draw from it, d=0 then d=1."""
    ls_dirs_deg = np.asarray(ls_dirs_deg, np.float64)
    n_ls = ls_dirs_deg.shape[0]
    freqs = cfg.afstft.centre_freqs(cfg.fs)
    n_bands = freqs.shape[0]
    mo = cfg.master_order
    if order_per_band is None:
        order_per_band = np.full(n_bands, mo, int)
    order_per_band = np.clip(np.asarray(order_per_band, int), 1, mo)

    # One glibc rand() stream shared across the design, consumed in the
    # C's initCodec order: the AllRAD triangulation for d=0, then d=1
    # (ambi_dec.c:258-276).  Separate streams could split coplanar quads
    # along other diagonals than the C does.
    if rand_stream is None:
        rand_stream = glibc_rand()

    # per-decoder, per-order truncated + maxRE + norm variants
    M_full = {}
    for d in range(2):
        M_master = hoa.get_loudspeaker_decoder_mtx(ls_dirs_deg,
                                                   cfg.dec_method[d], mo,
                                                   rand_stream=rand_stream)
        for n in range(1, mo + 1):
            M_n = M_master[:, :(n + 1) ** 2]
            norm_a, norm_e = _norm_factors(M_n, n)
            if cfg.re_weight[d]:
                M_n = M_n * hoa.get_max_re_weights(n)[None, :]
            gain = (norm_a if cfg.diff_eq_mode[d] == AMPLITUDE_PRESERVING
                    else norm_e)
            M_full[(d, n)] = M_n * gain

    conv = C.input_conversion_mtx(mo, cfg.ch_ordering, cfg.norm)
    M = np.zeros((n_bands, n_ls, cfg.nsh), np.float64)
    for band in range(n_bands):
        d = 0 if freqs[band] < cfg.transition_freq else 1
        n = int(order_per_band[band])
        M[band, :, : (n + 1) ** 2] = M_full[(d, n)]
        M[band] = M[band] @ conv
    return M


def weights_from_numpy(M_re: np.ndarray, M_im: Optional[np.ndarray] = None,
                       device: torch.device | str | None = None
                       ) -> AmbiDecWeightsRI:
    """Weights (e.g. the JAX package's ``design_ri`` output) from numpy
    arrays → float32 tensors on ``device``."""
    return AmbiDecWeightsRI(
        M_re=f32_tensor(M_re, device),
        M_im=None if M_im is None else f32_tensor(M_im, device))


def state_from_numpy(in_tail: np.ndarray, ola_tail: np.ndarray,
                     device: torch.device | str | None = None
                     ) -> ri.AfSTFTStateBatched:
    """A batched state (e.g. the JAX package's) from numpy arrays."""
    return ri.AfSTFTStateBatched(in_tail=f32_tensor(in_tail, device),
                                 ola_tail=f32_tensor(ola_tail, device))


def weights_complex_from_numpy(M_re, M_im, H_re=None, H_im=None,
                               device: torch.device | str | None = None
                               ) -> AmbiDecWeights:
    """The complex weights (e.g. the JAX package's ``design`` output) from
    their (re, im) numpy parts; H_* None without the binaural preview."""
    def cplx(re, im):
        return torch.complex(f32_tensor(re, device), f32_tensor(im, device))

    return AmbiDecWeights(M=cplx(M_re, M_im),
                          H_bin=None if H_re is None else cplx(H_re, H_im))


state_complex_from_numpy = _bin.state_complex_from_numpy


def _design_parts(cfg: AmbiDecConfig, ls_dirs_deg, order_per_band, hrirs,
                  hrir_dirs_deg, hrir_fs):
    """→ (M (nBands, nLS, nSH) float64 numpy, (Hre, Him) each (nBands, 2,
    nLS) float32 CPU tensors already scaled by 1/√nLS, or None).

    One glibc rand() stream serves the whole design in the C's initCodec
    order: the two AllRAD hulls (ambi_dec.c:258-276), THEN the HRTF VBAP
    table (ambi_dec.c:402).  The near-regular default HRIR grid's
    triangulation is jitter-sensitive, so the stream's position at that
    third hull matters for parity."""
    rand_stream = glibc_rand()
    M = design_host(cfg, ls_dirs_deg, order_per_band, rand_stream)
    if not cfg.binauralise_ls:
        return M, None
    n_ls = M.shape[1]
    # ambi_dec_interpHRTFs (ambi_dec_internal.c:59-115) is the magnitude +
    # ITD interpolation with the IPD resynthesised below 1.5 kHz: the
    # binauraliser's TRI_PS mode, always; 1/sqrt(nLS) as ambi_dec.c:563
    bcfg = _bin.BinauraliserConfig(n_sources=n_ls, fs=cfg.fs, hop=cfg.hop,
                                   interp_mode=_bin.INTERP_TRI_PS)
    bw = _bin.design_ri(bcfg, hrirs, hrir_dirs_deg, hrir_fs,
                        rand_stream=rand_stream, device="cpu")
    Hre, Him = _bin.interp_hrtfs_ri(bcfg, bw, f32_tensor(ls_dirs_deg, "cpu"))
    scale = 1.0 / np.sqrt(n_ls)
    return M, (Hre * scale, Him * scale)


def design(cfg: AmbiDecConfig, ls_dirs_deg: np.ndarray,
           order_per_band: Optional[np.ndarray] = None,
           hrirs: Optional[np.ndarray] = None,
           hrir_dirs_deg: Optional[np.ndarray] = None,
           hrir_fs: Optional[int] = None,
           device: torch.device | str | None = None) -> AmbiDecWeights:
    """Host design → the complex weights of :func:`process` on ``device``;
    with ``cfg.binauralise_ls`` also the HRTFs at the loudspeaker directions
    (from ``hrirs``, or the default set)."""
    M, H = _design_parts(cfg, ls_dirs_deg, order_per_band, hrirs,
                         hrir_dirs_deg, hrir_fs)
    if H is None:
        return weights_complex_from_numpy(M, np.zeros_like(M), device=device)
    return weights_complex_from_numpy(M, np.zeros_like(M), H[0].numpy(),
                                      H[1].numpy(), device=device)


def design_ri(cfg: AmbiDecConfig, ls_dirs_deg: np.ndarray,
              order_per_band: Optional[np.ndarray] = None,
              hrirs: Optional[np.ndarray] = None,
              hrir_dirs_deg: Optional[np.ndarray] = None,
              hrir_fs: Optional[int] = None,
              device: torch.device | str | None = None) -> AmbiDecWeightsRI:
    """Host design → weights for :func:`process_ri_batched`, on ``device``:
    the real decoder, or with ``cfg.binauralise_ls`` the headphone preview
    H_bin·M folded on the host into one (re, im) pair."""
    M, H = _design_parts(cfg, ls_dirs_deg, order_per_band, hrirs,
                         hrir_dirs_deg, hrir_fs)
    if H is None:
        return weights_from_numpy(M, None, device)
    M32 = f32_tensor(M, "cpu")
    with fp32_matmul():
        Mre = torch.einsum("bel,bls->bes", H[0], M32)
        Mim = torch.einsum("bel,bls->bes", H[1], M32)
    return weights_from_numpy(Mre.numpy(), Mim.numpy(), device)


def init_state(cfg: AmbiDecConfig, n_ls: int,
               device: torch.device | str | None = None) -> AfSTFTState:
    n_out = 2 if cfg.binauralise_ls else n_ls
    return cfg.afstft.init_state(cfg.nsh, n_out, device=device)


def process(cfg: AmbiDecConfig, w: AmbiDecWeights, state: AfSTFTState,
            x: torch.Tensor):
    """x: (nSH, T) → ((nLS or 2, T), state)."""
    bank = cfg.afstft
    spec, state = bank.analysis(state, x)                # (nBands, nSH, H)
    with fp32_matmul():
        out = torch.einsum("bls,bsh->blh", w.M, spec)    # (nBands, nLS, H)
        if cfg.binauralise_ls:
            out = torch.einsum("bel,blh->beh", w.H_bin, out)
    return bank.synthesis(state, out)


def init_state_batched(cfg: AmbiDecConfig, n_streams: int, n_ls: int,
                       device: torch.device | str | None = None
                       ) -> ri.AfSTFTStateBatched:
    n_out = 2 if cfg.binauralise_ls else n_ls
    return ri.init_state_batched(cfg.afstft, n_streams, cfg.nsh, n_out,
                                 device=device)


@spanned("models.ambi_dec.process_ri_batched")
def process_ri_batched(cfg: AmbiDecConfig, w: AmbiDecWeightsRI,
                       state: ri.AfSTFTStateBatched, x: torch.Tensor,
                       fused: bool = True):
    """Stream-batched render: x (S, nSH, T) → ((S, nLS or 2, T), state).

    ``fused=True`` takes the kernel route of
    :func:`ops.afstft_ri.render_tf_matrix_ri` (the CUDA kernels on CUDA
    tensors, their plain versions on the CPU); ``fused=False`` the plain
    reference path on any device."""
    return ri.render_tf_matrix_ri(cfg.afstft, state, x, w.M_re, w.M_im,
                                  fused=fused)
