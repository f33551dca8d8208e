"""ambi_dec — frequency-dependent Ambisonic loudspeaker decoder (counterpart
of ``spatial_audio_framework_tpu/models/ambi_dec.py``, batched RI path).

The reference's per-band machinery — dual decoders below/above the
transition frequency (ambi_dec.c:523), per-band decoding order, optional
max-rE weighting and amplitude/energy-preserving normalisation
(ambi_dec.c:255-345) — is static configuration, so ``design_ri`` folds it,
with the input-convention conversion, into ONE real (nBands, nLS, nSH)
matrix on the host.  ``process_ri_batched`` renders a chunk for many
streams through ``ops/afstft_ri.render_tf_matrix_ri``: with nLS·nSH > 128
that is analysis → per-band einsum → synthesis, on the CUDA kernels
``analysis_front_ri`` and ``synthesis_back_ri`` when ``fused=True``.

The headphone preview (``binauralise_ls``) needs binauraliser's TRI_PS
HRTF interpolation, which is not ported yet: it raises NotImplementedError.

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
from spatial_audio_framework_tpu_torch.modules import hoa, sh
from spatial_audio_framework_tpu_torch.ops import afstft_ri as ri
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT
from spatial_audio_framework_tpu_torch.utils import presets
from spatial_audio_framework_tpu_torch.utils.convhull3d import glibc_rand

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


class AmbiDecWeightsRI(NamedTuple):
    """Weights of the batched path: the real dual-band decoder."""
    M_re: torch.Tensor              # (nBands, nLS, nSH)
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
                order_per_band: Optional[np.ndarray] = None) -> np.ndarray:
    """The initCodec decoder design (ambi_dec.c:255-345, 520-540) → the
    per-band loudspeaker decoder (nBands, nLS, nSH) as float64 numpy, with
    the input conversion to (ACN, N3D) folded in."""
    if cfg.binauralise_ls:
        raise NotImplementedError(
            "ambi_dec binauralise_ls needs binauraliser's TRI_PS HRTF "
            "interpolation, not ported yet (ROADMAP.md, Queue 1: "
            "'ambi_dec binauralise_ls')")
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


def design_ri(cfg: AmbiDecConfig, ls_dirs_deg: np.ndarray,
              order_per_band: Optional[np.ndarray] = None,
              device: torch.device | str | None = None) -> AmbiDecWeightsRI:
    """Host design (:func:`design_host`) → weights for
    :func:`process_ri_batched`, on ``device``."""
    return weights_from_numpy(design_host(cfg, ls_dirs_deg, order_per_band),
                              None, device)


def init_state_batched(cfg: AmbiDecConfig, n_streams: int, n_ls: int,
                       device: torch.device | str | None = None
                       ) -> ri.AfSTFTStateBatched:
    n_out = 2 if cfg.binauralise_ls else n_ls
    return ri.init_state_batched(cfg.afstft, n_streams, cfg.nsh, n_out,
                                 device=device)


def process_ri_batched(cfg: AmbiDecConfig, w: AmbiDecWeightsRI,
                       state: ri.AfSTFTStateBatched, x: torch.Tensor,
                       fused: bool = True):
    """Stream-batched render: x (S, nSH, T) → ((S, nLS, T), state).

    ``fused=True`` takes the kernel route of
    :func:`ops.afstft_ri.render_tf_matrix_ri` (the CUDA kernels on CUDA
    tensors, their plain versions on the CPU); ``fused=False`` the plain
    reference path on any device."""
    return ri.render_tf_matrix_ri(cfg.afstft, state, x, w.M_re, w.M_im,
                                  fused=fused)
