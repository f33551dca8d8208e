"""array2sh — microphone array → SH encoder (counterpart of
``spatial_audio_framework_tpu/models/array2sh.py``;
``examples/src/array2sh``).

The design computes per-band encoding matrices W[band] = diag(1/b_n
regularised) · pinv(Y_mic) from theoretical modal coefficients on the host
(array2sh_internal.c:100-380): soft-limited (Bernschutz et al. 2011),
Tikhonov (Moreau et al. 2006), or the Zotter linear-phase filter-bank styles
(plain / max-rE), with the diffuse-field equalisation past the spatial
aliasing limit, and puts them on the device.  ``process_ri_batched`` encodes
a chunk for many arrays at once through
``ops/afstft_ri.render_tf_matrix_ri``: an Eigenmike32 to order 4 is
nSH·Q = 800 > 128 channel pairs, so analysis → per-band einsum → synthesis,
on the CUDA kernels ``analysis_front_ri`` and ``synthesis_back_ri`` when
``fused=True``.  ``process`` is the single-stream complex path.  Filter
evaluation against a simulated array (``evaluate_filters``) mirrors
array2sh_evaluateSHTfilters.

``weights_from_numpy`` / ``state_from_numpy`` take the JAX package's
``design_ri`` weights and batched state as numpy arrays;
``weights_complex_from_numpy`` / ``state_complex_from_numpy`` those of the
single-stream path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import f32_tensor
from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.models.binauraliser import (  # noqa: F401
    mix_complex, state_complex_from_numpy, state_from_numpy)
from spatial_audio_framework_tpu_torch.modules import array_proc as AP, hoa, sh
from spatial_audio_framework_tpu_torch.ops import afstft_ri as ri
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT, AfSTFTState
from spatial_audio_framework_tpu_torch.utils import presets
from spatial_audio_framework_tpu_torch.utils.misc import saf_print_warning

FILTER_SOFT_LIM = "soft_lim"
FILTER_TIKHONOV = "tikhonov"
FILTER_Z_STYLE = "z_style"
FILTER_Z_STYLE_MAXRE = "z_style_maxre"

ARRAY_SPHERICAL = "spherical"
ARRAY_CYLINDRICAL = "cylindrical"

# sensor weight types (array2sh.h)
WEIGHT_RIGID_OMNI = ("rigid", 1.0)
WEIGHT_RIGID_CARD = ("rigid", 0.5)
WEIGHT_RIGID_DIPOLE = ("rigid", 0.0)
WEIGHT_OPEN_OMNI = ("open", 1.0)
WEIGHT_OPEN_CARD = ("open", 0.5)
WEIGHT_OPEN_DIPOLE = ("open", 0.0)


@dataclass(frozen=True)
class Array2SHConfig:
    order: int = 1
    fs: float = 48000.0
    filter_type: str = FILTER_TIKHONOV
    array_type: str = ARRAY_SPHERICAL
    weight_type: tuple = WEIGHT_RIGID_OMNI
    r: float = 0.042          # sensor radius (Eigenmike-ish default)
    R: float = 0.042          # scatterer/baffle radius
    reg_par_db: float = 15.0
    c: float = 343.0
    ch_ordering: str = C.CH_ACN
    norm: str = C.NORM_SN3D
    gain_db: float = 0.0
    hop: int = 128
    # diffuse-field EQ above the spatial-aliasing band (array2sh's
    # enableDiffEQpastAliasing, default on — array2sh.c:85)
    diff_eq_past_aliasing: bool = True

    @property
    def nsh(self) -> int:
        return (self.order + 1) ** 2

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True)

    def __post_init__(self):
        C.validate_config(self)


class Array2SHWeights(NamedTuple):
    W: torch.Tensor  # (nBands, nSH, Q) complex64


def _modal_coeffs(cfg: Array2SHConfig, kr, kR):
    kind, dir_coeff = cfg.weight_type
    if cfg.array_type == ARRAY_CYLINDRICAL:
        return AP.cyl_modal_coeffs(cfg.order, kr,
                                   AP.ARRAY_RIGID if kind == "rigid" else AP.ARRAY_OPEN)
    if kind == "open":
        if dir_coeff == 1.0:
            return AP.sph_modal_coeffs(cfg.order, kr, AP.ARRAY_OPEN)
        return AP.sph_modal_coeffs(cfg.order, kr, AP.ARRAY_OPEN_DIRECTIONAL, dir_coeff)
    if cfg.R == cfg.r:
        return AP.sph_modal_coeffs(cfg.order, kr, AP.ARRAY_RIGID)
    if dir_coeff == 1.0:
        return AP.sph_scatterer_modal_coeffs(cfg.order, kr, kR)
    return AP.sph_scatterer_dir_modal_coeffs(cfg.order, kr, kR, dir_coeff)


def _replicate_orders(vals_per_order: np.ndarray) -> np.ndarray:
    """(..., order+1) → (..., nSH) replicating each order's value over its
    2n+1 channels (array2sh_replicate_order)."""
    order = vals_per_order.shape[-1] - 1
    idx = np.concatenate([[n] * (2 * n + 1) for n in range(order + 1)])
    return vals_per_order[..., idx]


def _apply_diff_eq_past_aliasing(cfg: Array2SHConfig, W: np.ndarray,
                                 sensor_dirs_deg: np.ndarray,
                                 freqs: np.ndarray, kr: np.ndarray):
    """Diffuse-field equalise the encoding matrices above the spatial
    aliasing limit (array2sh_internal.c:381-499 ``array2sh_apply_diff_EQ``):
    each SH channel is scaled so its diffuse-field energy (through the
    theoretical diffuse coherence matrix of the array) stays at the level it
    has at the aliasing band."""
    kind, dir_coeff = cfg.weight_type
    k_r_max = 2.0 * np.pi * 20e3 * cfg.r / cfg.c
    array_order = min(int(np.ceil(2.0 * k_r_max) + 0.01), 28)
    sensor_rad = np.radians(np.asarray(sensor_dirs_deg, np.float64))
    if kind == "rigid":
        # the C maps all rigid weight types onto RIGID modal coefficients
        # here (the theory matrix depends only on construction + dirCoeff)
        Mdc = AP.sph_diff_coh_mtx_theory(array_order, sensor_rad,
                                         AP.ARRAY_RIGID, dir_coeff, kr)
    else:
        Mdc = AP.sph_diff_coh_mtx_theory(
            array_order, sensor_rad,
            AP.ARRAY_OPEN if dir_coeff == 1.0 else AP.ARRAY_OPEN_DIRECTIONAL,
            dir_coeff, kr)                       # (nBands, Q, Q) real
    f_alias = AP.sph_array_alias_lim(cfg.r, cfg.c, cfg.order)
    idxf_alias = int(np.argmin(np.abs(freqs - f_alias)))

    def diff_energy(b):
        E = W[b] @ Mdc[b] @ W[b].conj().T
        return np.real(np.diag(E)) / (4.0 * np.pi)

    L_fal = diff_energy(idxf_alias)
    W = W.copy()
    for b in range(idxf_alias + 1, W.shape[0]):
        scale = np.sqrt(L_fal / diff_energy(b) + 2.23e-10)
        W[b] = scale[:, None] * W[b]
    return W


def _design_host(cfg: Array2SHConfig,
                 sensor_dirs_deg: np.ndarray) -> np.ndarray:
    """The encoding matrices (nBands, nSH, Q) as complex128 numpy, output
    convention and gain folded in.  sensor_dirs_deg: (Q, 2) [azi, elev] in
    DEGREES.  Note the sensor presets (utils.presets.mic_preset) are stored
    in radians, matching the reference's __*_coords_rad tables — convert
    with np.degrees first."""
    sensor_dirs_deg = np.asarray(sensor_dirs_deg, np.float64)
    if sensor_dirs_deg.shape[0] > 4 and np.abs(sensor_dirs_deg).max() < 7.0:
        saf_print_warning(
            "array2sh.design: sensor directions all within ±7 — these look "
            "like RADIANS; pass degrees (np.degrees(mic_preset(...))) or the "
            "SH matrix will be near-singular and the filters will explode")
    Q = sensor_dirs_deg.shape[0]
    order = cfg.order
    bank = cfg.afstft
    freqs = bank.centre_freqs(cfg.fs).astype(np.float64)
    kr = 2.0 * np.pi * freqs * cfg.r / cfg.c
    kR = 2.0 * np.pi * freqs * min(cfg.R, cfg.r) / cfg.c  # R clipped to r
    n_bands = freqs.shape[0]

    Y_mic = sh.get_rsh(order, sensor_dirs_deg)  # (nSH, Q)
    pinv_Y = np.linalg.pinv(Y_mic)  # (Q, nSH)

    bN = _modal_coeffs(cfg, kr, kR) / (4.0 * np.pi)  # (nBands, order+1)

    if cfg.filter_type in (FILTER_SOFT_LIM, FILTER_TIKHONOV):
        if cfg.filter_type == FILTER_SOFT_LIM:
            g_lim = np.sqrt(Q) * 10.0 ** (cfg.reg_par_db / 20.0)
            with np.errstate(divide="ignore", invalid="ignore"):
                bn_inv = (1.0 / bN) * (2.0 * g_lim * np.abs(bN) / np.pi) \
                         * np.arctan(np.pi / (2.0 * g_lim * np.abs(bN)))
            # where the modal response vanishes (DC bins at higher orders)
            # nothing can be recovered: zero instead of the C's NaN
            bn_inv = np.where(np.abs(bN) < 1e-12, 0.0, np.nan_to_num(bn_inv))
        else:
            alpha = np.sqrt(Q) * 10.0 ** (cfg.reg_par_db / 20.0)
            beta = np.sqrt((1.0 - np.sqrt(1.0 - 1.0 / alpha ** 2))
                           / (1.0 + np.sqrt(1.0 - 1.0 / alpha ** 2)))
            bn_inv = np.conj(bN) / (np.abs(bN) ** 2 + beta ** 2)
    else:
        # Zotter linear-phase filter-bank styles (array2sh_internal.c:225-355)
        kind, dir_coeff = cfg.weight_type
        at = (AP.ARRAY_RIGID if kind == "rigid"
              else (AP.ARRAY_OPEN if dir_coeff == 1.0 else AP.ARRAY_OPEN_DIRECTIONAL))
        f_lim = AP.sph_array_noise_threshold(order, Q, cfg.r, cfg.c, at,
                                             dir_coeff, cfg.reg_par_db)
        H = np.zeros((n_bands, order + 1))
        with np.errstate(divide="ignore", invalid="ignore"):
            for n in range(order + 1):
                if n == 0:
                    H[:, n] = 1.0 / (1.0 + (freqs / f_lim[0]) ** 2)
                elif n == order:
                    x = (freqs / f_lim[n - 1]) ** (order + 1.0)
                    H[:, n] = x / (1.0 + x)
                else:
                    x = (freqs / f_lim[n - 1]) ** (n + 1.0)
                    H[:, n] = (x / (1.0 + x)) / (1.0 + (freqs / f_lim[n]) ** (n + 2.0))
        H = np.nan_to_num(H)
        H = H / np.maximum(H.sum(-1, keepdims=True), 1e-12)
        with np.errstate(divide="ignore", invalid="ignore"):
            Hs = np.exp(1j * kr)[:, None] * (1.0 / bN)  # already /4π above
        Hs = np.nan_to_num(Hs)
        # per-order weighting table W[i][n] (plain or maxRE), normalised
        Wt = np.zeros((order + 1, order + 1))
        for n in range(order + 1):
            if cfg.filter_type == FILTER_Z_STYLE:
                wn = np.ones(n + 1)
            else:
                a_full = hoa.get_max_re_weights(n)
                wn = np.array([a_full[i * i] for i in range(n + 1)])
            scale = np.sum((2 * np.arange(n + 1) + 1) * wn ** 2)
            Wt[: n + 1, n] = wn / np.sqrt(scale)
        Wt = Wt / Wt[0, order]
        bn_inv = np.zeros((n_bands, order + 1), np.complex128)
        for n in range(order + 1):
            HW = H[:, n:] @ Wt[n, n:]
            bn_inv[:, n] = Hs[:, n] * HW

    bn_inv_R = _replicate_orders(bn_inv)  # (nBands, nSH)
    W = bn_inv_R[:, :, None] * pinv_Y[None, :, :].conj().transpose(0, 2, 1)
    if cfg.diff_eq_past_aliasing and cfg.array_type != ARRAY_CYLINDRICAL:
        W = _apply_diff_eq_past_aliasing(cfg, W, sensor_dirs_deg, freqs, kr)
    # output conventions + gain (applied in process in the reference; static)
    conv_out = C.output_conversion_mtx(order, cfg.ch_ordering, cfg.norm)
    W = np.einsum("st,btq->bsq", conv_out, W) * 10.0 ** (cfg.gain_db / 20.0)
    return W


def weights_from_numpy(W_re: np.ndarray, W_im: np.ndarray,
                       device: torch.device | str | None = None):
    """(W_re, W_im) numpy arrays (e.g. the JAX package's ``design_ri``
    output) → float32 tensors on ``device``."""
    return f32_tensor(W_re, device), f32_tensor(W_im, device)


def weights_complex_from_numpy(W_re: np.ndarray, W_im: np.ndarray,
                               device: torch.device | str | None = None
                               ) -> Array2SHWeights:
    """The complex encoder (e.g. the JAX package's ``design`` output) from
    its (re, im) numpy parts."""
    return Array2SHWeights(W=torch.complex(*weights_from_numpy(W_re, W_im,
                                                               device)))


def design(cfg: Array2SHConfig, sensor_dirs_deg: np.ndarray,
           device: torch.device | str | None = None) -> Array2SHWeights:
    """The complex encoder for :func:`process`, on ``device`` (default: the
    card).  sensor_dirs_deg: (Q, 2) [azi, elev] in degrees."""
    W = _design_host(cfg, sensor_dirs_deg)
    return weights_complex_from_numpy(W.real, W.imag, device)


def design_ri(cfg: Array2SHConfig, sensor_dirs_deg: np.ndarray,
              device: torch.device | str | None = None):
    """design() for the batched path: (W_re, W_im) float32 on ``device``."""
    W = _design_host(cfg, sensor_dirs_deg)
    return weights_from_numpy(W.real, W.imag, device)


def init_state_batched(cfg: Array2SHConfig, n_streams: int, n_sensors: int,
                       device: torch.device | str | None = None
                       ) -> ri.AfSTFTStateBatched:
    return ri.init_state_batched(cfg.afstft, n_streams, n_sensors, cfg.nsh,
                                 device=device)


def process_ri_batched(cfg: Array2SHConfig, w_ri,
                       state: ri.AfSTFTStateBatched, x: torch.Tensor,
                       fused: bool = True):
    """Stream-batched encoding: x (S, Q, T) → ((S, nSH, T), state); w_ri
    from :func:`design_ri`.  ``fused=True`` takes the kernel route of
    :func:`ops.afstft_ri.render_tf_matrix_ri` (the CUDA kernels on CUDA
    tensors, their plain versions on the CPU); ``fused=False`` the plain
    reference path on any device."""
    return ri.render_tf_matrix_ri(cfg.afstft, state, x, w_ri[0], w_ri[1],
                                  fused=fused)


def init_state(cfg: Array2SHConfig, n_sensors: int,
               device: torch.device | str | None = None) -> AfSTFTState:
    return cfg.afstft.init_state(n_sensors, cfg.nsh, device=device)


def process(cfg: Array2SHConfig, w: Array2SHWeights, state: AfSTFTState,
            x: torch.Tensor):
    """x: (Q, T) sensor signals → ((nSH, T), state)."""
    return mix_complex(cfg.afstft, state, x, w.W, 1.0)


def evaluate_filters(cfg: Array2SHConfig, w: Array2SHWeights,
                     sensor_dirs_deg: np.ndarray):
    """Objective evaluation (array2sh_evaluateSHTfilters →
    saf_sh ``evaluateSHTfilters``): spatial correlation & level difference of
    the encoded patterns vs ideal SH over a simulated array."""
    freqs = cfg.afstft.centre_freqs(cfg.fs).astype(np.float64)
    kr = 2.0 * np.pi * freqs * cfg.r / cfg.c
    grid = presets.tdesign(20)
    sensor_rad = np.radians(np.asarray(sensor_dirs_deg, np.float64))
    kind, dir_coeff = cfg.weight_type
    H_array = AP.simulate_sph_array(
        cfg.order + 1, kr, sensor_rad, grid,
        AP.ARRAY_OPEN if kind == "open" else AP.ARRAY_RIGID, dir_coeff)
    # getRSH scaling (√4π-inclusive), as array2sh_internal.c:593 passes it —
    # evaluate_sht_filters' C-exact correlation then peaks at 1 for a
    # perfect reconstruction
    Y_grid = sh.get_rsh(cfg.order, grid)
    # the reference evaluates the PRE-conversion (ACN/N3D, unity-gain)
    # matrices (array2sh_internal.c:593-605) — undo design()'s output
    # conversion + gain so lSH reads ~0 dB for a perfect reconstruction in
    # every convention
    conv_out = C.output_conversion_mtx(cfg.order, cfg.ch_ordering, cfg.norm)
    # pinv, not inv: the FuMa conversion zeroes channels ≥ 4 at order ≥ 2
    # (by design), making conv_out singular — evaluate the recoverable part
    M = np.einsum("ts,bsq->btq", np.linalg.pinv(conv_out), w.W.cpu().numpy())
    M = M / 10.0 ** (cfg.gain_db / 20.0)
    return AP.evaluate_sht_filters(M, H_array, Y_grid)
