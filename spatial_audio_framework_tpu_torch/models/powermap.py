"""powermap — SH-domain activity-map analyser (counterpart of
``spatial_audio_framework_tpu/models/powermap.py``; ``examples/src/powermap``).

Process: afSTFT analysis → per-band SCM with one-pole temporal averaging
(powermap.c:257-266) → order-truncated covariance grouping with per-band EQ
(powermap.c:275-289: each band contributes its top-left
(orderPerBand+1)²-block, scaled by 1e3·pmapEQ[band]) → activity map at the
max analysis order (PWD / MVDR / CroPaC-LCMV / MUSIC(±log) / MinNorm(±log))
→ map averaging on the analysis grid → VBAP interpolation to the dense
display grid (powermap.c:345-358).

The chain runs in split real/imaginary arithmetic (``ops/afstft_ri`` front
and ``ops/herm_ri`` covariance algebra through ``modules/sh_est``).
``analysis`` is one instance on the single-stream filterbank (plain torch,
no kernel, as in the JAX package); ``analysis_batched`` and
``analysis_chunks`` serve many instances with the batched filterbank,
whose front is the CUDA kernel ``analysis_front_ri`` over the (instances ·
nSH) rows when ``fused`` (the JAX package takes its Pallas front on the
TPU only; here the wrapper runs the kernel on CUDA tensors and its plain
version on CPU tensors).  ``analysis_chunks`` hoists the map out of the
chunk recursion: the MUSIC / MinNorm eigendecomposition, which makes the
host wait for the device on the card, runs once for all chunks × instances.

``weights_from_numpy`` and the ``state*_from_numpy`` functions take the
JAX package's weights and states as numpy arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import default_device, f32_tensor
from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.modules import sh, sh_est, vbap
from spatial_audio_framework_tpu_torch.ops import afstft_ri as ri
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul
from spatial_audio_framework_tpu_torch.utils import presets

PM_PWD = "pwd"
PM_MVDR = "mvdr"
PM_CROPAC = "cropac_lcmv"
PM_MUSIC = "music"
PM_MUSIC_LOG = "music_log"
PM_MINNORM = "minnorm"
PM_MINNORM_LOG = "minnorm_log"


@dataclass(frozen=True)
class PowermapConfig:
    master_order: int = 1
    fs: float = 48000.0
    mode: str = PM_PWD
    n_sources: int = 1
    cov_avg_coeff: float = 0.5
    pmap_avg_coeff: float = 0.666       # powermap.c:51
    ch_ordering: str = C.CH_ACN
    norm: str = C.NORM_SN3D
    # analysis grid: the reference scans the 812-dir icosahedral geosphere
    # (powermap_internal.c:57-59 geosphere_ico_freq = 9); a t-design can be
    # selected instead for cheaper maps
    analysis_grid: str = "geosphere_ico_9"
    grid_tdesign: int = 14              # used when analysis_grid == "tdesign"
    interp_res_deg: int = 5             # display grid resolution
    hop: int = 128
    # Per-band SH analysis order (len n_bands, each clipped to
    # [1, master_order]); None → master_order for every band
    # (powermap_internal.h:124 analysisOrderPerBand).
    analysis_order_per_band: Optional[Tuple[int, ...]] = None

    @property
    def nsh(self) -> int:
        return (self.master_order + 1) ** 2

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True)

    def orders_per_band(self) -> np.ndarray:
        n_bands = self.afstft.n_bands
        if self.analysis_order_per_band is None:
            return np.full(n_bands, self.master_order, int)
        o = np.asarray(self.analysis_order_per_band, int)
        assert o.shape == (n_bands,), (o.shape, n_bands)
        return np.clip(o, 1, self.master_order)

    @property
    def max_analysis_order(self) -> int:
        return int(self.orders_per_band().max())

    def __post_init__(self):
        C.validate_config(self)


class PowermapWeights(NamedTuple):
    Y_grid: torch.Tensor        # (nSH_max, nGrid) REAL SH steering
    interp_table: torch.Tensor  # (nInterp, nGrid)
    conv_in: torch.Tensor       # (nSH, nSH)
    band_mask: torch.Tensor     # (nBands, nSH_max) order-truncation masks
    grid_dirs_deg: np.ndarray
    interp_dirs_deg: np.ndarray


class PowermapState(NamedTuple):
    bank: object            # ri.AfSTFTStateRI, or ri.AfSTFTStateBatched
    Cx_re: torch.Tensor     # ([n,] nBands, nSH, nSH)
    Cx_im: torch.Tensor
    prev_pmap: torch.Tensor  # ([n,] nGrid): averaged on the ANALYSIS grid
                             # before interpolation (powermap.c:345-347)


def _display_grid(res_deg: int) -> np.ndarray:
    az = np.arange(-180, 180 + res_deg, res_deg)
    el = np.arange(-90, 90 + res_deg, res_deg)
    return np.stack(np.meshgrid(az, el), -1).reshape(-1, 2).astype(np.float64)


def weights_from_numpy(Y_grid, interp_table, conv_in, band_mask,
                       grid_dirs_deg, interp_dirs_deg,
                       device: torch.device | str | None = None
                       ) -> PowermapWeights:
    """Weights (e.g. the JAX package's ``design`` output) from numpy
    arrays → float32 tensors on ``device``; the direction grids stay numpy."""
    return PowermapWeights(
        Y_grid=f32_tensor(Y_grid, device),
        interp_table=f32_tensor(interp_table, device),
        conv_in=f32_tensor(conv_in, device),
        band_mask=f32_tensor(band_mask, device),
        grid_dirs_deg=np.asarray(grid_dirs_deg),
        interp_dirs_deg=np.asarray(interp_dirs_deg))


def design(cfg: PowermapConfig,
           device: torch.device | str | None = None) -> PowermapWeights:
    """Host design (the scanning-grid SH, the 5° display grid's VBAP
    interpolation table, the order-truncation masks) → weights on
    ``device`` (default: the card)."""
    if cfg.analysis_grid == "geosphere_ico_9":
        grid = presets.geosphere(9, icosahedral=True)
    else:
        grid = presets.tdesign(cfg.grid_tdesign)
    dirs_rad = np.stack([np.radians(grid[:, 0]),
                         np.pi / 2 - np.radians(grid[:, 1])], -1)
    max_order = cfg.max_analysis_order
    # the C scales the scanning-grid SH by 1/nSH (powermap_initAna,
    # powermap_internal.c:63 scaleY).  All maps except CroPaC are invariant
    # to this scale after the [0,1] display normalisation; CroPaC is NOT
    # (its MVDR base map scales as α⁻² while the LCMV cross-spectrum is
    # α-invariant, so the per-direction gain G mixes the two scalings).
    nsh_max = (max_order + 1) ** 2
    Y = sh.get_sh_real(max_order, dirs_rad) * np.sqrt(4.0 * np.pi) / nsh_max
    interp_dirs = _display_grid(cfg.interp_res_deg)
    g = vbap.generate_vbap_gain_table_3d_srcs(interp_dirs, grid)
    g = vbap.vbap_gain_table_to_interp_table(g)
    # order-truncation masks: band b contributes Cx rows/cols < (order_b+1)²
    orders = cfg.orders_per_band()
    mask = (np.arange(nsh_max)[None, :]
            < ((orders + 1) ** 2)[:, None]).astype(np.float32)
    return weights_from_numpy(
        Y, g, C.input_conversion_mtx(cfg.master_order, cfg.ch_ordering,
                                     cfg.norm),
        mask, grid, interp_dirs, device)


def init_state(cfg: PowermapConfig, w: PowermapWeights,
               device: torch.device | str | None = None) -> PowermapState:
    device = default_device() if device is None else device
    n_bands = cfg.afstft.n_bands
    z = dict(dtype=torch.float32, device=device)
    return PowermapState(
        bank=ri.init_state_ri(cfg.afstft, cfg.nsh, 1, device=device),
        Cx_re=torch.zeros((n_bands, cfg.nsh, cfg.nsh), **z),
        Cx_im=torch.zeros((n_bands, cfg.nsh, cfg.nsh), **z),
        prev_pmap=torch.zeros(w.grid_dirs_deg.shape[0], **z))


def state_from_numpy(bank: tuple, Cx_re, Cx_im, prev_pmap,
                     device: torch.device | str | None = None
                     ) -> PowermapState:
    """A state (e.g. the JAX package's) from numpy arrays: ``bank`` is the
    single-stream filterbank's (in_tail, hyb_tail_re, hyb_tail_im,
    ola_tail), or the batched one's (in_tail, ola_tail)."""
    bank = (ri.state_ri_from_numpy(*bank, device=device) if len(bank) == 4
            else ri.AfSTFTStateBatched(*(f32_tensor(a, device) for a in bank)))
    return PowermapState(bank=bank, Cx_re=f32_tensor(Cx_re, device),
                         Cx_im=f32_tensor(Cx_im, device),
                         prev_pmap=f32_tensor(prev_pmap, device))


def analysis(cfg: PowermapConfig, w: PowermapWeights, state: PowermapState,
             x: torch.Tensor, pmap_eq: Optional[torch.Tensor] = None):
    """x: (nSH, T) → (pmap (nInterp,) in [0,1], state).  pmap_eq: optional
    per-band map EQ weights (nBands,), clipped to [0, 2] (powermap.c:284)."""
    with fp32_matmul():
        xc = w.conv_in @ x
    (sre, sim), bank_st = ri.analysis_ri(cfg.afstft, state.bank, xc)
    pmap_i, Cx_re, Cx_im, prev = _post_front(cfg, w, state, sre, sim,
                                             pmap_eq)
    return pmap_i, PowermapState(bank=bank_st, Cx_re=Cx_re, Cx_im=Cx_im,
                                 prev_pmap=prev)


def init_state_batched(cfg: PowermapConfig, w: PowermapWeights, n: int,
                       device: torch.device | str | None = None
                       ) -> PowermapState:
    """State for ``analysis_batched`` / ``analysis_chunks``: n independent
    analyser instances on the batched filterbank (15-hop input tail, the
    hybrid history recomputed)."""
    device = default_device() if device is None else device
    n_bands = cfg.afstft.n_bands
    z = dict(dtype=torch.float32, device=device)
    return PowermapState(
        bank=ri.init_state_batched(cfg.afstft, n, cfg.nsh, 1, device=device),
        Cx_re=torch.zeros((n, n_bands, cfg.nsh, cfg.nsh), **z),
        Cx_im=torch.zeros((n, n_bands, cfg.nsh, cfg.nsh), **z),
        prev_pmap=torch.zeros((n, w.grid_dirs_deg.shape[0]), **z))


def _front_batched(cfg: PowermapConfig, w: PowermapWeights, bank_st,
                   x: torch.Tensor, fused: bool):
    """x (n, nSH, T) → per-instance ((n, nB, nSH, H) re, im), bank state."""
    with fp32_matmul():
        xc = w.conv_in @ x
    (sre, sim), bank_st = ri.analysis_ri_batched(cfg.afstft, bank_st, xc,
                                                 use_kernel=fused)
    # batched front layout (n, nSH, H, nBands) → (n, nB, nSH, H)
    return sre.permute(0, 3, 1, 2), sim.permute(0, 3, 1, 2), bank_st


def analysis_batched(cfg: PowermapConfig, w: PowermapWeights,
                     state: PowermapState, x: torch.Tensor,
                     pmap_eq: Optional[torch.Tensor] = None,
                     fused: bool = True):
    """n independent powermap instances in one call: x (n, nSH, T) →
    (pmaps (n, nInterp), state from init_state_batched).  The front runs
    as one batched call over all n·nSH channels (``analysis_front_ri`` when
    ``fused``); everything after it is batched over the instance axis."""
    sre, sim, bank_st = _front_batched(cfg, w, state.bank, x, fused)
    pmap_i, Cx_re, Cx_im, prev = _post_front(cfg, w, state, sre, sim,
                                             pmap_eq)
    return pmap_i, PowermapState(bank=bank_st, Cx_re=Cx_re, Cx_im=Cx_im,
                                 prev_pmap=prev)


def _scm_update(cfg: PowermapConfig, Cx_re, Cx_im, sre, sim):
    """One-pole SCM recursion from (..., nB, nSH, H) spectra: C = S Sᴴ in
    RI → re = Sre Sreᵀ + Sim Simᵀ, im = Sim Sreᵀ − Sre Simᵀ
    (powermap.c:257-266)."""
    H = sre.shape[-1]
    with fp32_matmul():
        new_re = (torch.einsum("...sh,...th->...st", sre, sre)
                  + torch.einsum("...sh,...th->...st", sim, sim)) / H
        new_im = (torch.einsum("...sh,...th->...st", sim, sre)
                  - torch.einsum("...sh,...th->...st", sre, sim)) / H
    a = cfg.cov_avg_coeff
    return a * Cx_re + (1.0 - a) * new_re, a * Cx_im + (1.0 - a) * new_im


def _map_from_cov(cfg: PowermapConfig, w: PowermapWeights, Cx_re, Cx_im,
                  pmap_eq: Optional[torch.Tensor]):
    """Grouped covariance → activity map on the analysis grid, batched over
    any leading axes of Cx (..., nB, nSH, nSH) → (..., nGrid).  Batching is
    what lets analysis_chunks run one eigh over all chunks × instances."""
    nsh_max = w.Y_grid.shape[0]
    m = 1e3 * w.band_mask
    if pmap_eq is not None:
        m = m * torch.clamp(pmap_eq, 0.0, 2.0)[:, None]
    with fp32_matmul():
        C_grp = (torch.einsum("bi,bj,...bij->...ij", m, w.band_mask,
                              Cx_re[..., :nsh_max, :nsh_max]),
                 torch.einsum("bi,bj,...bij->...ij", m, w.band_mask,
                              Cx_im[..., :nsh_max, :nsh_max]))
    if cfg.mode == PM_PWD:
        pmap = sh_est.generate_pwd_map_ri(C_grp, w.Y_grid)
    elif cfg.mode == PM_MVDR:
        pmap = sh_est.generate_mvdr_map_ri(C_grp, w.Y_grid, 8.0)
    elif cfg.mode == PM_CROPAC:
        pmap = sh_est.generate_cropac_lcmv_map_ri(C_grp, w.Y_grid, 8.0, 0.0)
    elif cfg.mode in (PM_MUSIC, PM_MUSIC_LOG):
        pmap = sh_est.generate_music_map_ri(C_grp, w.Y_grid, cfg.n_sources,
                                            cfg.mode == PM_MUSIC_LOG)
    elif cfg.mode in (PM_MINNORM, PM_MINNORM_LOG):
        pmap = sh_est.generate_minnorm_map_ri(C_grp, w.Y_grid, cfg.n_sources,
                                              cfg.mode == PM_MINNORM_LOG)
    else:
        raise ValueError(cfg.mode)
    # trace guard: a silent scene yields a zero map (powermap.c:295-343)
    if cfg.mode != PM_PWD:
        tr = torch.diagonal(C_grp[0], dim1=-2, dim2=-1).sum(-1)
        pmap = torch.where((tr > 1e-8)[..., None], pmap, 0.0)
    return pmap


def _interp_normalised(w: PowermapWeights, pmap: torch.Tensor) -> torch.Tensor:
    """VBAP display interpolation + [0,1] normalisation (powermap.c:
    349-365), batched over leading axes."""
    with fp32_matmul():
        pmap_i = torch.einsum("ig,...g->...i", w.interp_table, pmap)
    pmin = pmap_i.amin(dim=-1, keepdim=True)
    pmax = pmap_i.amax(dim=-1, keepdim=True)
    return (pmap_i - pmin) / torch.clamp_min(pmax - pmin, 1e-12)


def _post_front(cfg: PowermapConfig, w: PowermapWeights,
                state: PowermapState, sre: torch.Tensor, sim: torch.Tensor,
                pmap_eq: Optional[torch.Tensor]):
    """SCM averaging → grouping → map → map EWMA → display, from (..., nB,
    nSH, H) spectra.  Shared by the single-instance and batched entry
    points (every piece is batched over leading axes)."""
    Cx_re, Cx_im = _scm_update(cfg, state.Cx_re, state.Cx_im, sre, sim)
    pmap = _map_from_cov(cfg, w, Cx_re, Cx_im, pmap_eq)
    pmap = ((1.0 - cfg.pmap_avg_coeff) * pmap
            + cfg.pmap_avg_coeff * state.prev_pmap)
    return _interp_normalised(w, pmap), Cx_re, Cx_im, pmap


def analysis_chunks(cfg: PowermapConfig, w: PowermapWeights,
                    state: PowermapState, xs: torch.Tensor,
                    pmap_eq: Optional[torch.Tensor] = None,
                    fused: bool = True):
    """K sequential chunks in one call, with the map computation hoisted
    out of the chunk recursion.

    xs: (K, nSH, T), or (K, n, nSH, T) with a state from
    init_state_batched → (pmaps (K[, n], nInterp), state).

    The SCM one-pole is the only true chunk-to-chunk dependency, so the
    chunk loop carries just filterbank + Cx while stacking each chunk's
    smoothed covariance; the activity maps (including the MUSIC / MinNorm
    eigendecomposition) then run once, batched over all K chunks (× n
    instances): the same eigh on the same matrices as K calls of
    ``analysis``.  ``fused``: the batched front's kernel, as in
    :func:`analysis_batched`."""
    batched = xs.ndim == 4
    bank, Cre, Cim = state.bank, state.Cx_re, state.Cx_im
    Cres, Cims = [], []
    for xk in xs:
        if batched:
            sre, sim, bank = _front_batched(cfg, w, bank, xk, fused)
        else:
            with fp32_matmul():
                xc = w.conv_in @ xk
            (sre, sim), bank = ri.analysis_ri(cfg.afstft, bank, xc)
        Cre, Cim = _scm_update(cfg, Cre, Cim, sre, sim)
        Cres.append(Cre)
        Cims.append(Cim)
    pmaps = _map_from_cov(cfg, w, torch.stack(Cres), torch.stack(Cims),
                          pmap_eq)                       # ONE batched map
    prev = state.prev_pmap
    seq = []
    for pm in pmaps:          # chunk-sequential display EWMA (tiny)
        prev = (1.0 - cfg.pmap_avg_coeff) * pm + cfg.pmap_avg_coeff * prev
        seq.append(prev)
    return (_interp_normalised(w, torch.stack(seq)),
            PowermapState(bank=bank, Cx_re=Cre, Cx_im=Cim, prev_pmap=prev))
