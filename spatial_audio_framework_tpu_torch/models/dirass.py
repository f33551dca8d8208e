"""dirass — direction re-assigned activity maps (counterpart of
``spatial_audio_framework_tpu/models/dirass.py``; ``examples/src/dirass``;
Politis & McCormack re-assignment).

Three modes (dirass.h REASS_*):

* ``off``     — classic steered-beamformer energy map.
* ``upscale`` — per-grid-sector DoA via spatially-localised intensity, then
  re-encode the sector signals at a higher order at the estimated DoAs
  (``sh.get_sh_real_torch`` on the device) and beamform again
  (dirass.c:339-366).
* ``nearest`` — assign each sector's energy to the display grid point
  nearest its DoA estimate (dirass.c:372-...), a scatter-add
  (``index_add_``; on the card its additions run in no fixed order).

Time-domain (broadband) analysis with a band-pass pre-filter
(``ops.iir.iir_filter``, the log-depth scan); all grid beamforming is
matrix products.  None of the six afSTFT kernels serves this path, as in
the JAX package.  ``weights_from_numpy`` / ``state_from_numpy`` take the
JAX package's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import default_device, f32_tensor
from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.modules import sh, vbap
from spatial_audio_framework_tpu_torch.ops.iir import iir_filter
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul
from spatial_audio_framework_tpu_torch.utils import filters as F
from spatial_audio_framework_tpu_torch.utils import presets
from spatial_audio_framework_tpu_torch.utils.geometry import unit_sph2cart

REASS_OFF = "off"
REASS_UPSCALE = "upscale"
REASS_NEAREST = "nearest"


@dataclass(frozen=True)
class DirassConfig:
    input_order: int = 1
    upscale_order: int = 10
    mode: str = REASS_UPSCALE        # dirass.c:52
    beam_type: str = "maxre"         # grid beamformer pattern
    grid_tdesign: int = 14
    interp_res_deg: int = 5
    min_freq_hz: float = 100.0
    max_freq_hz: float = 8000.0
    pmap_avg_coeff: float = 0.25
    fs: float = 48000.0
    ch_ordering: str = C.CH_ACN
    norm: str = C.NORM_SN3D

    @property
    def nsh(self) -> int:
        return (self.input_order + 1) ** 2

    def __post_init__(self):
        C.validate_config(self)


class DirassWeights(NamedTuple):
    W_beam: torch.Tensor     # (nGrid, nSH) analysis-order beams
    Cw: torch.Tensor         # (nGrid, nSH) sector (W) beams, order N-1 padded
    Cxyz: torch.Tensor       # (nGrid, 3, nSH) velocity beams
    Uw: torch.Tensor         # (nGrid, up_nSH) upscale-order beams
    interp_table: torch.Tensor
    conv_in: torch.Tensor
    grid_dirs_deg: np.ndarray
    interp_dirs_deg: np.ndarray
    interp_u: torch.Tensor   # (nInterp, 3) unit vectors for 'nearest'


class DirassState(NamedTuple):
    hpf_z: torch.Tensor           # (nSH, 2) biquad states
    lpf_z: torch.Tensor
    prev_energy: torch.Tensor     # (nGrid,)
    prev_intensity: torch.Tensor  # (nGrid, 3)


def _steered_beams(order: int, pattern: str, dirs_deg: np.ndarray) -> np.ndarray:
    b_n = {"cardioid": sh.beam_weights_cardioid,
           "hypercardioid": sh.beam_weights_hypercardioid,
           "maxre": sh.beam_weights_max_ev}[pattern](order)
    out = np.zeros((dirs_deg.shape[0], (order + 1) ** 2), np.float32)
    for i, (a, e) in enumerate(dirs_deg):
        out[i] = sh.rotate_axis_coeffs_real(order, b_n,
                                            np.pi / 2 - np.radians(e),
                                            np.radians(a))
    return out


def weights_from_numpy(W_beam, Cw, Cxyz, Uw, interp_table, conv_in,
                       grid_dirs_deg, interp_dirs_deg, interp_u,
                       device: torch.device | str | None = None
                       ) -> DirassWeights:
    """Weights (e.g. the JAX package's ``design`` output) from numpy
    arrays → float32 tensors on ``device``; the direction grids stay numpy."""
    t = lambda a: f32_tensor(a, device)  # noqa: E731
    return DirassWeights(
        W_beam=t(W_beam), Cw=t(Cw), Cxyz=t(Cxyz), Uw=t(Uw),
        interp_table=t(interp_table), conv_in=t(conv_in),
        grid_dirs_deg=np.asarray(grid_dirs_deg),
        interp_dirs_deg=np.asarray(interp_dirs_deg), interp_u=t(interp_u))


def design(cfg: DirassConfig,
           device: torch.device | str | None = None) -> DirassWeights:
    """Host design (steered beams, sector and velocity beams, the display
    grid's VBAP interpolation table) → weights on ``device`` (default: the
    card)."""
    grid = presets.tdesign(cfg.grid_tdesign)
    N = cfg.input_order
    W_beam = _steered_beams(N, cfg.beam_type, grid)
    if N >= 2:
        sec, _ = sh.compute_sector_coeffs(N - 1, sh.SECTOR_PATTERN_MAXRE, grid)
        Cw = np.zeros((grid.shape[0], cfg.nsh), np.float32)
        Cw[:, : N * N] = sec[:, 0, : N * N]
        Cxyz = sec[:, 1:, :]  # (nGrid, 3 [x,y,z], (N+1)²)
    else:
        # first order: W sector ≡ omni, velocity beams ≡ dipoles (ACN X,Y,Z)
        Cw = np.zeros((grid.shape[0], cfg.nsh), np.float32)
        Cw[:, 0] = 1.0
        Cxyz = np.zeros((grid.shape[0], 3, cfg.nsh), np.float32)
        Cxyz[:, 0, 3] = Cxyz[:, 1, 1] = Cxyz[:, 2, 2] = 1.0 / np.sqrt(3.0)
    Uw = _steered_beams(cfg.upscale_order, cfg.beam_type, grid)
    az = np.arange(-180, 180 + cfg.interp_res_deg, cfg.interp_res_deg)
    el = np.arange(-90, 90 + cfg.interp_res_deg, cfg.interp_res_deg)
    interp_dirs = np.stack(np.meshgrid(az, el), -1).reshape(-1, 2).astype(np.float64)
    g = vbap.vbap_gain_table_to_interp_table(
        vbap.generate_vbap_gain_table_3d_srcs(interp_dirs, grid))
    return weights_from_numpy(
        W_beam, Cw, Cxyz, Uw, g,
        C.input_conversion_mtx(N, cfg.ch_ordering, cfg.norm), grid,
        interp_dirs, unit_sph2cart(interp_dirs, degrees=True), device)


def init_state(cfg: DirassConfig, w: DirassWeights,
               device: torch.device | str | None = None) -> DirassState:
    device = default_device() if device is None else device
    n_grid = w.W_beam.shape[0]
    z = dict(dtype=torch.float32, device=device)
    return DirassState(hpf_z=torch.zeros((cfg.nsh, 2), **z),
                       lpf_z=torch.zeros((cfg.nsh, 2), **z),
                       prev_energy=torch.zeros(n_grid, **z),
                       prev_intensity=torch.zeros((n_grid, 3), **z))


def state_from_numpy(hpf_z, lpf_z, prev_energy, prev_intensity,
                     device: torch.device | str | None = None) -> DirassState:
    """A state (e.g. the JAX package's) from numpy arrays."""
    return DirassState(*(f32_tensor(a, device) for a in (
        hpf_z, lpf_z, prev_energy, prev_intensity)))


def analysis(cfg: DirassConfig, w: DirassWeights, state: DirassState,
             x: torch.Tensor):
    """x: (nSH, T) → (pmap (nInterp,) normalised 0..1, state)."""
    with fp32_matmul():
        xc = w.conv_in @ x
    b_h, a_h = F.biquad_coeffs(F.BIQUAD_FILTER_HPF, cfg.min_freq_hz, cfg.fs,
                               0.7071)
    b_l, a_l = F.biquad_coeffs(F.BIQUAD_FILTER_LPF, cfg.max_freq_hz, cfg.fs,
                               0.7071)
    xc, hpf_z = iir_filter(b_h, a_h, xc, zi=state.hpf_z)
    xc, lpf_z = iir_filter(b_l, a_l, xc, zi=state.lpf_z)
    lam = cfg.pmap_avg_coeff

    with fp32_matmul():
        ss = (w.W_beam if cfg.mode == REASS_OFF else w.Cw) @ xc  # (nGrid, T)
        if cfg.mode == REASS_OFF:
            e = (ss ** 2).sum(-1)
            e = lam * state.prev_energy + (1.0 - lam) * e
            pmap = w.interp_table @ e
            new_state = state._replace(hpf_z=hpf_z, lpf_z=lpf_z,
                                       prev_energy=e)
        else:
            ssxyz = torch.einsum("gds,st->gdt", w.Cxyz, xc)  # (nGrid, 3, T)
            inten = (ssxyz * ss[:, None, :]).mean(-1)        # (nGrid, 3)
            inten = lam * state.prev_intensity + (1.0 - lam) * inten
            azi = torch.atan2(inten[:, 1], inten[:, 0])
            elev = torch.atan2(inten[:, 2], torch.sqrt(inten[:, 0] ** 2
                                                       + inten[:, 1] ** 2))
            if cfg.mode == REASS_UPSCALE:
                dirs_rad = torch.stack([azi, math.pi / 2 - elev], -1)
                Y_up = sh.get_sh_real_torch(cfg.upscale_order, dirs_rad) \
                    * math.sqrt(4.0 * math.pi)        # (up_nSH, nGrid)
                ss_up = w.Uw @ (Y_up @ ss)
                e = (ss_up ** 2).sum(-1)
                e = lam * state.prev_energy + (1.0 - lam) * e
                pmap = w.interp_table @ e
            else:  # REASS_NEAREST
                ce = torch.cos(elev)
                u_est = torch.stack([ce * torch.cos(azi), ce * torch.sin(azi),
                                     torch.sin(elev)], -1)   # (nGrid, 3)
                nearest = torch.argmax(u_est @ w.interp_u.T, dim=-1)
                # upstream quirk (C_PARITY #11): dirass.c:378-379 ASSIGNS
                # pmap[i] = ss[i,j]^2 inside the sample loop (OFF/UPSCALE
                # use +=), so NEAREST carries only the LAST sample's energy
                # per sector, not the frame sum.  Mirrored for parity.
                e = ss[:, -1] ** 2
                e = lam * state.prev_energy + (1.0 - lam) * e
                pmap = torch.zeros(w.interp_table.shape[0], dtype=e.dtype,
                                   device=e.device).index_add_(0, nearest, e)
            new_state = DirassState(hpf_z=hpf_z, lpf_z=lpf_z, prev_energy=e,
                                    prev_intensity=inten)
    pmin, pmax = pmap.min(), pmap.max()
    return (pmap - pmin) / (pmax - pmin + 1e-11), new_state
