"""sldoa — spatially-localised active-intensity DoA analyser (counterpart of
``spatial_audio_framework_tpu/models/sldoa.py``; ``examples/src/sldoa``;
McCormack et al. 2019, JAES 67(11)).

* **Per-order sector design** (sldoa_internal.c:62-122): for every analysis
  order o in 2..masterOrder, o² sector directions come from the minimal
  sphere-covering presets; VBAP gain patterns over a dense icosphere fit
  grid (the reference's 2562-point ``sldoa_database.c`` grid, regenerated
  from the geosphere + SH basis) are multiplied with the omni + normalised
  dipole basis rows and least-squares fitted (pinv of the grid SH matrix)
  to give each sector's WXYZ beamforming coefficients.
* **Per-band analysis order** (sldoa_internal.h:124): bands of one order
  share one coefficient matrix, so the sector signals are one
  (maxSec·4, nSH) @ (nSH, nB·H) product per distinct order.
* **Estimation** (sldoa_internal.c:144-209): sector signals → N3D→SN3D
  dipole scaling → energy + active intensity → per-slot azi/elev.
* **Averaging + display** (sldoa.c:263-336): energies one-pole averaged in
  closed form (the gated one-pole is linear); DoAs one-pole averaged in
  Cartesian and renormalised slot by slot, a sequential loop as the JAX
  package's scan; per-band display vectors with [minFreq, maxFreq] gating.

``analysis`` is one instance on the single-stream filterbank (plain torch,
no kernel, as in the JAX package); ``analysis_batched`` serves n instances
with the batched filterbank, whose front is the CUDA kernel
``analysis_front_ri`` over the (n · nSH) rows when ``fused``.
``weights_from_numpy`` / ``state_from_numpy`` take the JAX package's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import default_device, f32_tensor
from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.modules import sh, vbap
from spatial_audio_framework_tpu_torch.ops import afstft_ri as ri
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul
from spatial_audio_framework_tpu_torch.utils import presets


def order2num_sectors(order: int) -> int:
    """ORDER2NUMSECTORS(order) = order² (sldoa_internal.h)."""
    return max(1, order * order)


@dataclass(frozen=True)
class SldoaConfig:
    master_order: int = 1
    fs: float = 48000.0
    ch_ordering: str = C.CH_ACN
    norm: str = C.NORM_SN3D
    hop: int = 128
    # Per-band analysis order, clipped to [1, master_order]; None → master
    # everywhere (sldoa.c:62).  Static (shape-determining).
    analysis_order_per_band: Optional[Tuple[int, ...]] = None
    min_freq: float = 500.0   # sldoa.c:65
    max_freq: float = 5e3     # sldoa.c:66
    avg_ms: float = 500.0     # sldoa.c:67
    fit_grid_level: int = 16  # icosphere freq → 2562 dirs (sldoa_database.h)

    @property
    def nsh(self) -> int:
        return (self.master_order + 1) ** 2

    @property
    def max_sectors(self) -> int:
        return order2num_sectors(self.master_order)

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
    def avg_coeff(self) -> float:
        """sldoa.c:271-272 one-pole coefficient from avg_ms."""
        if self.avg_ms < 10.0:
            return 0.99999
        a = 1.0 / ((self.avg_ms / 1e3) / (1.0 / self.hop) + 2.23e-9)
        return float(np.clip(a, 0.0, 0.99999))

    def __post_init__(self):
        C.validate_config(self)


def _sector_coeffs_vbap(order: int, nsh_master: int,
                        grid_dirs_deg: np.ndarray, Y_grid: np.ndarray,
                        dipoles_norm: np.ndarray) -> tuple:
    """One order's sector coefficients (sldoa_internal.c:73-117):
    VBAP-interp gains of the sphere-covering sector layout over the fit
    grid, imposed on [omni, normalised dipoles], LS-fitted via pinv(Y)."""
    n_sec = order2num_sectors(order)
    nsh_o = (order + 1) ** 2
    sec_dirs = presets.sphere_covering(n_sec)
    g = vbap.generate_vbap_gain_table_3d_srcs(grid_dirs_deg, sec_dirs)
    g = vbap.vbap_gain_table_to_interp_table(g)          # (nGrid, nSec)
    basis = np.concatenate([Y_grid[0:1], dipoles_norm], 0)  # (4, nGrid)
    pinv_Y = np.linalg.pinv(Y_grid[:nsh_o])              # (nGrid, nSH_o)
    # secPatterns[n] = vbap_col_n * basis → w = patterns @ pinv_Y
    pat = g.T[:, None, :] * basis[None, :, :]            # (nSec, 4, nGrid)
    w = pat @ pinv_Y                                     # (nSec, 4, nSH_o)
    out = np.zeros((n_sec, 4, nsh_master), np.float32)
    out[:, :, :nsh_o] = w
    return out, sec_dirs


class SldoaWeights(NamedTuple):
    sec_coeffs: torch.Tensor     # (nBands, maxSec, 4, nSH) per-band WXYZ beams
    sec_mask: torch.Tensor       # (nBands, maxSec) valid-sector mask
    band_in_range: torch.Tensor  # (nBands,) [minFreq, maxFreq] gate, DC off
    colour_scale: torch.Tensor   # (nBands,) static display colours
    conv_in: torch.Tensor
    sec_dirs_deg: dict           # order → (nSec, 2) sector directions
    orders_per_band: np.ndarray
    # per distinct analysis order: (band mask (nB,), coeffs (maxSec·4, nSH))
    order_groups: tuple
    first_order: torch.Tensor    # (nBands, 1) bool: order-1 bands (alpha 1)


def _design_host(cfg: SldoaConfig) -> dict:
    conv = C.input_conversion_mtx(cfg.master_order, cfg.ch_ordering, cfg.norm)
    orders = cfg.orders_per_band()
    n_bands = cfg.afstft.n_bands
    max_sec = cfg.max_sectors

    # fit grid (regenerates the sldoa_database tables)
    grid = presets.geosphere(cfg.fit_grid_level)         # (~2562, 2) deg
    dirs_rad = np.stack([np.radians(grid[:, 0]),
                         np.pi / 2 - np.radians(grid[:, 1])], -1)
    Y_grid = sh.get_sh_real(cfg.master_order, dirs_rad) * np.sqrt(4 * np.pi)
    dipoles_norm = Y_grid[1:4] / np.sqrt(3.0)            # sldoa.c:88

    # per-order coefficient tables (orders ≥ 2)
    per_order, sec_dirs_deg = {}, {}
    for o in sorted(set(orders[orders >= 2].tolist())):
        per_order[o], sec_dirs_deg[o] = _sector_coeffs_vbap(
            o, cfg.nsh, grid, Y_grid, dipoles_norm)
    # order-1 "sector": WXYZ passthrough, ACN rows (W, Y, Z, X) into the
    # estimator's (W, X', Y', Z') slots as in the first-order branch
    o1 = np.zeros((1, 4, cfg.nsh), np.float32)
    o1[0, :4, :4] = np.eye(4)
    sec_dirs_deg[1] = np.zeros((1, 2))

    coeffs = np.zeros((n_bands, max_sec, 4, cfg.nsh), np.float32)
    mask = np.zeros((n_bands, max_sec), np.float32)
    for b, o in enumerate(orders):
        cb = per_order[o] if o >= 2 else o1
        coeffs[b, :cb.shape[0]] = cb
        mask[b, :cb.shape[0]] = 1.0

    groups = []
    for o in sorted(set(orders.tolist())):
        cb = per_order[o] if o >= 2 else o1
        cfull = np.zeros((max_sec * 4, cfg.nsh), np.float32)
        cfull[:cb.shape[0] * 4] = cb.reshape(-1, cfg.nsh)
        groups.append(((orders == o).astype(np.float32), cfull))

    freqs = cfg.afstft.centre_freqs(cfg.fs)
    in_range = ((freqs >= cfg.min_freq) & (freqs <= cfg.max_freq))
    in_range[0] = False  # ignore DC (sldoa.c:266)
    min_band = int(np.max(np.nonzero(freqs <= cfg.min_freq)[0], initial=0))
    n_ana = max(int(in_range.sum()), 1)
    colour = np.where(in_range,
                      (np.arange(n_bands) - min_band) / (n_ana + 1.0),
                      0.0).astype(np.float32)
    return dict(sec_coeffs=coeffs, sec_mask=mask,
                band_in_range=in_range.astype(np.float32),
                colour_scale=colour, conv_in=conv, sec_dirs_deg=sec_dirs_deg,
                orders_per_band=orders, order_groups=tuple(groups))


def weights_from_numpy(sec_coeffs, sec_mask, band_in_range, colour_scale,
                       conv_in, sec_dirs_deg, orders_per_band, order_groups,
                       device: torch.device | str | None = None
                       ) -> SldoaWeights:
    """Weights (e.g. the JAX package's ``design`` output, its arrays as
    numpy) → float32 tensors on ``device``; ``order_groups`` as ((band
    mask, coeffs), ...)."""
    t = lambda a: f32_tensor(a, device)  # noqa: E731
    return SldoaWeights(
        sec_coeffs=t(sec_coeffs), sec_mask=t(sec_mask),
        band_in_range=t(band_in_range), colour_scale=t(colour_scale),
        conv_in=t(conv_in), sec_dirs_deg=dict(sec_dirs_deg),
        orders_per_band=np.asarray(orders_per_band),
        order_groups=tuple((t(m), t(c)) for m, c in order_groups),
        first_order=t(np.asarray(orders_per_band)[:, None] == 1) > 0)


def design(cfg: SldoaConfig,
           device: torch.device | str | None = None) -> SldoaWeights:
    """Host design → weights on ``device`` (default: the card)."""
    return weights_from_numpy(**_design_host(cfg), device=device)


class SldoaState(NamedTuple):
    bank: object          # ri.AfSTFTStateRI, or ri.AfSTFTStateBatched
    doa_xyz: torch.Tensor  # ([n,] nBands, maxSec, 3) averaged DoA unit vectors
    energy: torch.Tensor   # ([n,] nBands, maxSec) averaged sector energies


class SldoaOutput(NamedTuple):
    doa_rad: torch.Tensor       # (..., nBands, maxSec, H, 2) per-slot estimates
    energy: torch.Tensor        # (..., nBands, maxSec, H) per-slot energies ×1e6
    azi_deg: torch.Tensor       # (..., nBands, maxSec) averaged display azimuths
    elev_deg: torch.Tensor      # (..., nBands, maxSec)
    colour_scale: torch.Tensor  # (..., nBands, maxSec)
    alpha_scale: torch.Tensor   # (..., nBands, maxSec)


def _init(cfg: SldoaConfig, bank, lead: tuple, device) -> SldoaState:
    n_bands = cfg.afstft.n_bands
    z = dict(dtype=torch.float32, device=device)
    doa = torch.zeros(tuple(lead) + (n_bands, cfg.max_sectors, 3), **z)
    doa[..., 0].fill_(1.0)   # arbitrary unit vectors
    return SldoaState(bank=bank, doa_xyz=doa,
                      energy=torch.zeros(tuple(lead)
                                         + (n_bands, cfg.max_sectors), **z))


def init_state(cfg: SldoaConfig,
               device: torch.device | str | None = None) -> SldoaState:
    device = default_device() if device is None else device
    return _init(cfg, ri.init_state_ri(cfg.afstft, cfg.nsh, 1, device=device),
                 (), device)


def init_state_batched(cfg: SldoaConfig, n: int,
                       device: torch.device | str | None = None) -> SldoaState:
    """State for ``analysis_batched``: n independent analyser instances on
    the batched filterbank."""
    device = default_device() if device is None else device
    return _init(cfg, ri.init_state_batched(cfg.afstft, n, cfg.nsh, 1,
                                            device=device), (n,), device)


def state_from_numpy(bank: tuple, doa_xyz, energy,
                     device: torch.device | str | None = None) -> SldoaState:
    """A state (e.g. the JAX package's) from numpy arrays: ``bank`` is the
    single-stream filterbank's (in_tail, hyb_tail_re, hyb_tail_im,
    ola_tail), or the batched one's (in_tail, ola_tail)."""
    bank = (ri.state_ri_from_numpy(*bank, device=device) if len(bank) == 4
            else ri.AfSTFTStateBatched(*(f32_tensor(a, device) for a in bank)))
    return SldoaState(bank=bank, doa_xyz=f32_tensor(doa_xyz, device),
                      energy=f32_tensor(energy, device))


def analysis(cfg: SldoaConfig, w: SldoaWeights, state: SldoaState,
             x: torch.Tensor):
    """x: (nSH, T) → (SldoaOutput, state)."""
    with fp32_matmul():
        xc = w.conv_in @ x
    (sre, sim), bank_st = ri.analysis_ri(cfg.afstft, state.bank, xc)
    out, doa_xyz, energy = _post_front(cfg, w, state, sre, sim)
    return out, SldoaState(bank=bank_st, doa_xyz=doa_xyz, energy=energy)


def analysis_batched(cfg: SldoaConfig, w: SldoaWeights, state: SldoaState,
                     x: torch.Tensor, fused: bool = True):
    """n independent sldoa instances in one call: x (n, nSH, T) →
    (SldoaOutput with a leading n axis, state).  The front runs as one
    batched call over all n·nSH channels (``analysis_front_ri`` when
    ``fused``); the estimator is batched over the instance axis."""
    with fp32_matmul():
        xc = w.conv_in @ x
    (sre, sim), bank_st = ri.analysis_ri_batched(cfg.afstft, state.bank, xc,
                                                 use_kernel=fused)
    sre = sre.permute(0, 3, 1, 2)    # (n, nB, nSH, H)
    sim = sim.permute(0, 3, 1, 2)
    out, doa_xyz, energy = _post_front(cfg, w, state, sre, sim)
    return out, SldoaState(bank=bank_st, doa_xyz=doa_xyz, energy=energy)


def _post_front(cfg: SldoaConfig, w: SldoaWeights, state: SldoaState,
                sre: torch.Tensor, sim: torch.Tensor):
    """Sector estimation + slot averaging from (..., nB, nSH, H) spectra;
    shared by the single-instance and batched entry points."""
    nB, nsh, H = sre.shape[-3:]
    lead = sre.shape[:-3]
    S_ = w.sec_mask.shape[1]
    BH = nB * H
    st_re = sre.transpose(-3, -2).reshape(lead + (nsh, BH))
    st_im = sim.transpose(-3, -2).reshape(lead + (nsh, BH))
    # sector WXYZ signals: one product per static order group, masked to
    # the group's bands (einsum("bcws,bsh->bcwh", sec_coeffs, s*))
    ws_re = ws_im = 0.0
    with fp32_matmul():
        for gm, coef in w.order_groups:
            mb = gm[:, None].expand(nB, H).reshape(1, BH)
            ws_re = ws_re + mb * (coef @ st_re)
            ws_im = ws_im + mb * (coef @ st_im)
    # N3D→SN3D on the dipoles (sldoa_internal.c:182-185)
    scale = torch.full((4, 1), 1.0 / math.sqrt(3.0), dtype=sre.dtype,
                       device=sre.device)
    scale[0].fill_(1.0)
    ws_re = ws_re.reshape(lead + (S_, 4, BH)) * scale
    ws_im = ws_im.reshape(lead + (S_, 4, BH)) * scale
    energy_s = 0.5 * torch.sum(ws_re ** 2 + ws_im ** 2, dim=-2)   # (.., S, BH)
    # active intensity: Re(conj(W) · dipole); dipole slots are the ACN rows
    # (Y, Z, X), so azi = atan2(I_y, I_x), elev vs the horizontal plane
    # (sldoa_internal.c:196-199)
    w_re, w_im = ws_re[..., 0, :], ws_im[..., 0, :]
    Iy = w_re * ws_re[..., 1, :] + w_im * ws_im[..., 1, :]       # (.., S, BH)
    Iz = w_re * ws_re[..., 2, :] + w_im * ws_im[..., 2, :]
    Ix = w_re * ws_re[..., 3, :] + w_im * ws_im[..., 3, :]

    def to_bsh(t):   # (..., S, B·H) → (..., B, S, H)
        return t.reshape(lead + (S_, nB, H)).transpose(-3, -2)

    azi = torch.atan2(Iy, Ix)
    elev = torch.atan2(Iz, torch.sqrt(Ix * Ix + Iy * Iy))
    doa = torch.stack([to_bsh(azi), to_bsh(elev)], dim=-1)   # (.., B, S, H, 2)
    energy = to_bsh(energy_s)                                # (.., B, S, H)

    # one-pole averaging across slots (sldoa.c:279-292)
    a = cfg.avg_coeff
    # per-slot DoA unit vector: the C's cos/sin(atan2(..)) round trip is
    # algebraically I/‖I‖; the all-zero intensity maps to (1, 0, 0) exactly
    # as cos(0)cos(0).  No lower clamp: rsqrt of the smallest positive f32
    # stays finite, and the n2 == 0 lane is masked
    n2 = Ix * Ix + Iy * Iy + Iz * Iz
    nz = n2 > 0
    inv = torch.where(nz, torch.rsqrt(n2), 0.0)
    u = torch.stack([torch.where(nz, Ix * inv, 1.0), Iy * inv, Iz * inv],
                    dim=-1)                                  # (.., S, BH, 3)
    gate_bs = w.band_in_range[:, None] * w.sec_mask          # (B, S)
    gate_t = gate_bs.transpose(0, 1) > 0                     # (S, B)

    # energy: the gated one-pole is LINEAR, so fold all H slots in closed
    # form, one weighted reduction instead of H sequential steps
    wgt = a * (1.0 - a) ** torch.arange(H - 1, -1, -1.0, dtype=torch.float32,
                                        device=sre.device)
    prev_e = state.energy.transpose(-1, -2)                  # (.., S, B)
    with fp32_matmul():
        en_fold = (prev_e * (1.0 - a) ** H
                   + torch.einsum("...sbh,h->...sb",
                                  1e6 * energy_s.reshape(lead + (S_, nB, H)),
                                  wgt))
    avg_en = torch.where(gate_t, en_fold, prev_e).transpose(-1, -2)

    # DoA: the per-slot renormalisation makes the fold nonlinear: a
    # sequential loop over the slots, carrying (.., S, B, 3)
    slots = u.reshape(lead + (S_, nB, H, 3))
    carry = state.doa_xyz.transpose(-3, -2)                  # (.., S, B, 3)
    g3 = gate_t[..., None]
    for h in range(H):
        p = torch.lerp(carry, slots[..., h, :], a)
        nrm = torch.clamp_min(torch.linalg.vector_norm(p, dim=-1,
                                                       keepdim=True), 1e-12)
        carry = torch.where(g3, p / nrm, carry)
    avg_xyz = carry.transpose(-3, -2)                        # (.., B, S, 3)

    # display vectors (sldoa.c:297-336)
    azi_avg = torch.rad2deg(torch.atan2(avg_xyz[..., 1], avg_xyz[..., 0]))
    elev_avg = torch.rad2deg(torch.atan2(
        avg_xyz[..., 2], torch.sqrt(avg_xyz[..., 0] ** 2
                                    + avg_xyz[..., 1] ** 2)))
    valid = w.sec_mask > 0
    big = 2.3e13
    max_en = torch.where(valid, avg_en, -big).amax(dim=-1, keepdim=True)
    min_en = torch.where(valid, avg_en, big).amin(dim=-1, keepdim=True)
    alpha = torch.clamp((avg_en - min_en) / (max_en - min_en + 2.3e-10),
                        0.05, 1.0)
    alpha = torch.where(w.first_order, 1.0, alpha)
    out = SldoaOutput(
        doa_rad=doa, energy=energy * 1e6,
        azi_deg=azi_avg * gate_bs, elev_deg=elev_avg * gate_bs,
        colour_scale=(w.colour_scale[:, None] * w.sec_mask).expand(
            lead + (nB, S_)),
        alpha_scale=alpha * gate_bs)
    return out, avg_xyz, avg_en
