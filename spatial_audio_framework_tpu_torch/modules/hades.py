"""HADES — parametric binaural renderer for hearing-assistive devices
(counterpart of ``spatial_audio_framework_tpu/modules/hades.py``;
``saf_hades``: saf_hades_analysis.h / saf_hades_synthesis.h).

* Analysis (:class:`HadesAnalysis`): afSTFT → per-band SCM with temporal
  averaging → diffuse whitening (from the array's theoretical diffuse
  covariance) → eigendecomposition → COMEDIE diffuseness + sdMUSIC DoA over
  whitened array steering vectors (saf_hades_analysis.c:244-357).
* Synthesis (:class:`HadesSynthesis`): per band, the direct stream by
  filter-and-sum or binaural-MVDR beamformers expressed as relative
  transfer functions to reference sensors plus HRTF re-mapping, the diffuse
  stream from the reference sensors × diffuse EQ; stream balance and EQ;
  optional covariance matching by CDF4SAP (saf_hades_synthesis.c:308-470).

The per-band chain — SCM, whitening, eigendecomposition, beamformer solves,
CDF4SAP — is batched over all bands in split (re, im) arithmetic
(``ops/herm_ri``).  With 2 microphones (the binaural case) every step is a
closed form on tensors: no ``torch.linalg`` call and no host wait.  Wider
arrays take ``torch.linalg.eigh`` / ``svd``, which make the host wait on
the card.

Entry points: the two-stage :meth:`HadesAnalysis.apply` /
:meth:`HadesSynthesis.apply` with the host parameter container between
them (what the C goldens and :class:`HadesRadialEditor` use), and
:class:`HadesPipeline`: one block (``process``), many blocks a call without
a loop over blocks (``process_chunk``, its one-pole recurrences as
triangular products, ``ops/iir.onepole_ewma_mats``), and N instances a call
(``process_chunk_batched``: with ``fused=True`` the filterbank's front and
back are the kernels ``analysis_front_ri`` / ``synthesis_back_ri`` over the
(instances × channels) rows).  The single-instance paths run the plain
single-stream filterbank, as the JAX package does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import default_device, f32_tensor
from spatial_audio_framework_tpu_torch.modules import cdf4sap
from spatial_audio_framework_tpu_torch.modules import hrir as hrir_mod
from spatial_audio_framework_tpu_torch.ops import afstft_ri as ri
from spatial_audio_framework_tpu_torch.ops import herm_ri as H
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT
from spatial_audio_framework_tpu_torch.ops.iir import onepole_ewma_mats
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul
from spatial_audio_framework_tpu_torch.utils import geometry as geo

HADES_USE_COMEDIE = "comedie"
HADES_USE_MUSIC = "music"
HADES_BEAMFORMER_NONE = "none"
HADES_BEAMFORMER_FILTER_AND_SUM = "filter_and_sum"
HADES_BEAMFORMER_BMVDR = "bmvdr"
HADES_HRTF_INTERP_NEAREST = "nearest"
HADES_HRTF_INTERP_TRIANGULAR = "triangular"


def comedie(evals: np.ndarray) -> float:
    """COMEDIE diffuseness from eigenvalues (saf_hades_internal.c:242)."""
    lam = np.asarray(evals, np.float64)
    N = lam.shape[-1]
    nord = np.sqrt(N) - 1.0
    s = lam.sum()
    if s < 1e-4:
        return 1.0
    g0 = 2.0 * ((nord + 1.0) ** 2 - 1.0)
    mean_ev = s / (nord + 1.0) ** 2
    g = np.abs(lam - mean_ev).sum() / mean_ev
    return float(max(1.0 - g / g0, 0.0))


def comedie_batch(lam: torch.Tensor) -> torch.Tensor:
    """comedie() over leading axes, on tensors."""
    N = lam.shape[-1]
    nord = np.sqrt(N) - 1.0
    s = lam.sum(-1)
    g0 = 2.0 * ((nord + 1.0) ** 2 - 1.0)
    mean_ev = s / (nord + 1.0) ** 2
    g = (lam - mean_ev[..., None]).abs().sum(-1) / (mean_ev + 2.23e-13)
    out = (1.0 - g / g0).clamp_min(0.0)
    return torch.where(s < 1e-4, 1.0, out)


@dataclass
class HadesParams:
    """hades_param_container (saf_hades_analysis.h:221-253), host numpy."""
    diffuseness: np.ndarray   # (nBands,)
    doa_idx: np.ndarray       # (nBands,) int
    gains_idx: np.ndarray
    gains_dir: np.ndarray
    gains_diff: np.ndarray


@dataclass
class HadesSignals:
    """hades_signal_container: inTF and Cx as (re, im) tensor pairs."""
    inTF: tuple   # ((nBands, nMics, H), ×2)
    Cx: tuple     # ((nBands, nMics, nMics), ×2) instantaneous SCMs


def _horizontal(grid_dirs_deg: np.ndarray) -> bool:
    return np.abs(grid_dirs_deg[:, 1]).sum() / grid_dirs_deg.shape[0] < 1e-4


class HadesAnalysis:
    def __init__(self, fs: float = 48000.0, hop: int = 128,
                 h_array: Optional[np.ndarray] = None,
                 grid_dirs_deg: Optional[np.ndarray] = None,
                 diff_opt: str = HADES_USE_COMEDIE,
                 doa_opt: str = HADES_USE_MUSIC,
                 blocksize: Optional[int] = None,
                 hybrid: bool = True, low_delay: bool = False,
                 device: torch.device | str | None = None):
        """h_array: (nGrid, nMics, h_len) measured array IRs; defaults to
        every fourth direction of the default HRIR set (a binaural 2-mic
        array).  Device constants on ``device`` (default: the card)."""
        if h_array is None:
            h_array, grid_dirs_deg, _ = hrir_mod.default_hrirs()
            h_array = h_array[::4]
            grid_dirs_deg = grid_dirs_deg[::4]
        self.device = default_device() if device is None else device
        self.fs, self.hop = fs, hop
        self.bank = AfSTFT(hop=hop, hybrid=hybrid, low_delay=low_delay)
        self.n_mics = h_array.shape[1]
        self.n_grid = h_array.shape[0]
        self.grid_dirs_deg = np.asarray(grid_dirs_deg)
        # scale by the SIGNED value of the largest-magnitude tap
        # (hades_analysis_create:94-95: isamax index, then 1/h[idx])
        h_array = np.asarray(h_array, np.float32)
        h_array = h_array / h_array.flat[np.abs(h_array).argmax()]
        self.freq_vector = self.bank.centre_freqs(fs)
        self.n_bands = self.bank.n_bands
        self.H_array = hrir_mod.hrirs_to_hrtfs_afstft(
            h_array, hop, low_delay=low_delay, hybrid=hybrid)  # (nB,nM,nG)
        # integration weights (hades_analysis_create:122-132): raw Voronoi
        # areas, or identity when the grid is horizontal-only
        if _horizontal(self.grid_dirs_deg):
            w = np.ones(self.n_grid, np.float64)
        else:
            w = geo.get_voronoi_weights(self.grid_dirs_deg).astype(np.float64)
        self.int_weights = w
        # diffuse covariance + whitening matrices (hades_analysis_create)
        self.DCM = np.einsum("bmg,g,bng->bmn", self.H_array, w / self.n_grid,
                             self.H_array.conj())
        T = np.zeros_like(self.DCM)
        for b in range(self.n_bands):
            e, U = np.linalg.eigh(self.DCM[b])
            e = e[::-1]
            U = U[:, ::-1]
            T[b] = np.diag(np.sqrt(1.0 / (e.real + 2.23e-10))) @ U.conj().T
        blocksize = 8 * hop if blocksize is None else blocksize
        assert blocksize % hop == 0
        self.blocksize = blocksize
        self.time_slots = blocksize // hop
        # hades_analysis_create:90-91 + the run-time 0.999 clamp at apply
        self.cov_avg_coeff = min(max(
            1.0 - 1.0 / (4096.0 / blocksize), 0.0), 0.99999)
        self.cov_avg_coeff = min(self.cov_avg_coeff, 0.999)
        self.diff_opt, self.doa_opt = diff_opt, doa_opt
        self.load_consts(self.H_array, T,
                         np.einsum("bmn,bng->bmg", T, self.H_array))
        z = torch.zeros((self.n_bands, self.n_mics, self.n_mics),
                        dtype=torch.float32, device=self.device)
        self.Cx_avg = (z, z.clone())
        self.bank_state = ri.init_state_ri(self.bank, self.n_mics, 2,
                                           self.device)

    def load_consts(self, H_array: np.ndarray, T: np.ndarray,
                    H_array_w: np.ndarray) -> None:
        """The array's filterbank responses H_array (nBands, nMics, nGrid),
        the whitening matrices T (nBands, nMics, nMics) and the whitened
        steering H_array_w (nBands, nMics, nGrid), complex numpy (e.g. the
        JAX package's), and the device constants made from them: T and the
        whitened steering as (re, im) pairs, and for 2 microphones T's four
        entries and the sdMUSIC quadform tables (per band and grid
        direction |a0|², |a1|², conj(a0)·a1).  A synthesis reads H_array
        when it is made (or loads its own constants)."""
        self.H_array = np.asarray(H_array)
        self.T, self.H_array_w = np.asarray(T), np.asarray(H_array_w)
        dev = self.device
        self._T_d = H.split(self.T, dev)
        self._Aw_d = H.split(self.H_array_w, dev)
        if self.n_mics == 2:
            self._T_e = tuple(tuple(H.split(self.T[:, i, j], dev)
                                    for j in (0, 1)) for i in (0, 1))
            a0, a1 = self.H_array_w[:, 0], self.H_array_w[:, 1]
            z = a0.conj() * a1
            self._qf_d = tuple(f32_tensor(a, dev) for a in (
                np.abs(a0) ** 2, np.abs(a1) ** 2, z.real, z.imag))

    @property
    def proc_delay(self) -> int:
        return self.bank.proc_delay

    def _cov_stats(self, Cx_avg):
        """Averaged SCM (..., nBands, nMics, nMics) → (COMEDIE diffuseness,
        sdMUSIC DoA index), batched over any leading axes."""
        # whiten: Cw = T Cx Tᴴ
        Cw = H.cmatmul(H.cmatmul(self._T_d, Cx_avg), H.chermitian(self._T_d))
        # eigenvalues (descending) → COMEDIE; noise projector → sdMUSIC
        if self.n_mics == 2:
            ev, V = H.herm_eig_2x2(Cw)           # descending
            vn = (V[0][..., 1:], V[1][..., 1:])   # smallest-λ eigenvector
            Pn = H.cmatmul(vn, H.chermitian(vn))
        else:
            # torch.linalg.eigh: a host wait on the card (arrays > 2 mics)
            ev, V = H.herm_eig_pairs(Cw)          # ascending
            # Rayleigh-refined eigenvalues: COMEDIE consumes only λ, and the
            # quotient squares the float32 vector error
            ev = H.rayleigh_refine(Cw, V).flip(-1)
            Pn = H.noise_projector(Cw, 1)
        diff = comedie_batch(ev.clamp_min(0.0))
        # sdMUSIC pseudo-spectrum: 1 / ‖Vnᴴ a‖² (hades_sdMUSIC_compute,
        # saf_hades_internal.c:196-204: no |a|² numerator)
        den = H.herm_quadform(Pn, self._Aw_d)     # (..., nBands, nGrid)
        return diff, torch.argmin(den, dim=-1)

    def _cov_stats_e(self, C_e):
        """_cov_stats for 2 microphones with the SCM in entry form
        (((c00, c01), (c10, c11)) of (re, im) tensors, bands last): whiten
        → closed-form eig → COMEDIE + sdMUSIC, elementwise."""
        Cw = cdf4sap._m2_mul(cdf4sap._m2_mul(self._T_e, C_e),
                             cdf4sap._m2_herm(self._T_e))
        l1, l2, V = cdf4sap._herm_eig_2x2_e(Cw[0][0][0], Cw[1][1][0],
                                            *Cw[0][1])
        diff = comedie_batch(torch.stack([l1.clamp_min(0.0),
                                          l2.clamp_min(0.0)], -1))
        # noise projector from the smallest-λ eigenvector v (second row
        # real): Pn = v vᴴ → p00 = |v₀|², p11 = v₁², p01 = v₀·v₁
        v2r0, v2i0 = V[0][1]
        v2r1 = V[1][1][0]
        p00 = v2r0 * v2r0 + v2i0 * v2i0
        p11 = v2r1 * v2r1
        p01r = v2r0 * v2r1
        p01i = v2i0 * v2r1
        A0, A1, zr, zi = self._qf_d
        den = (p00[..., None] * A0 + p11[..., None] * A1
               + 2.0 * (p01r[..., None] * zr - p01i[..., None] * zi))
        return diff, torch.argmin(den, dim=-1)

    def _step(self, bank_state, Cx_avg, x):
        """One block, batched over all bands."""
        (sre, sim), bank_state = ri.analysis_ri(self.bank, bank_state, x)
        with fp32_matmul():
            Cx_new = (torch.einsum("bmh,bnh->bmn", sre, sre)
                      + torch.einsum("bmh,bnh->bmn", sim, sim),
                      torch.einsum("bmh,bnh->bmn", sim, sre)
                      - torch.einsum("bmh,bnh->bmn", sre, sim))
        lam = self.cov_avg_coeff
        Cx_avg = (lam * Cx_avg[0] + (1 - lam) * Cx_new[0],
                  lam * Cx_avg[1] + (1 - lam) * Cx_new[1])
        diff, doa_idx = self._cov_stats(Cx_avg)
        return bank_state, Cx_avg, (sre, sim), Cx_new, diff, doa_idx

    def apply(self, x: torch.Tensor):
        """x: (nMics, T) → (HadesParams, HadesSignals).  The parameters
        come back to the host (the container the radial editor edits)."""
        bank_state, Cx_avg, inTF, Cx_new, diff, doa_idx = self._step(
            self.bank_state, self.Cx_avg, torch.as_tensor(x).to(self.device))
        self.bank_state, self.Cx_avg = bank_state, Cx_avg
        doa_idx = doa_idx.cpu().numpy()
        params = HadesParams(diffuseness=diff.cpu().numpy(),
                             doa_idx=doa_idx, gains_idx=doa_idx.copy(),
                             gains_dir=np.ones(self.n_bands, np.float32),
                             gains_diff=np.ones(self.n_bands, np.float32))
        return params, HadesSignals(inTF=inTF, Cx=Cx_new)


class HadesRadialEditor:
    """hades_radial_editor (saf_hades_synthesis.h:96-115): a per-direction
    gain pattern applied to the per-band direct/diffuse gains (host)."""

    def __init__(self, grid_dirs_deg: np.ndarray):
        self.grid_dirs_deg = np.asarray(grid_dirs_deg)

    def apply(self, params: HadesParams, dir_gains_db: np.ndarray):
        """dir_gains_db: (360,) azimuth-dependent gains in dB.

        hades_radial_editor_apply (saf_hades_synthesis.c:77-99): looks up
        the azimuth of ``gains_idx``, shifts -180..180 to 0..360, rounds
        half-up and clamps to [0, 359], clamps the dB edit to [-60, +12],
        and MULTIPLIES onto the existing per-band direct gains."""
        azi = self.grid_dirs_deg[params.gains_idx, 0].astype(np.float64)
        azi = np.where(azi < 0.0, azi + 360.0, azi)
        edit_idx = np.clip(np.floor(azi + 0.5).astype(int), 0, 359)
        g_db = np.clip(np.asarray(dir_gains_db, np.float64)[edit_idx],
                       -60.0, 12.0)
        params.gains_dir = (params.gains_dir *
                            (10.0 ** (g_db / 20.0))).astype(np.float32)
        return params


class HadesSynthesis:
    def __init__(self, ana: HadesAnalysis,
                 hrirs: Optional[np.ndarray] = None,
                 hrir_dirs_deg: Optional[np.ndarray] = None,
                 beam_option: str = HADES_BEAMFORMER_FILTER_AND_SUM,
                 ref_indices=(0, 1), enable_cm: bool = True,
                 hrir_fs: float = 48000.0,
                 interp_option: str = HADES_HRTF_INTERP_TRIANGULAR):
        """Device constants on the analysis's device."""
        self.ana = ana
        self.beam_option = beam_option
        self.ref = ref_indices
        self.enable_cm = enable_cm
        if hrirs is None:
            hrirs, hrir_dirs_deg, hrir_fs = hrir_mod.default_hrirs()
        hrirs = np.asarray(hrirs, np.float32)
        hrir_dirs_deg = np.asarray(hrir_dirs_deg, np.float64)
        # HRTFs through the SAME filterbank config, interpolated to the
        # analysis grid (hades_getInterpolatedHRTFs,
        # saf_hades_internal.c:42-114)
        H_fb = hrir_mod.hrirs_to_hrtfs_afstft(
            hrirs, ana.hop, low_delay=ana.bank.low_delay,
            hybrid=ana.bank.hybrid)
        # target-grid weights (None for horizontal-only grids)
        w_t = (None if _horizontal(ana.grid_dirs_deg)
               else geo.get_voronoi_weights(ana.grid_dirs_deg))
        if interp_option == HADES_HRTF_INTERP_NEAREST:
            from spatial_audio_framework_tpu_torch.utils.sort import (
                find_closest_grid_points)

            idx = find_closest_grid_points(
                np.radians(hrir_dirs_deg), np.radians(ana.grid_dirs_deg))
            # quantise, then diffuse-field EQ without phase simplification
            H_bin = hrir_mod.diffuse_field_equalise_hrtfs(
                H_fb[:, :, idx], weights=w_t, apply_eq=True,
                apply_phase=False).astype(np.complex64)
        else:  # triangular (VBAP) interpolation
            from spatial_audio_framework_tpu_torch.modules import vbap

            itds = hrir_mod.estimate_itds(hrirs, hrir_fs)
            # df-EQ with phase simplification on the measurement grid, with
            # the HRIR grid's own weights (the C passes the target grid's,
            # which only aligns when nHRIR == nTargetDirs)
            w_h = geo.get_voronoi_weights(hrir_dirs_deg)
            H_eq = hrir_mod.diffuse_field_equalise_hrtfs(
                H_fb, itds, ana.freq_vector, weights=w_h, apply_eq=True,
                apply_phase=True)
            gt = vbap.generate_vbap_gain_table_3d_srcs(ana.grid_dirs_deg,
                                                       hrir_dirs_deg)
            gt = vbap.vbap_gain_table_to_interp_table(gt)
            H_bin = hrir_mod.interp_hrtfs(H_eq, gt, itds, ana.freq_vector)
        # binaural diffuse covariance + diffuse EQ (hades_synthesis_create:
        # H_bin W H_binᴴ / nGrid, diffEQ vs the ARRAY's reference-sensor
        # diffuse response, cap +9 dB)
        DCM_bin = np.einsum("beg,g,bfg->bef", H_bin, ana.int_weights,
                            H_bin.conj()) / ana.n_grid
        r0, r1 = self.ref
        num = DCM_bin[:, 0, 0].real + DCM_bin[:, 1, 1].real
        den = (ana.DCM[:, r0, r0].real + ana.DCM[:, r1, r1].real + 2.23e-10)
        self.eq = np.ones(ana.n_bands, np.float32)
        self.stream_balance = np.ones(ana.n_bands, np.float32)
        # hades_synthesis_create:~34 + the [0, 0.99] clamp at apply
        self.syn_avg_coeff = min(max(
            1.0 - 1.0 / (4096.0 / ana.blocksize), 0.0), 0.99)
        self.load_consts(H_bin, DCM_bin / (num + 2.23e-10)[:, None, None],
                         np.minimum(np.sqrt(num / den), 3.0))
        z = torch.zeros((ana.n_bands, 2, ana.n_mics), dtype=torch.float32,
                        device=ana.device)
        self.M = (z, z.clone())
        self.bank_state = ri.init_state_ri(ana.bank, ana.n_mics, 2,
                                           ana.device)

    def load_consts(self, H_bin: np.ndarray, DCM_bin_norm: np.ndarray,
                    diff_eq: np.ndarray) -> None:
        """The interpolated binaural HRTFs H_bin (nBands, 2, nGrid), the
        normalised binaural diffuse covariance (nBands, 2, 2) and the
        diffuse EQ (nBands,), numpy (e.g. the JAX package's), and the device
        constants made from them: gather tables with (band, grid) rows for
        the steering and the HRTFs, the prototypes' one-hot rows."""
        ana = self.ana
        dev = ana.device
        self.H_bin = np.asarray(H_bin)
        self.DCM_bin_norm = np.asarray(DCM_bin_norm)
        self.diff_eq = np.asarray(diff_eq)

        def rows(A):
            # (nBands, C, nGrid) → (nBands·nGrid, C): row b·nGrid + g
            A = np.ascontiguousarray(np.asarray(A).transpose(0, 2, 1))
            return H.split(A.reshape(-1, A.shape[-1]), dev)

        self._Ha_rows = rows(ana.H_array)   # the steering, as loaded
        self._Hb_rows = rows(self.H_bin)
        self._row0 = torch.arange(ana.n_bands, device=dev) * ana.n_grid
        self._DCMn_d = H.split(self.DCM_bin_norm, dev)
        self._diff_eq_d = f32_tensor(self.diff_eq, dev)
        onehot = np.zeros((2, ana.n_mics), np.float32)
        onehot[0, self.ref[0]] = onehot[1, self.ref[1]] = 1.0
        self._Q_none = f32_tensor(onehot, dev)
        self._eye = torch.eye(ana.n_mics, dtype=torch.float32, device=dev)

    def _take_g(self, A_rows, idx: torch.Tensor):
        """Per-band grid column: idx (..., nBands) → (..., nBands, C)
        pair, one ``index_select`` on the (band, grid) rows."""
        flat = (self._row0 + idx).reshape(-1)
        shape = idx.shape + (A_rows[0].shape[-1],)
        return (A_rows[0].index_select(0, flat).reshape(shape),
                A_rows[1].index_select(0, flat).reshape(shape))

    def _mix_mtx(self, Cx, diffuseness, doa_idx, gains_idx, gains_dir,
                 gains_diff, eq, stream_balance):
        """The per-block mixing matrix (saf_hades_synthesis.c:308-460, up to
        but excluding the temporal smoothing): → Mb (..., nBands, 2, nMics)
        complex pair, batched over the bands and any leading axes."""
        ana = self.ana
        n_mics = ana.n_mics
        r0, r1 = self.ref
        psi = diffuseness.clamp(0.0, 1.0)
        bal = stream_balance.clamp(0.0, 2.0)
        a = bal.clamp_max(1.0) * gains_dir
        bb = (2.0 - bal).clamp_max(1.0) * gains_diff

        # steering at the estimated DoA + HRTF at the (editable) gain index
        As = self._take_g(self._Ha_rows, doa_idx)      # (..., nBands, nMics)
        h_dir = self._take_g(self._Hb_rows, gains_idx)  # (..., nBands, 2)
        As_r0 = (As[0][..., r0:r0 + 1] + 1e-12, As[1][..., r0:r0 + 1])
        As_r1 = (As[0][..., r1:r1 + 1] + 1e-12, As[1][..., r1:r1 + 1])
        As_l = H.cdiv(As, As_r0)
        As_r = H.cdiv(As, As_r1)
        g_l = H.cdiv((h_dir[0][..., 0], h_dir[1][..., 0]),
                     (As_r0[0][..., 0], As_r0[1][..., 0]))
        g_r = H.cdiv((h_dir[0][..., 1], h_dir[1][..., 1]),
                     (As_r1[0][..., 0], As_r1[1][..., 0]))
        # |g|>4 guard (hades_synthesis.c): both fall back to 1
        bad = (H.cabs2(g_l) > 16.0) | (H.cabs2(g_r) > 16.0)
        g_l = (torch.where(bad, 1.0, g_l[0]), torch.where(bad, 0.0, g_l[1]))
        g_r = (torch.where(bad, 1.0, g_r[0]), torch.where(bad, 0.0, g_r[1]))
        full = psi.shape + (2, n_mics)
        Q_diff = (self._Q_none * self._diff_eq_d[:, None, None]).expand(full)

        def row_g(row, g):
            return H.cmul(row, (g[0][..., None], g[1][..., None]))

        if self.beam_option == HADES_BEAMFORMER_NONE:
            Q = (self._Q_none.expand(full), torch.zeros(full, device=psi.device))
        else:
            if self.beam_option == HADES_BEAMFORMER_FILTER_AND_SUM:
                # pinv of a column vector: conj(v)/‖v‖²
                def fas_row(Asx, g):
                    n2 = H.cabs2(Asx).sum(-1, keepdim=True) + 1e-12
                    return row_g((Asx[0] / n2, -Asx[1] / n2), g)

                rl, rr = fas_row(As_l, g_l), fas_row(As_r, g_r)
            else:  # BMVDR
                tr = torch.diagonal(Cx[0], dim1=-2, dim2=-1).sum(-1)
                load = (tr / n_mics * 10.0 + 1e-4)[..., None, None] * self._eye
                # w = Cx⁻¹ conj(As) as the C's utility_cglslv (f32 LAPACK
                # cgesv op order, saf_hades_synthesis.c:411); both ears
                # share one factorization
                wv2 = H.cgesv_ri(
                    (Cx[0] + load, Cx[1]),
                    (torch.stack([As_l[0], As_r[0]], -1),
                     torch.stack([-As_l[1], -As_r[1]], -1)))

                def bmvdr_row(wv, Asx, g):
                    den = ((wv[0] * Asx[0]).sum(-1) - (wv[1] * Asx[1]).sum(-1)
                           + 1e-5,
                           (wv[0] * Asx[1]).sum(-1) + (wv[1] * Asx[0]).sum(-1))
                    # the C computes 1/den once (Smith division) then
                    # multiplies it through
                    rr_, ri_ = H._sladiv(torch.ones_like(den[0]),
                                         torch.zeros_like(den[0]),
                                         den[0], den[1])
                    return row_g(H.cmul(wv, (rr_[..., None], ri_[..., None])),
                                 g)

                rl = bmvdr_row((wv2[0][..., 0], wv2[1][..., 0]), As_l, g_l)
                rr = bmvdr_row((wv2[0][..., 1], wv2[1][..., 1]), As_r, g_r)
                # the C's check is cblas_scasum = sum(|re|+|im|)
                # (saf_hades_synthesis.c:396)
                dead = ((tr < 1e-4)
                        | ((As[0].abs() + As[1].abs()).sum(-1) < 1e-4))
                rl = tuple(torch.where(dead[..., None], 0.0, t) for t in rl)
                rr = tuple(torch.where(dead[..., None], 0.0, t) for t in rr)
            Q_dir = (torch.stack([rl[0], rr[0]], -2),
                     torch.stack([rl[1], rr[1]], -2))
            wd = (eq * a * (1.0 - psi))[..., None, None]
            wf = (eq * bb * psi)[..., None, None]
            Q = (wd * Q_dir[0] + wf * Q_diff, wd * Q_dir[1])

        if not self.enable_cm:
            return Q
        # covariance matching (saf_hades_synthesis.c:430-460)
        target_e = (eq * 0.25 * torch.diagonal(Cx[0], dim1=-2, dim2=-1).sum(-1)
                    * self._diff_eq_d)
        wdir = (eq * a * (1 - psi) * target_e)[..., None, None]
        wdif = (eq * bb * psi * target_e)[..., None, None]
        hr, hi = h_dir
        hh = (hr[..., :, None] * hr[..., None, :]
              + hi[..., :, None] * hi[..., None, :],
              hi[..., :, None] * hr[..., None, :]
              - hr[..., :, None] * hi[..., None, :])
        Cy = (wdir * hh[0] + wdif * self._DCMn_d[0],
              wdir * hh[1] + wdif * self._DCMn_d[1])
        Mb = cdf4sap.formulate_M_and_Cr_ri(Cx, Cy, Q, True, 0.1)[0]
        use = (target_e > 1e-4)[..., None, None]
        return torch.where(use, Mb[0], Q[0]), torch.where(use, Mb[1], Q[1])

    def _step(self, M, bank_state, inTF, Cx, diffuseness, doa_idx, gains_idx,
              gains_dir, gains_diff, eq, stream_balance):
        """Synthesis of one block, batched over all bands
        (saf_hades_synthesis.c:308-470)."""
        Mb = self._mix_mtx(Cx, diffuseness, doa_idx, gains_idx, gains_dir,
                           gains_diff, eq, stream_balance)
        c = self.syn_avg_coeff
        M = (c * M[0] + (1 - c) * eq[:, None, None] * Mb[0],
             c * M[1] + (1 - c) * eq[:, None, None] * Mb[1])
        out = H.ceinsum("bem,bmh->beh", M, inTF)
        y, bank_state = ri.synthesis_ri(self.ana.bank, bank_state, out)
        return M, bank_state, y

    def apply(self, params: HadesParams, sigs: HadesSignals) -> np.ndarray:
        """→ the binaural output block (2, T), on the host."""
        dev = self.ana.device

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        self.M, self.bank_state, y = self._step(
            self.M, self.bank_state, sigs.inTF, sigs.Cx,
            t(params.diffuseness), t(params.doa_idx, torch.int64),
            t(params.gains_idx, torch.int64), t(params.gains_dir),
            t(params.gains_diff), t(self.eq), t(self.stream_balance))
        return y.cpu().numpy()


class HadesPipeline:
    """Analysis + synthesis in one call per block, the spatial parameters
    (diffuseness, DoA indices) staying on the device: for deployments that
    do not edit the parameter stream between the two (no
    HadesRadialEditor).  Both paths share the same cores, so the outputs
    equal the two-stage path's.  :meth:`process_chunk` takes many blocks a
    call, :meth:`process_chunk_batched` many instances."""

    def __init__(self, ana: HadesAnalysis, syn: HadesSynthesis):
        assert syn.ana is ana
        self.ana, self.syn = ana, syn
        self._ones = torch.ones(ana.n_bands, dtype=torch.float32,
                                device=ana.device)
        self._ctl_key, self._ctl = None, None

    def _controls(self):
        """eq and stream balance on the device, copied again only when the
        host arrays change: runtime edits to syn.eq / syn.stream_balance
        are picked up per call, as in the two-stage path, without a host
        copy per call."""
        eq = np.asarray(self.syn.eq, np.float32)
        bal = np.asarray(self.syn.stream_balance, np.float32)
        key = (eq.tobytes(), bal.tobytes())
        if key != self._ctl_key:
            self._ctl_key = key
            self._ctl = (f32_tensor(eq, self.ana.device),
                         f32_tensor(bal, self.ana.device))
        return self._ctl

    def init_state(self):
        return (self.ana.bank_state, self.ana.Cx_avg, self.syn.M,
                self.syn.bank_state)

    @staticmethod
    def state_from_numpy(ana_bank: tuple, cx_avg: tuple, M: tuple,
                         syn_bank: tuple,
                         device: torch.device | str | None = None):
        """The state tuple (e.g. the JAX package's) from numpy: each
        filterbank state as (in_tail, hyb_tail_re, hyb_tail_im, ola_tail),
        the averaged SCM and the mixing matrix as (re, im) pairs."""
        return (ri.state_ri_from_numpy(*ana_bank, device=device),
                tuple(f32_tensor(a, device) for a in cx_avg),
                tuple(f32_tensor(a, device) for a in M),
                ri.state_ri_from_numpy(*syn_bank, device=device))

    def process(self, state, x: torch.Tensor):
        """One block: x (nMics, blocksize) → ((2, blocksize), state)."""
        ana, syn = self.ana, self.syn
        eq, bal = self._controls()
        ana_bank, cx_avg, M, syn_bank = state
        ana_bank, cx_avg, inTF, Cx_new, diff, doa_idx = ana._step(
            ana_bank, cx_avg, x)
        M, syn_bank, y = syn._step(M, syn_bank, inTF, Cx_new, diff, doa_idx,
                                   doa_idx, self._ones, self._ones, eq, bal)
        return y, (ana_bank, cx_avg, M, syn_bank)

    def _chunk_core(self, sre, sim, cx0, M0, nb: int):
        """All blocks of a chunk at once, no loop over blocks: the spectra
        (..., nBands, nMics, nb·ts) of the whole chunk → (the binaural
        spectra (..., nBands, 2, nb·ts), the last block's averaged SCM and
        mixing matrix).  The only sequential couplings across blocks are
        the filterbanks (run once over the chunk outside) and two one-pole
        recurrences (the SCM average, the mixing-matrix smoothing), linear,
        so each is one lower-triangular product with decay weights.  Any
        leading axes (instances) are batched."""
        ana, syn = self.ana, self.syn
        eq, bal = self._controls()
        ts = ana.time_slots
        dev = sre.device

        def to_blocks(s):  # (..., B, M, nb·ts) → (..., nb, B, M, ts)
            return s.reshape(s.shape[:-1] + (nb, ts)).movedim(-2, -4)

        inTF = (to_blocks(sre), to_blocks(sim))
        Lc, pc = onepole_ewma_mats(ana.cov_avg_coeff, nb, dev)
        with fp32_matmul():
            if ana.n_mics == 2:
                # entrywise: the SCM's three unique entries as (..., t,
                # nBands) tensors, stacked to 2×2 only where consumed
                r0, r1 = inTF[0][..., 0, :], inTF[0][..., 1, :]
                i0, i1 = inTF[1][..., 0, :], inTF[1][..., 1, :]
                c00 = (r0 * r0 + i0 * i0).sum(-1)
                c11 = (r1 * r1 + i1 * i1).sum(-1)
                c01r = (r0 * r1 + i0 * i1).sum(-1)
                c01i = (i0 * r1 - r0 * i1).sum(-1)

                def rec(e, e0):
                    return (torch.einsum("tk,...kb->...tb", Lc, e)
                            + pc[:, None] * e0[..., None, :])

                a00 = rec(c00, cx0[0][..., 0, 0])
                a11 = rec(c11, cx0[0][..., 1, 1])
                a01r = rec(c01r, cx0[0][..., 0, 1])
                a01i = rec(c01i, cx0[1][..., 0, 1])
                z = torch.zeros_like(a00)
                diff, doa_idx = ana._cov_stats_e((((a00, z), (a01r, a01i)),
                                                  ((a01r, -a01i), (a11, z))))

                def herm2(d0, d1, re, im):
                    zz = torch.zeros_like(d0)
                    return (torch.stack([torch.stack([d0, re], -1),
                                         torch.stack([re, d1], -1)], -2),
                            torch.stack([torch.stack([zz, im], -1),
                                         torch.stack([-im, zz], -1)], -2))

                Cx_new = herm2(c00, c11, c01r, c01i)
                Cx_avg = herm2(a00, a11, a01r, a01i)
            else:
                Cx_new = (torch.einsum("...tbmh,...tbnh->...tbmn", inTF[0],
                                       inTF[0])
                          + torch.einsum("...tbmh,...tbnh->...tbmn", inTF[1],
                                         inTF[1]),
                          torch.einsum("...tbmh,...tbnh->...tbmn", inTF[1],
                                       inTF[0])
                          - torch.einsum("...tbmh,...tbnh->...tbmn", inTF[0],
                                         inTF[1]))
                Cx_avg = tuple(
                    torch.einsum("tk,...kbmn->...tbmn", Lc, Cn)
                    + pc[:, None, None, None] * c0[..., None, :, :, :]
                    for Cn, c0 in zip(Cx_new, cx0))
                diff, doa_idx = ana._cov_stats(Cx_avg)
        Mb = syn._mix_mtx(Cx_new, diff, doa_idx, doa_idx, self._ones,
                          self._ones, eq, bal)
        Lm, pm = onepole_ewma_mats(syn.syn_avg_coeff, nb, dev)
        with fp32_matmul():
            M_t = tuple(
                torch.einsum("tk,...kbem->...tbem", Lm,
                             eq[:, None, None] * mb)
                + pm[:, None, None, None] * m0[..., None, :, :, :]
                for mb, m0 in zip(Mb, M0))
        out = H.ceinsum("...tbem,...tbmh->...tbeh", M_t, inTF)
        # (..., nb, B, 2, ts) → (..., B, 2, nb·ts)
        out_cat = tuple(o.movedim(-4, -2).reshape(o.shape[:-4] + (
            o.shape[-3], 2, nb * ts)) for o in out)
        return (out_cat, tuple(c[..., -1, :, :, :] for c in Cx_avg),
                tuple(m[..., -1, :, :, :] for m in M_t))

    def process_chunk(self, state, x_blocks: torch.Tensor):
        """Many blocks a call: x_blocks (nBlocks, nMics, blocksize) →
        ((nBlocks, 2, blocksize), state).  The filterbanks run once over
        the concatenated chunk (a long call equals consecutive short ones),
        everything else is :meth:`_chunk_core`."""
        ana = self.ana
        ana_bank, cx0, M0, syn_bank = state
        nb, nm, bs = x_blocks.shape
        x_cat = x_blocks.transpose(0, 1).reshape(nm, nb * bs)
        (sre, sim), ana_bank = ri.analysis_ri(ana.bank, ana_bank, x_cat)
        out_cat, cx, M = self._chunk_core(sre, sim, cx0, M0, nb)
        y_cat, syn_bank = ri.synthesis_ri(ana.bank, syn_bank, out_cat)
        ys = y_cat.reshape(2, nb, bs).transpose(0, 1)
        return ys, (ana_bank, cx, M, syn_bank)

    def init_state_batched(self, n_instances: int):
        """Zero state of ``n_instances`` independent instances on the
        batched filterbank (the analysis tail 15 hops of input, the
        synthesis tail as the single-stream one), SCMs and mixing matrices
        with a leading instance axis."""
        ana = self.ana
        dev = ana.device
        n = n_instances

        def z(*shape):
            return torch.zeros((n,) + shape, dtype=torch.float32, device=dev)

        B, M = ana.n_bands, ana.n_mics
        return (ri.init_state_batched(ana.bank, n, M, M, device=dev),
                (z(B, M, M), z(B, M, M)), (z(B, 2, M), z(B, 2, M)),
                ri.init_state_batched(ana.bank, n, 2, 2, device=dev))

    @staticmethod
    def state_batched_from_numpy(ana_in_tail, cx_avg: tuple, M: tuple,
                                 syn_ola_tail,
                                 device: torch.device | str | None = None):
        """A batched state from numpy: ``ana_in_tail`` (N, nMics, 15·hop),
        the last 15 hops of each instance's input (the batched filterbank
        recomputes the hybrid history from them; the JAX package's vmapped
        single-stream state carries it as spectra instead), the averaged
        SCMs and mixing matrices as (re, im) pairs with the instance axis,
        and the synthesis tails (N, 2, 9·hop), the single-stream state's
        ``ola_tail``."""
        in_tail = f32_tensor(ana_in_tail, device)
        ola = f32_tensor(syn_ola_tail, device)
        return (ri.AfSTFTStateBatched(in_tail=in_tail, ola_tail=torch.zeros(
                    in_tail.shape[:2] + ola.shape[-1:], dtype=torch.float32,
                    device=in_tail.device)),
                tuple(f32_tensor(a, device) for a in cx_avg),
                tuple(f32_tensor(a, device) for a in M),
                ri.AfSTFTStateBatched(
                    in_tail=torch.zeros(ola.shape[:2] + in_tail.shape[-1:],
                                        dtype=torch.float32,
                                        device=ola.device),
                    ola_tail=ola))

    def process_chunk_batched(self, state, x_blocks: torch.Tensor,
                              fused: bool = True):
        """N instances × many blocks a call: x_blocks (N, nBlocks, nMics,
        blocksize) → ((N, nBlocks, 2, blocksize), state), each instance as
        :meth:`process_chunk` on it alone; eq / stream balance shared.

        The filterbank runs batched over the (N · nMics) and (N · 2) rows:
        ``fused=True`` on the kernels ``analysis_front_ri`` /
        ``synthesis_back_ri`` (one launch each a call; their plain versions
        on CPU tensors), ``fused=False`` in plain torch."""
        ana = self.ana
        bank = ana.bank
        ana_bank, cx0, M0, syn_bank = state
        n, nb, nm, bs = x_blocks.shape
        x_cat = x_blocks.transpose(1, 2).reshape(n, nm, nb * bs)
        (sre, sim), ana_bank = ri.analysis_ri_batched(bank, ana_bank, x_cat,
                                                      use_kernel=fused)
        out_cat, cx, M = self._chunk_core(sre.permute(0, 3, 1, 2),
                                          sim.permute(0, 3, 1, 2), cx0, M0,
                                          nb)
        Y = tuple(o.permute(0, 2, 3, 1) for o in out_cat)  # (N, 2, H, nB)
        y_cat, syn_bank = ri.synthesis_ri_batched(bank, syn_bank, Y,
                                                  use_kernel=fused)
        ys = y_cat.reshape(n, 2, nb, bs).transpose(1, 2)
        return ys, (ana_bank, cx, M, syn_bank)
