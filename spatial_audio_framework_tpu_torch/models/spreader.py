"""spreader — coherent/incoherent source spreading over arbitrary IR sets
(counterpart of ``spatial_audio_framework_tpu/models/spreader.py``;
``examples/src/spreader``).

Modes (spreader.h SPREADER_MODE_*): 'naive' (coherent sum of the IR-set
responses within the spread area), 'evd' (eigendecomposition mixing of
decorrelated replicas to hit the target covariance) and 'om' (CDF4SAP
optimal mixing of the prototype signals plus a decorrelated residual).

The spread area is a mask over the IR grid computed on the device (angles
≤ spread/2), so directions and spreads stream per call; the target
covariances, the CDF4SAP solves and the EVD run batched over all bands in
split (re, im) arithmetic.  With the default IR set (the default HRIRs,
Q = 2, binaural spreading, as in the reference) every solve is a 2×2
closed form: no ``torch.linalg`` call and no host wait.

``process`` runs one frame, ``process_chunk`` many frames a call without a
loop over frames (the covariance averages as triangular products,
``ops/iir.onepole_ewma_mats``); both on the plain single-stream filterbank,
as in the JAX package.  ``process_chunk`` with a leading instance axis
(state from ``init_state(..., n_instances=N)``) runs N instances a call on
the batched filterbank: with ``fused=True`` its front and back are the
kernels ``analysis_front_ri`` / ``synthesis_back_ri`` over the (instances
× sources) and (instances × Q) rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import default_device, f32_tensor
from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.modules import cdf4sap
from spatial_audio_framework_tpu_torch.modules import hrir as hrir_mod
from spatial_audio_framework_tpu_torch.ops import afstft_ri as ri
from spatial_audio_framework_tpu_torch.ops import herm_ri as H
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT
from spatial_audio_framework_tpu_torch.ops.iir import onepole_ewma_mats
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul
from spatial_audio_framework_tpu_torch.utils import decor
from spatial_audio_framework_tpu_torch.utils import geometry as geo

MODE_NAIVE = "naive"
MODE_EVD = "evd"
MODE_OM = "om"
MAX_SPREAD_FREQ = 16e3  # spreader_internal.h


@dataclass(frozen=True)
class SpreaderConfig:
    n_sources: int = 1
    fs: float = 48000.0
    mode: str = MODE_OM
    cov_avg_coeff: float = 0.8
    hop: int = 128

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True)

    def __post_init__(self):
        C.validate_config(self)


class SpreaderWeights(NamedTuple):
    H_re: torch.Tensor      # (nBands, Q, nGrid) IR-set responses (re)
    H_im: torch.Tensor
    HHH_re: torch.Tensor    # (nBands, nGrid, Q, Q) outer products h hᴴ
    HHH_im: torch.Tensor
    grid_u: torch.Tensor    # (nGrid, 3)
    freqs: torch.Tensor
    lattice: dict           # decorrelator design (host dict + device data)


class SpreaderState(NamedTuple):
    bank: object                   # ri.AfSTFTStateRI, or ri.AfSTFTStateBatched
    lattice: tuple                 # per-source decorrelator states (RI)
    Cproto_re: torch.Tensor        # ([N,] nSrc, nBands, Q, Q)
    Cproto_im: torch.Tensor
    Cy_re: torch.Tensor
    Cy_im: torch.Tensor
    prev_M_re: torch.Tensor        # ([N,] nSrc, nBands, Q, Q)
    prev_M_im: torch.Tensor
    prev_Mr: torch.Tensor          # ([N,] nSrc, nBands, Q, Q) real


def _lat(cfg: SpreaderConfig, n_ch: int) -> decor.LatticeDecorrelator:
    # spreader.c:263-266: orders {20,15,6,6}, cutoffs {900, 6.8k, 12k, 24k},
    # maxDelay 12, enComp 0.75
    return decor.LatticeDecorrelator(
        fs=cfg.fs, hop_size=cfg.hop, n_ch=n_ch,
        orders=(20, 15, 6, 6), freq_cutoffs=(900.0, 6.8e3, 12e3, 24e3),
        max_delay=12, en_comp_coeff=0.75)


def weights_from_numpy(H_re, H_im, HHH_re, HHH_im, grid_u, freqs,
                       lattice: dict,
                       device: torch.device | str | None = None
                       ) -> SpreaderWeights:
    """Weights (e.g. the JAX package's) from numpy arrays and the host
    lattice design dict."""
    t = [f32_tensor(a, device) for a in (H_re, H_im, HHH_re, HHH_im, grid_u,
                                         freqs)]
    decor.lattice_design_on_device(lattice, device)
    return SpreaderWeights(*t, lattice=lattice)


def design(cfg: SpreaderConfig, irs: Optional[np.ndarray] = None,
           ir_dirs_deg: Optional[np.ndarray] = None,
           ir_fs: Optional[int] = None, c_rand_offset: int = None,
           device: torch.device | str | None = None) -> SpreaderWeights:
    """``c_rand_offset``: the glibc rand() stream position of the C process
    at its first latticeDecorrelator_create; the source-0 decorrelation
    delays then match the reference bit-exactly
    (``utils/decor.get_decorrelation_delays_c``)."""
    if irs is None:
        irs, ir_dirs_deg, ir_fs = hrir_mod.default_hrirs()
    if ir_fs != cfg.fs:
        irs, _ = hrir_mod.resample_hrirs(irs, ir_fs, int(cfg.fs))
    Hf = hrir_mod.hrirs_to_hrtfs_afstft(irs, cfg.hop)  # (nBands, Q, nGrid)
    # outer products carry the grid's Voronoi weights / 4π
    # (spreader.c:276-289: getVoronoiWeights → sscal 1/FOURPI → cscal HHH)
    w_g = geo.get_voronoi_weights(np.asarray(ir_dirs_deg, np.float64))
    w_g = np.asarray(w_g, np.float64) / (4.0 * np.pi)
    HHH = np.einsum("bqg,g,brg->bgqr", Hf, w_g, Hf.conj())
    u = geo.unit_sph2cart(np.asarray(ir_dirs_deg, np.float64), degrees=True)
    freqs = cfg.afstft.centre_freqs(cfg.fs)
    stream = None
    if c_rand_offset is not None:
        from spatial_audio_framework_tpu_torch.utils.convhull3d import (
            glibc_rand_at)

        stream = glibc_rand_at(c_rand_offset)
    lattice = _lat(cfg, irs.shape[1]).design(freqs, c_rand_stream=stream)
    return weights_from_numpy(Hf.real, Hf.imag, HHH.real, HHH.imag,
                              np.asarray(u, np.float32), freqs, lattice,
                              device)


def init_state(cfg: SpreaderConfig, w: SpreaderWeights,
               n_instances: Optional[int] = None,
               device: torch.device | str | None = None) -> SpreaderState:
    """Zero state; with ``n_instances`` the state of that many independent
    instances for :func:`process_chunk`'s instance axis, on the batched
    filterbank."""
    device = default_device() if device is None else device
    Q = w.H_re.shape[1]
    n_bands = cfg.afstft.n_bands
    lead = () if n_instances is None else (n_instances,)
    lat = _lat(cfg, Q)
    z = torch.zeros(lead + (cfg.n_sources, n_bands, Q, Q),
                    dtype=torch.float32, device=device)
    eye = torch.eye(Q, dtype=torch.float32, device=device).expand(z.shape)
    bank = (ri.init_state_ri(cfg.afstft, cfg.n_sources, Q, device)
            if n_instances is None else
            ri.init_state_batched(cfg.afstft, n_instances, cfg.n_sources, Q,
                                  device=device))
    return SpreaderState(
        bank=bank,
        lattice=tuple(decor.lattice_init_state_ri(lat, w.lattice, n_bands,
                                                  lead, device)
                      for _ in range(cfg.n_sources)),
        Cproto_re=z, Cproto_im=z.clone(), Cy_re=z.clone(), Cy_im=z.clone(),
        prev_M_re=eye.clone(), prev_M_im=z.clone(), prev_Mr=z.clone())


def state_from_numpy(bank: tuple, lattice: tuple, *leaves,
                     device: torch.device | str | None = None
                     ) -> SpreaderState:
    """A state (e.g. the JAX package's) from numpy: ``bank`` the
    single-stream filterbank's (in_tail, hyb_tail_re, hyb_tail_im,
    ola_tail) or the batched one's (in_tail, ola_tail); ``lattice`` per
    source (delay_buf, iir_state, in_energy, out_energy); then Cproto_re,
    Cproto_im, Cy_re, Cy_im, prev_M_re, prev_M_im, prev_Mr."""
    bank = (ri.state_ri_from_numpy(*bank, device=device) if len(bank) == 4
            else ri.AfSTFTStateBatched(*(f32_tensor(a, device) for a in bank)))
    lat = tuple(decor.LatticeDecorStateRI(*(f32_tensor(a, device) for a in s))
                for s in lattice)
    return SpreaderState(bank, lat, *(f32_tensor(a, device) for a in leaves))


def _spread_statics(w: SpreaderWeights, src_dir_deg: torch.Tensor,
                    spread_deg: torch.Tensor, below: torch.Tensor):
    """Per-source quantities that depend only on (direction, spread): the
    spread-area response average h_avg (nBands, Q), the target covariance
    Cy_st (nBands, Q, Q) and the centre direction's response h_c.

    Cy_st mirrors an upstream quirk (docs/C_PARITY.md bug #8): the C's
    per-band accumulator Cy is reset only INSIDE the freq < MAX_SPREAD_FREQ
    branch (spreader.c:485-503); above it, the nSpread==0 fallback of the
    centre direction's HHH lands ON TOP of the last below-band spread-area
    sum and keeps accumulating across the higher bands: a cumulative sum
    over the above-band mask."""
    u_src = geo.unit_sph2cart_torch(src_dir_deg)
    with fp32_matmul():
        cosang = (w.grid_u @ u_src).clamp(-1.0, 0.9999999)
    angles = torch.rad2deg(torch.arccos(cosang))
    centre = torch.argmin(angles).reshape(1)          # index_select index
    n_grid = angles.shape[0]
    in_area = angles <= spread_deg / 2.0
    oh = (torch.arange(n_grid, device=angles.device) == centre).float()
    area_mask = torch.where(in_area.any(), in_area.float(), oh)
    mask = torch.where(below[:, None], area_mask[None, :], oh[None, :])
    n_eff = mask.sum(-1).clamp_min(1.0)
    with fp32_matmul():
        h_avg = (torch.einsum("bqg,bg->bq", w.H_re, mask) / n_eff[:, None],
                 torch.einsum("bqg,bg->bq", w.H_im, mask) / n_eff[:, None])
        S = (torch.einsum("bgqr,g->bqr", w.HHH_re, area_mask),
             torch.einsum("bgqr,g->bqr", w.HHH_im, area_mask))
    ch = (w.HHH_re.index_select(1, centre)[:, 0],
          w.HHH_im.index_select(1, centre)[:, 0])     # (nBands, Q, Q)
    above = (~below)[:, None, None]
    cs = ((ch[0] * above).cumsum(0), (ch[1] * above).cumsum(0))
    k0m1 = (below.sum() - 1).clamp_min(0).reshape(1)  # the last below band
    bel3 = below[:, None, None]
    Cy_st = tuple(torch.where(bel3, s, s.index_select(0, k0m1) + c)
                  for s, c in zip(S, cs))
    h_c = (w.H_re.index_select(2, centre)[..., 0],
           w.H_im.index_select(2, centre)[..., 0])    # (nBands, Q)
    return h_avg, Cy_st, h_c


def _cmix(M, sig, eq: str):
    """Complex mixing M (re, im) applied to sig (re, im) by ``eq``."""
    e = torch.einsum
    with fp32_matmul():
        return (e(eq, M[0], sig[0]) - e(eq, M[1], sig[1]),
                e(eq, M[0], sig[1]) + e(eq, M[1], sig[0]))


def _evd_mix(Cy, s):
    """The EVD mixing matrix V·sqrt(Λ) of the scaled target covariance.
    Q = 2: LAPACK cheev's exact eigenvector signs (``cheev_2x2``): M mixes
    DECORRELATED channels, whose mutual correlations make the output depend
    on the vector phases.  Wider: ``torch.linalg.eigh`` (a host wait)."""
    C = (Cy[0] * s, Cy[1] * s)
    if C[0].shape[-1] == 2:
        lam_e, V = H.cheev_2x2(C)
    else:
        lam_e, V = H.herm_eig_pairs(C)
        lam_e, V = lam_e.flip(-1), (V[0].flip(-1), V[1].flip(-1))
    root = torch.sqrt(lam_e.clamp_min(0.0))[..., None, :]
    return V[0] * root, V[1] * root


def _om_mix(Cp, Cy, below):
    """The OM mixing matrices: CDF4SAP of the prototype covariance onto the
    target, and the real residual mix (routed through the entrywise 2×2
    complex path with zero imaginary parts for Q = 2)."""
    Q = Cp[0].shape[-1]
    eyeQ = torch.eye(Q, dtype=torch.float32, device=Cp[0].device)
    Qid = (eyeQ.expand(Cp[0].shape), torch.zeros_like(Cp[0]))
    M, Cr = cdf4sap.formulate_M_and_Cr_ri((Cp[0] + 1e-5 * eyeQ, Cp[1]), Cy,
                                          Qid, False, 0.2)
    Cp_diag = torch.diagonal(Cp[0], dim1=-2, dim2=-1)[..., None] * eyeQ
    zz = torch.zeros_like(Cp_diag)
    Mr = cdf4sap.formulate_M_and_Cr_ri((Cp_diag, zz), (Cr[0], zz), Qid,
                                       False, 0.2)[0][0]
    bel3 = below[:, None, None]
    return ((torch.where(bel3, M[0], eyeQ), torch.where(bel3, M[1], 0.0)),
            torch.where(bel3, Mr, 0.0))


def _proto(h, spec):
    """h (nBands, Q) ⊗ spec (..., nBands, S) → (..., nBands, Q, S)."""
    return (h[0][:, :, None] * spec[0][..., None, :]
            - h[1][:, :, None] * spec[1][..., None, :],
            h[0][:, :, None] * spec[1][..., None, :]
            + h[1][:, :, None] * spec[0][..., None, :])


def process(cfg: SpreaderConfig, w: SpreaderWeights, state: SpreaderState,
            x: torch.Tensor, src_dirs_deg: torch.Tensor,
            src_spread_deg: torch.Tensor):
    """One frame: x (nSrc, T) → ((Q, T), state)."""
    bank = cfg.afstft
    Q = w.H_re.shape[1]
    (sre, sim), bank_st = ri.analysis_ri(bank, state.bank, x)
    H_slots = sre.shape[-1]
    lam = cfg.cov_avg_coeff
    lat = _lat(cfg, Q)
    dev = x.device
    out = (torch.zeros((bank.n_bands, Q, H_slots), device=dev),
           torch.zeros((bank.n_bands, Q, H_slots), device=dev))
    new_lat, new_Cp, new_Cy, new_M, new_Mr = [], [], [], [], []
    fade_in = torch.arange(1, H_slots + 1, dtype=torch.float32,
                           device=dev) / H_slots
    below = w.freqs < MAX_SPREAD_FREQ

    for src in range(cfg.n_sources):
        spec_s = (sre[:, src], sim[:, src])              # (nBands, H)
        h_avg, Cy_st, h_c = _spread_statics(w, src_dirs_deg[src],
                                            src_spread_deg[src], below)
        proto = _proto(h_avg, spec_s)
        if cfg.mode == MODE_NAIVE:
            out = (out[0] + proto[0], out[1] + proto[1])
            new_lat.append(state.lattice[src])
            new_Cp.append((state.Cproto_re[src], state.Cproto_im[src]))
            new_Cy.append((state.Cy_re[src], state.Cy_im[src]))
            new_M.append((state.prev_M_re[src], state.prev_M_im[src]))
            new_Mr.append(state.prev_Mr[src])
            continue
        if cfg.mode == MODE_EVD:
            proto = tuple(s[:, None, :].expand(bank.n_bands, Q, H_slots)
                          for s in spec_s)
        dec, lat_st = decor.lattice_apply_ri(lat, w.lattice,
                                             state.lattice[src], *proto)
        Cp_new = H.ceinsum("bqh,brh->bqr", proto, H.conj(proto))
        Cp = (lam * state.Cproto_re[src] + (1 - lam) * Cp_new[0],
              lam * state.Cproto_im[src] + (1 - lam) * Cp_new[1])
        # target covariance (incl. the above-band accumulator quirk)
        Cy_new = Cy_st
        if cfg.mode == MODE_OM:
            # impose target energies (spreader.c:#if 1 block)
            tr_y = torch.diagonal(Cy_new[0], dim1=-2, dim2=-1).sum(-1)
            sig_c = _proto(h_c, spec_s)
            tr_e = (sig_c[0] ** 2).sum((-1, -2)) + (sig_c[1] ** 2).sum((-1, -2))
            scale = torch.where(below, tr_e / (tr_y + 2.23e-9), 1.0)
            Cy_new = (Cy_new[0] * scale[:, None, None],
                      Cy_new[1] * scale[:, None, None])
        Cy = (lam * state.Cy_re[src] + (1 - lam) * Cy_new[0],
              lam * state.Cy_im[src] + (1 - lam) * Cy_new[1])
        if cfg.mode == MODE_EVD:
            e_y = torch.diagonal(Cy[0], dim1=-2, dim2=-1).sum()
            # the C adds 1e-6 PER (band, channel) diagonal term
            # (spreader.c:552); Gcomp = sqrt(Eproto/Ey) (spreader.c:524)
            e_p = (torch.diagonal(Cp[0], dim1=-2, dim2=-1).sum()
                   + 1e-6 * (Cp[0].shape[0] * Cp[0].shape[1]))
            M = _evd_mix(Cy, torch.sqrt(e_p / (e_y + 2.23e-9)))
            Mr = torch.zeros_like(state.prev_Mr[src])
            sig_in = dec
        else:  # OM
            M, Mr = _om_mix(Cp, Cy, below)
            sig_in = proto
        # crossfaded mixing-matrix application (spreader.c interpolator)
        f = fade_in[None, :, None, None]
        M_t = (f * M[0][:, None] + (1 - f) * state.prev_M_re[src][:, None],
               f * M[1][:, None] + (1 - f) * state.prev_M_im[src][:, None])
        mixed = _cmix(M_t, sig_in, "bhqr,brh->bqh")
        if cfg.mode == MODE_OM:
            Mr_t = f * Mr[:, None] + (1 - f) * state.prev_Mr[src][:, None]
            with fp32_matmul():
                mixed = (mixed[0] + torch.einsum("bhqr,brh->bqh", Mr_t,
                                                 dec[0]),
                         mixed[1] + torch.einsum("bhqr,brh->bqh", Mr_t,
                                                 dec[1]))
        out = (out[0] + mixed[0], out[1] + mixed[1])
        new_lat.append(lat_st)
        new_Cp.append(Cp)
        new_Cy.append(Cy)
        new_M.append(M)
        new_Mr.append(Mr)

    y, bank_st = ri.synthesis_ri(bank, bank_st, out)
    return y, _new_state(bank_st, new_lat, new_Cp, new_Cy, new_M, new_Mr, 0)


def _new_state(bank_st, new_lat, new_Cp, new_Cy, new_M, new_Mr, lead: int):
    """The state from per-source lists, sources stacked after ``lead``
    instance axes."""
    def st(xs):
        return torch.stack(xs, dim=lead)

    return SpreaderState(
        bank=bank_st, lattice=tuple(new_lat),
        Cproto_re=st([c[0] for c in new_Cp]),
        Cproto_im=st([c[1] for c in new_Cp]),
        Cy_re=st([c[0] for c in new_Cy]), Cy_im=st([c[1] for c in new_Cy]),
        prev_M_re=st([m[0] for m in new_M]),
        prev_M_im=st([m[1] for m in new_M]), prev_Mr=st(new_Mr))


def process_chunk(cfg: SpreaderConfig, w: SpreaderWeights,
                  state: SpreaderState, x_frames: torch.Tensor,
                  src_dirs_deg: torch.Tensor, src_spread_deg: torch.Tensor,
                  fused: bool = True):
    """Many frames a call: x_frames (nFrames, nSrc, F) → ((nFrames, Q, F),
    state), equal to nFrames consecutive :func:`process` calls up to the
    float32 summation order of the covariance averages.  With a leading
    instance axis, x_frames (N, nFrames, nSrc, F) → (N, nFrames, Q, F),
    state from ``init_state(..., n_instances=N)``: the filterbank runs
    batched, on the kernels when ``fused`` (one front and one back launch a
    call; their plain versions on CPU tensors), in plain torch otherwise.

    The only cross-frame couplings are the filterbank and lattice states
    (each run once over the concatenated chunk), the two one-pole
    covariance averages (triangular products) and the one-frame
    mixing-matrix crossfade (the frame-shifted M).  Directions and spreads
    are held across the chunk (and shared by the instances)."""
    bank = cfg.afstft
    batched = x_frames.ndim == 4
    nF, nS, F = x_frames.shape[-3:]
    lead = x_frames.shape[:-3]
    nl = len(lead)
    Q = w.H_re.shape[1]
    x_cat = x_frames.movedim(-3, -2).reshape(lead + (nS, nF * F))
    if batched:
        (sre, sim), bank_st = ri.analysis_ri_batched(bank, state.bank, x_cat,
                                                     use_kernel=fused)
        sre, sim = sre.permute(0, 3, 1, 2), sim.permute(0, 3, 1, 2)
    else:
        (sre, sim), bank_st = ri.analysis_ri(bank, state.bank, x_cat)
    S_tot = sre.shape[-1]                                # (..., B, nS, S)
    Hs = S_tot // nF                                     # slots per frame
    lam = cfg.cov_avg_coeff
    lat = _lat(cfg, Q)
    dev = x_frames.device
    Lc, pc = onepole_ewma_mats(lam, nF, dev)
    fade_in = torch.arange(1, Hs + 1, dtype=torch.float32, device=dev) / Hs
    below = w.freqs < MAX_SPREAD_FREQ
    nB = bank.n_bands

    def frames(a):                          # (..., B, Q, S) → (..., nF, B, Q, Hs)
        return a.reshape(a.shape[:-1] + (nF, Hs)).movedim(-2, -4)

    def ewma(new, init):
        """Along the frame axis: new (..., nF, B, Q, Q), init (..., B, Q, Q)."""
        with fp32_matmul():
            return (torch.einsum("tk,...kbqr->...tbqr", Lc, new)
                    + pc[:, None, None, None] * init[..., None, :, :, :])

    def src_of(t, src):                      # state leaf → (..., B, Q, Q)
        return t.select(nl, src)

    out = (torch.zeros(lead + (nF, nB, Q, Hs), device=dev),
           torch.zeros(lead + (nF, nB, Q, Hs), device=dev))
    new_lat, new_Cp, new_Cy, new_M, new_Mr = [], [], [], [], []
    for src in range(cfg.n_sources):
        spec_s = (sre[..., src, :], sim[..., src, :])    # (..., B, S)
        h_avg, Cy_st, h_c = _spread_statics(w, src_dirs_deg[src],
                                            src_spread_deg[src], below)
        proto = _proto(h_avg, spec_s)
        if cfg.mode == MODE_NAIVE:
            out = (out[0] + frames(proto[0]), out[1] + frames(proto[1]))
            new_lat.append(state.lattice[src])
            new_Cp.append((src_of(state.Cproto_re, src),
                           src_of(state.Cproto_im, src)))
            new_Cy.append((src_of(state.Cy_re, src),
                           src_of(state.Cy_im, src)))
            new_M.append((src_of(state.prev_M_re, src),
                          src_of(state.prev_M_im, src)))
            new_Mr.append(src_of(state.prev_Mr, src))
            continue
        if cfg.mode == MODE_EVD:
            proto = tuple(s[..., None, :].expand(lead + (nB, Q, S_tot))
                          for s in spec_s)
        # one streaming lattice call over the chunk == nF per-frame calls
        dec_c, lat_st = decor.lattice_apply_ri(lat, w.lattice,
                                               state.lattice[src], *proto)
        pf = (frames(proto[0]), frames(proto[1]))      # (..., nF, B, Q, Hs)
        dec = (frames(dec_c[0]), frames(dec_c[1]))
        Cp_new = H.ceinsum("...tbqh,...tbrh->...tbqr", pf, H.conj(pf))
        Cp = (ewma(Cp_new[0], src_of(state.Cproto_re, src)),
              ewma(Cp_new[1], src_of(state.Cproto_im, src)))
        # the target covariance Cy_st: static across the chunk
        if cfg.mode == MODE_OM:
            tr_y = torch.diagonal(Cy_st[0], dim1=-2, dim2=-1).sum(-1)
            sf = (frames(spec_s[0][..., None, :])[..., 0, :],
                  frames(spec_s[1][..., None, :])[..., 0, :])  # (..., nF, B, Hs)
            sc = _proto(h_c, sf)                         # (..., nF, B, Q, Hs)
            tr_e = (sc[0] ** 2).sum((-1, -2)) + (sc[1] ** 2).sum((-1, -2))
            scale = torch.where(below, tr_e / (tr_y + 2.23e-9), 1.0)
            Cy_new = (Cy_st[0] * scale[..., None, None],
                      Cy_st[1] * scale[..., None, None])
        else:
            Cy_new = tuple(c.expand(lead + (nF, nB, Q, Q)) for c in Cy_st)
        Cy = (ewma(Cy_new[0], src_of(state.Cy_re, src)),
              ewma(Cy_new[1], src_of(state.Cy_im, src)))
        if cfg.mode == MODE_EVD:
            e_y = torch.diagonal(Cy[0], dim1=-2, dim2=-1).sum((-1, -2))
            # per-(band, channel) 1e-6, as in process() (spreader.c:552)
            e_p = (torch.diagonal(Cp[0], dim1=-2, dim2=-1).sum((-1, -2))
                   + 1e-6 * (nB * Q))
            M = _evd_mix(Cy, torch.sqrt(e_p / (e_y + 2.23e-9))[
                ..., None, None, None])
            Mr = torch.zeros(lead + (nF, nB, Q, Q), device=dev)
            sig_in = dec
        else:  # OM
            M, Mr = _om_mix(Cp, Cy, below)
            sig_in = pf
        # crossfade against the PREVIOUS frame's target M (frame-shifted)
        Mp = (torch.cat([src_of(state.prev_M_re, src)[..., None, :, :, :],
                         M[0][..., :-1, :, :, :]], dim=-4),
              torch.cat([src_of(state.prev_M_im, src)[..., None, :, :, :],
                         M[1][..., :-1, :, :, :]], dim=-4))
        f = fade_in[:, None, None]
        M_t = (f * M[0][..., None, :, :] + (1 - f) * Mp[0][..., None, :, :],
               f * M[1][..., None, :, :] + (1 - f) * Mp[1][..., None, :, :])
        mixed = _cmix(M_t, sig_in, "...tbhqr,...tbrh->...tbqh")
        if cfg.mode == MODE_OM:
            Mrp = torch.cat([src_of(state.prev_Mr, src)[..., None, :, :, :],
                             Mr[..., :-1, :, :, :]], dim=-4)
            Mr_t = f * Mr[..., None, :, :] + (1 - f) * Mrp[..., None, :, :]
            with fp32_matmul():
                mixed = tuple(m + torch.einsum("...tbhqr,...tbrh->...tbqh",
                                               Mr_t, d)
                              for m, d in zip(mixed, dec))
        out = (out[0] + mixed[0], out[1] + mixed[1])
        new_lat.append(lat_st)
        new_Cp.append((Cp[0][..., -1, :, :, :], Cp[1][..., -1, :, :, :]))
        new_Cy.append((Cy[0][..., -1, :, :, :], Cy[1][..., -1, :, :, :]))
        new_M.append((M[0][..., -1, :, :, :], M[1][..., -1, :, :, :]))
        new_Mr.append(Mr[..., -1, :, :, :])

    # (..., nF, B, Q, Hs) → (..., B, Q, S)
    out_cat = tuple(o.movedim(-4, -2).reshape(lead + (nB, Q, S_tot))
                    for o in out)
    if batched:
        y_cat, bank_st = ri.synthesis_ri_batched(
            bank, bank_st, tuple(o.permute(0, 2, 3, 1) for o in out_cat),
            use_kernel=fused)
    else:
        y_cat, bank_st = ri.synthesis_ri(bank, bank_st, out_cat)
    ys = y_cat.reshape(lead + (Q, nF, F)).movedim(-2, -3)
    return ys, _new_state(bank_st, new_lat, new_Cp, new_Cy, new_M, new_Mr,
                          nl)
