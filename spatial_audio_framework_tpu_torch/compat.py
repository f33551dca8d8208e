"""SAF-named compatibility facade — the safpy/safmex binding surface
(counterpart of ``spatial_audio_framework_tpu/compat.py``).

The reference ships MATLAB MEX wrappers for its most-used entry points
(extras/safmex: afSTFT, faf_IIRFilterbank, generateVBAPgainTable3D,
getSHcomplex, getSHreal, latticeDecorrelator, qmf, tracker3d) and points
Python users at an external SAFpy binding (extras/safpy/SAFPY.md).  In this
framework the public API *is* Python, so the binding layer becomes this
module: every major public symbol of saf.h under its original C name, with
the C calling conventions (units, argument order, shapes), adapted to
return-values instead of output pointers.  A user coming from SAF (or safmex/
SAFpy) can `from spatial_audio_framework_tpu_torch import compat as saf` and
keep their vocabulary; each wrapper cites the C symbol it mirrors.  Arrays come
back as numpy; the handles that run device code (afSTFT, qmf,
latticeDecorrelator) take ``device`` (default: the card).

Conventions preserved from C:
* `getSHreal`/`getSHcomplex` take [azi, inclination] in radians
  (saf_sh.h:176,240); `getRSH` takes [azi, elev] in degrees (saf_hoa.h:293).
* VBAP tables flatten to (nTable, nLS) gains (saf_vbap.h:73).
* afSTFT/qmf wrappers operate in BANDS_CH_TIME layout (afSTFTlib.h:80-90).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import default_device
from spatial_audio_framework_tpu_torch.modules import (
    cdf4sap as _cdf, hoa as _hoa, hrir as _hrir, sh as _sh, sh_est as _est,
    tracker as _trk, vbap as _vbap)
from spatial_audio_framework_tpu_torch.modules.sofa import (  # noqa: F401
    SofaContainer as saf_sofa_container, sofa_open as _sofa_open)
from spatial_audio_framework_tpu_torch.ops import (afstft as _afstft,
                                                   qmf as _qmf)
from spatial_audio_framework_tpu_torch.utils import (decor as _decor,
                                                     filters as _filters)

NUM_EARS = 2  # saf_utilities.h:52


def _on(a, dtype, device) -> torch.Tensor:
    """A numpy array-like as a tensor of ``dtype`` on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def _host(t) -> np.ndarray:
    """A tensor (on any device) or array-like as numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)

# =============================== saf_sh =====================================


def getSHreal(order, dirs_rad):
    """Real SH, (nSH, nDirs); dirs = [azi, INCLINATION] rad (saf_sh.h:176)."""
    return np.asarray(_sh.get_sh_real(order, np.atleast_2d(dirs_rad)))


getSHreal_recur = getSHreal  # saf_sh.h:211 (same values, recurrence impl)


def getSHcomplex(order, dirs_rad):
    """Complex SH w/ Condon-Shortley phase (saf_sh.h:240)."""
    return np.asarray(_sh.get_sh_complex(order, np.atleast_2d(dirs_rad)))


def complex2realSHMtx(order):
    """Complex→real SH transform T (saf_sh.h:261)."""
    return _sh.complex2real_sh_mtx(order)


def real2complexSHMtx(order):
    """Real→complex SH transform (saf_sh.h:275)."""
    return _sh.real2complex_sh_mtx(order)


def complex2realCoeffs(order, C):
    """Complex→real SH coefficient conversion (saf_sh.h:289)."""
    return _sh.complex2real_coeffs(order, C)


def getSHrotMtxReal(R, order):
    """Ivanic-recursion real-SH rotation matrix (saf_sh.h:326)."""
    return np.asarray(_sh.get_sh_rot_mtx_real(np.asarray(R), order))


def computeVelCoeffsMtx(sector_order):
    """Velocity coefficients A_xyz (saf_sh.h:348)."""
    return _sh.compute_vel_coeffs_mtx(sector_order)


def computeSectorCoeffsEP(order_sec, A_xyz, pattern, sec_dirs_deg):
    """Energy-preserving sector coeffs (saf_sh.h:393); A_xyz accepted for C
    signature parity but recomputed internally."""
    del A_xyz
    return _sh.compute_sector_coeffs(order_sec, pattern,
                                     np.atleast_2d(sec_dirs_deg), "EP")


def computeSectorCoeffsAP(order_sec, A_xyz, pattern, sec_dirs_deg):
    """Amplitude-preserving sector coeffs (saf_sh.h:440)."""
    del A_xyz
    return _sh.compute_sector_coeffs(order_sec, pattern,
                                     np.atleast_2d(sec_dirs_deg), "AP")


def beamWeightsCardioid2Spherical(order):
    """saf_sh.h:460."""
    return _sh.beam_weights_cardioid(order)


def beamWeightsHypercardioid2Spherical(order):
    """saf_sh.h:492."""
    return _sh.beam_weights_hypercardioid(order)


def beamWeightsMaxEV(order):
    """saf_sh.h:510."""
    return _sh.beam_weights_max_ev(order)


def beamWeightsVelocityPatternsReal(order, b_n, azi_rad, elev_rad):
    """saf_sh.h:588."""
    return _sh.beam_weights_velocity_patterns_real(order, b_n, azi_rad,
                                                   elev_rad)


def rotateAxisCoeffsReal(order, c_n, theta_0, phi_0):
    """saf_sh.h:629."""
    return _sh.rotate_axis_coeffs_real(order, c_n, theta_0, phi_0)


def checkCondNumberSHTReal(order, dirs_rad, weights=None):
    """saf_sh.h:649."""
    return _hoa.check_cond_number_sht_real(order, np.atleast_2d(dirs_rad),
                                           weights)


def sphPWD(Cx, grid_dirs_deg, nSrcs):
    """Plane-wave-decomposition DoA estimator (saf_sh.h:691)."""
    return _est.sph_pwd(Cx, grid_dirs_deg, nSrcs)


def sphMUSIC(Cx, grid_dirs_deg, nSrcs):
    """SH-MUSIC DoA estimator (saf_sh.h:741)."""
    return _est.sph_music(Cx, grid_dirs_deg, nSrcs)


def sphESPRIT(Us):
    """SH-ESPRIT from signal subspace in CONJUGATED complex SH (saf_sh.h:798)."""
    return _est.sph_esprit(Us)


def generatePWDmap(Cx, Y_grid):
    """saf_sh.h:842."""
    return np.asarray(_est.generate_pwd_map(Cx, Y_grid))


def generateMVDRmap(Cx, Y_grid, regPar=8.0):
    """saf_sh.h:865."""
    return np.asarray(_est.generate_mvdr_map(Cx, Y_grid, regPar))


def generateCroPaCLCMVmap(Cx, Y_grid, regPar=8.0, lambda_=0.0):
    """saf_sh.h:904."""
    return np.asarray(_est.generate_cropac_lcmv_map(Cx, Y_grid, regPar,
                                                    lambda_))


def generateMUSICmap(Cx, Y_grid, nSources, logScaleFlag=False):
    """saf_sh.h:928."""
    return np.asarray(_est.generate_music_map(Cx, Y_grid, nSources,
                                              logScaleFlag))


def generateMinNormMap(Cx, Y_grid, nSources, logScaleFlag=False):
    """saf_sh.h:952."""
    return np.asarray(_est.generate_minnorm_map(Cx, Y_grid, nSources,
                                                logScaleFlag))


# array processing (saf_sh.h:977-1229)
from spatial_audio_framework_tpu_torch.modules.array_proc import (  # noqa: E402
    cyl_modal_coeffs as cylModalCoeffs,
    sph_modal_coeffs as sphModalCoeffs,
    sph_scatterer_modal_coeffs as sphScattererModalCoeffs,
    sph_scatterer_dir_modal_coeffs as sphScattererDirModalCoeffs,
    sph_array_alias_lim as sphArrayAliasLim,
    sph_array_noise_threshold as sphArrayNoiseThreshold,
    sph_diff_coh_mtx_theory as sphDiffCohMtxTheory,
    simulate_cyl_array as simulateCylArray,
    simulate_sph_array as simulateSphArray,
    evaluate_sht_filters as evaluateSHTfilters,
)

# =============================== saf_hoa ====================================


def convertHOAChannelConvention(insig, order, inConvention, outConvention):
    """ACN↔FuMa channel re-ordering (saf_hoa.h:237)."""
    return np.asarray(_hoa.convert_hoa_channel_convention(
        insig, order, inConvention, outConvention))


def convertHOANormConvention(insig, order, inConvention, outConvention):
    """N3D↔SN3D↔FuMa gain conversion (saf_hoa.h:262)."""
    return np.asarray(_hoa.convert_hoa_norm_convention(
        insig, order, inConvention, outConvention))


def getRSH(order, dirs_deg):
    """Real SH ×√4π, dirs [azi, ELEV] DEGREES (saf_hoa.h:293)."""
    return np.asarray(_sh.get_rsh(order, np.atleast_2d(dirs_deg)))


getRSH_recur = getRSH  # saf_hoa.h:328


def getMaxREweights(order):
    """Per-channel max-rE weights, diagonal as vector (saf_hoa.h:363)."""
    return _hoa.get_max_re_weights(order)


def truncationEQ(w_n, order_truncated, order_target, kr):
    """Order-truncation EQ gains (saf_hoa.h:388)."""
    return _hoa.truncation_eq(w_n, order_truncated, order_target, kr)


def getLoudspeakerDecoderMtx(ls_dirs_deg, method, order,
                             enableMaxReWeighting=False):
    """SAD/MMD/EPAD/AllRAD decoder (saf_hoa.h:413); method: 'sad'|'mmd'|
    'epad'|'allrad'."""
    return _hoa.get_loudspeaker_decoder_mtx(
        np.atleast_2d(ls_dirs_deg), method, order, enableMaxReWeighting)


def getBinauralAmbiDecoderMtx(hrtfs, hrtf_dirs_deg, method, order,
                              freqVector=None, itds_s=None, weights=None):
    """LS/LSDIFFEQ/SPR/TA/MAGLS binaural decoder (saf_hoa.h:447);
    hrtfs: (nBands, 2, nDirs) complex."""
    return _hoa.get_binaural_ambi_decoder_mtx(
        hrtfs, np.atleast_2d(hrtf_dirs_deg), method, order,
        freq_vector=freqVector, itds=itds_s, weights=weights)


def applyDiffCovMatching(hrtfs, hrtf_dirs_deg, order, decMtx, weights=None):
    """Diffuse-field covariance matching (saf_hoa.h:520)."""
    return _hoa.apply_diff_cov_matching(hrtfs, np.atleast_2d(hrtf_dirs_deg),
                                        order, decMtx, weights)


# =============================== saf_vbap ===================================


def generateVBAPgainTable3D(ls_dirs_deg, az_res_deg, el_res_deg,
                            omitLargeTriangles=False, enableDummies=False,
                            spread=0.0):
    """(nTable, nLS) 3-D VBAP gain table (saf_vbap.h:73; safmex wrapper)."""
    return _vbap.generate_vbap_gain_table_3d(
        np.atleast_2d(ls_dirs_deg), az_res_deg, el_res_deg,
        omit_large_triangles=omitLargeTriangles,
        enable_dummies=enableDummies, spread=spread)


def generateVBAPgainTable3D_srcs(src_dirs_deg, ls_dirs_deg,
                                 omitLargeTriangles=False,
                                 enableDummies=False, spread=0.0):
    """saf_vbap.h:129."""
    return _vbap.generate_vbap_gain_table_3d_srcs(
        np.atleast_2d(src_dirs_deg), np.atleast_2d(ls_dirs_deg),
        omit_large_triangles=omitLargeTriangles,
        enable_dummies=enableDummies, spread=spread)


def compressVBAPgainTable3D(gtable):
    """→ (gains (nTable,3), indices (nTable,3)) (saf_vbap.h:174)."""
    return _vbap.compress_vbap_gain_table_3d(gtable)


def VBAPgainTable2InterpTable(gtable):
    """Row-normalised interpolation table (saf_vbap.h:192)."""
    return _vbap.vbap_gain_table_to_interp_table(gtable)


def generateVBAPgainTable2D(ls_dirs_deg, az_res_deg):
    """saf_vbap.h:215."""
    return _vbap.generate_vbap_gain_table_2d(np.atleast_2d(ls_dirs_deg),
                                             az_res_deg)


def getPvalues(DTT, freq):
    """p-value loudness-compensation exponents (saf_vbap.h:292)."""
    return _vbap.get_p_values(DTT, np.asarray(freq))


# =============================== saf_hrir / saf_brir ========================


def estimateITDs(hrirs, fs):
    """hrirs: (nDirs, 2, len) → ITDs seconds (saf_hrir.h:79)."""
    return _hrir.estimate_itds(np.asarray(hrirs), fs)


def HRIRs2HRTFs_afSTFT(hrirs, hopsize=128, LDmode=0, hybridmode=1):
    """(nDirs,2,len) → (nBands,2,nDirs) afSTFT coeffs (saf_hrir.h:107)."""
    return _hrir.hrirs_to_hrtfs_afstft(np.asarray(hrirs), hopsize,
                                       low_delay=bool(LDmode),
                                       hybrid=bool(hybridmode))


def HRIRs2HRTFs_qmf(hrirs, hopsize=128, hybridmode=1):
    """saf_hrir.h:136."""
    return _qmf.qmf_fir_to_filterbank_coeffs(np.asarray(hrirs), hopsize,
                                             hybrid=bool(hybridmode))


def HRIRs2HRTFs(hrirs, fftSize):
    """DFT-domain HRTFs (saf_hrir.h:156)."""
    return _hrir.hrirs_to_hrtfs(np.asarray(hrirs), fftSize)


def diffuseFieldEqualiseHRTFs(hrtfs, itds_s=None, centreFreq=None,
                              weights=None, applyEQFLAG=1, applyPhaseFLAG=0):
    """saf_hrir.h:186."""
    return _hrir.diffuse_field_equalise_hrtfs(
        hrtfs, itds_s, centreFreq, weights,
        apply_eq=bool(applyEQFLAG), apply_phase=bool(applyPhaseFLAG))


def interpHRTFs(hrtfs, interp_table, itds=None, freqVector=None):
    """VBAP-weight HRTF interpolation with mag/ITD phase re-synthesis
    (saf_hrir.h:228)."""
    return _hrir.interp_hrtfs(hrtfs, interp_table, itds, freqVector)


def binauralDiffuseCoherence(hrtfs, itds, freqVector):
    """saf_hrir.h:254."""
    return _hrir.binaural_diffuse_coherence(hrtfs, itds, freqVector)


def resampleHRIRs(hrirs, fs_in, fs_out, padToNextPow2=0):
    """→ (resampled, new_len) (saf_hrir.h:280)."""
    del padToNextPow2
    return _hrir.resample_hrirs(np.asarray(hrirs), fs_in, fs_out)


# =============================== saf_cdf4sap ================================


def formulate_M_and_Cr(Cx, Cy, Q, useEnergyFLAG=0, reg=1e-2):
    """Real covariance-domain optimal mixing (saf_cdf4sap.h:151)."""
    return _cdf.formulate_M_and_Cr(Cx, Cy, Q, bool(useEnergyFLAG), reg)


def formulate_M_and_Cr_cmplx(Cx, Cy, Q, useEnergyFLAG=0, reg=1e-2):
    """Complex variant (saf_cdf4sap.h:208)."""
    return _cdf.formulate_M_and_Cr_cmplx(Cx, Cy, Q, bool(useEnergyFLAG), reg)


# =============================== filterbanks (safmex parity) ===============


class afSTFT:
    """Stateful afSTFT wrapper mirroring safmex_afSTFT / the C handle API
    (afSTFTlib.h:107-278): create(nCHin, nCHout, hopsize[, LD, hybrid]) then
    forward/backward on (nBands, nCH, nHops) BANDS_CH_TIME data."""

    def __init__(self, nCHin, nCHout, hopsize=128, lowDelayMode=0,
                 hybridmode=1, device: torch.device | str | None = None):
        self.bank = _afstft.AfSTFT(hop=hopsize, hybrid=bool(hybridmode),
                                   low_delay=bool(lowDelayMode))
        self.nCHin, self.nCHout = nCHin, nCHout
        self.device = torch.device(default_device() if device is None
                                   else device)
        self.clearBuffers()

    # afSTFTlib.h getters
    def getNBands(self):
        return self.bank.n_bands

    def getProcDelay(self):
        return self.bank.proc_delay

    def getCentreFreqs(self, fs):
        return self.bank.centre_freqs(fs)

    def clearBuffers(self):
        self._st = self.bank.init_state(self.nCHin, self.nCHout, self.device)

    def channelChange(self, new_nCHin, new_nCHout):
        self.nCHin, self.nCHout = new_nCHin, new_nCHout
        self.clearBuffers()

    def forward(self, dataTD):
        """(nCHin, nSamples) → (nBands, nCHin, nHops) complex."""
        spec, self._st = self.bank.analysis(
            self._st, _on(dataTD, np.float32, self.device))
        return _host(spec)

    def backward(self, dataFD):
        """(nBands, nCHout, nHops) → (nCHout, nSamples)."""
        y, self._st = self.bank.synthesis(
            self._st, _on(dataFD, np.complex64, self.device))
        return _host(y)


def afSTFT_FIRtoFilterbankCoeffs(hIR, hopSize=128, LDmode=0, hybridmode=1):
    """(nDirs, nCH, irLen) → (nBands, nCH, nDirs) (afSTFTlib.c:592)."""
    return _afstft.fir_to_filterbank_coeffs(np.asarray(hIR), hopSize,
                                            low_delay=bool(LDmode),
                                            hybrid=bool(hybridmode))


class qmf:
    """Stateful QMF wrapper (saf_utility_qmf.h:62-164; safmex_qmf)."""

    def __init__(self, nCHin, nCHout, hopsize=128, hybridmode=1,
                 formatFlag=0, device: torch.device | str | None = None):
        del formatFlag  # QMF_BANDS_CH_TIME is the only layout here
        self.bank = _qmf.QMF(hop=hopsize, hybrid=bool(hybridmode))
        self.nCHin, self.nCHout = nCHin, nCHout
        self.device = torch.device(default_device() if device is None
                                   else device)
        self.clearBuffers()

    def getNBands(self):
        return self.bank.n_bands

    def getProcDelay(self):
        return self.bank.proc_delay

    def getCentreFreqs(self, fs):
        return self.bank.centre_freqs(fs)

    def clearBuffers(self):
        self._st = self.bank.init_state(self.nCHin, self.nCHout, self.device)

    def analysis(self, dataTD):
        spec, self._st = self.bank.analysis(
            self._st, _on(dataTD, np.float32, self.device))
        return _host(spec)

    def synthesis(self, dataFD):
        y, self._st = self.bank.synthesis(
            self._st, _on(dataFD, np.complex64, self.device))
        return _host(y)


def qmf_FIRtoFilterbankCoeffs(hIR, hopSize=128, hybridmode=1):
    """saf_utility_qmf.h:164."""
    return _qmf.qmf_fir_to_filterbank_coeffs(np.asarray(hIR), hopSize,
                                             hybrid=bool(hybridmode))


class latticeDecorrelator:
    """Stateful lattice all-pass decorrelator (saf_utility_decor.h:161;
    safmex_latticeDecorrelator). Operates on (nBands, nCH, nHops) frames."""

    def __init__(self, fs, hopsize, freqVector, nCH,
                 orders=(20, 15, 6, 3), freqCutoffs=(700.0, 2.4e3, 4e3, 12e3),
                 maxDelay=8, device: torch.device | str | None = None):
        self.dec = _decor.LatticeDecorrelator(
            fs=fs, hop_size=hopsize, n_ch=nCH, orders=tuple(orders),
            freq_cutoffs=tuple(freqCutoffs), max_delay=maxDelay)
        self._freqs = np.asarray(freqVector)
        self._design = self.dec.design(self._freqs)
        self.device = torch.device(default_device() if device is None
                                   else device)
        self.reset()

    def reset(self):
        self._st = self.dec.init_state(self._design, self._freqs.shape[0],
                                       self.device)

    def apply(self, inFrame):
        out, self._st = self.dec.apply(self._design, self._st,
                                       _on(inFrame, np.complex64, self.device))
        return _host(out)


def faf_IIRFilterbank(order, fc, fs, maxBand=None):
    """Favrot&Faller IIR filterbank designer (saf_utility_filters.h:448;
    safmex_faf_IIRFilterbank) → a FafIIRFilterbank object with .apply()."""
    del maxBand
    return _filters.FafIIRFilterbank(order, np.asarray(fc), fs)


# =============================== saf_tracker ================================


def tracker3d_create(cfg: Optional[_trk.Tracker3DConfig] = None, **kw):
    """saf_tracker.h:123 (safmex_tracker3d)."""
    return _trk.Tracker3D(cfg or _trk.Tracker3DConfig(**kw))


def tracker3d_step(htracker, newObs_xyz):
    """One predict+update step → (target_pos_xyz, target_var_xyz, target_IDs)
    (saf_tracker.h:161)."""
    return htracker.step(np.atleast_2d(newObs_xyz) if newObs_xyz is not None
                         else None)


def tracker3d_reset(htracker):
    htracker.reset()


# =============================== saf_sofa_reader ============================


def saf_sofa_open(path, usecase="default"):
    """saf_sofa_reader.h:296 / fork's saf_sofa_open_universal (:291)."""
    return _sofa_open(path, usecase)


# =============================== saf_utilities ==============================

# geometry (saf_utility_geometry.h)
from spatial_audio_framework_tpu_torch.utils.geometry import (  # noqa: E402
    sph2cart, cart2sph,
    euler2rotation_matrix as euler2rotationMatrix,
    yaw_pitch_roll2_rzyx as yawPitchRoll2Rzyx,
    quaternion2rotation_matrix as quaternion2rotationMatrix,
    rotation_matrix2quaternion as rotationMatrix2quaternion,
    crossProduct3,
    L2_norm,
    sph_delaunay as sphDelaunay,
    sph_voronoi as sphVoronoi,
    sph_voronoi_areas as sphVoronoiAreas,
    euler2quaternion as euler2Quaternion,
    quaternion2euler,
    get_voronoi_weights as getVoronoiWeights,
)

# fft/stft (saf_utility_fft.h)
from spatial_audio_framework_tpu_torch.ops.fft import (  # noqa: E402
    get_uniform_freq_vector as getUniformFreqVector,
    fftconv, fftfilt, hilbert,
)

# filters (saf_utility_filters.h)
from spatial_audio_framework_tpu_torch.utils.filters import (  # noqa: E402
    get_windowing_function as getWindowingFunction,
    get_octave_band_cutoff_freqs as getOctaveBandCutoffFreqs,
    biquad_coeffs as biQuadCoeffs,
    eval_iir_transfer_function as evalIIRTransferFunction,
    apply_iir as applyIIR,
    butter_coeffs as butterCoeffs,
    fir_coeffs as FIRCoeffs,
    fir_filterbank as FIRFilterbank,
    interpolate_filters_h as interpolateFiltersH,
)

# decorrelation helpers (saf_utility_decor.h)
from spatial_audio_framework_tpu_torch.utils.decor import (  # noqa: E402
    get_decorrelation_delays as getDecorrelationDelays,
    get_decorrelation_delays_c as getDecorrelationDelays_c_exact,
    synthesise_noise_reverb as synthesiseNoiseReverb,
)

# the vendored quickhull (framework/resources/convhull_3d) — bit-faithful
# reimplementation incl. the unseeded-rand() jitter; glibc_rand models the
# C process's rand() stream
from spatial_audio_framework_tpu_torch.utils.convhull3d import (  # noqa: E402
    convhull_3d_build,
    glibc_rand,
)

# bessel/hankel (saf_utility_bessel.h)
from spatial_audio_framework_tpu_torch.utils.bessel import (  # noqa: E402
    bessel_Jn_all as bessel_Jn_ALL,
    bessel_Yn_all as bessel_Yn_ALL,
    hankel_Hn1_all as hankel_Hn1_ALL,
    hankel_Hn2_all as hankel_Hn2_ALL,
    bessel_jn_all as bessel_jn_ALL,
    bessel_yn_all as bessel_yn_ALL,
    bessel_in_all as bessel_in_ALL,
    bessel_kn_all as bessel_kn_ALL,
    hankel_hn1_all as hankel_hn1_ALL,
    hankel_hn2_all as hankel_hn2_ALL,
)

# misc (saf_utility_misc.h)
from spatial_audio_framework_tpu_torch.utils.misc import (  # noqa: E402
    next_pow2 as nextpow2,
    lagrange_weights as lagrangeWeights,
    find_erb_partitions as findERBpartitions,
    matlab_fmod as matlab_fmodf,
    cxcorr,
    rand_perm as randperm,
    convd, polyd_v, polyd_m, unique_i, gexpm,
)

# sort / grid search (saf_utility_sort.h)
from spatial_audio_framework_tpu_torch.utils.sort import (  # noqa: E402
    sort_with_indices as sortf,
    sortc,
    cmplx_pair_up as cmplxPairUp,
    find_closest_grid_points as findClosestGridPoints,
)

# veclib: utility_?xxx → ops.veclib (dtype prefix dropped; see its docstring)
from spatial_audio_framework_tpu_torch.ops import veclib as utility  # noqa: E402


# -- utility_?xxx: the complete 114-symbol C-named surface --------------------
# (saf_utility_veclib.h:112-1836).  Dtype prefixes map s/d/c/z →
# float32/float64/complex64/complex128; array arguments are cast to the
# variant's dtype, exactly as the C signatures constrain them.  The
# _create/_destroy pairs pre-allocate per-thread LAPACK workspaces in the
# reference; numpy and torch own their scratch allocation, so they are
# documented no-ops
# (accept and return a None handle, and every utility_?xxx ignores a
# leading ``hWork=None``-style handle being absent — call without one).

_VECLIB_DTYPES = {"s": "float32", "d": "float64",
                  "c": "complex64", "z": "complex128"}
# generic op name -> (C base name, dtype prefixes with a C variant)
_VECLIB_SURFACE = {
    "iminv": ("iminv", "sdcz"), "imaxv": ("imaxv", "sdcz"),
    "vabs": ("vabs", "sc"), "vmod": ("vmod", "s"), "vrecip": ("vrecip", "s"),
    "vconj": ("vconj", "cz"), "vvcopy": ("vvcopy", "sdcz"),
    "vvadd": ("vvadd", "sdcz"), "vvsub": ("vvsub", "sdcz"),
    "vvmul": ("vvmul", "sc"), "vvdot": ("vvdot", "sc"),
    "svsmul": ("vsmul", "sdcz"), "svsdiv": ("vsdiv", "s"),
    "svsadd": ("vsadd", "s"), "svssub": ("vssub", "s"),
    "sv2cv_inds": ("sv2cv_inds", "s"),
    "svd": ("svd", "sc"), "seig": ("seig", "sc"),
    "eig": ("eig", "cz"), "eigmp": ("eigmp", "cz"),
    "glslv": ("glslv", "sdcz"), "glslvt": ("glslvt", "s"),
    "slslv": ("slslv", "sc"), "pinv": ("pinv", "sdcz"),
    "chol": ("chol", "sc"), "det": ("det", "sd"), "inv": ("inv", "sdc"),
}
_VECLIB_HAS_HANDLE = {  # ops with _create/_destroy in the reference
    "svd", "seig", "eig", "eigmp", "glslv", "glslvt", "slslv", "pinv",
    "chol", "det", "inv",
}


def _make_veclib_variant(generic_name: str, c_name: str, dtype_name: str):
    base = getattr(utility, generic_name)

    def f(*args, **kw):
        dt = getattr(np, dtype_name)
        cast = []
        for a in args:
            if isinstance(a, torch.Tensor):
                # integer tensors are index arguments (e.g. sv2cv_inds)
                cast.append(a if not (a.is_floating_point() or a.is_complex())
                            else a.to(getattr(torch, dtype_name)))
            elif hasattr(a, "ndim"):  # numpy array
                # integer arrays are index arguments (e.g. sv2cv_inds)
                cast.append(a if np.issubdtype(a.dtype, np.integer)
                            else a.astype(dt))
            elif isinstance(a, (list, tuple)):
                arr = np.asarray(a)
                cast.append(arr if np.issubdtype(arr.dtype, np.integer)
                            else arr.astype(dt))
            else:
                cast.append(a)
        return base(*cast, **kw)

    f.__name__ = c_name
    f.__qualname__ = c_name
    f.__doc__ = (f"saf_utility_veclib.h ``{c_name}`` — {dtype_name} variant "
                 f"of :func:`ops.veclib.{generic_name}`.")
    return f


def _veclib_noop(c_name: str):
    def f(*_args, **_kw):
        return None

    f.__name__ = c_name
    f.__doc__ = (f"saf_utility_veclib.h ``{c_name}``: per-thread LAPACK "
                 "workspace pre-allocation in the reference; numpy and "
                 "torch own their scratch memory, so this is a documented "
                 "no-op.")
    return f


for _gname, (_cbase, _prefixes) in _VECLIB_SURFACE.items():
    for _p in _prefixes:
        _cn = f"utility_{_p}{_cbase}"
        globals()[_cn] = _make_veclib_variant(_gname, _cn,
                                              _VECLIB_DTYPES[_p])
        if _gname in _VECLIB_HAS_HANDLE:
            globals()[_cn + "_create"] = _veclib_noop(_cn + "_create")
            globals()[_cn + "_destroy"] = _veclib_noop(_cn + "_destroy")
del _gname, _cbase, _prefixes, _p, _cn
