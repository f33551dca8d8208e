"""The port's tracker, SAF-named facade (compat) and the names its ported
modules had left out (geometry quaternions and hulls, the HOA convention
converters, the FFT helpers, VBAP's qhull triangulation), each held against
the JAX package on the same inputs."""
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu import compat as jsaf
from spatial_audio_framework_tpu.modules import hoa as jhoa
from spatial_audio_framework_tpu.modules import tracker as jtrk
from spatial_audio_framework_tpu.modules import vbap as jvbap
from spatial_audio_framework_tpu.ops import fft as jfft
from spatial_audio_framework_tpu.utils import geometry as jgeo
from spatial_audio_framework_tpu_torch import compat as tsaf
from spatial_audio_framework_tpu_torch.modules import hoa as thoa
from spatial_audio_framework_tpu_torch.modules import tracker as ttrk
from spatial_audio_framework_tpu_torch.modules import vbap as tvbap
from spatial_audio_framework_tpu_torch.ops import fft as tfft
from spatial_audio_framework_tpu_torch.utils import geometry as tgeo

# float32 paths computed in another order (torch vs XLA on the CPU)
TOL = 1e-5


def _close(a, b, tol=TOL, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# tracker: the same seed gives the same tracks
# ---------------------------------------------------------------------------

def _track(T, seed, n_steps, starve):
    cfg = T.Tracker3DConfig(n_particles=30, dt=0.05, measure_noise_sd=0.1,
                            noise_spec_den=0.5, alpha_death=2.0)
    cfg.M0 = np.zeros(6)
    cfg.M0[0] = 1.0
    trk = T.Tracker3D(cfg, seed=seed)
    rng = np.random.default_rng(seed + 100)
    out = []
    for k in range(n_steps):
        azi = np.radians(k * 3.0)
        obs = np.array([np.cos(azi), np.sin(azi), 0.0]) + rng.normal(0, .05, 3)
        if k % 7 == 3:   # a clutter observation now and then
            obs = rng.normal(0, 1, 3)
        out.append(trk.step(None if (starve and k > n_steps // 2)
                            else (obs / np.linalg.norm(obs))[None]))
    return out


@pytest.mark.parametrize("seed,starve", [(0, False), (1, False), (2, True)])
def test_tracker_same_seed_same_tracks(seed, starve):
    ref = _track(jtrk, seed, 40, starve)
    got = _track(ttrk, seed, 40, starve)
    for (p, v, i), (rp, rv, ri) in zip(got, ref):
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_array_equal(p, rp)
        np.testing.assert_array_equal(v, rv)


def test_tracker_numerics_equal():
    F = np.zeros((6, 6))
    F[:3, 3:] = np.eye(3)
    Qc = np.diag([0, 0, 0, 0.7, 0.7, 0.7])
    for a, b in zip(ttrk.lti_disc(F, Qc, 0.125), jtrk.lti_disc(F, Qc, 0.125)):
        np.testing.assert_array_equal(a, b)
    for x in (0.1, 0.7, 2.5):
        assert ttrk.gamma_cdf(x, 2.0, 0.8) == jtrk.gamma_cdf(x, 2.0, 0.8)


# ---------------------------------------------------------------------------
# the seven facade cases of tests/test_compat.py, port against JAX
# ---------------------------------------------------------------------------

def _sh(saf):
    dirs_rad = np.array([[0.3, 1.1], [2.0, 0.4]])
    R = saf.yawPitchRoll2Rzyx(0.3, 0.1, -0.2)
    return {"Y": saf.getSHreal(2, dirs_rad),
            "Yc": saf.getSHcomplex(2, dirs_rad),
            "T": saf.complex2realSHMtx(2), "R": R,
            "M": saf.getSHrotMtxReal(R, 2),
            "Yr": saf.getRSH(1, np.array([[30.0, 10.0]]))}


def _vbap_hoa(saf):
    ls = np.array([[0.0, 0.0], [90.0, 0.0], [180.0, 0.0], [-90.0, 0.0],
                   [0.0, 90.0], [0.0, -90.0]])
    gt = saf.generateVBAPgainTable3D(ls, 10, 15)
    comp, idx = saf.compressVBAPgainTable3D(gt)
    return {"gt": gt, "comp": comp, "idx": idx,
            "it": saf.VBAPgainTable2InterpTable(gt),
            "dec": saf.getLoudspeakerDecoderMtx(ls, "allrad", 1),
            "w": saf.getMaxREweights(3),
            "p": saf.getPvalues(20.0, np.array([100.0, 1000.0, 10000.0]))}


def _afstft_handle(saf, **kw):
    h = saf.afSTFT(2, 2, 128, 0, 1, **kw)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 128 * 12)).astype(
        np.float32)
    specs = [h.forward(x[:, s:s + 512]) for s in range(0, x.shape[1], 512)]
    y = np.concatenate([h.backward(s) for s in specs], axis=1)
    return {"n": h.getNBands(), "d": h.getProcDelay(),
            "fv": h.getCentreFreqs(48000.0), "spec": np.concatenate(
                specs, -1), "y": y}


def _hrir_cdf4sap(saf, **kw):
    rng = np.random.default_rng(1)
    hrirs = rng.standard_normal((8, 2, 128)).astype(np.float32)
    itds = saf.estimateITDs(hrirs, 48000.0)
    hrtfs = saf.HRIRs2HRTFs_afSTFT(hrirs)
    Cx = np.eye(4, dtype=np.float32) * 2.0
    Cy = np.eye(2, dtype=np.float32)
    Q = np.ones((2, 4), np.float32) / 2.0
    M, Cr = saf.formulate_M_and_Cr(Cx, Cy, Q)
    return {"itds": itds, "hrtfs": hrtfs,
            "eq": saf.diffuseFieldEqualiseHRTFs(
                hrtfs, itds, saf.afSTFT(1, 1, **kw).getCentreFreqs(48e3)),
            "M": M, "Cr": Cr,
            "qmf": saf.HRIRs2HRTFs_qmf(hrirs[:2])}


def _lattice_tracker_utils(saf, **kw):
    fv = saf.afSTFT(1, 1, **kw).getCentreFreqs(48000.0)
    ld = saf.latticeDecorrelator(48000.0, 128, fv, 2, **kw)
    frame = (np.random.default_rng(2).standard_normal((133, 2, 8))
             + 0j).astype(np.complex64)
    trk = saf.tracker3d_create(n_particles=20)
    tracks = [saf.tracker3d_step(trk, np.array([[1.0, 0.0, 0.0]]) + 0.01 * k)
              for k in range(5)]
    saf.tracker3d_reset(trk)
    b, a = saf.butterCoeffs("lpf", 4, 1000.0, 0.0, 48000.0)
    fb = saf.faf_IIRFilterbank(3, np.array([500.0, 2000.0]), 48000.0)
    return {"ld": ld.apply(frame), "pos": tracks[-1][0],
            "ids": tracks[-1][2], "n2": saf.nextpow2(100),
            "win": saf.getWindowingFunction("hann", 64), "b": b, "a": a,
            "bands": fb.apply(np.random.default_rng(3).standard_normal(512)),
            "u": np.asarray(saf.sph2cart(np.array([[0.0, 0.0, 1.0]])))}


def _estimators(saf):
    grid = np.stack(np.meshgrid(np.arange(-180, 180, 10),
                                np.arange(-80, 81, 10)), -1).reshape(-1, 2)
    a = saf.getRSH(3, np.array([[40.0, 10.0]]))
    Cx = (a @ a.T).astype(np.float32)
    peaks, pmap = saf.sphPWD(Cx, grid, 1)
    return {"peaks": np.asarray(peaks), "pmap": np.asarray(pmap)}


def _veclib(saf):
    A = np.eye(3) * 2.0 + 0.1 * np.arange(9.0).reshape(3, 3)
    U, s, V = saf.utility_csvd(A + 1j * np.eye(3))
    out = {"sinv": saf.utility_sinv(A), "dinv": saf.utility_dinv(A),
           "cinv": saf.utility_cinv(A), "s": s,
           "USV": U @ np.diag(s) @ V.conj().T,
           "gth": saf.utility_ssv2cv_inds(np.arange(6.0), np.array([5, 1])),
           "iminv": saf.utility_ciminv(np.array([2.2 + 0j, 1.5 + 1.5j])),
           "imaxv": saf.utility_cimaxv(np.array([2.2 + 0j, 1.5 + 1.5j]))}
    out["dtypes"] = np.array([str(out[k].dtype)
                              for k in ("sinv", "dinv", "cinv")])
    return out


def _maps_decoders_filters(saf):
    """More of the facade: the DoA maps, the decoders, the HRTF helpers, the
    filterbank coefficients and the veclib variants."""
    grid = np.stack(np.meshgrid(np.arange(-180, 180, 20),
                                np.arange(-80, 81, 20)), -1).reshape(
        -1, 2).astype(float)
    a = saf.getRSH(2, np.array([[40.0, 10.0], [-70, 0]]))
    Cx = (a @ a.T + 0.01 * np.eye(9)).astype(np.float32)
    Yg = saf.getRSH(2, grid).astype(np.float32)
    h = np.random.default_rng(9).standard_normal((10, 2, 64)).astype(
        np.float32)
    hd = np.stack([np.linspace(-180, 150, 10),
                   np.tile([-30.0, 30.0], 5)], -1)
    hrtf = saf.HRIRs2HRTFs_afSTFT(h)
    fv = np.asarray(jsaf.afSTFT(1, 1).getCentreFreqs(48e3))
    return {
        "pwd": saf.generatePWDmap(Cx, Yg), "mvdr": saf.generateMVDRmap(Cx, Yg),
        "music": saf.generateMUSICmap(Cx, Yg, 2),
        "minnorm": saf.generateMinNormMap(Cx, Yg, 2),
        "bindec": saf.getBinauralAmbiDecoderMtx(hrtf, hd, "ls", 1, fv),
        "sad": saf.getLoudspeakerDecoderMtx(hd[:6], "sad", 1),
        "vbap2d": saf.generateVBAPgainTable2D(hd[:5], 5),
        "hrtfs": saf.HRIRs2HRTFs(h, 128),
        "bdc": saf.binauralDiffuseCoherence(hrtf, saf.estimateITDs(h, 48e3),
                                            fv),
        "afir": saf.afSTFT_FIRtoFilterbankCoeffs(h),
        "qfir": saf.qmf_FIRtoFilterbankCoeffs(h[:2]),
        "voronoi": saf.getVoronoiWeights(grid),
        "quat": saf.quaternion2rotationMatrix(np.array([0.9, 0.1, 0.2, 0.3])),
        "hilbert": saf.hilbert(np.sin(np.arange(32.0))),
        "fftconv": saf.fftconv(np.arange(5.0), np.ones(3)),
        "sseig": saf.utility_sseig(Cx)[1],
        "cslslv": saf.utility_cslslv(Cx + np.eye(9), np.ones((9, 2))),
        "spinv": saf.utility_spinv(Cx), "cchol": saf.utility_cchol(
            Cx + np.eye(9)),
        "ceig": np.sort_complex(saf.utility_ceig(Cx)[0]),
        "sdet": saf.utility_sdet(Cx + np.eye(9)),
        "svmod": saf.utility_svmod(np.array([-3.0, 4]), np.array([2.0, 3])),
        "cvvdot": saf.utility_cvvdot(np.array([1 + 1j, 2]),
                                     np.array([1j, 3]))}


CASES = {"sh": _sh, "vbap_hoa": _vbap_hoa, "afstft_handle": _afstft_handle,
         "hrir_cdf4sap": _hrir_cdf4sap,
         "lattice_tracker_utils": _lattice_tracker_utils,
         "estimators": _estimators, "veclib": _veclib,
         "maps_decoders_filters": _maps_decoders_filters}
_DEVICE_CASES = {"afstft_handle", "hrir_cdf4sap", "lattice_tracker_utils"}


@pytest.mark.parametrize("case", list(CASES))
def test_compat_case_matches_jax_facade(case):
    fn = CASES[case]
    kw = {"device": "cpu"} if case in _DEVICE_CASES else {}
    ref = fn(jsaf)
    got = fn(tsaf, **kw)
    assert set(got) == set(ref)
    for k in ref:
        if isinstance(ref[k], np.ndarray) and ref[k].dtype.kind in "US":
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            _close(got[k], ref[k], what=f"{case}: {k}")


def test_compat_veclib_surface_and_no_op_handles():
    """The 116 utility_?xxx symbols of saf_utility_veclib.h resolve in the
    port's facade as in the JAX one; torch tensors are cast per prefix."""
    names = sorted(n for n in vars(jsaf) if n.startswith("utility_"))
    assert len(names) == 116
    for n in names:
        assert callable(getattr(tsaf, n)), n
        if n.endswith(("_create", "_destroy")):
            assert getattr(tsaf, n)() is None
    t = torch.eye(3, dtype=torch.float64) * 2.0
    assert tsaf.utility_sinv(t).dtype == torch.float32
    assert tsaf.utility_cinv(t).dtype == torch.complex64
    idx = torch.tensor([5, 1])
    assert tsaf.utility_ssv2cv_inds(torch.arange(6.0), idx).tolist() == [5, 1]


def test_compat_handles_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tsaf.afSTFT(1, 1), lambda: tsaf.qmf(1, 1),
                 lambda: tsaf.latticeDecorrelator(
                     48000.0, 128, np.linspace(0, 24000, 133), 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_compat_qmf_handle_matches_jax():
    x = np.random.default_rng(5).uniform(-1, 1, (2, 1024)).astype(np.float32)
    hj, ht = jsaf.qmf(2, 2, 128, 1), tsaf.qmf(2, 2, 128, 1, device="cpu")
    assert ht.getNBands() == hj.getNBands()
    assert ht.getProcDelay() == hj.getProcDelay()
    _close(ht.getCentreFreqs(48e3), hj.getCentreFreqs(48e3))
    sj, st = hj.analysis(x), ht.analysis(x)
    _close(st, sj, what="qmf analysis")
    _close(ht.synthesis(st), hj.synthesis(sj), what="qmf synthesis")


# ---------------------------------------------------------------------------
# the names the ported modules had left out
# ---------------------------------------------------------------------------

_Q = np.array([[0.9, 0.1, -0.3, 0.2], [0.2, -0.7, 0.5, 0.4]])
_Q /= np.linalg.norm(_Q, axis=-1, keepdims=True)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_geometry_quaternions_match_jax(as_tensor):
    conv = (lambda a: torch.from_numpy(np.asarray(a))) if as_tensor else \
        (lambda a: a)
    back = (lambda t: t.numpy()) if as_tensor else np.asarray
    a, b, c = np.array([0.3, -2.0]), np.array([0.2, 1.2]), np.array([-0.1, 3])
    for deg in (False, True):
        for cv in (jgeo.EULER_ROTATION_YAW_PITCH_ROLL,
                   jgeo.EULER_ROTATION_ROLL_PITCH_YAW):
            q = tgeo.euler2quaternion(conv(a), conv(b), conv(c), deg, cv)
            _close(back(q), jgeo.euler2quaternion(a, b, c, deg, cv), 1e-12)
            for x, y in zip(tgeo.quaternion2euler(conv(_Q), deg, cv),
                            jgeo.quaternion2euler(_Q, deg, cv)):
                _close(back(x), y, 1e-12)
    R = tgeo.quaternion2rotation_matrix(conv(_Q))
    _close(back(R), jgeo.quaternion2rotation_matrix(_Q), 1e-12)
    _close(back(tgeo.rotation_matrix2quaternion(R)),
           jgeo.rotation_matrix2quaternion(np.asarray(back(R))), 1e-12)
    u, v = np.array([1.0, 2.0, -0.5]), np.array([0.3, -1.0, 2.0])
    _close(back(tgeo.crossProduct3(conv(u), conv(v))),
           jgeo.crossProduct3(u, v), 1e-12)
    _close(back(tgeo.L2_norm(conv(_Q))), jgeo.L2_norm(_Q), 1e-12)
    ax = np.array([0.0, 0.6, 0.8])
    _close(back(tgeo.rodrigues(conv(ax), 0.7)), jgeo.rodrigues(ax, 0.7),
           1e-12)


def test_geometry_hulls_match_jax():
    pts = np.random.default_rng(6).standard_normal((30, 3))
    np.testing.assert_array_equal(tgeo.convhull_nd(pts), jgeo.convhull_nd(pts))
    np.testing.assert_array_equal(tgeo.delaunay_nd(pts[:, :2]),
                                  jgeo.delaunay_nd(pts[:, :2]))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_hoa_convention_converters_match_jax(as_tensor):
    sig = np.random.default_rng(7).standard_normal((2, 9, 16)).astype(
        np.float32)
    x = torch.from_numpy(sig) if as_tensor else sig
    back = (lambda t: t.numpy()) if as_tensor else np.asarray
    ACN, FUMA = jhoa.HOA_CH_ORDER_ACN, jhoa.HOA_CH_ORDER_FUMA
    assert (thoa.HOA_CH_ORDER_ACN, thoa.HOA_CH_ORDER_FUMA) == (ACN, FUMA)
    for order, nsh in ((1, 4), (2, 9)):
        for i, o in ((FUMA, ACN), (ACN, FUMA), (ACN, ACN)):
            np.testing.assert_array_equal(
                back(thoa.convert_hoa_channel_convention(x[:, :nsh], order, i,
                                                         o)),
                jhoa.convert_hoa_channel_convention(sig[:, :nsh], order, i, o))
    N3D, SN3D, FN = jhoa.HOA_NORM_N3D, jhoa.HOA_NORM_SN3D, jhoa.HOA_NORM_FUMA
    for i, o in ((N3D, SN3D), (SN3D, N3D), (N3D, FN), (FN, N3D), (SN3D, FN),
                 (FN, SN3D)):
        order = 1 if FN in (i, o) else 2
        nsh = (order + 1) ** 2
        _close(back(thoa.convert_hoa_norm_convention(x[:, :nsh], order, i, o)),
               jhoa.convert_hoa_norm_convention(sig[:, :nsh], order, i, o),
               1e-7)


def test_fft_helpers_match_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 100)).astype(np.float32)
    h = rng.standard_normal((3, 17)).astype(np.float32)
    np.testing.assert_array_equal(tfft.get_uniform_freq_vector(256, 48e3),
                                  jfft.get_uniform_freq_vector(256, 48e3))
    for as_tensor in (False, True):
        conv = torch.from_numpy if as_tensor else (lambda a: a)
        back = (lambda t: t.numpy()) if as_tensor else np.asarray
        _close(back(tfft.rfft(conv(x), 128)), jfft.rfft(x, 128))
        X = np.asarray(jfft.rfft(x, 128))
        _close(back(tfft.irfft(conv(X), 128)), jfft.irfft(X, 128))
        xc = (x + 1j * x[::-1]).astype(np.complex64)
        _close(back(tfft.fft(conv(xc))), jfft.fft(xc))
        _close(back(tfft.ifft(conv(xc), 64)), jfft.ifft(xc, 64))
        _close(back(tfft.fftconv(conv(x), conv(h))), jfft.fftconv(x, h))
        _close(back(tfft.fftconv(conv(x), conv(h), 50)),
               jfft.fftconv(x, h, 50))
        _close(back(tfft.fftfilt(conv(x), conv(h))), jfft.fftfilt(x, h))
        for n in (100, 99):
            _close(back(tfft.hilbert(conv(x[:, :n]))), jfft.hilbert(x[:, :n]))


@pytest.mark.parametrize("preset", ["cube", "22.x"])
def test_vbap_qhull_matches_jax(preset):
    from spatial_audio_framework_tpu_torch.utils import presets

    ls = presets.loudspeaker_preset(preset) if preset != "cube" else \
        np.array([[45.0, 35.3], [135, 35.3], [-135, 35.3], [-45, 35.3],
                  [45, -35.3], [135, -35.3], [-135, -35.3], [-45, -35.3]])
    tv, tf = tvbap.find_ls_triplets(ls, method="qhull")
    jv, jf = jvbap.find_ls_triplets(ls, method="qhull")
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    with pytest.raises(ValueError, match="unknown method"):
        tvbap.find_ls_triplets(ls, method="delaunay")
