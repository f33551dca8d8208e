"""Host design code and small device functions of the PyTorch port vs the
JAX package on the CPU, on the same seeded numpy inputs: 2-D VBAP and the
p-values, the torch real SH, the condition-number check, each DVF function,
HRIR resampling (speex), DFT-domain HRTFs, binaural coherence, the SPR
binaural decoder, diffuse-covariance matching, the output conversion
matrix, and the designs that now reach them (ambi_bin ``method="spr"`` and
``enable_diff_cov_matching``, the binauraliser at another HRIR rate).

Run alone with ``python -m pytest -q tests/test_torch_design_host.py``."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import _common as jcommon
from spatial_audio_framework_tpu.models import ambi_bin as jab
from spatial_audio_framework_tpu.models import binauraliser as jbin
from spatial_audio_framework_tpu.modules import brir as jbrir
from spatial_audio_framework_tpu.modules import hoa as jhoa
from spatial_audio_framework_tpu.modules import hrir as jhrir
from spatial_audio_framework_tpu.modules import sh as jsh
from spatial_audio_framework_tpu.modules import vbap as jvbap
from spatial_audio_framework_tpu.utils import dvf as jdvf
from spatial_audio_framework_tpu.utils import speex as jspeex
from spatial_audio_framework_tpu_torch.models import _common as tcommon
from spatial_audio_framework_tpu_torch.models import ambi_bin as tab
from spatial_audio_framework_tpu_torch.models import binauraliser as tbin
from spatial_audio_framework_tpu_torch.modules import brir as tbrir
from spatial_audio_framework_tpu_torch.modules import hoa as thoa
from spatial_audio_framework_tpu_torch.modules import hrir as thrir
from spatial_audio_framework_tpu_torch.modules import sh as tsh
from spatial_audio_framework_tpu_torch.modules import vbap as tvbap
from spatial_audio_framework_tpu_torch.utils import dvf as tdvf
from spatial_audio_framework_tpu_torch.utils import speex as tspeex

EXACT = 1e-12       # numpy float64 on both sides, the same operations
F32_TOL = 1e-5      # float32 on both sides; only libm differs
# float32 DVF shelf parameters cancel near the table's large entries
# (3404, 10336, 16818): relative to max(|reference|, 1e-3)
DVF_REL_TOL = 1e-4

_LAYOUTS = {
    "5.0": [[30, 0], [-30, 0], [0, 0], [110, 0], [-110, 0]],
    "unsorted ring": [[170, 0], [-20, 0], [95, 0], [-100, 0], [20, 0],
                      [-170, 0]],
    "stereo": [[30, 0], [-30, 0]],
}


# -- 2-D VBAP -----------------------------------------------------------------

@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_vbap_2d_vs_jax(layout):
    ls = np.asarray(_LAYOUTS[layout], np.float64)
    np.testing.assert_array_equal(tvbap.find_ls_pairs(ls),
                                  jvbap.find_ls_pairs(ls))
    rng = np.random.default_rng(len(ls))
    azis = np.concatenate([rng.uniform(-200, 200, 40), ls[:, 0],
                           [-180.0, 180.0, 0.0]])
    got, ref = tvbap.vbap_2d(azis, ls), jvbap.vbap_2d(azis, ls)
    assert got.dtype == np.float32 and got.shape == (len(azis), len(ls))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("res", [1, 2, 5])
def test_vbap_2d_gain_table_vs_jax(res):
    ls = np.asarray(_LAYOUTS["5.0"], np.float64)
    got = tvbap.generate_vbap_gain_table_2d(ls, res)
    assert got.shape == (int(360 / res) + 1, 5)
    np.testing.assert_array_equal(got,
                                  jvbap.generate_vbap_gain_table_2d(ls, res))
    # energy-normalised rows, at most two loudspeakers a row
    np.testing.assert_allclose((got.astype(np.float64) ** 2).sum(-1), 1.0,
                               atol=1e-6)
    assert ((got > 0).sum(-1) <= 2).all()


@pytest.mark.parametrize("dtt", [0.0, 0.5, 1.0])
def test_get_p_values_vs_jax(dtt):
    freq = np.random.default_rng(1).uniform(0, 24e3, 133)
    got = tvbap.get_p_values(dtt, freq)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jvbap.get_p_values(dtt, freq))


# -- spherical harmonics ------------------------------------------------------

@pytest.mark.parametrize("order", range(1, 8))
def test_get_sh_real_torch_vs_jax(order):
    """The torch real SH on float32 directions (with the poles and the
    azimuth seam) vs the JAX package's traced branch, and in float64 vs
    its numpy branch."""
    rng = np.random.default_rng(order)
    dirs = np.stack([rng.uniform(-np.pi, np.pi, 50),
                     rng.uniform(0, np.pi, 50)], -1)
    dirs[:4] = [[0, 0], [np.pi, np.pi], [-np.pi, np.pi / 2], [1.0, 0.0]]
    got = tsh.get_sh_real_torch(order, torch.from_numpy(dirs))
    assert tuple(got.shape) == ((order + 1) ** 2, 50)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), jsh.get_sh_real(order, dirs),
                               rtol=0, atol=EXACT)
    d32 = dirs.astype(np.float32)
    got32 = tsh.get_sh_real_torch(order, torch.from_numpy(d32))
    assert got32.dtype == torch.float32
    ref32 = np.asarray(jsh.get_sh_real(order, jnp.asarray(d32)))
    np.testing.assert_allclose(got32.numpy(), ref32, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_check_cond_number_sht_real_vs_jax(weighted):
    rng = np.random.default_rng(2)
    dirs = np.stack([rng.uniform(-np.pi, np.pi, 60),
                     np.arccos(rng.uniform(-1, 1, 60))], -1)
    w = rng.uniform(0.5, 1.5, 60) if weighted else None
    got = tsh.check_cond_number_sht_real(5, dirs, w)
    ref = jsh.check_cond_number_sht_real(5, dirs, w)
    assert got.shape == (6,)
    np.testing.assert_allclose(got, ref, rtol=1e-10)
    np.testing.assert_allclose(thoa.check_cond_number_sht_real(5, dirs, w),
                               ref, rtol=1e-10)


@pytest.mark.parametrize("ch,norm", [("acn", "n3d"), ("acn", "sn3d"),
                                     ("fuma", "fuma"), ("acn", "fuma")])
def test_output_conversion_mtx_vs_jax(ch, norm):
    order = 1 if "fuma" in (ch, norm) else 3
    np.testing.assert_array_equal(
        tcommon.output_conversion_mtx(order, ch, norm),
        jcommon.output_conversion_mtx(order, ch, norm))


# -- DVF ------------------------------------------------------------------------

def _dvf_inputs(dtype):
    """Lateral angles over [0, 180] with the table's knots and both ends,
    rho from the head's surface to the far field."""
    rng = np.random.default_rng(3)
    theta = np.concatenate([rng.uniform(0, 180, 150),
                            np.arange(0.0, 181.0, 10.0), [-5.0, 190.0]])
    rho = np.concatenate([rng.uniform(1.0, 40.0, 150),
                          np.full(19, 1.0), [0.5, 2.0]])
    return theta.astype(dtype), rho.astype(dtype)


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return (np.abs(np.asarray(got, np.float64) - ref)
            / np.maximum(np.abs(ref), 1e-3)).max()


def test_calc_dvf_shelf_params_vs_jax():
    """At table indices: float64 vs the JAX package's numpy branch, float32
    vs its traced branch with a relative tolerance (module docstring), and
    both against the float64 values."""
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 19, 100)
    rho = rng.uniform(1.0, 30.0, 100)
    ref = jdvf.calc_dvf_shelf_params(idx, rho)
    got = tdvf.calc_dvf_shelf_params(torch.from_numpy(idx),
                                     torch.from_numpy(rho))
    for a, b in zip(ref, got):
        assert _rel(b.numpy(), a) <= EXACT
    r32 = rho.astype(np.float32)
    ref32 = jdvf.calc_dvf_shelf_params(jnp.asarray(idx), jnp.asarray(r32),
                                       xp=jnp)
    got32 = tdvf.calc_dvf_shelf_params(torch.from_numpy(idx),
                                       torch.from_numpy(r32))
    for a, b, c in zip(ref32, got32, ref):
        assert b.dtype == torch.float32
        assert _rel(b.numpy(), np.asarray(a)) <= DVF_REL_TOL
        assert _rel(b.numpy(), c) <= DVF_REL_TOL


def test_interp_dvf_shelf_params_vs_jax():
    th, rho = _dvf_inputs(np.float64)
    ref = jdvf.interp_dvf_shelf_params(th, rho)
    got = tdvf.interp_dvf_shelf_params(torch.from_numpy(th),
                                       torch.from_numpy(rho))
    for a, b in zip(ref, got):
        assert _rel(b.numpy(), a) <= EXACT
    th32, rho32 = _dvf_inputs(np.float32)
    ref32 = jdvf.interp_dvf_shelf_params(jnp.asarray(th32), jnp.asarray(rho32))
    got32 = tdvf.interp_dvf_shelf_params(torch.from_numpy(th32),
                                         torch.from_numpy(rho32))
    for a, b in zip(ref32, got32):
        assert _rel(b.numpy(), np.asarray(a)) <= DVF_REL_TOL
    # broadcasting (nSrc, 2) angles against (nSrc, 1) distances, as the
    # near-field binauraliser calls it
    a2 = torch.from_numpy(th32[:20].reshape(10, 2))
    r1 = torch.from_numpy(rho32[:10, None].copy())
    for p, q in zip(tdvf.interp_dvf_shelf_params(a2, r1),
                    tdvf.interp_dvf_shelf_params(a2, r1.expand(10, 2))):
        assert tuple(p.shape) == (10, 2) and torch.equal(p, q)


def test_dvf_shelf_coeffs_and_calc_dvf_coeffs_vs_jax():
    th, rho = _dvf_inputs(np.float64)
    g0, gi, fc = jdvf.interp_dvf_shelf_params(th, rho)
    ref = jdvf.dvf_shelf_coeffs(g0, gi, fc, 48000.0)
    got = tdvf.dvf_shelf_coeffs(*(torch.from_numpy(v) for v in (g0, gi, fc)),
                                48000.0)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=EXACT)
    for fs in (44100.0, 48000.0):
        rb, ra = jdvf.calc_dvf_coeffs(th, rho, fs)
        gb, ga = tdvf.calc_dvf_coeffs(torch.from_numpy(th),
                                      torch.from_numpy(rho), fs)
        assert tuple(gb.shape) == rb.shape and tuple(ga.shape) == ra.shape
        np.testing.assert_allclose(gb.numpy(), rb, rtol=0, atol=EXACT)
        np.testing.assert_allclose(ga.numpy(), ra, rtol=0, atol=EXACT)
    th32, rho32 = _dvf_inputs(np.float32)
    rb, ra = jdvf.calc_dvf_coeffs(jnp.asarray(th32), jnp.asarray(rho32),
                                  48000.0)
    gb, ga = tdvf.calc_dvf_coeffs(torch.from_numpy(th32),
                                  torch.from_numpy(rho32), 48000.0)
    np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=0,
                               atol=F32_TOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(ra), rtol=0,
                               atol=F32_TOL)


def test_doa_to_ipsi_interaural_vs_jax():
    rng = np.random.default_rng(5)
    az = np.concatenate([rng.uniform(-180, 180, 100),
                         [0.0, 90.0, -90.0, 180.0, -180.0, 0.0, 0.0]])
    el = np.concatenate([rng.uniform(-90, 90, 100),
                         [0.0, 0.0, 0.0, 0.0, 0.0, 90.0, -90.0]])
    ref = jdvf.doa_to_ipsi_interaural(az, el)
    got = tdvf.doa_to_ipsi_interaural(torch.from_numpy(az),
                                      torch.from_numpy(el))
    for a, b in zip(ref, got):
        assert tuple(b.shape) == (107, 2)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-9)
    az32, el32 = az.astype(np.float32), el.astype(np.float32)
    ref = jdvf.doa_to_ipsi_interaural(jnp.asarray(az32), jnp.asarray(el32))
    got = tdvf.doa_to_ipsi_interaural(torch.from_numpy(az32),
                                      torch.from_numpy(el32))
    for a, b in zip(ref, got):      # degrees, float32 acos near ±1
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-3)


def test_dvf_table_is_cached_per_device_and_dtype():
    a = tdvf._table(torch.device("cpu"), torch.float32)
    assert a is tdvf._table(torch.device("cpu"), torch.float32)
    assert tuple(a.shape) == (13, 19) and a.dtype == torch.float32
    assert tdvf._table(torch.device("cpu"), torch.float64).dtype \
        == torch.float64
    np.testing.assert_array_equal(
        tdvf._table(torch.device("cpu"), torch.float64).numpy(),
        np.stack([jdvf._P11, jdvf._P21, jdvf._Q11, jdvf._Q21, jdvf._P12,
                  jdvf._P22, jdvf._Q12, jdvf._Q22, jdvf._P13, jdvf._P23,
                  jdvf._P33, jdvf._Q13, jdvf._Q23]))


# -- HRIR processing ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _hrir_subset():
    h, d, fs = thrir.default_hrirs()
    return h[::40].copy(), d[::40].copy(), fs


@pytest.mark.parametrize("fs_in,fs_out,pad", [
    (44100, 48000, False), (48000, 44100, False), (48000, 96000, True),
    (48000, 16000, False), (48000, 48000, False)])
def test_resample_hrirs_vs_jax(fs_in, fs_out, pad):
    """44.1 → 48 kHz and back (interpolated table), a direct table with
    the power-of-two pad, heavy downsampling, and the identity."""
    h, _, _ = _hrir_subset()
    got, n = thrir.resample_hrirs(h, fs_in, fs_out, pad_to_next_pow2=pad)
    ref, n_ref = jhrir.resample_hrirs(h, fs_in, fs_out, pad_to_next_pow2=pad)
    assert n == n_ref and got.shape == ref.shape == h.shape[:2] + (n,)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tbrir.resample_hrirs(h[:2], fs_in, fs_out, pad)[0], ref[:2])


def test_speex_resampler_vs_jax():
    x = np.random.default_rng(6).standard_normal((3, 300)).astype(np.float32)
    for fs_in, fs_out, q in ((44100, 48000, 10), (48000, 32000, 5),
                             (8000, 48000, 10)):
        a = tspeex.SpeexResampler(fs_in, fs_out, quality=q)
        b = jspeex.SpeexResampler(fs_in, fs_out, quality=q)
        n = int(np.ceil(300 * fs_out / fs_in))
        np.testing.assert_array_equal(a.resample(x, n), b.resample(x, n))
        assert a.output_latency == b.output_latency


@pytest.mark.parametrize("fft_size", [128, 256, 512])
def test_hrirs_to_hrtfs_vs_jax(fft_size):
    h, _, _ = _hrir_subset()
    got = thrir.hrirs_to_hrtfs(h, fft_size)
    assert got.shape == (fft_size // 2 + 1, 2, len(h))
    assert got.dtype == np.complex64
    np.testing.assert_array_equal(got, jhrir.hrirs_to_hrtfs(h, fft_size))
    assert tbrir.hrirs_to_hrtfs is thrir.hrirs_to_hrtfs


def test_binaural_diffuse_coherence_vs_jax():
    h, _, fs = _hrir_subset()
    H = thrir.hrirs_to_hrtfs(h, 256)
    itds = thrir.estimate_itds(h, fs)
    f = np.arange(129) * fs / 256.0
    got = thrir.binaural_diffuse_coherence(H, itds, f)
    np.testing.assert_array_equal(
        got, jhrir.binaural_diffuse_coherence(H, itds, f))
    assert got[0] == 1.0 and (got >= 0).all() and got.dtype == np.float32


def test_brir_module_reexports_hrir():
    assert tbrir.__all__ == jbrir.__all__
    for name in tbrir.__all__:
        assert getattr(tbrir, name) is getattr(thrir, name)


# -- binaural decoders ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _hrtf_set():
    """A seeded complex HRTF set on a third of the default grid (279
    directions, 20 bands) with Voronoi-like weights summing to 4π."""
    _, dirs, _ = thrir.default_hrirs()
    dirs = dirs[::3]
    rng = np.random.default_rng(7)
    H = (rng.standard_normal((20, 2, len(dirs)))
         + 1j * rng.standard_normal((20, 2, len(dirs)))).astype(np.complex64)
    w = rng.uniform(0.5, 1.5, len(dirs))
    return H, dirs, w * (4.0 * np.pi / w.sum())


@pytest.mark.parametrize("order", [1, 3, 5])
@pytest.mark.parametrize("weighted", [False, True])
def test_get_bin_decoder_spr_vs_jax(order, weighted):
    H, dirs, w = _hrtf_set()
    w = w if weighted else None
    got = thoa.get_bin_decoder_spr(H, dirs, order, w)
    ref = jhoa.get_bin_decoder_spr(H, dirs, order, w)
    assert got.shape == (20, 2, (order + 1) ** 2)
    assert got.dtype == np.complex64
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_get_bin_decoder_spr_raises_on_a_sparse_grid():
    H, dirs, _ = _hrtf_set()
    with pytest.raises(ValueError, match="modal order"):
        thoa.get_bin_decoder_spr(H[:, :, :9], dirs[:9], 3)


@pytest.mark.parametrize("method", ["ls", "magls"])
def test_apply_diff_cov_matching_vs_jax(method):
    H, dirs, w = _hrtf_set()
    f = np.linspace(0, 24e3, 20)
    dec = jhoa.get_binaural_ambi_decoder_mtx(H, dirs, method, 2,
                                             freq_vector=f, weights=w)
    got = thoa.apply_diff_cov_matching(H, dirs, 2, dec, w)
    ref = jhoa.apply_diff_cov_matching(H, dirs, 2, dec, w)
    assert got.shape == dec.shape and got.dtype == np.complex64
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    np.testing.assert_array_equal(got[-1], dec[-1])      # Nyquist skipped
    assert np.abs(got[:-1] - dec[:-1]).max() > 1e-3
    # through the dispatch, with max-rE on top
    kw = dict(freq_vector=f, weights=w, enable_diff_cov_matching=True,
              enable_max_re_weighting=True)
    a = thoa.get_binaural_ambi_decoder_mtx(H, dirs, method, 2, **kw)
    b = jhoa.get_binaural_ambi_decoder_mtx(H, dirs, method, 2, **kw)
    assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


@pytest.mark.parametrize("kw", [
    dict(method="spr"), dict(method="spr", enable_diff_cov_matching=True),
    dict(method="magls", enable_diff_cov_matching=True)],
    ids=["spr", "spr+diffcov", "magls+diffcov"])
def test_ambi_bin_design_ri_spr_and_diff_cov_vs_jax(kw):
    """What raised NotImplementedError before: the designs now match the
    JAX package's decode matrices."""
    ref = jab.design_ri(jab.AmbiBinConfig(order=2, **kw))
    got = tab.design_ri(tab.AmbiBinConfig(order=2, **kw), device="cpu")
    for a, b in zip(ref, got):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape == (133, 2, 9)
        assert np.abs(a - b.numpy()).max() <= 1e-5 * max(1.0, np.abs(a).max())


def test_binauraliser_design_at_another_hrir_rate_vs_jax():
    """An HRIR set at 44.1 kHz under a 48 kHz configuration: the design
    resamples it (it raised before).  Bands above 21 kHz lie in the
    resampler's transition and stop band: their coefficients are float32 noise of the
    filterbank analysis, which the diffuse-field EQ amplifies (its floor is
    1e-5 in energy), so there the two packages agree to 1e-3 only."""
    h, d, _ = thrir.default_hrirs()
    h, d = h[::8], d[::8]
    ref = jbin.design_ri(jbin.BinauraliserConfig(), h, d, 44100)
    got = tbin.design_ri(tbin.BinauraliserConfig(), h, d, 44100,
                         device="cpu")
    for name, a, b in zip(got._fields, ref, got):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, name
        peak = max(1.0, float(np.abs(a).max()))
        err = np.abs(a - b.numpy())
        if name.startswith("hrtf"):
            passband = np.asarray(ref.freqs) < 21000.0
            assert err[passband].max() <= 2e-6 * peak, name
            assert err[~passband].max() <= 1e-3 * peak, name
        else:
            assert err.max() <= 1e-6 * peak, name
