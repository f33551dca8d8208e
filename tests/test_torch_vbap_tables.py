"""The VBAP grid tables the binauraliser interpolates with, and the host
HRTF interpolation, in the PyTorch port vs the JAX package (CPU): the
regular azimuth/elevation gain table, its compression to three
amplitude-normalised gains per row, the dense interpolation form, and
``hrir.interp_hrtfs`` (complex and magnitude/ITD)."""
import numpy as np
import pytest

from spatial_audio_framework_tpu.modules import hrir as jhrir
from spatial_audio_framework_tpu.modules import vbap as jvbap
from spatial_audio_framework_tpu.utils import convhull3d as jch
from spatial_audio_framework_tpu_torch.modules import hrir as thrir
from spatial_audio_framework_tpu_torch.modules import vbap as tvbap
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT
from spatial_audio_framework_tpu_torch.utils import convhull3d as tch
from spatial_audio_framework_tpu_torch.utils import presets as tpre

TOL = 1e-6   # gains and weights: host numpy on both sides


def _hrir_grid(step=1):
    return np.asarray(thrir.default_hrirs()[1][::step], np.float64)


# (layout, az_res, el_res, options): the binauraliser's own table (the
# HRIR grid at 2° x 5°, large triangles omitted), and loudspeaker layouts
# with dummies and spread
_TABLES = {
    "hrir_grid_2x5": (lambda: _hrir_grid(), 2, 5,
                      dict(omit_large_triangles=True)),
    "hrir_subset_10x10": (lambda: _hrir_grid(3), 10, 10, {}),
    "22.x_5x5_spread": (lambda: tpre.loudspeaker_preset("22.x"), 5, 5,
                        dict(spread=15.0)),
    "5.x_6x6_dummies": (lambda: tpre.loudspeaker_preset("5.x"), 6, 6,
                        dict(enable_dummies=True)),
}


@pytest.fixture(scope="module", params=list(_TABLES))
def tables(request):
    layout, az, el, kw = _TABLES[request.param]
    ls = layout()
    tg = tvbap.generate_vbap_gain_table_3d(
        ls, az, el, rand_stream=tch.glibc_rand(), **kw)
    jg = jvbap.generate_vbap_gain_table_3d(
        ls, az, el, rand_stream=jch.glibc_rand(), **kw)
    return ls, az, el, tg, jg


def test_gain_table_vs_jax(tables):
    ls, az, el, tg, jg = tables
    n_rows = int(360 / az + 1.5) * int(180 / el + 1.5)
    assert tg.shape == jg.shape == (n_rows, ls.shape[0])
    assert np.abs(tg - jg).max() <= TOL


def test_compressed_table_vs_jax(tables):
    """Exact indices, weights within 1e-6; rows sum to 1 where non-empty."""
    *_, tg, jg = tables
    tw, ti = tvbap.compress_vbap_gain_table_3d(tg)
    jw, ji = jvbap.compress_vbap_gain_table_3d(jg)
    assert tw.dtype == np.float32 and ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    assert np.abs(tw - jw).max() <= TOL
    sums = tw.sum(-1)
    assert np.all((np.abs(sums - 1.0) <= 1e-6) | (sums == 0.0))


def test_interp_table_vs_jax(tables):
    *_, tg, jg = tables
    t = tvbap.vbap_gain_table_to_interp_table(tg)
    j = jvbap.vbap_gain_table_to_interp_table(jg)
    assert t.dtype == np.float32
    assert np.abs(t - j).max() <= TOL


def test_gain_table_shares_the_rand_stream():
    """The triangulation draws from the caller's glibc rand() stream: after
    one table both streams stand at the same place."""
    ls = tpre.loudspeaker_preset("22.x")
    ts, js = tch.glibc_rand(), jch.glibc_rand()
    tvbap.generate_vbap_gain_table_3d(ls, 20, 20, rand_stream=ts)
    jvbap.generate_vbap_gain_table_3d(ls, 20, 20, rand_stream=js)
    assert [next(ts) for _ in range(5)] == [next(js) for _ in range(5)]


@pytest.mark.parametrize("phase", ["complex", "itd"])
def test_interp_hrtfs_vs_jax(phase):
    """saf_hrir interpHRTFs on a subset of the default set's filterbank
    HRTFs at 2° x 5° grid directions: complex interpolation, or
    magnitudes and ITDs with the phase re-synthesised in the C's f32."""
    hrirs, dirs, fs = thrir.default_hrirs()
    sub = slice(0, None, 6)
    H = thrir.hrirs_to_hrtfs_afstft(hrirs[sub], 128)
    g = tvbap.generate_vbap_gain_table_3d(np.asarray(dirs[sub], np.float64),
                                          30, 30, omit_large_triangles=True)
    T = tvbap.vbap_gain_table_to_interp_table(g)
    kw = {}
    if phase == "itd":
        kw = dict(itds=thrir.estimate_itds(hrirs[sub], fs),
                  freq_vector=AfSTFT().centre_freqs(float(fs)))
    got = thrir.interp_hrtfs(H, T, **kw)
    ref = jhrir.interp_hrtfs(H, T, **kw)
    assert got.dtype == np.complex64 and got.shape == (133, 2, T.shape[0])
    assert np.abs(got - ref).max() <= TOL
