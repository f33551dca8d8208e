"""array2sh and the host modules under it in the PyTorch port vs the JAX
reference and the compiled C goldens (CPU): Bessel and Hankel functions,
modal coefficients, array simulators and SHT metrics, the four encoding
filter designs on spherical and cylindrical arrays, the batched render on
both routes and the single-stream complex ``process``.

Tolerances: 1e-12 relative where both sides run the same float64 numpy and
scipy; 1e-4 against C (``tests/test_c_goldens.py``'s limits, 2e-4 relative
for the filters); renders 1e-5 of the largest output on the plain paths and
2e-4 against the JAX Pallas route (its default bf16 f32x3 matmul mode)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import array2sh as ja2s
from spatial_audio_framework_tpu.modules import array_proc as jap
from spatial_audio_framework_tpu.utils import bessel as jbes
from spatial_audio_framework_tpu_torch.models import array2sh as ta2s
from spatial_audio_framework_tpu_torch.modules import array_proc as tap
from spatial_audio_framework_tpu_torch.utils import bessel as tbes
from spatial_audio_framework_tpu_torch.utils import presets as tpre

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "c_goldens.npz")
TOL_C = 1e-4
TOL = 1e-5
HIGH_TOL = 2e-4
FILTERS = [ta2s.FILTER_SOFT_LIM, ta2s.FILTER_TIKHONOV, ta2s.FILTER_Z_STYLE,
           ta2s.FILTER_Z_STYLE_MAXRE]


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDENS)


def _same(a, b):
    """Both packages' host results: tuples of arrays, or arrays."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    ok = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), ok)
    assert np.abs(a[ok] - b[ok]).max(initial=0.0) <= 1e-12 * max(
        1.0, np.abs(b[ok]).max(initial=0.0))


_BESSEL = [n for n in dir(jbes) if not n.startswith("_")
           and callable(getattr(jbes, n)) and n not in ("annotations",)
           and getattr(getattr(jbes, n), "__module__", "") == jbes.__name__]


@pytest.mark.parametrize("name", _BESSEL)
def test_bessel_vs_jax(name):
    """Every public function of utils/bessel, orders 0..5 on a grid that
    includes 0 (the reference's special case) and large arguments."""
    z = np.array([0.0, 1e-3, 0.5, 1.0, 3.7, 12.0, 40.0])
    assert hasattr(tbes, name)
    _same(getattr(tbes, name)(5, z), getattr(jbes, name)(5, z))


def test_bessel_module_lists_the_same_functions():
    mine = [n for n in dir(tbes) if not n.startswith("_")
            and getattr(getattr(tbes, n), "__module__", "") == tbes.__name__]
    assert mine == _BESSEL and len(_BESSEL) >= 8


def test_sph_modal_coeffs_vs_c_and_jax(g):
    kr = np.asarray(g["ap_kr"], np.float64)
    kR = 0.8 * kr
    cases = [
        ("ap_modal_rigid", "sph_modal_coeffs", (3, kr, tap.ARRAY_RIGID, 1.0)),
        ("ap_modal_open", "sph_modal_coeffs", (3, kr, tap.ARRAY_OPEN, 1.0)),
        ("ap_modal_open_card", "sph_modal_coeffs",
         (3, kr, tap.ARRAY_OPEN_DIRECTIONAL, 0.5)),
        ("ap_modal_scatterer", "sph_scatterer_modal_coeffs", (3, kr, kR)),
        ("ap_modal_scatterer_dir", "sph_scatterer_dir_modal_coeffs",
         (3, kr, kR, 0.5)),
    ]
    for key, fn, args in cases:
        mine = getattr(tap, fn)(*args)
        assert np.abs(mine - g[key]).max() <= TOL_C, key
        _same(mine, getattr(jap, fn)(*args))


def test_cyl_modal_coeffs_and_simulator_vs_c_and_jax(g):
    """Includes the reference's hankel_Hn2_ALL n = 0 derivative quirk (rigid
    b0 = i·Y0) and the C simulator's mis-indexed sensor angle: parity on the
    diagonal, as ``tests/test_c_goldens.py`` has it."""
    kr = np.asarray(g["mu_cyl_kr"], np.float64)
    for kind, key in ((tap.ARRAY_RIGID, "mu_cyl_modal_rigid"),
                      (tap.ARRAY_OPEN, "mu_cyl_modal_open")):
        mine = tap.cyl_modal_coeffs(3, kr, kind)
        assert np.abs(mine - g[key]).max() <= TOL_C
        _same(mine, jap.cyl_modal_coeffs(3, kr, kind))
    args = (3, kr, np.asarray(g["mu_cyl_sensor_rad"], np.float64),
            np.asarray(g["mu_cyl_src_deg"], np.float64), tap.ARRAY_RIGID)
    H = tap.simulate_cyl_array(*args)
    _same(H, jap.simulate_cyl_array(*args))
    ref = np.asarray(g["mu_cyl_H"])
    for i in range(3):
        assert np.abs(H[:, i, i] - ref[:, 0, i]).max() <= TOL_C, i


def test_sph_array_analysis_vs_c_and_jax(g):
    kr = np.asarray(g["ap_kr"], np.float64)
    sens = np.asarray(g["ap_sensor_dirs_rad"], np.float64)
    dc = tap.sph_diff_coh_mtx_theory(3, sens, tap.ARRAY_RIGID, 1.0, kr)
    _same(dc, jap.sph_diff_coh_mtx_theory(3, sens, jap.ARRAY_RIGID, 1.0, kr))
    ref = np.asarray(g["ap_diffcoh_rigid"])          # (nS, nS, nBands)
    assert np.abs(dc.transpose(1, 2, 0) - ref).max() <= TOL_C * np.abs(ref).max()
    args = (3, 16, 0.042, 343.0, tap.ARRAY_RIGID, 1.0, 40.0)
    flim = tap.sph_array_noise_threshold(*args)
    _same(flim, jap.sph_array_noise_threshold(*args))
    assert np.abs(flim - g["ap_noise_flim"]).max() <= 1e-3 * flim.max()
    assert abs(tap.sph_array_alias_lim(0.042, 343.0, 3)
               - float(np.asarray(g["ap_alias_lim"]).reshape(-1)[0])) <= 1e-2


def test_simulate_sph_array_and_sht_eval_vs_c_and_jax(g):
    kr = np.asarray(g["ap_kr"], np.float64)
    sens = np.asarray(g["ap_sensor_dirs_rad"], np.float64)
    grid = tpre.tdesign(21)
    args = (3, kr, sens, grid, tap.ARRAY_RIGID, 1.0, 0.8 * kr)
    H = tap.simulate_sph_array(*args)
    _same(H, jap.simulate_sph_array(*args))
    ref_H = np.asarray(g["ap_H_array"])
    assert np.abs(H - ref_H).max() <= TOL_C * np.abs(ref_H).max()
    ev = (np.asarray(g["ap_M_sht"]), ref_H, np.asarray(g["ap_Ygrid_cmplx"]))
    cSH, lSH = tap.evaluate_sht_filters(*ev)
    _same((cSH, lSH), jap.evaluate_sht_filters(*ev))
    assert np.abs(cSH - g["ap_eval_csh"]).max() <= TOL_C
    assert np.abs(lSH - g["ap_eval_lsh"]).max() <= 1e-4 * np.abs(
        np.asarray(g["ap_eval_lsh"])).max()


# -- the encoder ---------------------------------------------------------------

def _em32_deg():
    return np.degrees(tpre.mic_preset("eigenmike32"))


@pytest.mark.parametrize("ftype,key", zip(FILTERS, [
    "a2s_W_softlim", "a2s_W_tikhonov", "a2s_W_zstyle", "a2s_W_zstylemaxre"]))
def test_encoding_filters_vs_c(g, ftype, key):
    """Eigenmike32, order 4, N3D, diffuse-field EQ past aliasing on (the C's
    default).  Band 0 is excluded: the C's modal coefficients at kr = 0 are
    ill defined.  2e-4 relative, as ``tests/test_c_goldens.py``."""
    cfg = ta2s.Array2SHConfig(order=4, filter_type=ftype, r=0.042, R=0.042,
                              norm="n3d")
    w = ta2s.design(cfg, _em32_deg(), device="cpu")
    assert w.W.dtype == torch.complex64 and w.W.shape == (133, 25, 32)
    ref = np.asarray(g[key])
    assert np.abs(w.W.numpy()[1:] - ref[1:]).max() <= 2e-4 * max(
        1.0, np.abs(ref).max())


_ARRAYS = {
    "em32": dict(),
    "cylinder": dict(array_type=ta2s.ARRAY_CYLINDRICAL),
    "open_card": dict(weight_type=ta2s.WEIGHT_OPEN_CARD),
    "open_omni_fuma": dict(weight_type=ta2s.WEIGHT_OPEN_OMNI, order=1,
                           ch_ordering="fuma", norm="fuma", gain_db=-6.0),
    "scatterer": dict(R=0.03, diff_eq_past_aliasing=False),
    "scatterer_card": dict(R=0.03, weight_type=ta2s.WEIGHT_RIGID_CARD,
                           reg_par_db=20.0),
}


@pytest.mark.parametrize("ftype", FILTERS)
@pytest.mark.parametrize("array", list(_ARRAYS))
def test_design_vs_jax(array, ftype):
    """design_ri and design against the JAX package: the same host numpy,
    so to float32 rounding of the same float64 matrices."""
    kw = dict(order=3, filter_type=ftype)
    kw.update(_ARRAYS[array])
    jW = ja2s.design_ri(ja2s.Array2SHConfig(**kw), _em32_deg())
    tcfg = ta2s.Array2SHConfig(**kw)
    tW = ta2s.design_ri(tcfg, _em32_deg(), device="cpu")
    scale = max(1.0, float(np.abs(jW[0]).max()), float(np.abs(jW[1]).max()))
    for a, b in zip(jW, tW):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
        assert b.shape == (133, tcfg.nsh, 32)
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-6 * scale
    wc = ta2s.design(tcfg, _em32_deg(), device="cpu")
    assert torch.equal(wc.W.real, tW[0]) and torch.equal(wc.W.imag, tW[1])


def test_design_warns_on_radians():
    with pytest.warns(UserWarning, match="RADIANS"):
        ta2s.design_ri(ta2s.Array2SHConfig(order=1),
                       tpre.mic_preset("eigenmike32"), device="cpu")


@pytest.mark.parametrize("order,fused", [(1, True), (1, False), (2, True),
                                         (2, False)])
def test_process_ri_batched_vs_jax(order, fused):
    """Eigenmike32 → order 1 (nSH·Q = 128: the decode kernels' route with a
    complex matrix) and order 2 (288 > 128: analysis → einsum → synthesis
    on the filterbank kernels), 2 streams, three chained chunks.  fused is
    the kernel route (here the kernels' plain versions) against the JAX
    Pallas route in interpret mode; unfused the plain path against JAX's."""
    jcfg = ja2s.Array2SHConfig(order=order)
    tcfg = ta2s.Array2SHConfig(order=order)
    jW = ja2s.design_ri(jcfg, _em32_deg())
    tW = ta2s.weights_from_numpy(np.asarray(jW[0]), np.asarray(jW[1]), "cpu")
    jst = ja2s.init_state_batched(jcfg, 2, 32)
    tst = ta2s.init_state_batched(tcfg, 2, 32, device="cpu")
    rng = np.random.default_rng(order)
    tol, peak = (HIGH_TOL if fused else TOL), 1e-30
    for i, H in enumerate((16, 8, 2)):
        x = rng.uniform(-1, 1, (2, 32, H * 128)).astype(np.float32)
        if i == 1:
            tst = ta2s.state_from_numpy(np.asarray(jst.in_tail),
                                        np.asarray(jst.ola_tail), "cpu")
        jy, jst = ja2s.process_ri_batched(jcfg, jW, jst, jnp.asarray(x),
                                          use_pallas=fused, interpret=True)
        ty, tst = ta2s.process_ri_batched(tcfg, tW, tst, torch.from_numpy(x),
                                          fused=fused)
        assert ty.shape == (2, tcfg.nsh, H * 128)
        peak = max(peak, float(np.abs(jy).max()))
        assert np.abs(np.asarray(jy) - ty.numpy()).max() <= tol * peak
    assert np.abs(np.asarray(jst.ola_tail)
                  - tst.ola_tail.numpy()).max() <= tol * peak
    np.testing.assert_array_equal(np.asarray(jst.in_tail),
                                  tst.in_tail.numpy())


def test_fused_route_equals_plain_route():
    """Order 4 (the width the card runs: 25·32 = 800 channel pairs), one
    stream: the kernel route's plain versions against the plain path."""
    cfg = ta2s.Array2SHConfig(order=4)
    W = ta2s.design_ri(cfg, _em32_deg(), device="cpu")
    rng = np.random.default_rng(4)
    sts = [ta2s.init_state_batched(cfg, 1, 32, device="cpu")] * 2
    for H in (4, 1):
        x = torch.from_numpy(rng.uniform(-1, 1, (1, 32, H * 128)).astype(
            np.float32))
        ys = []
        for k, fused in enumerate((True, False)):
            y, sts[k] = ta2s.process_ri_batched(cfg, W, sts[k], x,
                                                fused=fused)
            ys.append(y)
        assert (ys[0] - ys[1]).abs().max() <= 2e-5 * max(
            1.0, float(ys[1].abs().max()))


def test_process_complex_vs_jax():
    """The single-stream path over four blocks, the JAX state handed across
    at a block boundary."""
    jcfg = ja2s.Array2SHConfig(order=2, filter_type=ja2s.FILTER_SOFT_LIM)
    tcfg = ta2s.Array2SHConfig(order=2, filter_type=ta2s.FILTER_SOFT_LIM)
    jw = ja2s.design(jcfg, _em32_deg())
    W = np.asarray(jw.W)
    tw = ta2s.weights_complex_from_numpy(W.real, W.imag, "cpu")
    js = ja2s.init_state(jcfg, 32)
    ts = ta2s.init_state(tcfg, 32, device="cpu")
    rng = np.random.default_rng(6)
    peak = 1e-30
    for i, H in enumerate((16, 1, 2, 3)):
        x = rng.uniform(-1, 1, (32, H * 128)).astype(np.float32)
        if i == 2:
            hyb = np.asarray(js.hyb_tail)
            ts = ta2s.state_complex_from_numpy(
                np.asarray(js.in_tail), hyb.real, hyb.imag,
                np.asarray(js.ola_tail), "cpu")
        jy, js = ja2s.process(jcfg, jw, js, jnp.asarray(x))
        ty, ts = ta2s.process(tcfg, tw, ts, torch.from_numpy(x))
        assert ty.shape == (9, H * 128)
        peak = max(peak, float(np.abs(jy).max()))
        assert np.abs(np.asarray(jy) - ty.numpy()).max() <= TOL * peak


@pytest.mark.parametrize("conv", [("acn", "n3d"), ("fuma", "fuma")])
def test_evaluate_filters_vs_jax(conv):
    kw = dict(order=2 if conv[0] == "acn" else 1, ch_ordering=conv[0],
              norm=conv[1], gain_db=3.0)
    jw = ja2s.design(ja2s.Array2SHConfig(**kw), _em32_deg())
    tw = ta2s.design(ta2s.Array2SHConfig(**kw), _em32_deg(), device="cpu")
    ref = ja2s.evaluate_filters(ja2s.Array2SHConfig(**kw), jw, _em32_deg())
    got = ta2s.evaluate_filters(ta2s.Array2SHConfig(**kw), tw, _em32_deg())
    for a, b in zip(ref, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(a).max())
