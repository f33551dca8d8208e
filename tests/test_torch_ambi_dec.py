"""ambi_dec and its design stack in the port vs the JAX package on the CPU:
presets, the glibc rand() stream, the convhull_3d triangulation, 3-D VBAP
gain tables, the loudspeaker decoders folded into design_ri, and the
batched render at order 3 → the 22.x layout (cout·cin = 352 > 128: the
analysis → einsum → synthesis path)."""
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import ambi_dec as jdec
from spatial_audio_framework_tpu.modules import vbap as jvbap
from spatial_audio_framework_tpu.utils import convhull3d as jch
from spatial_audio_framework_tpu.utils import presets as jpre
from spatial_audio_framework_tpu_torch.models import ambi_dec as tdec
from spatial_audio_framework_tpu_torch.modules import vbap as tvbap
from spatial_audio_framework_tpu_torch.utils import convhull3d as tch
from spatial_audio_framework_tpu_torch.utils import presets as tpre

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "c_goldens.npz")
DESIGN_TOL = 1e-6   # host numpy on both sides: identical arithmetic
TOL = 1e-5          # time-domain outputs, fp32 on both sides
HIGH_TOL = 2e-4     # vs the JAX Pallas route's bf16 f32x3 default mode


def _golden_ls():
    return np.asarray(np.load(GOLDENS)["dec_e2e_ls_dirs"], np.float64)


def _layout(name):
    return _golden_ls() if name == "golden9" else tpre.loudspeaker_preset(name)


def test_presets_vs_jax():
    np.testing.assert_array_equal(tpre.tdesign(100), jpre.tdesign(100))
    np.testing.assert_array_equal(tpre.tdesign(30), jpre.tdesign(30))
    np.testing.assert_array_equal(tpre.loudspeaker_preset("22.x"),
                                  jpre.loudspeaker_preset("22.x"))
    assert tpre.loudspeaker_preset("22.x").shape == (22, 2)
    assert tpre.tdesign(100).shape == (5100, 2)
    assert tpre.loudspeaker_preset_names() == jpre.loudspeaker_preset_names()
    assert tpre.tdesign_n_points(7) == jpre.tdesign_n_points(7)


def test_glibc_rand_stream_vs_jax():
    a, b = tch.glibc_rand(), jch.glibc_rand()
    assert [next(a) for _ in range(2000)] == [next(b) for _ in range(2000)]
    a, b = tch.glibc_rand_at(17), jch.glibc_rand_at(17)
    assert [next(a) for _ in range(10)] == [next(b) for _ in range(10)]


@pytest.mark.parametrize("layout", ["22.x", "golden9"])
def test_triangulation_vs_jax(layout):
    """The C's quickhull (faces and their vertex order), two calls on one
    shared rand() stream, as ambi_dec's two AllRAD designs make them."""
    ls = _layout(layout)
    ts, js = tch.glibc_rand(), jch.glibc_rand()
    for _ in range(2):
        tv, tf = tvbap.find_ls_triplets(ls, rand_stream=ts)
        jv, jf = jvbap.find_ls_triplets(ls, rand_stream=js)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("layout,kw", [
    ("22.x", {}), ("golden9", {}), ("22.x", {"spread": 20.0}),
    ("5.x", {"enable_dummies": True}),
    ("22.x", {"omit_large_triangles": True}),
])
def test_vbap_gain_table_vs_jax(layout, kw):
    ls = _layout(layout)
    src = tpre.tdesign(100)
    tg = tvbap.generate_vbap_gain_table_3d_srcs(src, ls, **kw)
    jg = jvbap.generate_vbap_gain_table_3d_srcs(src, ls, **kw)
    assert tg.shape == (5100, ls.shape[0])
    assert np.abs(tg - jg).max() <= DESIGN_TOL


_DESIGNS = {
    "allrad_dual": dict(dec_method=("allrad", "allrad"),
                        re_weight=(False, True)),
    "sad_epad_amplitude": dict(
        dec_method=("sad", "epad"), re_weight=(False, False),
        diff_eq_mode=(tdec.AMPLITUDE_PRESERVING, tdec.AMPLITUDE_PRESERVING)),
    "mmd_order_per_band": dict(dec_method=("mmd", "mmd"),
                               re_weight=(True, True)),
    "epad_allrad_mixed_eq": dict(
        dec_method=("epad", "allrad"), re_weight=(True, False),
        diff_eq_mode=(tdec.ENERGY_PRESERVING, tdec.AMPLITUDE_PRESERVING)),
}


@pytest.mark.parametrize("layout", ["22.x", "golden9"])
@pytest.mark.parametrize("design", list(_DESIGNS))
def test_design_ri_vs_jax(design, layout):
    ls = _layout(layout)
    kw = dict(master_order=3, norm="n3d", **_DESIGNS[design])
    opb = None
    if design == "mmd_order_per_band":
        opb = np.where(np.arange(133) < 40, 1, 3)
    tw = tdec.design_ri(tdec.AmbiDecConfig(**kw), ls, opb, device="cpu")
    jw = jdec.design_ri(jdec.AmbiDecConfig(**kw), ls, opb)
    assert tw.M_im is None and jw.M_im is None
    assert tw.M_re.shape == (133, ls.shape[0], 16)
    assert np.abs(np.asarray(jw.M_re) - tw.M_re.numpy()).max() <= DESIGN_TOL


def test_design_ri_input_conversion_vs_jax():
    """FuMa ordering and normalisation folded into an order-1 decoder."""
    kw = dict(master_order=1, ch_ordering="fuma", norm="fuma")
    ls = tpre.loudspeaker_preset("22.x")
    tw = tdec.design_ri(tdec.AmbiDecConfig(**kw), ls, device="cpu")
    jw = jdec.design_ri(jdec.AmbiDecConfig(**kw), ls)
    assert np.abs(np.asarray(jw.M_re) - tw.M_re.numpy()).max() <= DESIGN_TOL


def test_binauralise_ls_is_not_ported_yet():
    """It is ported now (the test keeps its name): the headphone preview
    designs to a complex (nBands, 2, nSH) fold where it used to raise."""
    cfg = tdec.AmbiDecConfig(master_order=3, binauralise_ls=True)
    w = tdec.design_ri(cfg, tpre.loudspeaker_preset("22.x"), device="cpu")
    assert w.M_re.shape == w.M_im.shape == (133, 2, 16)
    assert float(w.M_im.abs().max()) > 0.0


@functools.lru_cache(maxsize=None)
def _preview(layout):
    """JAX designs of the binaural preview (order 1, default HRIRs): the
    batched fold and the complex pair, as numpy."""
    ls = _layout(layout)
    cfg = jdec.AmbiDecConfig(master_order=1, norm="n3d", binauralise_ls=True,
                             re_weight=(False, True))
    ri_w = jdec.design_ri(cfg, ls)
    cw = jdec.design(cfg, ls)
    return (np.asarray(ri_w.M_re), np.asarray(ri_w.M_im), np.asarray(cw.M),
            np.asarray(cw.H_bin))


@pytest.mark.parametrize("layout", ["golden9", "22.x"])
def test_binauralise_ls_design_vs_jax(layout):
    """TRI_PS at the loudspeaker directions, 1/√nLS, and one rand() stream
    through the two AllRAD hulls and then the HRTF table."""
    Mre, Mim, M, H = _preview(layout)
    ls = _layout(layout)
    cfg = tdec.AmbiDecConfig(master_order=1, norm="n3d", binauralise_ls=True,
                             re_weight=(False, True))
    w = tdec.design_ri(cfg, ls, device="cpu")
    scale = np.abs(Mre).max()
    assert np.abs(Mre - w.M_re.numpy()).max() <= 2e-6 * scale
    assert np.abs(Mim - w.M_im.numpy()).max() <= 2e-6 * scale
    cw = tdec.design(cfg, ls, device="cpu")
    assert cw.M.dtype == cw.H_bin.dtype == torch.complex64
    assert cw.H_bin.shape == (133, 2, len(ls))
    assert np.abs(M - cw.M.numpy()).max() <= DESIGN_TOL
    assert np.abs(H - cw.H_bin.numpy()).max() <= 2e-6 * np.abs(H).max()
    assert tdec.design(tdec.AmbiDecConfig(master_order=1), ls,
                       device="cpu").H_bin is None


def test_binauralise_ls_vbap_table_vs_c():
    """The compressed HRTF VBAP table inside the preview's design (all 6697
    rows) against the compiled C: the third hull on the design's rand()
    stream, after the two AllRAD triangulations.  Dense reconstructions are
    compared, as ``tests/test_c_goldens.py`` does: gains of ~1e-7 straddle
    the compression's keep-threshold."""
    from spatial_audio_framework_tpu_torch.models import binauraliser as tbin
    from spatial_audio_framework_tpu_torch.modules import hoa as thoa

    g = np.load(GOLDENS)
    ls = np.asarray(g["ad16_ls_dirs"], np.float64)
    rs = tch.glibc_rand()
    for _ in range(2):
        thoa.get_loudspeaker_decoder_mtx(ls, "allrad", 3, rand_stream=rs)
    bcfg = tbin.BinauraliserConfig(n_sources=9,
                                   interp_mode=tbin.INTERP_TRI_PS)
    _, _, comp, idx, _ = tbin._design_host(bcfg, rand_stream=rs)
    mine = np.zeros((comp.shape[0], 836), np.float32)
    ref = np.zeros_like(mine)
    rows = np.arange(comp.shape[0])[:, None]
    np.add.at(mine, (rows, np.asarray(idx, int)), np.asarray(comp))
    np.add.at(ref, (rows, np.asarray(g["adb_vbap_idx"], int)),
              np.asarray(g["adb_vbap_w"]))
    assert np.abs(mine - ref).max() <= 5e-6
    # a fresh stream at the third hull gives another table: the order matters
    _, _, comp2, idx2, _ = tbin._design_host(bcfg)
    other = np.zeros_like(mine)
    np.add.at(other, (rows, np.asarray(idx2, int)), np.asarray(comp2))
    assert np.abs(other - ref).max() > 1e-3


@pytest.mark.parametrize("fused", [True, False])
def test_binauralise_ls_batched_vs_jax(fused):
    """The fold as a complex decode, 4 SH → 2 ears, 2 streams, three chained
    chunks: the one-pass kernel's plain version vs the JAX Pallas route in
    interpret mode, and the plain path vs JAX's."""
    Mre, Mim, _, _ = _preview("golden9")
    kw = dict(master_order=1, norm="n3d", binauralise_ls=True)
    jcfg, tcfg = jdec.AmbiDecConfig(**kw), tdec.AmbiDecConfig(**kw)
    jw = jdec.AmbiDecWeightsRI(jnp.asarray(Mre), jnp.asarray(Mim))
    tw = tdec.weights_from_numpy(Mre, Mim, "cpu")
    jst = jdec.init_state_batched(jcfg, 2, 9)
    tst = tdec.init_state_batched(tcfg, 2, 9, device="cpu")
    assert tst.ola_tail.shape == (2, 2, 9 * 128)
    rng = np.random.default_rng(3)
    tol = HIGH_TOL if fused else TOL
    for H in (16, 4, 1):
        x = rng.uniform(-1, 1, (2, 4, H * 128)).astype(np.float32)
        jy, jst = jdec.process_ri_batched(jcfg, jw, jst, jnp.asarray(x),
                                          use_pallas=fused, interpret=True)
        ty, tst = tdec.process_ri_batched(tcfg, tw, tst, torch.from_numpy(x),
                                          fused=fused)
        assert ty.shape == (2, 2, H * 128)
        assert np.abs(np.asarray(jy) - ty.numpy()).max() <= tol


@pytest.mark.parametrize("preview", [False, True])
def test_process_complex_vs_jax(preview):
    """The single-stream complex path over four blocks (to loudspeakers,
    and through H_bin to two ears), the JAX state handed across."""
    _, _, M, H = _preview("golden9")
    kw = dict(master_order=1, norm="n3d", binauralise_ls=preview)
    jcfg, tcfg = jdec.AmbiDecConfig(**kw), tdec.AmbiDecConfig(**kw)
    jw = jdec.AmbiDecWeights(jnp.asarray(M),
                             jnp.asarray(H) if preview else None)
    tw = tdec.weights_complex_from_numpy(
        M.real, M.imag, *((H.real, H.imag) if preview else ()), device="cpu")
    js = jdec.init_state(jcfg, 9)
    ts = tdec.init_state(tcfg, 9, device="cpu")
    n_out = 2 if preview else 9
    rng = np.random.default_rng(5)
    peak = 1e-30
    for i, H_ in enumerate((16, 1, 2, 3)):
        x = rng.uniform(-1, 1, (4, H_ * 128)).astype(np.float32)
        if i == 2:
            hyb = np.asarray(js.hyb_tail)
            ts = tdec.state_complex_from_numpy(
                np.asarray(js.in_tail), hyb.real, hyb.imag,
                np.asarray(js.ola_tail), "cpu")
        jy, js = jdec.process(jcfg, jw, js, jnp.asarray(x))
        ty, ts = tdec.process(tcfg, tw, ts, torch.from_numpy(x))
        assert ty.shape == (n_out, H_ * 128)
        peak = max(peak, float(np.abs(jy).max()))
        assert np.abs(np.asarray(jy) - ty.numpy()).max() <= TOL * peak


@pytest.fixture(scope="module")
def slice22():
    """The slice's configuration: order 3 → 22.x, defaults otherwise."""
    ls = tpre.loudspeaker_preset("22.x")
    jcfg = jdec.AmbiDecConfig(master_order=3)
    tcfg = tdec.AmbiDecConfig(master_order=3)
    jw = jdec.design_ri(jcfg, ls)
    tw = tdec.weights_from_numpy(np.asarray(jw.M_re), device="cpu")
    return jcfg, tcfg, jw, tw


def _inputs(rng, n_blocks, S=2, H=16):
    return [rng.uniform(-1, 1, (S, 16, H * 128)).astype(np.float32)
            for _ in range(n_blocks)]


@pytest.mark.parametrize("fused", [True, False])
def test_process_ri_batched_vs_jax(slice22, fused):
    """S = 2, H = 16, two chained blocks.  fused=True is the kernel route
    (on the CPU: the kernels' plain versions) vs the JAX Pallas route in
    interpret mode; fused=False the plain path vs the JAX XLA path."""
    jcfg, tcfg, jw, tw = slice22
    rng = np.random.default_rng(0)
    jst = jdec.init_state_batched(jcfg, 2, 22)
    tst = tdec.init_state_batched(tcfg, 2, 22, device="cpu")
    tol = HIGH_TOL if fused else TOL
    for x in _inputs(rng, 2):
        jy, jst = jdec.process_ri_batched(jcfg, jw, jst, jnp.asarray(x),
                                          use_pallas=fused, interpret=True)
        ty, tst = tdec.process_ri_batched(tcfg, tw, tst, torch.from_numpy(x),
                                          fused=fused)
        assert ty.shape == (2, 22, 16 * 128)
        assert np.abs(np.asarray(jy) - ty.numpy()).max() <= tol
    assert np.abs(np.asarray(jst.ola_tail) - tst.ola_tail.numpy()).max() <= tol
    np.testing.assert_array_equal(np.asarray(jst.in_tail), tst.in_tail.numpy())


def test_process_ri_batched_block_split(slice22):
    """Four 2-hop blocks (shorter than both tails) give the same output and
    state as one 8-hop block."""
    _, cfg, _, w = slice22
    x = torch.from_numpy(_inputs(np.random.default_rng(1), 1, H=8)[0])
    st1 = tdec.state_from_numpy(
        np.random.default_rng(2).uniform(-1, 1, (2, 16, 15 * 128)),
        np.random.default_rng(3).uniform(-1, 1, (2, 22, 9 * 128)), "cpu")
    y1, s1 = tdec.process_ri_batched(cfg, w, st1, x)
    st, ys = st1, []
    for i in range(4):
        y, st = tdec.process_ri_batched(cfg, w, st,
                                        x[..., i * 256:(i + 1) * 256])
        ys.append(y)
    assert (torch.cat(ys, dim=-1) - y1).abs().max().item() <= TOL
    assert (st.ola_tail - s1.ola_tail).abs().max().item() <= TOL
    assert torch.equal(st.in_tail, s1.in_tail)
