"""ambi_dec and its design stack in the port vs the JAX package on the CPU:
presets, the glibc rand() stream, the convhull_3d triangulation, 3-D VBAP
gain tables, the loudspeaker decoders folded into design_ri, and the
batched render at order 3 → the 22.x layout (cout·cin = 352 > 128: the
analysis → einsum → synthesis path)."""
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
    cfg = tdec.AmbiDecConfig(master_order=3, binauralise_ls=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdec.design_ri(cfg, tpre.loudspeaker_preset("22.x"), device="cpu")


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
