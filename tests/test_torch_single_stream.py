"""The single-stream entry points of the PyTorch port vs the JAX reference
(CPU): ``analysis_ri`` / ``synthesis_ri`` with the carried hybrid history,
the head-tracked ``ambi_bin.process`` / ``process_ri`` (the SH rotation
built per block from ``ypr``), and the complex ``design`` / ``init_state``
/ ``process`` of binauraliser, binauraliser_nf, roombinauraliser and
panner.  Every run carries its state over several blocks and takes the JAX
package's state across at a block boundary (``state_*_from_numpy``), so a
mismatch in the state layout shows; the same numpy inputs from a seed go
through both packages.  None of these paths reaches a Pallas kernel.

Tolerance: 1e-5 of the largest output (float32 on both sides; only the
order of sums differs)."""
import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import ambi_bin as jab
from spatial_audio_framework_tpu.models import binauraliser as jbin
from spatial_audio_framework_tpu.models import binauraliser_nf as jnf
from spatial_audio_framework_tpu.models import panner as jpan
from spatial_audio_framework_tpu.models import roombinauraliser as jrb
from spatial_audio_framework_tpu.ops import afstft_ri as jri
from spatial_audio_framework_tpu.ops.afstft import AfSTFT as JAfSTFT
from spatial_audio_framework_tpu_torch.models import ambi_bin as tab
from spatial_audio_framework_tpu_torch.models import binauraliser as tbin
from spatial_audio_framework_tpu_torch.models import binauraliser_nf as tnf
from spatial_audio_framework_tpu_torch.models import panner as tpan
from spatial_audio_framework_tpu_torch.models import roombinauraliser as trb
from spatial_audio_framework_tpu_torch.modules import hrir as thrir
from spatial_audio_framework_tpu_torch.modules import sh as tsh
from spatial_audio_framework_tpu_torch.ops import afstft_ri as tri
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT as TAfSTFT
from spatial_audio_framework_tpu_torch.utils import geometry as tgeo

TOL = 1e-5
# hops per block: H = 32 first, so that the run's largest output (the scale
# of the tolerance) is known before the short blocks, then H = 1, 2 and 3
BLOCKS = (32, 1, 2, 3)


def _T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class _Run:
    """Holds a run's largest reference output so far: a block's error is
    judged against it (a 128-sample block inside the filterbank's latency
    holds only leakage of 1e-11)."""

    def __init__(self):
        self.peak = 1e-30

    def rel(self, ref, got):
        ref = np.asarray(ref)
        assert ref.shape == tuple(got.shape)
        self.peak = max(self.peak, float(np.abs(ref).max()))
        return np.abs(ref - got.numpy()).max() / self.peak


def _complex_state(js):
    """The JAX complex AfSTFTState as the numpy parts the port takes."""
    hyb = np.asarray(js.hyb_tail)
    return (np.asarray(js.in_tail), hyb.real, hyb.imag,
            np.asarray(js.ola_tail))


# -- the filterbank -----------------------------------------------------------

@pytest.mark.parametrize("hybrid", [True, False])
@pytest.mark.parametrize("low_delay", [False, True])
def test_analysis_synthesis_ri_vs_jax(hybrid, low_delay):
    """Blocks of H = 32, 1, 2 and 3 hops with the state carried: spectra,
    resynthesis and every state field, then the JAX state handed across."""
    jbank = JAfSTFT(hop=128, hybrid=hybrid, low_delay=low_delay)
    tbank = TAfSTFT(hop=128, hybrid=hybrid, low_delay=low_delay)
    rng = np.random.default_rng(int(hybrid) * 2 + int(low_delay))
    js = jri.init_state_ri(jbank, 3, 3)
    ts = tri.init_state_ri(tbank, 3, 3, device="cpu")
    assert ts.in_tail.shape == (3, 9 * 128)
    assert ts.hyb_tail_re.shape == ts.hyb_tail_im.shape == (3, 6, 129)
    assert ts.ola_tail.shape == (3, 9 * 128)
    run = _Run()
    for i, H in enumerate(BLOCKS):
        x = rng.uniform(-1, 1, (3, H * 128)).astype(np.float32)
        if i == 2:
            ts = tri.state_ri_from_numpy(*(np.asarray(a) for a in js), "cpu")
        (jre, jim), js = jri.analysis_ri(jbank, js, jnp.asarray(x))
        (tre, tim), ts = tri.analysis_ri(tbank, ts, _T(x))
        assert tre.shape == (tbank.n_bands, 3, H)
        scale = max(np.abs(jre).max(), np.abs(jim).max())
        assert np.abs(np.asarray(jre) - tre.numpy()).max() <= TOL * scale
        assert np.abs(np.asarray(jim) - tim.numpy()).max() <= TOL * scale
        jy, js = jri.synthesis_ri(jbank, js, (jre, jim))
        ty, ts = tri.synthesis_ri(tbank, ts, (tre, tim))
        assert run.rel(jy, ty) <= TOL
        for name, a, b in zip(js._fields, js, ts):
            a = np.asarray(a)
            assert tuple(b.shape) == a.shape, name
            assert np.abs(a - b.numpy()).max() <= TOL * max(
                1.0, np.abs(a).max()), name


def test_analysis_ri_equals_the_complex_bank():
    """The (re, im) pair is the complex AfSTFT's spectrum, state for state."""
    bank = TAfSTFT(hop=128, hybrid=True)
    rng = np.random.default_rng(9)
    sr = tri.init_state_ri(bank, 2, 2, device="cpu")
    sc = bank.init_state(2, 2, device="cpu")
    for H in (2, 1, 8):
        x = _T(rng.uniform(-1, 1, (2, H * 128)).astype(np.float32))
        (re, im), sr = tri.analysis_ri(bank, sr, x)
        spec, sc = bank.analysis(sc, x)
        assert (torch.complex(re, im) - spec).abs().max() <= 1e-4
        yr, sr = tri.synthesis_ri(bank, sr, (re, im))
        yc, sc = bank.synthesis(sc, spec)
        assert (yr - yc).abs().max() <= TOL
        assert (torch.complex(sr.hyb_tail_re, sr.hyb_tail_im)
                - sc.hyb_tail).abs().max() <= 1e-4


# -- ambi_bin, head tracked -----------------------------------------------------

def _ambi_bin_cfgs(order, fuma):
    kw = dict(order=order, enable_rotation=True, mxu_precision="highest")
    if fuma:
        kw.update(ch_ordering="fuma", norm="fuma")
    return jab.AmbiBinConfig(**kw), tab.AmbiBinConfig(**kw)


@pytest.mark.parametrize("order,fuma", [(1, False), (1, True), (3, False),
                                        (7, False)])
@pytest.mark.parametrize("entry", ["process_ri", "process"])
def test_ambi_bin_head_tracked_vs_jax(entry, order, fuma):
    """A new rotation every block, on random decoder weights: the rotation
    matrix built on the port's side from the ypr tensor, FuMa input
    converted right of the rotation, the state carried and handed across."""
    jcfg, tcfg = _ambi_bin_cfgs(order, fuma)
    nsh = (order + 1) ** 2
    rng = np.random.default_rng(order + 10 * fuma)
    M = rng.standard_normal((2, 133, 2, nsh)).astype(np.float32)
    if entry == "process_ri":
        jw = (jnp.asarray(M[0]), jnp.asarray(M[1]))
        tw = tab.weights_from_numpy(M[0], M[1], "cpu")
        js, ts = jab.init_state_ri(jcfg), tab.init_state_ri(tcfg, device="cpu")
    else:
        jw = jab.AmbiBinWeights(jnp.asarray(M[0] + 1j * M[1]))
        tw = tab.weights_complex_from_numpy(M[0], M[1], "cpu")
        assert tw.M_dec.dtype == torch.complex64
        js, ts = jab.init_state(jcfg), tab.init_state(tcfg, device="cpu")
    jproc, tproc = getattr(jab, entry), getattr(tab, entry)
    run = _Run()
    for i, H in enumerate(BLOCKS):
        x = rng.uniform(-1, 1, (nsh, H * 128)).astype(np.float32)
        ypr = rng.uniform(-np.pi, np.pi, 3).astype(np.float32)
        if i == 1:      # a degenerate rotation on the way
            ypr = np.array([np.pi, np.pi / 2, -np.pi], np.float32)
        if i == 2:
            ts = (tab.state_ri_from_numpy(*(np.asarray(a) for a in js), "cpu")
                  if entry == "process_ri"
                  else tab.state_complex_from_numpy(*_complex_state(js),
                                                    "cpu"))
        jy, js = jproc(jcfg, jw, js, jnp.asarray(x), jnp.asarray(ypr))
        ty, ts = tproc(tcfg, tw, ts, _T(x), _T(ypr))
        assert ty.shape == (2, H * 128)
        assert run.rel(jy, ty) <= TOL, (i, H)


def test_ambi_bin_rotation_off_ignores_ypr():
    """enable_rotation False (and order 0 has no rotation): ypr unused."""
    cfg = tab.AmbiBinConfig(order=1)
    rng = np.random.default_rng(2)
    w = tab.weights_from_numpy(*rng.standard_normal((2, 133, 2, 4)), "cpu")
    x = _T(rng.uniform(-1, 1, (4, 256)).astype(np.float32))
    st = tab.init_state_ri(cfg, device="cpu")
    y0, _ = tab.process_ri(cfg, w, st, x)
    y1, _ = tab.process_ri(cfg, w, st, x, torch.tensor([1.0, 0.5, -0.2]))
    assert torch.equal(y0, y1)


@pytest.mark.parametrize("order", [1, 3])
def test_process_ri_equals_the_batched_path(order):
    """One listener through process_ri with a rotation equals one stream of
    process_ri_batched with that rotation folded into the weights (both
    routes of the batched path), although the two carry different states
    (9 hops + hybrid history against 15 raw hops)."""
    cfg = tab.AmbiBinConfig(order=order, enable_rotation=True)
    nsh = cfg.nsh
    rng = np.random.default_rng(order)
    Mre, Mim = tab.weights_from_numpy(
        *rng.standard_normal((2, 133, 2, nsh)), "cpu")
    ypr = torch.tensor([0.7, -0.3, 0.2])
    rot = tsh.get_sh_rot_mtx_real_torch(
        tgeo.yaw_pitch_roll2_rzyx_torch(ypr), order)
    folded = (torch.einsum("bes,st->bet", Mre, rot),
              torch.einsum("bes,st->bet", Mim, rot))
    s1 = tab.init_state_ri(cfg, device="cpu")
    sb = {f: tab.init_state_batched(cfg, 1, device="cpu")
          for f in (True, False)}
    for H in (2, 1, 16):
        x = _T(rng.uniform(-1, 1, (nsh, H * 128)).astype(np.float32))
        y1, s1 = tab.process_ri(cfg, (Mre, Mim), s1, x, ypr)
        for fused in sb:
            yb, sb[fused] = tab.process_ri_batched(cfg, folded, sb[fused],
                                                   x[None], fused=fused)
            assert (y1 - yb[0]).abs().max() <= 2e-5 * float(y1.abs().max())


def test_ambi_bin_design_complex_vs_jax():
    """design (complex) is design_ri's pair as one tensor, and matches the
    JAX design."""
    cfg = tab.AmbiBinConfig(order=1)
    w = tab.design(cfg, device="cpu")
    Mre, Mim = tab.design_ri(cfg, device="cpu")
    assert torch.equal(w.M_dec.real, Mre) and torch.equal(w.M_dec.imag, Mim)
    a, b = tab.weights_ri(w)
    assert torch.equal(a, Mre) and torch.equal(b, Mim) and a.is_contiguous()
    ref = np.asarray(jab.design(jab.AmbiBinConfig(order=1)).M_dec)
    assert np.abs(ref - w.M_dec.numpy()).max() <= 1e-4


# -- binauraliser and binauraliser_nf -----------------------------------------

@functools.lru_cache(maxsize=None)
def _bin_design(mode):
    """The JAX complex design on every 8th default HRIR, a 10° × 15° table."""
    h, d, fs = thrir.default_hrirs()
    cfg = jbin.BinauraliserConfig(n_sources=3, interp_mode=mode,
                                  enable_rotation=True, azi_res=10,
                                  elev_res=15)
    w = jbin.design(cfg, h[::8], d[::8], fs)
    fb = np.asarray(w.hrtf_fb)
    return w, (fb.real, fb.imag) + tuple(np.asarray(a) for a in w[1:])


def _bin_cfgs(mode, nf=False):
    kw = dict(n_sources=3, interp_mode=mode, enable_rotation=True,
              azi_res=10, elev_res=15)
    if nf:
        return jnf.BinauraliserNFConfig(**kw), tnf.BinauraliserNFConfig(**kw)
    return jbin.BinauraliserConfig(**kw), tbin.BinauraliserConfig(**kw)


@pytest.mark.parametrize("mode", [jbin.INTERP_TRI, jbin.INTERP_TRI_PS])
def test_binauraliser_design_complex_vs_jax(mode):
    h, d, fs = thrir.default_hrirs()
    _, tcfg = _bin_cfgs(mode)
    jw, _ = _bin_design(mode)
    tw = tbin.design(tcfg, h[::8], d[::8], fs, device="cpu")
    assert tw._fields == jbin.BinauraliserWeights._fields
    assert tw.hrtf_fb.dtype == torch.complex64
    for name, a, b in zip(tw._fields, jw, tw):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, name
        assert np.abs(a - b.numpy()).max() <= 1e-6 * max(
            1.0, np.abs(a).max()), name
    ri_w = tw.as_ri()
    assert torch.equal(ri_w.hrtf_re, tw.hrtf_fb.real)
    assert torch.equal(ri_w.table_idx, tw.table_idx)


@pytest.mark.parametrize("nf", [False, True], ids=["binauraliser", "nf"])
@pytest.mark.parametrize("mode", [jbin.INTERP_TRI, jbin.INTERP_TRI_PS])
def test_binauraliser_process_vs_jax(mode, nf):
    """Gains, head rotation (the C's row convention), interpolation and,
    for the near-field model, the DVF shelves with one source below the
    near-field clamp and one beyond the far-field bypass."""
    jmod, tmod = (jnf, tnf) if nf else (jbin, tbin)
    jcfg, tcfg = _bin_cfgs(mode, nf)
    jw, parts = _bin_design(mode)
    tw = tmod.weights_complex_from_numpy(*parts, device="cpu")
    js, ts = jmod.init_state(jcfg), tmod.init_state(tcfg, device="cpu")
    rng = np.random.default_rng(5 + nf)
    dist = np.array([0.1, 0.5, 4.0], np.float32)
    run = _Run()
    for i, H in enumerate(BLOCKS):
        x = rng.uniform(-1, 1, (3, H * 128)).astype(np.float32)
        d = np.stack([rng.uniform(-180, 180, 3), rng.uniform(-80, 80, 3)],
                     -1).astype(np.float32)
        g = rng.uniform(0.5, 1.0, 3).astype(np.float32)
        ypr = rng.uniform(-1, 1, 3).astype(np.float32)
        extra = (dist,) if nf else ()
        if i == 2:
            ts = tmod.state_complex_from_numpy(*_complex_state(js), "cpu")
        jy, js = jmod.process(jcfg, jw, js, jnp.asarray(x), jnp.asarray(d),
                              *(jnp.asarray(e) for e in extra),
                              jnp.asarray(g), jnp.asarray(ypr))
        ty, ts = tmod.process(tcfg, tw, ts, _T(x), _T(d),
                              *(_T(e) for e in extra), _T(g), _T(ypr))
        assert ty.shape == (2, H * 128)
        assert run.rel(jy, ty) <= TOL, (i, H)


def test_tri_ps_on_the_seam_and_around_1500_hz_vs_jax():
    """TRI_PS at directions on and beside the ±180° seam and the poles, with
    band frequencies just below, at and above the 1.5 kHz phase-synthesis
    limit (the band's own frequencies never land there): the same HRTFs as
    the JAX package, in both the (re, im) and the complex form."""
    jcfg, tcfg = _bin_cfgs(jbin.INTERP_TRI_PS)
    jw, parts = _bin_design(jbin.INTERP_TRI_PS)
    freqs = np.asarray(jw.freqs).copy()
    freqs[10:15] = [1499.0, np.nextafter(np.float32(1500.0), np.float32(0)),
                    1500.0, np.nextafter(np.float32(1500.0), np.float32(2e3)),
                    1501.0]
    jw = jw._replace(freqs=jnp.asarray(freqs))
    tw = tbin.weights_complex_from_numpy(*parts[:-1], freqs, device="cpu")
    dirs = np.array([[180.0, 0.0], [-180.0, 0.0], [179.999, 10.0],
                     [-179.999, -10.0], [175.0, 45.0], [-175.1, -45.0],
                     [0.0, 90.0], [0.0, -90.0], [360.0, 0.0], [540.0, 7.4]],
                    np.float32)
    ref = np.asarray(jbin.interp_hrtfs(jcfg, jw, jnp.asarray(dirs)))
    got = tbin.interp_hrtfs(tcfg, tw, _T(dirs))
    assert got.dtype == torch.complex64 and tuple(got.shape) == ref.shape
    assert np.abs(ref - got.numpy()).max() <= 2e-6 * np.abs(ref).max()
    # above the limit the phase is exactly zero, below it is not
    assert float(got[12:].imag.abs().max()) == 0.0
    assert float(got[11].imag.abs().max()) > 0.0
    jri_w = jbin.BinauraliserWeightsRI(
        jnp.asarray(parts[0]), jnp.asarray(parts[1]), *jw[1:])
    rre, rim = jbin.interp_hrtfs_ri(jcfg, jri_w, jnp.asarray(dirs))
    gre, gim = tbin.interp_hrtfs_ri(tcfg, tw.as_ri(), _T(dirs))
    assert np.abs(np.asarray(rre) - gre.numpy()).max() <= 2e-6 * np.abs(ref).max()
    assert np.abs(np.asarray(rim) - gim.numpy()).max() <= 2e-6 * np.abs(ref).max()


def test_dvf_band_gains_complex_vs_jax():
    jcfg, tcfg = _bin_cfgs(jbin.INTERP_TRI, nf=True)
    rng = np.random.default_rng(8)
    freqs = np.asarray(tcfg.afstft.centre_freqs(48000.0))
    d = np.stack([rng.uniform(-180, 180, 5), rng.uniform(-90, 90, 5)],
                 -1).astype(np.float32)
    dist = np.array([0.05, 0.2, 1.0, 3.09264, 10.0], np.float32)
    ref = np.asarray(jnf._dvf_band_gains(jcfg, jnp.asarray(freqs),
                                         jnp.asarray(d), jnp.asarray(dist)))
    got = tnf._dvf_band_gains(tcfg, _T(freqs), _T(d), _T(dist))
    assert got.dtype == torch.complex64 and tuple(got.shape) == ref.shape
    assert np.abs(ref - got.numpy()).max() <= 2e-5 * np.abs(ref).max()


# -- roombinauraliser -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _brirs(grid, n_src=3):
    """Per source its own BRIR set: the default HRIR subset rolled along its
    directions, the right ear scaled (a swapped axis cannot pass)."""
    h, d, fs = thrir.default_hrirs()
    if grid == "3d":
        h, d = h[::8], d[::8]
    else:
        h = h[::35][:24]
        d = np.stack([np.arange(24) * 15.0, np.full(24, 10.0)], -1)
    sets = []
    for s in range(n_src):
        b = np.roll(h, 7 * (s + 1), axis=0).copy()
        b[:, 1] *= 1.0 - 0.1 * (s + 1) / n_src
        sets.append(b)
    return np.stack(sets).astype(np.float32), d.astype(np.float64), fs


@functools.lru_cache(maxsize=None)
def _rb_design(grid, mode):
    cfg = jrb.RoomBinauraliserConfig(n_sources=3, interp_mode=mode)
    return jrb.design(cfg, *_brirs(grid))


@pytest.mark.parametrize("grid", ["3d", "2d"])
def test_roombinauraliser_design_complex_vs_jax(grid):
    jcfg, jw = _rb_design(grid, jrb.INTERP_TRI)
    tcfg, tw = trb.design(trb.RoomBinauraliserConfig(n_sources=3),
                          *_brirs(grid), reinit=trb.REINIT_RESAMPLE,
                          device="cpu")
    assert tcfg.vbap_3d == jcfg.vbap_3d == (grid == "3d")
    assert tw._fields == jrb.RoomBinauraliserWeights._fields
    for name, a, b in zip(tw._fields, jw, tw):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, name
        assert np.abs(a - b.numpy()).max() <= 1e-6 * max(
            1.0, np.abs(a).max()), name


@pytest.mark.parametrize("grid", ["3d", "2d"])
@pytest.mark.parametrize("mode", [jrb.INTERP_TRI, jrb.INTERP_TRI_PS])
def test_roombinauraliser_process_vs_jax(mode, grid):
    jcfg, jw = _rb_design(grid, mode)
    tcfg = trb.RoomBinauraliserConfig(n_sources=3, interp_mode=mode,
                                      vbap_3d=jcfg.vbap_3d)
    fb = np.asarray(jw.hrtf_fb)
    tw = trb.weights_complex_from_numpy(
        fb.real, fb.imag, *(np.asarray(a) for a in jw[1:]), device="cpu")
    rot = np.array([40.0, -15.0], np.float32)
    ref = np.asarray(jrb.interp_hrtfs(jcfg, jw, jnp.asarray(rot)))
    got = trb.interp_hrtfs(tcfg, tw, _T(rot))
    assert np.abs(ref - got.numpy()).max() <= 2e-6 * np.abs(ref).max()
    js, ts = jrb.init_state(jcfg), trb.init_state(tcfg, device="cpu")
    rng = np.random.default_rng(11)
    run = _Run()
    for i, H in enumerate(BLOCKS):
        x = rng.uniform(-1, 1, (3, H * 128)).astype(np.float32)
        g = rng.uniform(0.5, 1.0, 3).astype(np.float32)
        ypr = rng.uniform(-1, 1, 3).astype(np.float32)
        if i == 2:
            ts = trb.state_complex_from_numpy(*_complex_state(js), "cpu")
        if i == 3:      # no rotation given: the lookup at (0, 0)
            jy, js = jrb.process(jcfg, jw, js, jnp.asarray(x))
            ty, ts = trb.process(tcfg, tw, ts, _T(x))
        else:
            jy, js = jrb.process(jcfg, jw, js, jnp.asarray(x), jnp.asarray(g),
                                 jnp.asarray(ypr))
            ty, ts = trb.process(tcfg, tw, ts, _T(x), _T(g), _T(ypr))
        assert ty.shape == (2, H * 128)
        assert run.rel(jy, ty) <= TOL, (i, H)


# -- panner -----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pan_design(layout):
    ls = (np.array([[30.0, 0], [-30, 0], [0, 0], [110, 0], [-110, 0]])
          if layout == "2d" else
          np.array([[30.0, 0], [-30, 0], [0, 0], [110, 0], [-110, 0],
                    [45, 40], [-45, 40], [135, 40], [-135, 40], [0, 90],
                    [0, -60]]))
    cfg = jpan.PannerConfig(n_sources=2, n_loudspeakers=len(ls), azi_res=5,
                            elev_res=5)
    w = jpan.design(cfg, ls)
    return len(ls), tuple(np.asarray(a) for a in w)


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("layout", ["3d", "2d"])
def test_panner_process_vs_jax(layout, rotate):
    n_ls, parts = _pan_design(layout)
    kw = dict(n_sources=2, n_loudspeakers=n_ls, azi_res=5, elev_res=5)
    jcfg, tcfg = jpan.PannerConfig(**kw), tpan.PannerConfig(**kw)
    jw = jpan.PannerWeights(*(jnp.asarray(a) for a in parts))
    tw = tpan.weights_from_numpy(*parts, device="cpu")
    js, ts = jpan.init_state(jcfg), tpan.init_state(tcfg, device="cpu")
    assert ts.ola_tail.shape == (n_ls, 9 * 128)
    rng = np.random.default_rng(13)
    run = _Run()
    for i, H in enumerate(BLOCKS):
        x = rng.uniform(-1, 1, (2, H * 128)).astype(np.float32)
        d = np.stack([rng.uniform(-180, 180, 2), rng.uniform(-60, 60, 2)],
                     -1).astype(np.float32)
        ypr = rng.uniform(-1, 1, 3).astype(np.float32) if rotate else None
        if i == 2:
            ts = tpan.state_complex_from_numpy(*_complex_state(js), "cpu")
        jy, js = jpan.process(jcfg, jw, js, jnp.asarray(x), jnp.asarray(d),
                              None if ypr is None else jnp.asarray(ypr))
        ty, ts = tpan.process(tcfg, tw, ts, _T(x), _T(d),
                              None if ypr is None else _T(ypr))
        assert ty.shape == (n_ls, H * 128)
        assert run.rel(jy, ty) <= TOL, (i, H)


# -- every model keeps the JAX entry points' names and parameters -------------

@pytest.mark.parametrize("jmod,tmod,entry", [
    (j, t, e) for j, t, es in [
        (jab, tab, ("design", "init_state", "process", "weights_ri",
                    "init_state_ri", "process_ri")),
        (jbin, tbin, ("design", "init_state", "interp_hrtfs", "process")),
        (jnf, tnf, ("design", "init_state", "_dvf_band_gains", "process")),
        (jrb, trb, ("design", "init_state", "interp_hrtfs", "process")),
        (jpan, tpan, ("init_state", "process")),
        (jri, tri, ("init_state_ri", "analysis_ri", "synthesis_ri")),
    ] for e in es], ids=lambda v: v if isinstance(v, str)
    else v.__name__.rsplit(".", 1)[-1])
def test_entry_point_signatures_follow_jax(jmod, tmod, entry):
    """Same parameter names in the same order; the port adds ``device`` and
    drops what exists only for the TPU (private switches, mxu_mode)."""
    ref = [p for p in inspect.signature(getattr(jmod, entry)).parameters
           if not p.startswith("_") and p != "mxu_mode"]
    got = [p for p in inspect.signature(getattr(tmod, entry)).parameters
           if p != "device"]
    assert got == ref
