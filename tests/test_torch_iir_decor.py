"""ops/iir, utils/filters and utils/decor in the PyTorch port vs the JAX
reference (CPU), on the same seeded numpy inputs.

Tolerances: host designs (filters, delays, lattice tables) are the same
numpy code on both sides and must agree exactly, or to float32 rounding
where a side casts; the scan IIR 2e-6 of the output scale for the short
butterworths (float32 on both sides, two different log-depth schedules:
JAX's associative scan, the port's doubling scan), and the 100 Hz
high-pass at 8192 samples against float64 ``lfilter`` at 5e-5 of the
output's scale (the port composes its pole-matrix powers in float64 on
the host: 1.6e-5; the JAX scan squares them in float32: 5e-4); the block
form 1e-5 of the scale (the same float64-built matrices, float32 products), the FaF bank
against its float64 evaluation (2e-5 the port, 2e-4 the JAX package); the
lattice 2e-5 absolute, the JAX test's own
(tests/test_decor.py), and the ducker 1e-6 of the scale (its energies
reach ~4e3)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from spatial_audio_framework_tpu.ops import iir as jiir
from spatial_audio_framework_tpu.utils import decor as jdecor
from spatial_audio_framework_tpu.utils import filters as jF
from spatial_audio_framework_tpu_torch.ops import iir as tiir
from spatial_audio_framework_tpu_torch.utils import decor as tdecor
from spatial_audio_framework_tpu_torch.utils import filters as tF
from spatial_audio_framework_tpu_torch.utils.convhull3d import glibc_rand_at
from spatial_audio_framework_tpu.utils.convhull3d import (
    glibc_rand_at as j_glibc_rand_at)


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30)


# ---------------------------------------------------------------------------
# ops/iir
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("with_zi", [False, True])
def test_iir_filter_vs_jax_and_scipy(order, with_zi):
    rng = np.random.default_rng(order)
    b, a = sps.butter(order, 0.25)
    x = rng.standard_normal((2, 3, 300)).astype(np.float32)
    zi = (rng.standard_normal((2, 3, order)) * 0.1).astype(np.float32) \
        if with_zi else None
    yj, zj = jiir.iir_filter(b, a, jnp.asarray(x),
                             None if zi is None else jnp.asarray(zi))
    yt, zt = tiir.iir_filter(b, a, torch.from_numpy(x),
                             None if zi is None else torch.from_numpy(zi))
    assert _rel(yj, yt) <= 2e-6 and _rel(zj, zt) <= 2e-6
    yr, zr = sps.lfilter(b, a, x, zi=np.zeros((2, 3, order)) if zi is None
                         else zi)
    assert _rel(yr, yt) <= 2e-6 and _rel(zr, zt) <= 2e-6


def test_iir_filter_100hz_highpass_stays_finite_and_close():
    """The dirass band-pass: near-unit-circle poles composed 13 times over
    8192 samples; the products run with TF32 off (fp32_matmul)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((9, 8192)).astype(np.float32)
    zi = np.zeros((9, 2), np.float32)
    for ftype, fc in ((tF.BIQUAD_FILTER_HPF, 100.0),
                      (tF.BIQUAD_FILTER_LPF, 8000.0)):
        b, a = tF.biquad_coeffs(ftype, fc, 48000.0, 0.7071)
        assert np.array_equal((b, a), jF.biquad_coeffs(ftype, fc, 48000.0,
                                                       0.7071))
        yt, zt = tiir.iir_filter(b, a, torch.from_numpy(x),
                                 torch.from_numpy(zi))
        yr, zr = sps.lfilter(b, a, x.astype(np.float64), zi=zi)
        assert bool(torch.isfinite(yt).all())
        # the state relative to the output's scale, as the JAX scan's
        scale = np.abs(yr).max()
        assert np.abs(yt.numpy() - yr).max() <= 5e-5 * scale, fc
        assert np.abs(zt.numpy() - zr).max() <= 5e-5 * scale, fc


def test_iir_filter_batched_vs_jax():
    """One filter per (band, channel), batched coefficients."""
    rng = np.random.default_rng(1)
    b = np.stack([sps.butter(2, f)[0] for f in (0.1, 0.2, 0.3, 0.4)])
    a = np.stack([sps.butter(2, f)[1] for f in (0.1, 0.2, 0.3, 0.4)])
    b, a = b.reshape(2, 2, 3), a.reshape(2, 2, 3)
    x = rng.standard_normal((5, 2, 2, 200)).astype(np.float32)
    zi = (rng.standard_normal((5, 2, 2, 2)) * 0.1).astype(np.float32)
    yj, zj = jiir.iir_filter_batched(b, a, jnp.asarray(x), jnp.asarray(zi))
    yt, zt = tiir.iir_filter_batched(b, a, torch.from_numpy(x),
                                     torch.from_numpy(zi))
    assert _rel(yj, yt) <= 2e-6 and _rel(zj, zt) <= 2e-6


@pytest.mark.parametrize("T", [1, 16, 64])
def test_iir_block_form_vs_jax(T):
    """The exact block form on the decorrelator's lattice coefficients
    (order 20, 15, 6 and 3 rows), leading stream and (re, im) axes."""
    rng = np.random.default_rng(T)
    lat = tdecor.LatticeDecorrelator(fs=48000.0, hop_size=128, n_ch=2,
                                     orders=(20, 15, 6, 3),
                                     freq_cutoffs=(600.0, 2.4e3, 4e3, 12e3))
    freqs = np.linspace(0.0, 24000.0, 12)
    des = lat.design(freqs, rng=np.random.default_rng(0))
    b, a = des["b"], des["a"]
    x = rng.standard_normal((3, 2, 12, 2, T)).astype(np.float32)
    zi = (rng.standard_normal((3, 2, 12, 2, 19)) * 0.1).astype(np.float32)
    yj, zj = jiir.iir_filter_batched_block(b, a, jnp.asarray(x),
                                           jnp.asarray(zi))
    yt, zt = tiir.iir_filter_batched_block(b, a, torch.from_numpy(x),
                                           torch.from_numpy(zi))
    assert _rel(yj, yt) <= 1e-5 and _rel(zj, zt) <= 1e-5
    # the matrices are made once per (coefficients, T, device)
    m1 = tiir.block_mats(b, a, T, "cpu")
    m2 = tiir.block_mats(b.copy(), a.copy(), T, "cpu")
    assert all(p is q for p, q in zip(m1, m2))
    for mj, mt in zip(jiir._iir_block_mats(np.asarray(b), np.asarray(a), T),
                      m1):
        assert np.array_equal(mj, mt.numpy())


def test_onepole_ewma_mats_vs_jax():
    for lam, n in ((0.75, 64), (0.9, 7)):
        Lj, pj = jiir.onepole_ewma_mats(lam, n)
        Lt, pt = tiir.onepole_ewma_mats(lam, n, device="cpu")
        assert np.array_equal(np.asarray(Lj), Lt.numpy())
        assert np.array_equal(np.asarray(pj), pt.numpy())
    assert tiir.onepole_ewma_mats(0.9, 7, "cpu")[0] is Lt


# ---------------------------------------------------------------------------
# utils/filters (host numpy/scipy; the FaF bank's device part on ops/iir)
# ---------------------------------------------------------------------------

_WINDOWS = [tF.WINDOWING_FUNCTION_RECTANGULAR, tF.WINDOWING_FUNCTION_HAMMING,
            tF.WINDOWING_FUNCTION_HANN, tF.WINDOWING_FUNCTION_BARTLETT,
            tF.WINDOWING_FUNCTION_BLACKMAN, tF.WINDOWING_FUNCTION_NUTTALL,
            tF.WINDOWING_FUNCTION_BLACKMAN_NUTTALL,
            tF.WINDOWING_FUNCTION_BLACKMAN_HARRIS]
_BIQUADS = [tF.BIQUAD_FILTER_LPF, tF.BIQUAD_FILTER_LPF_EQCB,
            tF.BIQUAD_FILTER_HPF, tF.BIQUAD_FILTER_HPF_EQCB,
            tF.BIQUAD_FILTER_PEAK, tF.BIQUAD_FILTER_PEAK_EQCB,
            tF.BIQUAD_FILTER_LOW_SHELF, tF.BIQUAD_FILTER_LOW_SHELF_EQCB,
            tF.BIQUAD_FILTER_HI_SHELF, tF.BIQUAD_FILTER_HI_SHELF_EQCB]


def test_filter_designs_equal_jax():
    for wt in _WINDOWS:
        for n in (8, 127):
            assert np.array_equal(tF.get_windowing_function(wt, n),
                                  jF.get_windowing_function(wt, n)), wt
    cen = np.array([125.0, 250.0, 500.0, 1000.0, 2000.0, 4000.0])
    assert np.array_equal(tF.get_octave_band_cutoff_freqs(cen),
                          jF.get_octave_band_cutoff_freqs(cen))
    for bt in _BIQUADS:
        for gain in (-6.0, 6.0):
            t = tF.biquad_coeffs(bt, 1000.0, 48000.0, 0.7071, gain_db=gain)
            j = jF.biquad_coeffs(bt, 1000.0, 48000.0, 0.7071, gain_db=gain)
            assert all(np.array_equal(p, q) for p, q in zip(t, j)), bt
    b, a = tF.biquad_coeffs(tF.BIQUAD_FILTER_PEAK, 1000.0, 48000.0, 1.0,
                            gain_db=6.0)
    f = np.array([10.0, 1000.0, 20000.0])
    for p, q in zip(tF.eval_iir_transfer_function(b, a, f, 48000.0),
                    jF.eval_iir_transfer_function(b, a, f, 48000.0)):
        assert np.array_equal(p, q)
    for ft, c2 in (("lpf", 0.0), ("hpf", 0.0), ("bpf", 3000.0),
                   ("bsf", 3000.0)):
        for p, q in zip(tF.butter_coeffs(ft, 2, 300.0, c2, 48000.0),
                        jF.butter_coeffs(ft, 2, 300.0, c2, 48000.0)):
            assert np.array_equal(p, q), ft
        assert np.array_equal(tF.fir_coeffs(ft, 64, 300.0, c2, 48000.0),
                              jF.fir_coeffs(ft, 64, 300.0, c2, 48000.0)), ft
    for cuts in ([1000.0], [500.0, 2000.0, 8000.0]):
        assert np.array_equal(tF.fir_filterbank(128, np.array(cuts), 48000.0),
                              jF.fir_filterbank(128, np.array(cuts), 48000.0))
    x = np.random.default_rng(0).standard_normal((2, 100))
    assert np.array_equal(tF.apply_iir(x, b, a), jF.apply_iir(x, b, a))
    H = np.random.default_rng(1).standard_normal((3, 129)) * (1 + 1j)
    for n_out in (128, 512):
        assert np.array_equal(tF.interpolate_filters_h(H, 256, n_out),
                              jF.interpolate_filters_h(H, 256, n_out))


@pytest.mark.parametrize("order", [1, 3])
def test_faf_filterbank_vs_jax(order):
    """The host bank equals the JAX one.  The device bank (biquad cascades
    on the port's scan IIR), three blocks with its state carried, is held
    against its own float64 evaluation (the same cascades; that equals the
    host bank's scipy ``lfilter`` to 1e-6) at 2e-5 of the scale, and the
    JAX device bank against the same reference at 2e-4: its float32 scan
    squares the pole matrices on the device, and the order-3 bank's poles
    lie near the unit circle (1.5e-4 seen in its state)."""
    cuts = np.array([250.0, 1000.0, 4000.0])
    tb = tF.FafIIRFilterbank(order, cuts, 48000.0)
    jb = jF.FafIIRFilterbank(order, cuts, 48000.0)
    x = np.random.default_rng(order).standard_normal(
        (2, 3 * 512)).astype(np.float32)
    assert np.array_equal(tb.apply(x[0]), jb.apply(x[0]))
    zt = tb.init_device_state((2,), device="cpu")
    zj = jb.init_device_state((2,))
    assert tuple(zt.shape) == tuple(zj.shape)
    z64 = zt.double()
    y64s = []
    for k in range(3):
        blk = x[:, k * 512:(k + 1) * 512]
        yj, zj = jb.apply_device(jnp.asarray(blk), zj)
        yt, zt = tb.apply_device(torch.from_numpy(blk), zt)
        y64, z64 = tb.apply_device(torch.from_numpy(blk).double(), z64)
        y64s.append(y64)
        assert _rel(y64, yt) <= 2e-5 and _rel(z64, zt) <= 2e-5, k
        assert _rel(y64, yj) <= 2e-4 and _rel(z64, zj) <= 2e-4, k
    host = tb.apply(x[0])
    assert _rel(host, torch.cat(y64s, -1)[:, 0].float()) <= 1e-6


# ---------------------------------------------------------------------------
# utils/decor
# ---------------------------------------------------------------------------

def test_delays_and_lattice_design_equal_jax():
    freqs = np.linspace(0.0, 24000.0, 133)
    for n_ch in (1, 4, 7):
        dt = tdecor.get_decorrelation_delays(n_ch, freqs, 48000.0, 8, 128,
                                             np.random.default_rng(n_ch))
        dj = jdecor.get_decorrelation_delays(n_ch, freqs, 48000.0, 8, 128,
                                             np.random.default_rng(n_ch))
        assert np.array_equal(dt, dj)
        for off in (0, 5016):
            ct = tdecor.get_decorrelation_delays_c(n_ch, freqs, 48000.0, 8,
                                                   128, glibc_rand_at(off))
            cj = jdecor.get_decorrelation_delays_c(n_ch, freqs, 48000.0, 8,
                                                   128, j_glibc_rand_at(off))
            assert np.array_equal(ct, cj)
    assert np.array_equal(tdecor.c_randperm(9, glibc_rand_at(3)),
                          jdecor.c_randperm(9, j_glibc_rand_at(3)))
    for o in (3, 6, 15, 20):
        assert np.array_equal(tdecor.lattice_coeffs(o, 2, 1),
                              jdecor.lattice_coeffs(o, 2, 1))
    kw = dict(fs=48000.0, hop_size=128, n_ch=4, orders=(20, 15, 6, 3),
              freq_cutoffs=(600.0, 2.4e3, 4e3, 12e3), max_delay=8)
    dt = tdecor.LatticeDecorrelator(**kw).design(freqs,
                                                 c_rand_stream=glibc_rand_at(0))
    dj = jdecor.LatticeDecorrelator(**kw).design(
        freqs, c_rand_stream=j_glibc_rand_at(0))
    assert dt.keys() == dj.keys()
    for k in dj:
        assert np.array_equal(dt[k], dj[k]), k


def test_synthesise_noise_reverb_and_flatten_equal_jax():
    t60 = np.array([0.2, 0.15, 0.1])
    fc = np.array([500.0, 1000.0, 2000.0])
    for flat in (False, True):
        rt = tdecor.synthesise_noise_reverb(2, 8000.0, t60, fc, flat,
                                            np.random.default_rng(0))
        rj = jdecor.synthesise_noise_reverb(2, 8000.0, t60, fc, flat,
                                            np.random.default_rng(0))
        assert np.array_equal(rt, np.asarray(rj))


def _lattice(n_ch):
    kw = dict(fs=48000.0, hop_size=128, n_ch=n_ch, orders=(20, 15, 6, 3),
              freq_cutoffs=(600.0, 2.4e3, 4e3, 12e3), max_delay=8,
              en_comp_coeff=0.75)
    return tdecor.LatticeDecorrelator(**kw), jdecor.LatticeDecorrelator(**kw)


@pytest.mark.parametrize("aliased", [False, True])
def test_lattice_apply_vs_jax(aliased):
    """The complex apply and the (re, im) apply with a leading stream
    axis, 3 blocks each, with the JAX state handed across after block 1."""
    rng = np.random.default_rng(int(aliased))
    tl, jl = _lattice(3)
    freqs = np.linspace(0.0, 24000.0, 40)
    des = jl.design(freqs, rng=np.random.default_rng(2))
    sj = jl.init_state(des, 40)
    st = tl.init_state(des, 40, device="cpu")
    S = 2
    sbj = jdecor.lattice_init_state_ri(jl, des, 40)
    sbj = jdecor.LatticeDecorStateRI(*(jnp.broadcast_to(a, (S,) + a.shape)
                                       for a in sbj))
    sbt = tdecor.lattice_init_state_ri(tl, des, 40, (S,), device="cpu")
    for blk in range(3):
        fr = rng.standard_normal((2, S, 40, 3, 16)).astype(np.float32)
        if blk == 1:     # hand the JAX states across at a block boundary
            st = tdecor.LatticeDecorState(*(
                torch.from_numpy(np.asarray(a).copy()) for a in sj))
            sbt = tdecor.LatticeDecorStateRI(*(
                torch.from_numpy(np.asarray(a).copy()) for a in sbj))
        z = fr[0, 0] + 1j * fr[1, 0]
        yj, sj = jl.apply(des, sj, jnp.asarray(z), aliased_energy=aliased)
        yt, st = tl.apply(des, st, torch.from_numpy(z), aliased_energy=aliased)
        assert np.abs(np.asarray(yj) - yt.numpy()).max() <= 2e-5
        (ybj, sbj) = _vmapped_ri(jl, des, sbj, fr, aliased)
        (ybt, sbt) = tdecor.lattice_apply_ri(
            tl, des, sbt, torch.from_numpy(fr[0]), torch.from_numpy(fr[1]),
            aliased_energy=aliased)
        for a, b in zip(ybj + tuple(sbj), ybt + tuple(sbt)):
            assert np.abs(np.asarray(a) - b.numpy()).max() <= 2e-5


def _vmapped_ri(jl, des, st, fr, aliased):
    import jax

    return jax.vmap(lambda s, a, b: jdecor.lattice_apply_ri(
        jl, des, s, a, b, aliased_energy=aliased))(
        st, jnp.asarray(fr[0]), jnp.asarray(fr[1]))


def test_transient_ducker_vs_jax():
    rng = np.random.default_rng(5)
    sj = jdecor.transient_ducker_init(20, 2)
    st = tdecor.transient_ducker_init(20, 2, device="cpu")
    for blk in range(3):
        fr = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
        fr[..., 7] *= 30.0                       # a transient slot
        z = fr[0] + 1j * fr[1]
        rj, tj, sj2 = jdecor.transient_ducker_apply(sj, jnp.asarray(z))
        rt, tt, st2 = tdecor.transient_ducker_apply(st, torch.from_numpy(z))
        assert _rel(rj, rt) <= 1e-6 and _rel(tj, tt) <= 1e-6
        (a, b), (c, d), st3 = tdecor.transient_ducker_apply_ri(
            st, torch.from_numpy(fr[0]), torch.from_numpy(fr[1]))
        assert _rel(np.real(np.asarray(rj)), a) <= 1e-6
        assert _rel(np.imag(np.asarray(tj)), d) <= 1e-6
        for p, q, r in zip(sj2, st2, st3):     # energies up to ~4e3
            assert _rel(p, q) <= 1e-6
            assert torch.equal(q, r)
        sj, st = sj2, st2
