"""modules/reverb and models/ambi_roomsim in the PyTorch port vs the JAX
reference (CPU): the host echograms, absorption and RIR render (the port's
own copy: equal to the JAX package's), the tap packing, the time-domain
applicator ``ImsTDApplicator`` (broadband and 4-band on the Favrot & Faller
bank, integer and fractional delays, the crossfade), and the roomsim
chunks in both forms at 1 and 8 instances, with the JAX state handed
across at a block boundary.

Tolerance: 1e-5 relative to max(1, |ref|) (float32 on both sides); the
4-band applicator 2e-4, the JAX device FaF bank's own distance from its
float64 evaluation (its float32 scan squares pole matrices near the unit
circle; tests/test_torch_iir_decor.py holds the port's bank at 2e-5 of
that evaluation)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import ambi_roomsim as JR
from spatial_audio_framework_tpu.modules import reverb as J
from spatial_audio_framework_tpu_torch.models import ambi_roomsim as TR
from spatial_audio_framework_tpu_torch.modules import reverb as T
from spatial_audio_framework_tpu_torch.ops import matrix_conv as TM

TOL = 1e-5


def _err(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(ref - got).max() / max(1.0, np.abs(ref).max()))


def _rooms(abs_wall, band=125.0):
    return [M.ShoeboxRoom(np.array([6.0, 5.0, 3.0]), abs_wall,
                          lowest_octave_band=band) for M in (J, T)]


@pytest.mark.parametrize("frac", [False, True])
def test_echograms_rirs_and_taps_equal_jax(frac):
    abs_wall = np.tile([[0.2, 0.25, 0.3, 0.3, 0.4, 0.45]], (3, 1))
    abs_wall += 0.05 * np.arange(3)[:, None]
    rooms = _rooms(abs_wall, 250.0)
    for r in rooms:
        r.add_source([1.0, 1.2, 1.0])
        r.add_source([4.2, 3.1, 1.8])
        r.add_receiver_sh(2, [3.5, 2.5, 1.6])
        r.compute_echograms(max_order=2)
    rj, rt = rooms
    for key in rj.echograms:
        for ej, et in zip(rj.echograms[key], rt.echograms[key]):
            for f in ("value", "time", "order", "coords"):
                np.testing.assert_array_equal(getattr(ej, f), getattr(et, f))
    for a, b in zip(rj.render_rirs(frac).values(),
                    rt.render_rirs(frac).values()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(rj.pack_taps(0, 800, frac), rt.pack_taps(0, 800, frac)):
        np.testing.assert_array_equal(a, b)
    ec = J.compute_echogram([6.0, 5.0, 3.0], [1, 1, 1], [4, 3, 2],
                            max_time_s=0.02)
    et = T.compute_echogram([6.0, 5.0, 3.0], [1, 1, 1], [4, 3, 2],
                            max_time_s=0.02)
    np.testing.assert_array_equal(ec.value, et.value)


@pytest.mark.parametrize("n_bands,frac", [(1, False), (1, True), (4, False)])
def test_td_applicator_vs_jax(n_bands, frac):
    """Several blocks, an echogram update with the crossfade in the middle,
    and the JAX state handed across at a block boundary."""
    abs_wall = np.tile([[0.2, 0.2, 0.3, 0.3, 0.4, 0.4]], (n_bands, 1))
    rooms = _rooms(abs_wall, 250.0)
    taps = []
    for r in rooms:
        r.add_source([1.0, 1.0, 1.0])
        r.add_source([4.5, 3.5, 2.0])
        r.add_receiver_sh(1, [4.0, 3.0, 2.0])
        r.compute_echograms(max_order=1)
        t0 = r.pack_taps(0, 64, frac)
        r.update_source(0, [1.3, 1.1, 1.0])
        r.compute_echograms(max_order=1)
        taps.append((t0, r.pack_taps(0, 64, frac)))
    (t0, t1), _ = taps
    aj = rooms[0].td_applicator(0, max_delay=1536)
    at = rooms[1].td_applicator(0, max_delay=1536)
    sj, st = aj.init_state(), at.init_state("cpu")
    d0, d1 = (T.taps_from_numpy(t, "cpu") for t in (t0, t1))
    rng = np.random.default_rng(n_bands + 2 * frac)
    for blk in range(4):
        x = rng.uniform(-1, 1, (2, 256)).astype(np.float32)
        if blk == 2:
            st = T.td_state_from_numpy(
                np.asarray(sj.band_tail),
                None if sj.faf_zi is None else np.asarray(sj.faf_zi), "cpu")
        if blk == 1:       # the first block after the update: crossfade
            xf = np.array([1.0, 0.0], np.float32)
            yj, sj = aj.process(sj, jnp.asarray(x), t1, t0, jnp.asarray(xf))
            yt, st = at.process(st, torch.from_numpy(x), d1, d0,
                                torch.from_numpy(xf))
        else:
            cur = t0 if blk == 0 else t1
            yj, sj = aj.process(sj, jnp.asarray(x), cur)
            yt, st = at.process(st, torch.from_numpy(x),
                                d0 if blk == 0 else cur)   # numpy taps too
        tol = TOL if n_bands == 1 else 2e-4
        assert yt.shape == (4, 256) and _err(yj, yt) <= tol, blk
    with pytest.raises(ValueError, match="max_delay"):
        at.process(st, torch.from_numpy(x),
                   t1._replace(delays=t1.delays + 2000))


@pytest.fixture(scope="module")
def roomsim():
    kw = dict(sh_order=1, n_sources=2, n_receivers=1, refl_order=1,
              room_dims=(6.0, 5.0, 3.0), hop=64)
    src = np.array([[2.0, 3.0, 1.5], [4.0, 2.0, 1.7]])
    rec = np.array([[3.0, 2.5, 1.6]])
    return JR.AmbiRoomSimConfig(**kw), TR.AmbiRoomSimConfig(**kw), src, rec


@pytest.mark.parametrize("form,batch", [("complex", ()), ("ri", ()),
                                        ("ri", (8,))])
def test_ambi_roomsim_vs_jax(roomsim, form, batch):
    jc, tc, src, rec = roomsim
    if form == "complex":
        wj, wt = JR.design(jc, src, rec), TR.design(tc, src, rec,
                                                    device="cpu")
        sj, st = JR.init_state(jc, wj), TR.init_state(tc, wt, "cpu")
        pj, pt = JR.process, TR.process
        Hj = np.asarray(wj.Hf)
    else:
        wj, wt = JR.design_ri(jc, src, rec), TR.design_ri(tc, src, rec,
                                                          device="cpu")
        sj = wj.conv.init_state_ri(batch)
        st = TR.init_state_ri(tc, wt, batch, "cpu")
        pj, pt = JR.process_ri, TR.process_ri
        Hj = tuple(np.asarray(h) for h in wj.Hf)
    w2 = TR.weights_from_numpy(tc, Hj, "cpu")
    assert w2.conv.n_part == wt.conv.n_part
    rng = np.random.default_rng(len(batch))
    for blk in range(4):
        x = rng.uniform(-1, 1, batch + (2, 4 * 64)).astype(np.float32)
        if blk == 2:
            st = TM.state_from_numpy(*(np.asarray(a) for a in sj),
                                     device="cpu")
        yj, sj = jax.jit(lambda s, xx: pj(jc, wj, s, xx))(sj, jnp.asarray(x))
        yt, st = pt(tc, w2 if blk % 2 else wt, st, torch.from_numpy(x))
        assert yt.shape == batch + (4, 256) and _err(yj, yt) <= TOL, blk
