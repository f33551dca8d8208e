"""ambi_enc in the PyTorch port vs the JAX package on the CPU: the encoding
matrix, the output conversion, and ``process`` over several frames with the
state carried (one-frame latency, crossfade between the previous and the
current encoding matrix), with moving directions, gains, every output
convention and orders 1 to 7.  Both sides are exact fp32 paths.

Run alone with ``python -m pytest -q tests/test_torch_ambi_enc.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import ambi_enc as jenc
from spatial_audio_framework_tpu_torch.models import ambi_enc as tenc

# exact paths, float32 on both sides: 1e-5 of the reference's peak where it
# exceeds 1 (order-7 N3D harmonics reach 5.6, outputs √nSrc times that)
TOL = 1e-5


def _close(ref, got):
    ref = np.asarray(ref)
    return np.abs(ref - got.numpy()).max() <= TOL * max(1.0, np.abs(ref).max())


def _inputs(rng, n_src, frame, n_frames):
    """Directions that move every frame (with a pole and the azimuth seam
    in frame 0), gains, and input frames."""
    dirs = np.concatenate([rng.uniform(-180, 180, (n_frames, n_src, 1)),
                           rng.uniform(-90, 90, (n_frames, n_src, 1))], -1)
    dirs[0, 0] = [180.0, 90.0]
    if n_src > 1:
        dirs[0, 1] = [-180.0, -90.0]
    gains = rng.uniform(0.5, 1.5, n_src)
    xs = rng.uniform(-1, 1, (n_frames, n_src, frame))
    return (dirs.astype(np.float32), gains.astype(np.float32),
            xs.astype(np.float32))


@pytest.mark.parametrize("order", range(1, 8))
def test_encoding_mtx_vs_jax(order):
    dirs = _inputs(np.random.default_rng(order), 6, 8, 1)[0][0]
    jcfg = jenc.AmbiEncConfig(order=order, n_sources=6)
    tcfg = tenc.AmbiEncConfig(order=order, n_sources=6)
    assert tcfg.nsh == jcfg.nsh == (order + 1) ** 2
    got = tenc.encoding_mtx(tcfg, dirs.astype(np.float64))
    np.testing.assert_allclose(
        got, jenc.encoding_mtx(jcfg, dirs.astype(np.float64)), rtol=0,
        atol=1e-12)


@pytest.mark.parametrize("order,ch,norm", [
    (1, "acn", "sn3d"), (1, "fuma", "fuma"), (3, "acn", "n3d"),
    (5, "acn", "sn3d"), (7, "acn", "n3d")])
@pytest.mark.parametrize("post_scaling", [True, False])
def test_process_vs_jax(order, ch, norm, post_scaling):
    """Five frames of 64 samples, 5 sources, moving directions, gains from
    the second frame on, the state made from initial directions."""
    kw = dict(order=order, n_sources=5, ch_ordering=ch, norm=norm,
              enable_post_scaling=post_scaling, frame_size=64)
    jcfg, tcfg = jenc.AmbiEncConfig(**kw), tenc.AmbiEncConfig(**kw)
    dirs, gains, xs = _inputs(np.random.default_rng(order), 5, 64, 5)
    jconv, tconv = jenc.design(jcfg), tenc.design(tcfg, device="cpu")
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))
    jst = jenc.init_state(jcfg, dirs[0].astype(np.float64))
    tst = tenc.init_state(tcfg, dirs[0].astype(np.float64), device="cpu")
    np.testing.assert_allclose(tst.prev_Y.numpy(), np.asarray(jst.prev_Y),
                               rtol=0, atol=1e-6)
    for f, x in enumerate(xs):
        g = gains if f else None
        jy, jst = jenc.process(jcfg, jconv, jst, jnp.asarray(x),
                               jnp.asarray(dirs[f]),
                               None if g is None else jnp.asarray(g))
        ty, tst = tenc.process(tcfg, tconv, tst, torch.from_numpy(x),
                               torch.from_numpy(dirs[f]),
                               None if g is None else torch.from_numpy(g))
        assert tuple(ty.shape) == ((order + 1) ** 2, 64)
        assert ty.dtype == torch.float32
        assert _close(jy, ty) and _close(jst.prev_Y, tst.prev_Y)
        np.testing.assert_array_equal(tst.prev_x.numpy(),
                                      np.asarray(jst.prev_x))
    assert float(ty.abs().max()) > 0.1


def test_one_frame_latency_and_crossfade():
    """The first output is silence (it encodes the zero previous frame);
    the second encodes frame 0 with a crossfade arange(1, T+1)/T from the
    previous matrix to the current one."""
    cfg = tenc.AmbiEncConfig(order=2, n_sources=2, norm="n3d",
                             enable_post_scaling=False, frame_size=32)
    conv = tenc.design(cfg, device="cpu")
    d0 = np.array([[10.0, 20.0], [-70.0, -30.0]])
    d1 = np.array([[50.0, 0.0], [100.0, 40.0]])
    rng = np.random.default_rng(0)
    x0, x1 = (torch.from_numpy(rng.uniform(-1, 1, (2, 32)).astype(np.float32))
              for _ in range(2))
    st = tenc.init_state(cfg, d0, device="cpu")
    y0, st = tenc.process(cfg, conv, st, x0,
                          torch.from_numpy(d0.astype(np.float32)))
    assert not y0.any()
    y1, st = tenc.process(cfg, conv, st, x1,
                          torch.from_numpy(d1.astype(np.float32)))
    fade = np.arange(1, 33) / 32.0
    Y0, Y1 = (tenc.encoding_mtx(cfg, d) for d in (d0, d1))
    ref = (Y1 @ x0.numpy().astype(np.float64)) * fade \
        + (Y0 @ x0.numpy().astype(np.float64)) * (1.0 - fade)
    assert np.abs(y1.numpy() - ref).max() <= TOL
    assert torch.equal(st.prev_x, x1)


def test_state_from_numpy_and_zero_state_vs_jax():
    jcfg = jenc.AmbiEncConfig(order=3, n_sources=4, frame_size=16)
    tcfg = tenc.AmbiEncConfig(order=3, n_sources=4, frame_size=16)
    z = tenc.init_state(tcfg, device="cpu")
    jz = jenc.init_state(jcfg)
    assert tuple(z.prev_Y.shape) == jz.prev_Y.shape == (16, 4)
    assert tuple(z.prev_x.shape) == jz.prev_x.shape == (4, 16)
    assert not z.prev_Y.any() and not z.prev_x.any()
    rng = np.random.default_rng(1)
    Y, x = rng.standard_normal((16, 4)), rng.standard_normal((4, 16))
    st = tenc.state_from_numpy(Y, x, device="cpu")
    assert st._fields == jenc.AmbiEncState._fields
    assert st.prev_Y.dtype == st.prev_x.dtype == torch.float32
    np.testing.assert_array_equal(st.prev_Y.numpy(), Y.astype(np.float32))
    dirs, _, xs = _inputs(rng, 4, 16, 1)
    jy, _ = jenc.process(jcfg, jenc.design(jcfg),
                         jenc.AmbiEncState(jnp.asarray(Y, jnp.float32),
                                           jnp.asarray(x, jnp.float32)),
                         jnp.asarray(xs[0]), jnp.asarray(dirs[0]))
    ty, _ = tenc.process(tcfg, tenc.design(tcfg, device="cpu"), st,
                         torch.from_numpy(xs[0]), torch.from_numpy(dirs[0]))
    assert _close(jy, ty)
