"""rotator and beamformer in the PyTorch port vs the JAX reference (CPU):
designs, and ``process`` over several frames with the state carried — from
the JAX package's state at a frame boundary (``state_from_numpy``), so a
mismatch in the state layout shows.

Tolerance: 1e-5 of the largest output (float32 on both sides, a few small
matrix products a frame)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import beamformer as jbf
from spatial_audio_framework_tpu.models import rotator as jrot
from spatial_audio_framework_tpu_torch.models import beamformer as tbf
from spatial_audio_framework_tpu_torch.models import rotator as trot

TOL = 1e-5


def _rel(ref, got):
    ref = np.asarray(ref)
    return np.abs(ref - got.numpy()).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("order,conv,rpy,T", [
    (1, ("acn", "sn3d"), False, 128), (3, ("acn", "n3d"), True, 64),
    (1, ("fuma", "fuma"), False, 128), (7, ("acn", "sn3d"), False, 32),
    (2, ("acn", "fuma"), True, 128)])
def test_rotator_process_vs_jax(order, conv, rpy, T):
    kw = dict(order=order, ch_ordering=conv[0], norm=conv[1],
              use_roll_pitch_yaw=rpy, frame_size=T)
    jcfg, tcfg = jrot.RotatorConfig(**kw), trot.RotatorConfig(**kw)
    jw, tw = jrot.design(jcfg), trot.design(tcfg, device="cpu")
    for a, b in zip(jw, tw):
        assert np.array_equal(np.asarray(a), b.numpy())
    rng = np.random.default_rng(order)
    nsh = (order + 1) ** 2
    js, ts = jrot.init_state(jcfg), trot.init_state(tcfg, device="cpu")
    for a, b in zip(js, ts):
        assert np.array_equal(np.asarray(a), b.numpy())
    for f in range(5):
        x = rng.standard_normal((nsh, T)).astype(np.float32)
        ypr = rng.uniform(-np.pi, np.pi, 3).astype(np.float32)
        if f == 2:      # hand the JAX state across at a frame boundary
            ts = trot.state_from_numpy(np.asarray(js.prev_M),
                                       np.asarray(js.prev_x), "cpu")
        jy, js = jrot.process(jcfg, jw, js, jnp.asarray(x), jnp.asarray(ypr))
        ty, ts = trot.process(tcfg, tw, ts, torch.from_numpy(x),
                              torch.from_numpy(ypr))
        if f:
            assert _rel(jy, ty) <= TOL, f
        else:           # one-frame latency: the first output is silence
            assert float(ty.abs().max()) == 0.0 == float(np.abs(jy).max())
        assert np.abs(np.asarray(js.prev_M) - ts.prev_M.numpy()).max() <= TOL


@pytest.mark.parametrize("beam_type", [tbf.BEAM_CARDIOID,
                                       tbf.BEAM_HYPERCARDIOID,
                                       tbf.BEAM_MAX_EV])
@pytest.mark.parametrize("order,conv", [(1, ("fuma", "fuma")),
                                        (3, ("acn", "n3d")),
                                        (5, ("acn", "sn3d"))])
def test_beamformer_vs_jax(order, conv, beam_type):
    kw = dict(order=order, n_beams=3, beam_type=beam_type,
              ch_ordering=conv[0], norm=conv[1])
    jcfg, tcfg = jbf.BeamformerConfig(**kw), tbf.BeamformerConfig(**kw)
    rng = np.random.default_rng(order)
    nsh = (order + 1) ** 2
    js, ts = jbf.init_state(jcfg), tbf.init_state(tcfg, device="cpu")
    for f in range(4):
        # the beams move every frame: the crossfade runs between two designs
        dirs = np.stack([rng.uniform(-180, 180, 3), rng.uniform(-90, 90, 3)],
                        -1)
        jW, tW = jbf.design(jcfg, dirs), tbf.design(tcfg, dirs, device="cpu")
        assert tW.shape == (3, nsh)
        assert np.abs(np.asarray(jW) - tW.numpy()).max() <= 1e-6
        x = rng.standard_normal((nsh, 128)).astype(np.float32)
        if f == 2:
            ts = tbf.state_from_numpy(np.asarray(js.prev_W),
                                      np.asarray(js.prev_x), "cpu")
        jy, js = jbf.process(jcfg, jW, js, jnp.asarray(x))
        ty, ts = tbf.process(tcfg, tW, ts, torch.from_numpy(x))
        assert ty.shape == (3, 128)
        if f:
            assert _rel(jy, ty) <= TOL, f
