"""ambi_drc in the PyTorch port vs the JAX reference (CPU): the
single-stream complex ``process`` and the stream-batched packed
``process_ri_batched`` (its kernels' plain versions on CPU tensors; the
JAX side with ``use_pallas=False``), over several blocks with the JAX
state handed across at a block boundary.

Tolerance: 1e-5 absolute on outputs of unit scale, 1e-6 of the largest
on the smoother's level (dB values to ~35: a few float32 ulps).  float32
on both sides; the smoother blends as y + (1 - a)(x - y) where the JAX
package writes a·y + (1 - a)·x, and its coefficients may differ by one
ulp (numpy's exp on the host, XLA's in the JAX package), equal up to
rounding.  The JAX package's batched-vs-single check holds 2e-4
(tests/test_afstft_ri.py::test_ambi_drc_batched_fast_path)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import ambi_drc as J
from spatial_audio_framework_tpu_torch.models import ambi_drc as T

TOL = 1e-5
_KW = dict(theshold_db=-30.0, ratio=8.0, knee_db=5.0, attack_ms=20.0,
           release_ms=200.0, in_gain_db=6.0, out_gain_db=3.0)


def _err(a, b):
    return float(np.abs(np.asarray(a) - b.numpy()).max())


def _scale(a):
    return max(1.0, float(np.abs(np.asarray(a)).max()))


@pytest.mark.parametrize("order,knee", [(1, 5.0), (2, 0.0)])
def test_process_vs_jax(order, knee):
    kw = dict(_KW, order=order, knee_db=knee)
    jc, tc = J.AmbiDrcConfig(**kw), T.AmbiDrcConfig(**kw)
    rng = np.random.default_rng(order)
    sj, st = J.init_state(jc), T.init_state(tc, device="cpu")
    nsh = (order + 1) ** 2
    for blk in range(4):
        env = 0.05 + np.abs(np.sin(np.arange(512) / 90.0 + blk))
        x = (rng.uniform(-1, 1, (nsh, 512)) * env).astype(np.float32)
        if blk == 2:
            b = [np.asarray(a) for a in sj.bank]
            st = T.state_from_numpy((b[0], b[1].real, b[1].imag, b[2]),
                                    np.asarray(sj.yl_z1), device="cpu")
        yj, sj = J.process(jc, sj, jnp.asarray(x))
        yt, st = T.process(tc, st, torch.from_numpy(x))
        assert yt.shape == (nsh, 512) and _err(yj, yt) <= TOL, blk
        assert _err(sj.yl_z1, st.yl_z1) <= 1e-6 * _scale(sj.yl_z1)


def test_process_ri_batched_vs_jax():
    kw = dict(_KW, order=1)
    jc, tc = J.AmbiDrcConfig(**kw), T.AmbiDrcConfig(**kw)
    rng = np.random.default_rng(3)
    sj = J.init_state_batched(jc, 3)
    st = T.init_state_batched(tc, 3, device="cpu")
    for blk, H in enumerate((4, 4, 1, 8)):
        x = rng.uniform(-1, 1, (3, 4, H * 128)).astype(np.float32)
        x[1] *= 0.01                      # one quiet stream, below threshold
        if blk == 2:
            st = T.state_batched_from_numpy(
                np.asarray(sj.bank.in_tail), np.asarray(sj.bank.ola_tail),
                np.asarray(sj.yl_z1), device="cpu")
        yj, sj = J.process_ri_batched(jc, sj, jnp.asarray(x),
                                      use_pallas=False)
        yt, st = T.process_ri_batched(tc, st, torch.from_numpy(x))
        assert yt.shape == (3, 4, H * 128) and _err(yj, yt) <= TOL, blk
        assert _err(sj.yl_z1, st.yl_z1) <= 1e-6 * _scale(sj.yl_z1)
    x = torch.from_numpy(rng.uniform(-1, 1, (3, 4, 512)).astype(np.float32))
    y1, s1 = T.process_ri_batched(tc, st, x, fused=True)
    y2, s2 = T.process_ri_batched(tc, st, x, fused=False)
    assert float((y1 - y2).abs().max()) <= TOL
    assert torch.equal(s1.bank.in_tail, s2.bank.in_tail)


def test_batched_matches_single_stream():
    """The packed batched path against ``process`` per stream, at the JAX
    package's own 2e-4 (the two filterbank layouts)."""
    tc = T.AmbiDrcConfig(order=1, theshold_db=-20.0, ratio=8.0)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, 4, 2048)).astype(np.float32)
    yb, _ = T.process_ri_batched(tc, T.init_state_batched(tc, 2, device="cpu"),
                                 torch.from_numpy(x))
    for s in range(2):
        ys, _ = T.process(tc, T.init_state(tc, device="cpu"),
                          torch.from_numpy(x[s]))
        assert float((ys - yb[s]).abs().max()) <= 2e-4
