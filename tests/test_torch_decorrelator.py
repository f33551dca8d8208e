"""decorrelator in the PyTorch port vs the JAX reference (CPU): the design
(host dict, delays from the C's rand() stream), the single-stream complex
``process`` and the stream-batched ``process_ri_batched`` (its kernels'
plain versions on CPU tensors; the JAX side with ``use_pallas=False``),
over several blocks with the JAX state handed across at a block boundary
(``state_from_numpy`` / ``state_batched_from_numpy``).

Tolerance: 1e-5 absolute on outputs of unit scale (float32 on both sides;
the lattice is the same float64-built block-form matrices, the filterbank
the same algorithm)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import decorrelator as J
from spatial_audio_framework_tpu_torch.models import decorrelator as T

TOL = 1e-5


def _cfgs(**kw):
    return J.DecorrelatorConfig(**kw), T.DecorrelatorConfig(**kw)


def _err(a, b):
    return float(np.abs(np.asarray(a) - b.numpy()).max())


def test_design_equals_jax():
    jc, tc = _cfgs(n_channels=4)
    for off in (None, 0, 5016):
        dj = J.design(jc, c_rand_offset=off)
        dt = T.design(tc, c_rand_offset=off, device="cpu")
        for k in dj:
            assert np.array_equal(dj[k], dt[k]), (off, k)
        dev = dt["_device"]["cpu"]
        md = dj["max_delay_slots"] + 1
        assert np.array_equal(dev["start"][..., 0, 0].numpy(),
                              md - dj["delays"])
        assert np.array_equal(dev["filtered_mask"][:, 0, 0].numpy(),
                              dj["filtered"])


@pytest.mark.parametrize("ducker,comp,amount", [(False, False, 1.0),
                                                (True, True, 0.7)])
def test_process_vs_jax(ducker, comp, amount):
    jc, tc = _cfgs(n_channels=3, decor_amount=amount,
                   enable_transient_ducker=ducker, compensate_level=comp)
    dj = J.design(jc, c_rand_offset=11)
    dt = T.design(tc, c_rand_offset=11, device="cpu")
    rng = np.random.default_rng(int(ducker))
    sj, st = J.init_state(jc, dj), T.init_state(tc, dt, device="cpu")
    for blk in range(4):
        x = (0.5 * rng.standard_normal((3, 256))).astype(np.float32)
        if blk == 2:          # the JAX state at a block boundary
            b = [np.asarray(a) for a in sj.bank]
            lat, dk = sj.lattice, sj.ducker
            st = T.state_from_numpy(
                (b[0], b[1].real, b[1].imag, b[2]),
                ((np.real(lat.delay_buf), np.imag(lat.delay_buf)),
                 (np.real(lat.iir_state), np.imag(lat.iir_state)),
                 lat.in_energy, lat.out_energy),
                tuple(np.asarray(a) for a in dk), device="cpu")
        yj, sj = J.process(jc, dj, sj, jnp.asarray(x))
        yt, st = T.process(tc, dt, st, torch.from_numpy(x))
        assert yt.shape == (3, 256) and _err(yj, yt) <= TOL, blk
    assert _err(sj.lattice.in_energy, st.lattice.in_energy) <= TOL


@pytest.mark.parametrize("ducker", [False, True])
def test_process_ri_batched_vs_jax(ducker):
    """Three streams of four channels, blocks of 4 and 1 hops."""
    jc, tc = _cfgs(n_channels=4, decor_amount=0.8,
                   enable_transient_ducker=ducker, compensate_level=ducker)
    dj = J.design(jc, c_rand_offset=0)
    dt = T.design(tc, c_rand_offset=0, device="cpu")
    rng = np.random.default_rng(7)
    sj = J.init_state_batched(jc, dj, 3)
    st = T.init_state_batched(tc, dt, 3, device="cpu")
    for blk, H in enumerate((4, 4, 1, 4)):
        x = rng.uniform(-1, 1, (3, 4, H * 128)).astype(np.float32)
        if blk == 2:
            st = T.state_batched_from_numpy(
                tuple(np.asarray(a) for a in sj.bank),
                tuple(np.asarray(a) for a in sj.lattice),
                tuple(np.asarray(a) for a in sj.ducker), device="cpu")
        yj, sj = J.process_ri_batched(jc, dj, sj, jnp.asarray(x),
                                      use_pallas=False)
        yt, st = T.process_ri_batched(tc, dt, st, torch.from_numpy(x))
        assert yt.shape == (3, 4, H * 128) and _err(yj, yt) <= TOL, blk
        for a, b in zip(tuple(sj.lattice) + tuple(sj.ducker),
                        tuple(st.lattice) + tuple(st.ducker)):
            assert np.abs(np.asarray(a) - b.numpy()).max() \
                <= TOL * max(1.0, float(np.abs(np.asarray(a)).max()))
    # the plain filterbank route computes the same
    st2 = T.state_batched_from_numpy(
        tuple(np.asarray(a) for a in sj.bank),
        tuple(np.asarray(a) for a in sj.lattice),
        tuple(np.asarray(a) for a in sj.ducker), device="cpu")
    x = torch.from_numpy(rng.uniform(-1, 1, (3, 4, 512)).astype(np.float32))
    y1, _ = T.process_ri_batched(tc, dt, st2, x, fused=True)
    y2, _ = T.process_ri_batched(tc, dt, st2, x, fused=False)
    assert float((y1 - y2).abs().max()) <= TOL


def test_batched_matches_single_stream():
    """Each stream of the batched path equals ``process`` on it alone (the
    JAX package's own check, tests/test_decor.py, at its 3e-5)."""
    _, tc = _cfgs(n_channels=2, decor_amount=0.7,
                  enable_transient_ducker=True, compensate_level=True)
    dt = T.design(tc, c_rand_offset=3, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 2, 3 * 512)).astype(np.float32)
    sb = T.init_state_batched(tc, dt, 2, device="cpu")
    outs_b = []
    for k in range(3):
        y, sb = T.process_ri_batched(tc, dt, sb, torch.from_numpy(
            x[..., k * 512:(k + 1) * 512]))
        outs_b.append(y)
    yb = torch.cat(outs_b, -1)
    for s in range(2):
        ss = T.init_state(tc, dt, device="cpu")
        outs = []
        for k in range(3):
            y, ss = T.process(tc, dt, ss, torch.from_numpy(
                x[s, :, k * 512:(k + 1) * 512]))
            outs.append(y)
        assert float((torch.cat(outs, -1) - yb[s]).abs().max()) <= 3e-5
