"""ops/matrix_conv and models/conv_examples in the PyTorch port vs the JAX
reference (CPU): MatrixConv (partitioned and not), MultiConv (partitioned
and not) and TVConv in both forms, at 1 and 8 instances (both sides of the
JAX package's ``_CONV_CORE_MIN_BATCH``, where it switches MAC cores), TVConv
with moving, static and repeated indices, over several blocks with the JAX
state handed across at a block boundary (``state_from_numpy``,
``tv_state_from_numpy``).

Tolerance: 1e-5 relative to max(1, |ref|) (float32 on both sides; the JAX
side's f32x3 matmul DFT against torch.fft)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import conv_examples as JE
from spatial_audio_framework_tpu.ops import matrix_conv as J
from spatial_audio_framework_tpu_torch.models import conv_examples as TE
from spatial_audio_framework_tpu_torch.ops import matrix_conv as T

TOL = 1e-5
HOP = 32


def _err(ref, got):
    ref = np.asarray(ref)
    return float(np.abs(ref - got.numpy()).max() / max(1.0, np.abs(ref).max()))


def _np(state):
    return tuple(np.asarray(a) for a in state)


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _filters(rng, shape):
    H = 0.2 * rng.standard_normal(shape).astype(np.float32)
    H[..., 0] += 1.0
    return H


@pytest.mark.parametrize("form,batch", [("complex", ()), ("ri", ()),
                                        ("ri", (8,))])
def test_matrix_conv_partitioned_vs_jax(form, batch):
    rng = np.random.default_rng(len(batch))
    H = _filters(rng, (3, 2, 150))
    mj = J.MatrixConv(hop=HOP, length_h=150, n_in=2, n_out=3)
    mt = T.MatrixConv(hop=HOP, length_h=150, n_in=2, n_out=3)
    if form == "complex":
        Hj, Ht = mj.design(H), mt.design(H, "cpu")
        sj, st = mj.init_state(), mt.init_state(device="cpu")
        fj, ft = jax.jit(mj.apply_block), mt.apply_block
    else:
        Hj, Ht = mj.design_ri(H), mt.design_ri(H, "cpu")
        sj, st = mj.init_state_ri(batch), mt.init_state_ri(batch, "cpu")
        fj, ft = jax.jit(mj.apply_block_ri), mt.apply_block_ri
    for blk, nh in enumerate((4, 1, 6, 3)):
        x = _x(rng, batch + (2, nh * HOP))
        if blk == 2:
            st = T.state_from_numpy(*_np(sj), device="cpu")
        yj, sj = fj(Hj, sj, jnp.asarray(x))
        yt, st = ft(Ht, st, torch.from_numpy(x))
        assert _err(yj, yt) <= TOL, blk
    for a, b in zip(sj, st):
        assert _err(a if form == "ri" else np.abs(a), b if form == "ri"
                    else b.abs()) <= TOL


def test_matrix_conv_design_from_numpy_and_nonpartitioned():
    rng = np.random.default_rng(2)
    H = _filters(rng, (2, 3, 100))
    mj = J.MatrixConv(hop=HOP, length_h=100, n_in=3, n_out=2,
                      partitioned=False)
    mt = T.MatrixConv(hop=HOP, length_h=100, n_in=3, n_out=2,
                      partitioned=False)
    Hj = mj.design(H)
    Ht = T.design_from_numpy(np.asarray(Hj), "cpu")
    assert torch.equal(Ht, mt.design(H, "cpu"))
    sj, st = mj.init_state(), mt.init_state(device="cpu")
    for blk, nh in enumerate((5, 1, 7)):
        x = _x(rng, (3, nh * HOP))
        if blk == 1:
            st = T.state_from_numpy(*_np(sj), device="cpu")
        yj, sj = jax.jit(mj.apply_block)(Hj, sj, jnp.asarray(x))
        yt, st = mt.apply_block(Ht, st, torch.from_numpy(x))
        assert _err(yj, yt) <= TOL, blk
        assert _err(sj.ola, st.ola) <= TOL, blk


@pytest.mark.parametrize("partitioned,form", [(True, "complex"), (True, "ri"),
                                              (False, "complex")])
def test_multi_conv_vs_jax(partitioned, form):
    rng = np.random.default_rng(3)
    H = _filters(rng, (3, 90))
    mj = J.MultiConv(hop=HOP, length_h=90, n_ch=3, partitioned=partitioned)
    mt = T.MultiConv(hop=HOP, length_h=90, n_ch=3, partitioned=partitioned)
    if form == "complex":
        Hj, Ht = mj.design(H), mt.design(H, "cpu")
        sj, st = mj.init_state(), mt.init_state(device="cpu")
        fj, ft = jax.jit(mj.apply_block), mt.apply_block
    else:
        Hj, Ht = mj.design_ri(H), mt.design_ri(H, "cpu")
        sj, st = mj.init_state_ri(), mt.init_state_ri(device="cpu")
        fj, ft = jax.jit(mj.apply_block_ri), mt.apply_block_ri
    for blk, nh in enumerate((4, 2, 5)):
        x = _x(rng, (3, nh * HOP))
        if blk == 1:
            st = T.state_from_numpy(*_np(sj), device="cpu")
        yj, sj = fj(Hj, sj, jnp.asarray(x))
        yt, st = ft(Ht, st, torch.from_numpy(x))
        assert _err(yj, yt) <= TOL, blk


# index streams per block (3 positions): moving every hop, static, one
# position repeated after a change (pos_last == pos_last2 paths)
_IDX = {"moving": [[0, 1, 2, 1], [2, 0, 0, 1], [1, 1, 2, 0]],
        "static": [[1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 1]],
        "repeated": [[0, 0, 2, 2], [2, 2, 2, 0], [0, 0, 0, 0]]}


@pytest.fixture(scope="module")
def tv():
    rng = np.random.default_rng(4)
    H = _filters(rng, (3, 2, 100))
    return (H, J.TVConv(hop=HOP, length_h=100, n_out=2, n_irs=3),
            T.TVConv(hop=HOP, length_h=100, n_out=2, n_irs=3))


def _tv_state(sj):
    return T.tv_state_from_numpy(*_np(sj), device="cpu")


@pytest.mark.parametrize("motion", sorted(_IDX))
@pytest.mark.parametrize("form", ["complex", "ri"])
@pytest.mark.parametrize("batch", [(), (8,)])
def test_tvconv_block_vs_jax(tv, motion, form, batch):
    H, cj, ct = tv
    rng = np.random.default_rng(5)
    if form == "complex":
        Hj, Ht = cj.design(H), ct.design(H, "cpu")
        sj, st = cj.init_state(1, batch), ct.init_state(1, batch, "cpu")
        fj, ft = jax.jit(cj.apply_block), ct.apply_block
    else:
        Hj, Ht = cj.design_ri(H), ct.design_ri(H, "cpu")
        sj, st = cj.init_state_ri(1, batch), ct.init_state_ri(1, batch, "cpu")
        fj, ft = jax.jit(cj.apply_block_ri), ct.apply_block_ri
    for blk, row in enumerate(_IDX[motion]):
        idx = np.broadcast_to(np.asarray(row, np.int32), batch + (4,))
        if batch:                        # instances on different streams
            idx = (idx + np.arange(8)[:, None]) % 3
        idx = np.array(idx, np.int32)
        x = _x(rng, batch + (4 * HOP,))
        if blk == 1:
            st = _tv_state(sj)
        yj, sj = fj(Hj, sj, jnp.asarray(x), jnp.asarray(idx))
        yt, st = ft(Ht, st, torch.from_numpy(x), torch.from_numpy(idx))
        assert _err(yj, yt) <= TOL, blk
        assert np.array_equal(np.asarray(sj.pos_last), st.pos_last.numpy())
        assert np.array_equal(np.asarray(sj.pos_last2), st.pos_last2.numpy())


@pytest.mark.parametrize("motion", sorted(_IDX))
@pytest.mark.parametrize("batch", [(), (8,)])
def test_tvconv_const_and_hop_vs_jax(tv, motion, batch):
    """apply_block_ri_const (one index a block, the example's path; nh = 1
    falls back to the per-hop path) and apply_hop / apply_hop_ri."""
    H, cj, ct = tv
    rng = np.random.default_rng(6)
    Hj, Ht = cj.design_ri(H), ct.design_ri(H, "cpu")
    sj, st = cj.init_state_ri(2, batch), ct.init_state_ri(2, batch, "cpu")
    for blk, (row, nh) in enumerate(zip(_IDX[motion], (4, 1, 3))):
        idx = np.full(batch, row[0], np.int32)
        if batch:
            idx = ((idx + np.arange(8)) % 3).astype(np.int32)
        x = _x(rng, batch + (nh * HOP,))
        if blk == 2:
            st = _tv_state(sj)
        yj, sj = jax.jit(cj.apply_block_ri_const)(Hj, sj, jnp.asarray(x),
                                                  jnp.asarray(idx))
        yt, st = ct.apply_block_ri_const(Ht, st, torch.from_numpy(x),
                                         torch.from_numpy(idx))
        assert _err(yj, yt) <= TOL, blk
    if batch:
        return
    Hc_j, Hc_t = cj.design(H), ct.design(H, "cpu")
    for fj, ft, Hj_, Ht_, init_j, init_t in (
            (cj.apply_hop, ct.apply_hop, Hc_j, Hc_t, cj.init_state,
             ct.init_state),
            (cj.apply_hop_ri, ct.apply_hop_ri, Hj, Ht, cj.init_state_ri,
             ct.init_state_ri)):
        sj, st = init_j(0), init_t(0, device="cpu")
        for k in _IDX[motion][0] + _IDX[motion][1]:
            x = _x(rng, (HOP,))
            yj, sj = jax.jit(fj)(Hj_, sj, jnp.asarray(x), jnp.int32(k))
            yt, st = ft(Ht_, st, torch.from_numpy(x),
                        torch.tensor(k, dtype=torch.int32))
            assert _err(yj, yt) <= TOL, k


def test_conv_examples_vs_jax():
    rng = np.random.default_rng(7)
    H = _filters(rng, (2, 3, 120))
    for part in (True, False):
        ej = JE.MatrixConvExample(hop=HOP, partitioned=part)
        et = TE.MatrixConvExample(hop=HOP, partitioned=part)
        cj, Hj = ej.design(H)
        ct, Ht = et.design(H, "cpu")
        x = _x(rng, (3, 4 * HOP))
        yj, _ = ej.process(cj, Hj, ej.init_state(cj), jnp.asarray(x))
        yt, _ = et.process(ct, Ht, et.init_state(ct, "cpu"),
                           torch.from_numpy(x))
        assert _err(yj, yt) <= TOL
        mj = JE.MultiConvExample(hop=HOP, partitioned=part)
        mt = TE.MultiConvExample(hop=HOP, partitioned=part)
        cj, Hj = mj.design(H[0])
        ct, Ht = mt.design(H[0], "cpu")
        yj, _ = mj.process(cj, Hj, mj.init_state(cj), jnp.asarray(x))
        yt, _ = mt.process(ct, Ht, mt.init_state(ct, "cpu"),
                           torch.from_numpy(x))
        assert _err(yj, yt) <= TOL
    ej, et = JE.MatrixConvExample(hop=HOP), TE.MatrixConvExample(hop=HOP)
    mj, mt = JE.MultiConvExample(hop=HOP), TE.MultiConvExample(hop=HOP)
    cj, Hj = ej.design_ri(H)
    ct, Ht = et.design_ri(H, "cpu")
    yj, _ = ej.process_ri(cj, Hj, ej.init_state_ri(cj), jnp.asarray(x))
    yt, _ = et.process_ri(ct, Ht, et.init_state_ri(ct, device="cpu"),
                          torch.from_numpy(x))
    assert _err(yj, yt) <= TOL
    cj, Hj = mj.design_ri(H[0])
    ct, Ht = mt.design_ri(H[0], "cpu")
    yj, _ = mj.process_ri(cj, Hj, mj.init_state_ri(cj), jnp.asarray(x))
    yt, _ = mt.process_ri(ct, Ht, mt.init_state_ri(ct, device="cpu"),
                          torch.from_numpy(x))
    assert _err(yj, yt) <= TOL


def test_tvconv_example_vs_jax():
    """A moving listener: the nearest position by argmin on the device,
    both forms; the (re, im) form at 8 moving instances too."""
    rng = np.random.default_rng(8)
    irs = _filters(rng, (5, 2, 100))
    pos = rng.uniform(0, 5, (5, 3)).astype(np.float32)
    ej, et = JE.TVConvExample(hop=HOP), TE.TVConvExample(hop=HOP)
    cj, Hj, pj = ej.design(irs, pos)
    ct, Ht, pt = et.design(irs, pos, "cpu")
    sj, st = ej.init_state(cj), et.init_state(ct, device="cpu")
    for k in range(3):
        x = _x(rng, (4 * HOP,))
        yj, sj = ej.process(cj, Hj, sj, jnp.asarray(x), jnp.asarray(pos[k]),
                            pj)
        yt, st = et.process(ct, Ht, st, torch.from_numpy(x),
                            torch.from_numpy(pos[k]), pt)
        assert _err(yj, yt) <= TOL, k
    cj, Hj, pj = ej.design_ri(irs, pos)
    ct, Ht, pt = et.design_ri(irs, pos, "cpu")
    for batch in ((), (8,)):
        sj = cj.init_state_ri(0, batch)
        st = et.init_state_ri(ct, 0, batch, "cpu")
        for k in range(3):
            lp = pos[(k + np.arange(8)) % 5] if batch else pos[k]
            lp = lp + 0.01
            idx_t = et.nearest_position(pt, torch.from_numpy(lp))
            assert np.array_equal(
                np.asarray(ej.nearest_position(pj, jnp.asarray(lp))),
                idx_t.numpy())
            x = _x(rng, batch + (4 * HOP,))
            yj, sj = ej.process_ri(cj, Hj, sj, jnp.asarray(x),
                                   jnp.asarray(lp), pj)
            yt, st = et.process_ri(ct, Ht, st, torch.from_numpy(x),
                                   torch.from_numpy(lp), pt)
            assert _err(yj, yt) <= TOL, (batch, k)
