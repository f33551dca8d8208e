"""modules/hades in the PyTorch port vs the JAX reference (CPU): the host
design (the port's own numpy copy), the two-stage HadesAnalysis.apply /
HadesSynthesis.apply (2 microphones: closed forms; 6: the generic eigh /
SVD chain), HadesPipeline.process, process_chunk, and
process_chunk_batched at 2 instances (the batched filterbank with its
kernels' plain versions, ``fused`` both ways), with the JAX state handed
across at a block boundary.

Tolerances: 2e-4 relative to max(1, |ref|) on audio and parameters (the
solve / CDF4SAP chains in float32 on both sides; the C's own chain moves
by 5e-4 for a one-ulp input change, tests/test_c_goldens.py); DoA indices
equal in every band whose diffuse covariance float32 can whiten
(condition number below 1e5: all but band 0 of the 2-mic design, whose
DC covariance has condition 2e6, so its noise eigenvector is rounding in
either implementation)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.modules import hades as J
from spatial_audio_framework_tpu.modules.hrir import default_hrirs
from spatial_audio_framework_tpu_torch.modules import hades as T

TOL = 2e-4
GOLDENS = "tests/goldens/c_goldens.npz"


def _err(ref, got):
    ref = np.asarray(ref)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(ref - got).max() / max(1.0, np.abs(ref).max()))


def _np(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(_np(t) for t in tree)
    return np.asarray(tree)


def _make(mics, beam=J.HADES_BEAMFORMER_BMVDR, interp="nearest"):
    if mics == 2:
        h, d, _ = default_hrirs()
        kw = dict(hop=128, h_array=h[::16], grid_dirs_deg=d[::16],
                  blocksize=512)
        skw = dict(ref_indices=(0, 1))
    else:
        g = np.load(GOLDENS)
        kw = dict(hop=64, h_array=np.asarray(g["hds_h_array"], np.float32),
                  grid_dirs_deg=np.asarray(g["hds_grid_dirs_deg"]),
                  blocksize=256, hybrid=False, low_delay=True)
        skw = dict(ref_indices=(1, 5))
    hr, hd, hfs = default_hrirs()
    skw.update(hrirs=hr[::4], hrir_dirs_deg=hd[::4], hrir_fs=hfs,
               beam_option=beam, interp_option=interp)
    aj = J.HadesAnalysis(**kw)
    at = T.HadesAnalysis(**kw, device="cpu")
    sj, st = J.HadesSynthesis(aj, **skw), T.HadesSynthesis(at, **skw)
    # the JAX design handed across (its float32 filterbank responses and
    # the eigendecompositions of near-singular diffuse covariances differ
    # from the port's own by ~1e-5 relative; the runs share one design)
    at.load_consts(aj.H_array, aj.T, aj.H_array_w)
    st.load_consts(sj.H_bin, sj.DCM_bin_norm, sj.diff_eq)
    return aj, sj, at, st


@pytest.fixture(scope="module")
def two_mic():
    return _make(2)


def _scene(rng, shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


def test_design_equals_jax():
    aj = J.HadesAnalysis(hop=128, h_array=default_hrirs()[0][::16],
                         grid_dirs_deg=default_hrirs()[1][::16])
    at = T.HadesAnalysis(hop=128, h_array=default_hrirs()[0][::16],
                         grid_dirs_deg=default_hrirs()[1][::16], device="cpu")
    sj = J.HadesSynthesis(aj, beam_option=J.HADES_BEAMFORMER_FILTER_AND_SUM)
    st = T.HadesSynthesis(at, beam_option=J.HADES_BEAMFORMER_FILTER_AND_SUM)
    # the port's own design: float32 filterbank responses, equal to float32
    # rounding (1e-5 of the scale); the whitening equal where float32 can resolve it (band 0's
    # diffuse covariance has condition 2e6, see the module docstring)
    ok = np.linalg.cond(aj.DCM) < 1e5
    for name in ("H_array", "DCM", "T", "H_array_w", "int_weights",
                 "freq_vector"):
        a, b = getattr(at, name), getattr(aj, name)
        if name in ("T", "H_array_w"):
            a, b = a[ok], b[ok]
        assert _err(b, a) <= 1e-5, name
    for name in ("H_bin", "diff_eq", "DCM_bin_norm"):
        assert _err(getattr(sj, name), getattr(st, name)) <= 1e-5, name
    assert at.cov_avg_coeff == aj.cov_avg_coeff
    assert st.syn_avg_coeff == sj.syn_avg_coeff
    assert T.comedie(np.ones(4)) == J.comedie(np.ones(4)) == 1.0
    lam = np.abs(np.random.default_rng(0).standard_normal((5, 4))).astype(
        np.float32)
    np.testing.assert_allclose(
        T.comedie_batch(torch.from_numpy(lam)).numpy(),
        np.asarray(J.comedie_batch(jnp.asarray(lam))), atol=1e-6)


@pytest.mark.parametrize("mics,beam,redit", [
    (2, J.HADES_BEAMFORMER_BMVDR, False),
    (2, J.HADES_BEAMFORMER_FILTER_AND_SUM, True),
    (6, J.HADES_BEAMFORMER_BMVDR, False),
    (6, J.HADES_BEAMFORMER_NONE, False)])
def test_two_stage_vs_jax(mics, beam, redit):
    aj, sj, at, st = _make(mics, beam)
    ej = J.HadesRadialEditor(aj.grid_dirs_deg)
    et = T.HadesRadialEditor(at.grid_dirs_deg)
    ramp = -70.0 + 0.45 * np.arange(360)
    rng = np.random.default_rng(mics)
    ok = np.linalg.cond(aj.DCM) < 1e5
    assert ok.sum() >= aj.n_bands - 1
    for blk in range(3):
        x = _scene(rng, (aj.n_mics, aj.blocksize))
        pj, gj = aj.apply(x)
        pt, gt = at.apply(x)
        assert np.array_equal(pj.doa_idx[ok], pt.doa_idx[ok]), blk
        assert _err(pj.diffuseness, pt.diffuseness) <= TOL, blk
        if redit:
            pj, pt = ej.apply(pj, ramp), et.apply(pt, ramp)
            assert np.array_equal(pj.gains_dir[ok], pt.gains_dir[ok])
        # both syntheses from the JAX parameters (the host container)
        pt = T.HadesParams(**{k: np.copy(v) for k, v in vars(pj).items()})
        assert _err(sj.apply(pj, gj), st.apply(pt, gt)) <= TOL, blk


def _state_from_jax(state):
    ab, cx, M, sb = _np(state)
    return T.HadesPipeline.state_from_numpy(ab, cx, M, sb, device="cpu")


def test_pipeline_process_and_chunk_vs_jax(two_mic):
    aj, sj, at, st = two_mic
    pj, pt = J.HadesPipeline(aj, sj), T.HadesPipeline(at, st)
    rng = np.random.default_rng(3)
    x = _scene(rng, (6, 2, aj.blocksize))
    sj_, st_ = pj.init_state(), pt.init_state()
    for blk in range(3):
        if blk == 1:
            st_ = _state_from_jax(sj_)
        yj, sj_ = pj.process(sj_, jnp.asarray(x[blk]))
        yt, st_ = pt.process(st_, torch.from_numpy(x[blk]))
        assert _err(yj, yt) <= TOL, blk
    # the chunk from the JAX state after the three blocks
    yj, cj = pj.process_chunk(sj_, jnp.asarray(x[3:]))
    yt, ct = pt.process_chunk(_state_from_jax(sj_), torch.from_numpy(x[3:]))
    assert yt.shape == (3, 2, aj.blocksize) and _err(yj, yt) <= TOL
    for a, b in zip(_np(cj)[1:3], (ct[1], ct[2])):
        assert all(_err(u, v) <= TOL for u, v in zip(a, b))
    st.eq[:] = 0.5          # a runtime edit reaches the next call
    sj.eq[:] = 0.5
    try:
        yj, _ = pj.process_chunk(cj, jnp.asarray(x[:2]))
        yt, _ = pt.process_chunk(ct, torch.from_numpy(x[:2]))
        assert _err(yj, yt) <= TOL
    finally:
        st.eq[:] = 1.0
        sj.eq[:] = 1.0


@pytest.mark.parametrize("fused", [True, False])
def test_pipeline_chunk_batched_vs_jax(two_mic, fused):
    """2 instances, 2 calls of 3 blocks, the JAX state handed across
    between them: its vmapped single-stream filterbank state becomes the
    batched filterbank's, the analysis tail from the last 15 hops of each
    instance's input."""
    aj, sj, at, st = two_mic
    pj, pt = J.HadesPipeline(aj, sj), T.HadesPipeline(at, st)
    rng = np.random.default_rng(4)
    N, NB = 2, 3
    xs = [_scene(rng, (N, NB, 2, aj.blocksize)) for _ in range(2)]
    sj_, st_ = pj.init_state_batched(N), pt.init_state_batched(N)
    for call, x in enumerate(xs):
        if call == 1:
            hist = xs[0].transpose(0, 2, 1, 3).reshape(N, 2, -1)
            hist = np.concatenate([np.zeros((N, 2, 15 * aj.hop), np.float32),
                                   hist], -1)
            ab, cx, M, sb = _np(sj_)
            st_ = T.HadesPipeline.state_batched_from_numpy(
                hist[..., -15 * aj.hop:], cx, M, sb[3], device="cpu")
        yj, sj_ = pj.process_chunk_batched(sj_, jnp.asarray(x))
        yt, st_ = pt.process_chunk_batched(st_, torch.from_numpy(x),
                                           fused=fused)
        assert yt.shape == (N, NB, 2, aj.blocksize)
        assert _err(yj, yt) <= TOL, call
    # each instance equals process_chunk on it alone
    y1, _ = pt.process_chunk(pt.init_state(), torch.from_numpy(xs[0][1]))
    yb, _ = pt.process_chunk_batched(pt.init_state_batched(N),
                                     torch.from_numpy(xs[0]), fused=fused)
    assert _err(y1.numpy(), yb[1]) <= 1e-5
