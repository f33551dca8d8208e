"""powermap in the PyTorch port vs the JAX reference (CPU), in all seven
modes: the design, the single-instance ``analysis``, the n-instance
``analysis_batched`` (the batched filterbank, its front kernel's plain
version on CPU tensors; the JAX side with its plain front, as off the TPU)
and ``analysis_chunks`` (single and batched), with the JAX state handed
across at a block boundary (``state_from_numpy``).  The scenes are two
planted plane waves in diffuse noise, so the MUSIC / MinNorm subspace split
is well conditioned; the analysis grid is the coarse t-design the JAX
tests use.

Tolerances: the [0, 1]-normalised display maps 1e-4 absolute (the JAX
package's own batched-vs-sequential check holds 5e-4,
tests/test_batched_native.py): float32 SCMs, then a solve or an eigh of
each grouped covariance in LAPACK on both sides through different drivers;
the SCM state 1e-5 of its largest entry; the design exactly (the same
numpy code, cast to float32 on both sides)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import powermap as J
from spatial_audio_framework_tpu.modules import sh as jsh
from spatial_audio_framework_tpu_torch.models import powermap as T

MAP_TOL = 1e-4
MODES = [T.PM_PWD, T.PM_MVDR, T.PM_CROPAC, T.PM_MUSIC, T.PM_MUSIC_LOG,
         T.PM_MINNORM, T.PM_MINNORM_LOG]


def _cfgs(**kw):
    base = dict(master_order=2, n_sources=2, norm="n3d",
                analysis_grid="tdesign", grid_tdesign=10, interp_res_deg=15)
    base.update(kw)
    return J.PowermapConfig(**base), T.PowermapConfig(**base)


def _scene(rng, shape_lead, order, T_len):
    """Two plane waves (random directions per instance) in -20 dB diffuse
    noise, N3D SH: (*shape_lead, nSH, T)."""
    nsh = (order + 1) ** 2
    n = int(np.prod(shape_lead)) if shape_lead else 1
    out = np.empty((n, nsh, T_len), np.float32)
    for i in range(n):
        dirs = np.stack([rng.uniform(-180, 180, 2), rng.uniform(-60, 60, 2)],
                        -1)
        Y = jsh.get_rsh(order, dirs)                      # (nSH, 2)
        s = rng.standard_normal((2, T_len))
        out[i] = Y @ s + 0.1 * rng.standard_normal((nsh, T_len))
    return out.reshape(tuple(shape_lead) + (nsh, T_len))


def _err(a, b):
    return float(np.abs(np.asarray(a) - b.numpy()).max())


def _rel(a, b):
    a = np.asarray(a)
    return float(np.abs(a - b.numpy()).max() / max(np.abs(a).max(), 1e-30))


def _hand_over(sj):
    bank = tuple(np.asarray(a) for a in sj.bank)
    return T.state_from_numpy(bank, np.asarray(sj.Cx_re), np.asarray(sj.Cx_im),
                              np.asarray(sj.prev_pmap), device="cpu")


def test_design_equals_jax():
    """The reference's 812-point geosphere grid and 5° display table, and a
    per-band order vector."""
    for kw in (dict(master_order=3, mode=T.PM_MUSIC, norm="n3d"),
               dict(master_order=3, analysis_grid="tdesign", grid_tdesign=10,
                    analysis_order_per_band=tuple([1] * 60 + [2] * 40
                                                  + [3] * 33))):
        jc, tc = J.PowermapConfig(**kw), T.PowermapConfig(**kw)
        wj, wt = J.design(jc), T.design(tc, device="cpu")
        for name in ("Y_grid", "interp_table", "conv_in", "band_mask"):
            assert np.array_equal(np.asarray(getattr(wj, name)),
                                  getattr(wt, name).numpy()), name
        assert np.array_equal(wj.grid_dirs_deg, wt.grid_dirs_deg)
        assert np.array_equal(wj.interp_dirs_deg, wt.interp_dirs_deg)


@pytest.mark.parametrize("mode", MODES)
def test_analysis_vs_jax(mode):
    jc, tc = _cfgs(mode=mode)
    wj, wt = J.design(jc), T.design(tc, device="cpu")
    rng = np.random.default_rng(MODES.index(mode))
    sj, st = J.init_state(jc, wj), T.init_state(tc, wt, device="cpu")
    eq = np.linspace(0.0, 2.5, 133).astype(np.float32)
    for blk in range(3):
        x = _scene(rng, (), 2, 512)
        if blk == 1:
            st = _hand_over(sj)
        e = None if blk < 2 else eq
        pj, sj = J.analysis(jc, wj, sj, jnp.asarray(x),
                            None if e is None else jnp.asarray(e))
        pt, st = T.analysis(tc, wt, st, torch.from_numpy(x),
                            None if e is None else torch.from_numpy(e))
        assert pt.shape == (wt.interp_table.shape[0],)
        assert _err(pj, pt) <= MAP_TOL, blk
        assert _rel(sj.Cx_re, st.Cx_re) <= 1e-5
        assert _rel(sj.Cx_im, st.Cx_im) <= 1e-5


@pytest.mark.parametrize("mode", [T.PM_MUSIC, T.PM_MVDR, T.PM_CROPAC,
                                  T.PM_MINNORM])
def test_analysis_batched_and_chunks_vs_jax(mode):
    jc, tc = _cfgs(mode=mode)
    wj, wt = J.design(jc), T.design(tc, device="cpu")
    rng = np.random.default_rng(11)
    n = 3
    sj = J.init_state_batched(jc, wj, n)
    st = T.init_state_batched(tc, wt, n, device="cpu")
    for blk in range(2):
        x = _scene(rng, (n,), 2, 512)
        if blk == 1:
            st = _hand_over(sj)
        pj, sj = J.analysis_batched(jc, wj, sj, jnp.asarray(x))
        pt, st = T.analysis_batched(tc, wt, st, torch.from_numpy(x))
        assert pt.shape == (n, wt.interp_table.shape[0])
        assert _err(pj, pt) <= MAP_TOL, blk
    # K chunks in one call with the map hoisted out of the chunk loop
    xs = _scene(rng, (3, n), 2, 256)
    pj, sj2 = J.analysis_chunks(jc, wj, sj, jnp.asarray(xs))
    pt, st2 = T.analysis_chunks(tc, wt, st, torch.from_numpy(xs))
    assert pt.shape == (3, n, wt.interp_table.shape[0])
    assert _err(pj, pt) <= MAP_TOL
    assert _rel(sj2.Cx_re, st2.Cx_re) <= 1e-5
    assert _rel(sj2.prev_pmap, st2.prev_pmap) <= MAP_TOL
    # the kernel's plain version (fused, on CPU tensors) and the plain
    # filterbank compute the same front
    p1, _ = T.analysis_chunks(tc, wt, st, torch.from_numpy(xs), fused=True)
    p2, _ = T.analysis_chunks(tc, wt, st, torch.from_numpy(xs), fused=False)
    assert float((p1 - p2).abs().max()) <= MAP_TOL


def test_single_instance_chunks_vs_jax_and_sequential():
    """analysis_chunks on one instance equals the JAX package's and K
    calls of ``analysis`` (the same eigh on the same matrices)."""
    jc, tc = _cfgs(mode=T.PM_MUSIC_LOG)
    wj, wt = J.design(jc), T.design(tc, device="cpu")
    rng = np.random.default_rng(5)
    xs = _scene(rng, (4,), 2, 256)
    pj, _ = J.analysis_chunks(jc, wj, J.init_state(jc, wj), jnp.asarray(xs))
    pt, st = T.analysis_chunks(tc, wt, T.init_state(tc, wt, device="cpu"),
                               torch.from_numpy(xs))
    assert pt.shape == (4, wt.interp_table.shape[0])
    assert _err(pj, pt) <= MAP_TOL
    ss = T.init_state(tc, wt, device="cpu")
    for k in range(4):
        p, ss = T.analysis(tc, wt, ss, torch.from_numpy(xs[k]))
        assert float((p - pt[k]).abs().max()) <= MAP_TOL
    assert float((ss.Cx_re - st.Cx_re).abs().max()) \
        <= 1e-5 * float(st.Cx_re.abs().max())


def test_silent_scene_gives_a_zero_map():
    """The trace guard (powermap.c:295-343): no energy, no map."""
    _, tc = _cfgs(mode=T.PM_MUSIC)
    wt = T.design(tc, device="cpu")
    st = T.init_state_batched(tc, wt, 2, device="cpu")
    p, st = T.analysis_batched(tc, wt, st, torch.zeros((2, 9, 256)))
    assert float(p.abs().max()) == 0.0 and float(st.prev_pmap.abs().max()) == 0
