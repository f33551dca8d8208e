"""roombinauraliser in the PyTorch port vs the JAX package on the CPU: the
design in its three diffuse-field-EQ modes, on 3-D and 2-D (one elevation)
BRIR grids and at another BRIR sample rate; the lookup direction; the BRTF
interpolation in both modes on both grids, at edge, NaN and out-of-table
directions; and the batched render over three chunks with state carried on
both routes (≤ 16 sources: the one-pass kernel's plain version with
per-stream taps; more: the (d, g) pair's).  Every source has its own BRIR
set (the default HRIR set, its directions rolled by a per-source shift, its
ears scaled apart), so a swapped source or ear axis cannot pass.  The JAX
side runs its Pallas kernels in interpret mode.

Run alone with ``python -m pytest -q tests/test_torch_roombinauraliser.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import roombinauraliser as jrb
from spatial_audio_framework_tpu.ops import precision as jprec
from spatial_audio_framework_tpu_torch.models import roombinauraliser as trb
from spatial_audio_framework_tpu_torch.modules import hrir as thrir

DESIGN_TOL = 1e-6   # host numpy on both sides; relative to a table's peak
INTERP_TOL = 2e-6   # f32 gathers and sums of three products, |H| up to ~3
# time-domain outputs: fp32 on both sides, the JAX side through its Pallas
# kernels in interpret mode at exact fp32
RENDER_TOL = 2e-5
MODES = [jrb.INTERP_TRI, jrb.INTERP_TRI_PS]
GRIDS = ["3d", "2d"]


@functools.lru_cache(maxsize=None)
def _brirs(grid, n_src):
    """(brirs (nSrc, nDirs, 2, 256), dirs_deg, fs): per source the default
    HRIR subset rolled along its directions by 7·(s+1), the right ear
    scaled by 1 − 0.1·(s+1).  "3d": every 8th direction of the default
    grid (105); "2d": 24 of them placed on a ring at elevation 10°."""
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
def _jax_design(grid, mode, n_src, eq=jrb.DIFF_EQ_BRIR_CTF):
    cfg = jrb.RoomBinauraliserConfig(n_sources=n_src, interp_mode=mode,
                                     diff_eq_mode=eq)
    cfg, w = jrb.design_ri(cfg, *_brirs(grid, n_src))
    return cfg.vbap_3d, tuple(np.asarray(a) for a in w)


def _both(grid, mode, n_src, **kw):
    """(JAX cfg, JAX weights, port cfg, the port's weights made from the
    JAX design), vbap_3d resolved."""
    vbap_3d, ref = _jax_design(grid, mode, n_src)
    kw = dict(n_sources=n_src, interp_mode=mode, vbap_3d=vbap_3d, **kw)
    return (jrb.RoomBinauraliserConfig(**kw),
            jrb.RoomBinauraliserWeightsRI(*(jnp.asarray(a) for a in ref)),
            trb.RoomBinauraliserConfig(**kw),
            trb.weights_from_numpy(*ref, device="cpu"))


@pytest.fixture
def exact_jax():
    """The JAX package's process-default matmul mode at exact fp32 for the
    test's duration (its default is the TPU's bf16 f32x3 split)."""
    old = jprec.hot_mode()
    jprec.set_hot_precision("highest")
    yield
    jprec.set_hot_precision(old)


def _assert_weights(ref, got, n_src, n_dirs):
    assert got._fields == jrb.RoomBinauraliserWeightsRI._fields
    assert tuple(got.hrtf_re.shape) == (n_src, 133, 2, n_dirs)
    assert tuple(got.itds.shape) == (n_src, n_dirs)
    for name, a, b in zip(got._fields, ref, got):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, name
        if name == "table_idx":
            assert b.dtype == torch.int64
            np.testing.assert_array_equal(b.numpy(), a)
            continue
        assert b.dtype == torch.float32, name
        peak = max(1.0, float(np.abs(a).max()))
        assert np.abs(a - b.numpy()).max() <= DESIGN_TOL * peak, name


@pytest.mark.parametrize("eq", [jrb.DIFF_EQ_FABIAN_CTF, jrb.DIFF_EQ_BRIR_CTF,
                                jrb.DIFF_EQ_OWN_FILTER, None])
@pytest.mark.parametrize("grid", GRIDS)
def test_design_ri_vs_jax(grid, eq):
    brirs, dirs, fs = _brirs(grid, 3)
    own = (np.random.default_rng(0).standard_normal(64) * 0.2
           if eq == jrb.DIFF_EQ_OWN_FILTER else None)
    kw = dict(n_sources=3, enable_hrir_diff_eq=eq is not None,
              diff_eq_mode=eq or jrb.DIFF_EQ_BRIR_CTF)
    jcfg, ref = jrb.design_ri(jrb.RoomBinauraliserConfig(**kw), brirs, dirs,
                              fs, own)
    tcfg, got = trb.design_ri(trb.RoomBinauraliserConfig(**kw), brirs, dirs,
                              fs, own, device="cpu")
    assert tcfg.vbap_3d == jcfg.vbap_3d == (grid == "3d")
    assert tcfg == trb.RoomBinauraliserConfig(**kw, vbap_3d=grid == "3d")
    _assert_weights(ref, got, 3, len(dirs))
    n_azi = 181
    assert got.table_w.shape[0] == (n_azi * 37 if grid == "3d" else n_azi)
    # each source kept its own set
    assert not torch.equal(got.hrtf_re[0], got.hrtf_re[1])
    assert not torch.equal(got.itds[0], got.itds[2])


def test_design_ri_default_set_and_unknown_mode():
    """No BRIRs: the default HRIR set for every source, as the JAX package;
    an unknown EQ mode raises; a wrong number of sets raises."""
    jcfg, ref = jrb.design_ri(jrb.RoomBinauraliserConfig(
        n_sources=2, diff_eq_mode=jrb.DIFF_EQ_FABIAN_CTF))
    tcfg, got = trb.design_ri(trb.RoomBinauraliserConfig(
        n_sources=2, diff_eq_mode=trb.DIFF_EQ_FABIAN_CTF), device="cpu")
    assert tcfg.vbap_3d and jcfg.vbap_3d
    _assert_weights(ref, got, 2, 836)
    assert torch.equal(got.hrtf_re[0], got.hrtf_re[1])
    np.testing.assert_array_equal(trb.fabian_ctf_ir(), jrb.fabian_ctf_ir())
    brirs, dirs, fs = _brirs("2d", 2)
    with pytest.raises(ValueError, match="diff_eq_mode"):
        trb.design_ri(trb.RoomBinauraliserConfig(
            n_sources=2, diff_eq_mode="nope"), brirs, dirs, fs, device="cpu")
    with pytest.raises(ValueError, match="BRIR sets"):
        trb.design_ri(trb.RoomBinauraliserConfig(n_sources=3), brirs, dirs,
                      fs, device="cpu")


def test_design_ri_at_another_brir_rate_vs_jax():
    """BRIRs at 44.1 kHz under a 48 kHz configuration: ITDs from the
    1000-tap truncations before resampling, then the speex resampler.
    Bands above 21 kHz lie in the resampler's transition and stop band:
    float32 noise of the filterbank analysis that the diffuse-field EQ
    amplifies, so there the packages agree to 1e-3 only."""
    brirs, dirs, _ = _brirs("2d", 2)
    long = np.zeros(brirs.shape[:-1] + (1100,), np.float32)
    long[..., :256] = brirs
    long[..., 1050] = 0.5            # past the ITD truncation
    jcfg, ref = jrb.design_ri(jrb.RoomBinauraliserConfig(n_sources=2), long,
                              dirs, 44100)
    tcfg, got = trb.design_ri(trb.RoomBinauraliserConfig(n_sources=2), long,
                              dirs, 44100, device="cpu")
    np.testing.assert_array_equal(got.itds.numpy(), np.asarray(ref.itds))
    passband = np.asarray(ref.freqs) < 21000.0
    for name in ("hrtf_re", "hrtf_im", "hrtf_mag"):
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        peak = max(1.0, np.abs(a).max())
        assert np.abs(a - b)[:, passband].max() <= 2e-6 * peak, name
        assert np.abs(a - b)[:, ~passband].max() <= 1e-3 * peak, name


def test_rotation_lookup_dir_vs_jax():
    rng = np.random.default_rng(1)
    ypr = rng.uniform(-np.pi, np.pi, (9, 3)).astype(np.float32)
    ypr[0] = 0.0
    ypr[1] = np.deg2rad([40.0, -15.0, 10.0])
    ref = jax.vmap(jrb.rotation_lookup_dir)(jnp.asarray(ypr))
    got = trb.rotation_lookup_dir(torch.from_numpy(ypr))
    assert tuple(got.shape) == (9, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    assert not got[0].any()
    one = trb.rotation_lookup_dir(torch.from_numpy(ypr[1]))
    assert torch.equal(one, got[1])


# lookup directions (azimuth, elevation): poles, the ±180° seam, half-step
# rows and columns (round half up), azimuths outside [-180, 180]
_EDGE_DIRS = np.array([
    [0.0, 0.0], [180.0, 90.0], [-180.0, -90.0], [179.9, 0.0], [-179.0, -87.5],
    [1.0, 2.5], [359.0, 45.0], [-541.0, -45.0], [720.5, 12.5], [-45.0, 10.0]],
    np.float32)

# as tests/test_torch_host_faults.py
_BAD_DIRS = {
    "elevation 95": [10.0, 95.0],
    "elevation -100": [10.0, -100.0],
    "NaN azimuth": [np.nan, 10.0],
    "NaN elevation": [10.0, np.nan],
    "elevation 1e9": [10.0, 1e9],
    "infinite azimuth": [np.inf, 3.0],
}


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("mode", MODES)
def test_interp_hrtfs_ri_vs_jax(mode, grid):
    jcfg, jw, tcfg, tw = _both(grid, mode, 3)
    assert tcfg.vbap_3d == (grid == "3d")
    ref = jax.vmap(lambda r: jrb.interp_hrtfs_ri(jcfg, jw, r))(
        jnp.asarray(_EDGE_DIRS))
    got = trb.interp_hrtfs_ri(tcfg, tw, torch.from_numpy(_EDGE_DIRS))
    for a, b in zip(ref, got):
        assert tuple(b.shape) == (len(_EDGE_DIRS), 3, 133, 2)
        assert bool(torch.isfinite(b).all())
        assert np.abs(np.asarray(a) - b.numpy()).max() <= INTERP_TOL
    # one direction, as the JAX function takes it
    one = trb.interp_hrtfs_ri(tcfg, tw, torch.from_numpy(_EDGE_DIRS[4]))
    assert tuple(one[0].shape) == (3, 133, 2)
    assert torch.equal(one[0], got[0][4]) and torch.equal(one[1], got[1][4])
    # the sources differ, and so do the ears
    assert (got[0][0, 0] - got[0][0, 1]).abs().max() > 1e-3
    assert (got[0][0, ..., 0] - got[0][0, ..., 1]).abs().max() > 1e-3


@pytest.mark.parametrize("case", list(_BAD_DIRS))
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("mode", MODES)
def test_interp_hrtfs_ri_bad_directions_vs_jax(mode, grid, case):
    """NaN, infinite and out-of-table lookup directions raise nothing and
    give the JAX package's BRTFs: NaN where its take fills (past a 3-D
    table), finite elsewhere; the 2-D table ignores the elevation."""
    jcfg, jw, tcfg, tw = _both(grid, mode, 3)
    d = np.asarray(_BAD_DIRS[case], np.float32)
    ref = jrb.interp_hrtfs_ri(jcfg, jw, jnp.asarray(d))
    got = trb.interp_hrtfs_ri(tcfg, tw, torch.from_numpy(d))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=INTERP_TOL, equal_nan=True)
    nan = bool(torch.isnan(got[0]).all())
    assert nan == (grid == "3d" and case in ("elevation 95", "elevation 1e9"))
    assert nan or bool(torch.isfinite(got[0]).all())


def _stream_inputs(rng, S, n_src):
    """Per-stream yaw/pitch/roll (stream 0 unrotated), per-source gains
    and chunks of 4, 4 and 2 hops (H < 9 and H < 15)."""
    ypr = rng.uniform(-1, 1, (S, 3))
    ypr[0] = 0.0
    gains = rng.uniform(0.5, 1.5, (S, n_src))
    xs = [rng.uniform(-1, 1, (S, n_src, h * 128)) for h in (4, 4, 2)]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(ypr), f32(gains), [f32(x) for x in xs]


@pytest.mark.parametrize("grid,n_src,mode,rotate", [
    ("3d", 3, jrb.INTERP_TRI, True), ("3d", 3, jrb.INTERP_TRI_PS, True),
    ("2d", 3, jrb.INTERP_TRI, True), ("2d", 3, jrb.INTERP_TRI_PS, False),
    ("3d", 17, jrb.INTERP_TRI, True), ("2d", 17, jrb.INTERP_TRI_PS, True),
    ("3d", 3, jrb.INTERP_TRI, False)])
def test_process_ri_batched_vs_jax(exact_jax, grid, n_src, mode, rotate):
    """Three streams, gains on, three chunks with state carried.  3 sources
    take the one-pass kernel, 17 the (d, g) pair, both with per-stream
    taps.  ``rotate`` False: ypr is passed but not applied, the lookup
    direction is (0, 0)."""
    S = 3
    jcfg, jw, tcfg, tw = _both(grid, mode, n_src, enable_rotation=rotate)
    ypr, gains, xs = _stream_inputs(np.random.default_rng(n_src), S, n_src)
    jst = jrb.init_state_batched(jcfg, S)
    tst = trb.init_state_batched(tcfg, S, device="cpu")
    for x in xs:
        jy, jst = jrb.process_ri_batched(
            jcfg, jw, jst, jnp.asarray(x), jnp.asarray(gains),
            jnp.asarray(ypr), use_pallas=True, interpret=True)
        ty, tst = trb.process_ri_batched(
            tcfg, tw, tst, torch.from_numpy(x), torch.from_numpy(gains),
            torch.from_numpy(ypr))
        assert tuple(ty.shape) == (S, 2, x.shape[-1])
        assert bool(torch.isfinite(ty).all())
        assert np.abs(np.asarray(jy) - ty.numpy()).max() <= RENDER_TOL
    assert np.abs(np.asarray(jst.ola_tail)
                  - tst.ola_tail.numpy()).max() <= RENDER_TOL
    np.testing.assert_array_equal(np.asarray(jst.in_tail),
                                  tst.in_tail.numpy())


@pytest.mark.parametrize("n_src", [2, 17])
def test_fused_path_vs_plain_path(n_src):
    """The port's kernel route vs its einsum reference path from a random
    non-zero state (state_from_numpy), rotation on, no gains."""
    rng = np.random.default_rng(50 + n_src)
    _, _, cfg, w = _both("3d", jrb.INTERP_TRI, n_src)
    ypr, _, xs = _stream_inputs(rng, 2, n_src)
    st0 = trb.state_from_numpy(rng.uniform(-1, 1, (2, n_src, 15 * 128)),
                               rng.uniform(-1, 1, (2, 2, 9 * 128)), "cpu")
    outs = []
    for fused in (True, False):
        st, ys = st0, []
        for x in xs:
            y, st = trb.process_ri_batched(cfg, w, st, torch.from_numpy(x),
                                           ypr=torch.from_numpy(ypr),
                                           fused=fused)
            ys.append(y.numpy())
        outs.append((ys, st))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert np.abs(a - b).max() <= RENDER_TOL
    assert torch.equal(outs[0][1].in_tail, outs[1][1].in_tail)
    assert (outs[0][1].ola_tail - outs[1][1].ola_tail).abs().max() <= RENDER_TOL


def test_no_rotation_looks_up_the_front():
    """ypr None, and rotation disabled with a ypr given, both render at
    the lookup direction (0, 0): equal to a zero rotation."""
    rng = np.random.default_rng(3)
    _, _, cfg, w = _both("3d", jrb.INTERP_TRI, 3)
    ypr, _, xs = _stream_inputs(rng, 2, 3)
    x = torch.from_numpy(np.concatenate(xs + xs, -1))
    st = trb.init_state_batched(cfg, 2, device="cpu")
    y_none, _ = trb.process_ri_batched(cfg, w, st, x)
    y_zero, _ = trb.process_ri_batched(cfg, w, st, x, ypr=torch.zeros(2, 3))
    off = trb.RoomBinauraliserConfig(n_sources=3, enable_rotation=False)
    y_off, _ = trb.process_ri_batched(off, w, st, x,
                                      ypr=torch.from_numpy(ypr) + 0.5)
    assert torch.equal(y_none, y_zero) and torch.equal(y_none, y_off)
    y_rot, _ = trb.process_ri_batched(cfg, w, st, x,
                                      ypr=torch.from_numpy(ypr) + 0.5)
    assert (y_rot - y_none).abs().max() > 1e-2


def test_solo_and_mute_gains_vs_jax():
    np.testing.assert_array_equal(trb.solo_gains(4, None),
                                  jrb.solo_gains(4, None))
    np.testing.assert_array_equal(trb.solo_gains(4, 2), jrb.solo_gains(4, 2))
    g = trb.solo_gains(4, None)
    np.testing.assert_array_equal(trb.mute_gains(g, 1, True),
                                  jrb.mute_gains(g, 1, True))
    m = trb.mute_gains(g, 1, True)
    np.testing.assert_array_equal(trb.mute_gains(m, 1, False), g)
    assert g[1] == 1.0 and m.dtype == np.float32     # the input is not edited
    # a soloed source renders alone
    rng = np.random.default_rng(4)
    _, _, cfg, w = _both("2d", jrb.INTERP_TRI, 3)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 2560)).astype(np.float32))
    st = trb.init_state_batched(cfg, 1, device="cpu")
    solo = torch.from_numpy(trb.solo_gains(3, 1))[None]
    y_solo, _ = trb.process_ri_batched(cfg, w, st, x, solo)
    x1 = x.clone()
    x1[:, [0, 2]] = 0.0
    y_one, _ = trb.process_ri_batched(cfg, w, st, x1)
    assert torch.equal(y_solo, y_one) and float(y_one.abs().max()) > 1e-2


@pytest.mark.parametrize("entry", ["design", "init_state", "process"])
def test_single_stream_entry_points_are_not_ported(entry):
    """They are ported now (the test keeps its name): each entry point has
    the JAX function's parameters, in order, plus ``device``, and no module
    carries the old message.  ``tests/test_torch_single_stream.py`` holds
    their outputs against the JAX package."""
    import inspect

    ref = [p for p in inspect.signature(getattr(jrb, entry)).parameters
           if not p.startswith("_")]
    got = [p for p in inspect.signature(getattr(trb, entry)).parameters
           if p != "device"]
    assert got == ref
    assert not hasattr(trb, "_SINGLE_STREAM")
