"""panner in the PyTorch port vs the JAX package on the CPU: the design (3-D
table with dummies for 7.1.4, 2-D pairwise table for a planar 5.0 ring), the
table lookup at edge, NaN and out-of-table directions, and the batched
render over three chunks with state carried, with and without rotation,
on both routes (the JAX side runs its Pallas kernel in interpret mode).
Coarse tables (5° × 5°) keep the designs short.

Run alone with ``python -m pytest -q tests/test_torch_panner.py``."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import panner as jpan
from spatial_audio_framework_tpu.ops import precision as jprec
from spatial_audio_framework_tpu_torch.models import panner as tpan

LOOKUP_TOL = 1e-7   # the same float32 table rows
# time-domain outputs: fp32 on both sides, the JAX side through its Pallas
# kernel in interpret mode at exact fp32 (observed 2e-6)
RENDER_TOL = 1e-5
RES = 5

LAYOUTS = {
    "5.0": np.array([[30, 0], [-30, 0], [0, 0], [110, 0], [-110, 0]],
                    np.float64),
    "7.1.4": np.array(
        [[30, 0], [-30, 0], [0, 0], [90, 0], [-90, 0], [135, 0], [-135, 0],
         [45, 45], [-45, 45], [135, 45], [-135, 45]], np.float64),
}


def _cfgs(layout, n_src=3, **kw):
    kw = dict(n_sources=n_src, n_loudspeakers=len(LAYOUTS[layout]),
              azi_res=RES, elev_res=RES, **kw)
    return jpan.PannerConfig(**kw), tpan.PannerConfig(**kw)


@functools.lru_cache(maxsize=None)
def _jax_design(layout):
    w = jpan.design(_cfgs(layout)[0], LAYOUTS[layout])
    return tuple(np.asarray(a) for a in w)


def _weights(layout):
    """(JAX weights, the port's made from them), so both see one table."""
    ref = _jax_design(layout)
    return (jpan.PannerWeights(*(jnp.asarray(a) for a in ref)),
            tpan.weights_from_numpy(*ref, device="cpu"))


@pytest.fixture
def exact_jax():
    """The JAX package's process-default matmul mode at exact fp32 for the
    test's duration (its default is the TPU's bf16 f32x3 split)."""
    old = jprec.hot_mode()
    jprec.set_hot_precision("highest")
    yield
    jprec.set_hot_precision(old)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_design_vs_jax(layout):
    ref = _jax_design(layout)
    got = tpan.design(_cfgs(layout)[1], LAYOUTS[layout], device="cpu")
    assert got._fields == jpan.PannerWeights._fields
    n_azi = 360 // RES + 1
    rows = n_azi if layout == "5.0" else n_azi * (180 // RES + 1)
    assert tuple(got.gtable.shape) == (rows, len(LAYOUTS[layout]))
    for a, b in zip(ref, got):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), a)


def test_design_with_spread_and_dtt_vs_jax():
    jcfg, tcfg = _cfgs("7.1.4", spread_deg=20.0, dtt=0.9)
    ref = jpan.design(jcfg, LAYOUTS["7.1.4"])
    got = tpan.design(tcfg, LAYOUTS["7.1.4"], device="cpu")
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-7)


# (azimuth, elevation): both poles (the bottom one lies in the dummy
# loudspeaker's triangles: every gain zero), the ±180° seam, half-step rows
# and columns (round half up), azimuths outside [-180, 180]
_EDGE_DIRS = np.array([
    [180.0, 90.0], [-180.0, -90.0], [180.0, -90.0], [-180.0, 90.0],
    [179.9, 0.0], [-179.9, 0.0], [-177.5, -87.5], [2.5, 2.5],
    [0.0, 89.9], [359.0, 45.0], [-541.0, -45.0], [722.5, 12.5],
    [30.0, 0.0], [-45.0, 20.0]], np.float32)

# as tests/test_torch_host_faults.py: rows past the table's end or, at an
# elevation of -inf, before its start (NaN gains, jnp.take's fill), a
# negative row (counted from the table's end), NaN directions and an
# infinite azimuth (row 0)
_BAD_DIRS = {
    "elevation 95": [10.0, 95.0],
    "elevation -100": [10.0, -100.0],
    "NaN azimuth": [np.nan, 10.0],
    "NaN elevation": [10.0, np.nan],
    "elevation 1e9": [10.0, 1e9],
    "infinite azimuth": [np.inf, 3.0],
    "infinite elevation": [10.0, -np.inf],
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_table_lookup_edge_directions_vs_jax(layout):
    jcfg, tcfg = _cfgs(layout)
    jw, tw = _weights(layout)
    ref = np.asarray(jpan._table_lookup(jcfg, jw.gtable,
                                        jnp.asarray(_EDGE_DIRS)))
    got = tpan._table_lookup(tcfg, tw.gtable, torch.from_numpy(_EDGE_DIRS))
    assert tuple(got.shape) == (len(_EDGE_DIRS), len(LAYOUTS[layout]))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=LOOKUP_TOL)
    if layout == "7.1.4":
        assert got[1:3].abs().max() <= 1e-12             # the bottom pole
    # batched over streams: the same rows per stream
    two = torch.from_numpy(np.stack([_EDGE_DIRS, _EDGE_DIRS[::-1]]))
    both = tpan._table_lookup(tcfg, tw.gtable, two)
    assert torch.equal(both[0], got) and torch.equal(both[1], got.flip(0))


@pytest.mark.parametrize("case", list(_BAD_DIRS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_table_lookup_bad_directions_vs_jax(layout, case):
    """NaN, infinite and out-of-table directions raise nothing and give the
    JAX package's gains: NaN exactly where it fills, finite elsewhere.  The
    2-D table ignores the elevation."""
    jcfg, tcfg = _cfgs(layout)
    jw, tw = _weights(layout)
    dirs = np.array([_BAD_DIRS[case], [30.0, 0.0]], np.float32)
    ref = np.asarray(jpan._table_lookup(jcfg, jw.gtable, jnp.asarray(dirs)))
    got = tpan._table_lookup(tcfg, tw.gtable, torch.from_numpy(dirs))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=LOOKUP_TOL,
                               equal_nan=True)
    assert bool(torch.isfinite(got[1]).all())
    past_the_table = layout == "7.1.4" and case in (
        "elevation 95", "elevation 1e9", "infinite elevation")
    assert bool(torch.isnan(got[0]).all()) == past_the_table
    if layout == "5.0" and "azimuth" not in case:
        assert torch.equal(got[0], tw.gtable[(10 + 180) // RES])


def _stream_inputs(rng, S, n_src):
    """Per-(stream, source) directions with edges of _EDGE_DIRS in stream
    0, per-stream yaw/pitch/roll, and chunks of 4, 4 and 2 hops (H < 9 and
    H < 15)."""
    dirs = np.concatenate([rng.uniform(-180, 180, (S, n_src, 1)),
                           rng.uniform(-90, 90, (S, n_src, 1))], -1)
    dirs[0, :min(n_src, 3)] = _EDGE_DIRS[[1, 7, 9]][:min(n_src, 3)]
    ypr = rng.uniform(-1, 1, (S, 3))
    xs = [rng.uniform(-1, 1, (S, n_src, h * 128)) for h in (4, 4, 2)]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(dirs), f32(ypr), [f32(x) for x in xs]


@pytest.mark.parametrize("rotate", [False, True], ids=["fixed", "rotated"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_process_ri_batched_vs_jax(exact_jax, layout, rotate):
    """Three streams of 3 sources, three chunks with state carried: the
    port's kernel route (its plain version on the CPU, per-stream taps,
    cout 5 and 11) vs the JAX Pallas route in interpret mode, on the JAX
    design's table."""
    S, n_ls = 3, len(LAYOUTS[layout])
    jcfg, tcfg = _cfgs(layout)
    jw, tw = _weights(layout)
    dirs, ypr, xs = _stream_inputs(np.random.default_rng(n_ls), S, 3)
    jst = jpan.init_state_batched(jcfg, S, n_ls)
    tst = tpan.init_state_batched(tcfg, S, n_ls, device="cpu")
    for x in xs:
        jy, jst = jpan.process_ri_batched(
            jcfg, jw, jst, jnp.asarray(x), jnp.asarray(dirs),
            jnp.asarray(ypr) if rotate else None, use_pallas=True,
            interpret=True)
        ty, tst = tpan.process_ri_batched(
            tcfg, tw, tst, torch.from_numpy(x), torch.from_numpy(dirs),
            torch.from_numpy(ypr) if rotate else None)
        assert tuple(ty.shape) == (S, n_ls, x.shape[-1])
        assert bool(torch.isfinite(ty).all())
        assert np.abs(np.asarray(jy) - ty.numpy()).max() <= RENDER_TOL
    assert np.abs(np.asarray(jst.ola_tail)
                  - tst.ola_tail.numpy()).max() <= RENDER_TOL
    np.testing.assert_array_equal(np.asarray(jst.in_tail),
                                  tst.in_tail.numpy())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fused_path_vs_plain_path(layout):
    """The port's kernel route vs its einsum reference path from a random
    non-zero state (state_from_numpy), rotation on, 4 sources."""
    S, n_ls = 2, len(LAYOUTS[layout])
    rng = np.random.default_rng(30 + n_ls)
    _, tcfg = _cfgs(layout, n_src=4)
    _, tw = _weights(layout)
    dirs, ypr, xs = _stream_inputs(rng, S, 4)
    st0 = tpan.state_from_numpy(rng.uniform(-1, 1, (S, 4, 15 * 128)),
                                rng.uniform(-1, 1, (S, n_ls, 9 * 128)), "cpu")
    outs = []
    for fused in (True, False):
        st, ys = st0, []
        for x in xs:
            y, st = tpan.process_ri_batched(
                tcfg, tw, st, torch.from_numpy(x), torch.from_numpy(dirs),
                torch.from_numpy(ypr), fused=fused)
            ys.append(y.numpy())
        outs.append((ys, st))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert np.abs(a - b).max() <= RENDER_TOL
    assert torch.equal(outs[0][1].in_tail, outs[1][1].in_tail)
    assert (outs[0][1].ola_tail - outs[1][1].ola_tail).abs().max() <= RENDER_TOL


def test_bad_direction_gives_jax_output(exact_jax):
    """A source past the table makes its stream's output NaN in both
    packages (NaN gains in every loudspeaker's row); the other stream is
    untouched.  Nothing raises."""
    jcfg, tcfg = _cfgs("7.1.4", n_src=2)
    jw, tw = _weights("7.1.4")
    rng = np.random.default_rng(8)
    dirs = np.array([[[10.0, 95.0], [30.0, 0.0]],
                     [[-20.0, 10.0], [30.0, 0.0]]], np.float32)
    x = rng.uniform(-1, 1, (2, 2, 512)).astype(np.float32)
    jy, _ = jpan.process_ri_batched(
        jcfg, jw, jpan.init_state_batched(jcfg, 2, 11), jnp.asarray(x),
        jnp.asarray(dirs), use_pallas=False)
    ty, _ = tpan.process_ri_batched(
        tcfg, tw, tpan.init_state_batched(tcfg, 2, 11, device="cpu"),
        torch.from_numpy(x), torch.from_numpy(dirs))
    jy = np.asarray(jy)
    assert np.isnan(jy[0]).all() and bool(torch.isnan(ty[0]).all())
    assert np.abs(jy[1] - ty[1].numpy()).max() <= RENDER_TOL


def test_p_norm_switch_and_zero_gain_source_vs_jax(exact_jax):
    """dtt = 0 makes p = 2 in every band (no renormalisation: the |p − 2|
    switch); a source at the bottom pole of 7.1.4 has all-zero gains and
    stays silent (0 / 2.23e-9), as in the JAX package."""
    for dtt in (0.0, 1.0):
        jcfg, tcfg = _cfgs("7.1.4", n_src=2, dtt=dtt)
        jw = jpan.design(jcfg, LAYOUTS["7.1.4"])
        tw = tpan.weights_from_numpy(*(np.asarray(a) for a in jw),
                                     device="cpu")
        if dtt == 0.0:
            assert bool((tw.p_values == 2.0).all())
        dirs = np.array([[[0.0, -90.0], [40.0, 10.0]]], np.float32)
        x = np.random.default_rng(9).uniform(-1, 1, (1, 2, 512)).astype(
            np.float32)
        jy, _ = jpan.process_ri_batched(
            jcfg, jw, jpan.init_state_batched(jcfg, 1, 11), jnp.asarray(x),
            jnp.asarray(dirs), use_pallas=False)
        ty, _ = tpan.process_ri_batched(
            tcfg, tw, tpan.init_state_batched(tcfg, 1, 11, device="cpu"),
            torch.from_numpy(x), torch.from_numpy(dirs))
        assert np.abs(np.asarray(jy) - ty.numpy()).max() <= RENDER_TOL
        x0 = x.copy()
        x0[:, 1] = 0.0                  # only the zero-gain source plays
        ty0, _ = tpan.process_ri_batched(
            tcfg, tw, tpan.init_state_batched(tcfg, 1, 11, device="cpu"),
            torch.from_numpy(x0), torch.from_numpy(dirs))
        assert ty0.abs().max() <= 1e-12


@pytest.mark.parametrize("entry", ["init_state", "process"])
def test_single_stream_entry_points_are_not_ported(entry):
    """They are ported now (the test keeps its name): each entry point has
    the JAX function's parameters, in order, plus ``device``, and no module
    carries the old message.  ``tests/test_torch_single_stream.py`` holds
    their outputs against the JAX package."""
    import inspect

    ref = [p for p in inspect.signature(getattr(jpan, entry)).parameters
           if not p.startswith("_")]
    got = [p for p in inspect.signature(getattr(tpan, entry)).parameters
           if p != "device"]
    assert got == ref
    assert not hasattr(tpan, "_SINGLE_STREAM")
