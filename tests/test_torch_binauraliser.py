"""binauraliser in the PyTorch port vs the JAX package on the CPU: the
design, the HRTF interpolation at edge directions, the head rotation, and
the batched render with rotation on both routes (≤ 16 sources: the one-pass
kernel's plain version with per-stream taps; more: the (d, g) pair's).

Run alone with ``python -m pytest -q tests/test_torch_binauraliser.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import _common as jcommon
from spatial_audio_framework_tpu.models import binauraliser as jbin
from spatial_audio_framework_tpu.ops import precision as jprec
from spatial_audio_framework_tpu.utils import geometry as jgeo
from spatial_audio_framework_tpu_torch.models import _common as tcommon
from spatial_audio_framework_tpu_torch.models import binauraliser as tbin
from spatial_audio_framework_tpu_torch.utils import geometry as tgeo

DESIGN_TOL = 1e-6   # host numpy on both sides; relative to a table's peak
INTERP_TOL = 1e-6   # f32 gathers and sums of three products
RENDER_TOL = 1e-5   # time-domain outputs, fp32 on both sides
MODES = [jbin.INTERP_TRI, jbin.INTERP_TRI_PS]


@functools.lru_cache(maxsize=None)
def _jax_design(mode):
    w = jbin.design_ri(jbin.BinauraliserConfig(interp_mode=mode))
    return tuple(np.asarray(a) for a in w)


@functools.lru_cache(maxsize=None)
def _port_weights(mode):
    """The port's weights made from the JAX design (weights_from_numpy), so
    the render tests see identical tables."""
    return tbin.weights_from_numpy(*_jax_design(mode), device="cpu")


@pytest.fixture
def exact_jax():
    """The JAX package's process-default matmul mode at exact fp32 for the
    test's duration (its default is the TPU's bf16 f32x3 split)."""
    old = jprec.hot_mode()
    jprec.set_hot_precision("highest")
    yield
    jprec.set_hot_precision(old)


@pytest.mark.parametrize("mode", MODES)
def test_design_ri_vs_jax(mode):
    ref = _jax_design(mode)
    got = tbin.design_ri(tbin.BinauraliserConfig(interp_mode=mode),
                         device="cpu")
    # the JAX package's fields, then the port's direction-major copies of
    # the HRTF tables, which its hrtf_taps_ri kernel reads
    assert got._fields == jbin.BinauraliserWeightsRI._fields + (
        "hrtf_ri_by_dir", "hrtf_mag_by_dir")
    assert torch.equal(got.hrtf_ri_by_dir, torch.stack(
        [got.hrtf_re, got.hrtf_im], -1).permute(2, 1, 0, 3))
    assert torch.equal(got.hrtf_mag_by_dir, got.hrtf_mag.permute(2, 1, 0))
    assert got.hrtf_ri_by_dir.is_contiguous()
    assert got.hrtf_mag_by_dir.is_contiguous()
    for name, a, b in zip(got._fields, ref, got):
        assert tuple(b.shape) == a.shape, name
        if name == "table_idx":
            assert b.dtype == torch.int64
            np.testing.assert_array_equal(b.numpy(), a)
            continue
        assert b.dtype == torch.float32, name
        peak = max(1.0, float(np.abs(a).max()))
        assert np.abs(a - b.numpy()).max() <= DESIGN_TOL * peak, name


def test_round_half_up_vs_jax():
    """C's (int)(x + 0.5f): halves round up, unlike round-half-to-even."""
    x = np.array([0.0, 0.5, 1.5, 2.5, 112.5, 0.49999997, 35.5, 179.5,
                  3.4999998, 1e-8], np.float32)
    got = tcommon.round_half_up(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcommon.round_half_up(
        jnp.asarray(x))))
    np.testing.assert_array_equal(got[1:5], [1.0, 2.0, 3.0, 113.0])


# (azimuth, elevation): both poles, the ±180° seam, half-step rows and
# columns (round half up), and azimuths outside [-180, 180]
_EDGE_DIRS = np.array([
    [180.0, 90.0], [-180.0, -90.0], [180.0, -90.0], [-180.0, 90.0],
    [179.9, 0.0], [-179.9, 0.0], [-179.0, -87.5], [1.0, 2.5],
    [0.0, 89.9], [359.0, 45.0], [-541.0, -45.0], [720.5, 12.5],
    [30.0, 0.0], [-45.0, 10.0]], np.float32)


@pytest.mark.parametrize("mode", MODES)
def test_interp_hrtfs_ri_edge_directions_vs_jax(mode):
    jcfg = jbin.BinauraliserConfig(n_sources=len(_EDGE_DIRS),
                                   interp_mode=mode)
    tcfg = tbin.BinauraliserConfig(n_sources=len(_EDGE_DIRS),
                                   interp_mode=mode)
    jw = jbin.BinauraliserWeightsRI(*(jnp.asarray(a)
                                      for a in _jax_design(mode)))
    ref = jbin.interp_hrtfs_ri(jcfg, jw, jnp.asarray(_EDGE_DIRS))
    got = tbin.interp_hrtfs_ri(tcfg, _port_weights(mode),
                               torch.from_numpy(_EDGE_DIRS))
    for a, b in zip(ref, got):
        assert tuple(b.shape) == (133, 2, len(_EDGE_DIRS))
        assert bool(torch.isfinite(b).all())
        assert np.abs(np.asarray(a) - b.numpy()).max() <= INTERP_TOL
    # batched over streams: the same rows per stream
    two = torch.from_numpy(np.stack([_EDGE_DIRS, _EDGE_DIRS[::-1]]))
    both = tbin.interp_hrtfs_ri(tcfg, _port_weights(mode), two)
    assert torch.equal(both[0][0], got[0])
    assert torch.equal(both[0][1], got[0].flip(-1))


def test_geometry_vs_jax():
    """The numpy conversions and the torch ones the per-chunk path runs."""
    rng = np.random.default_rng(3)
    dirs = np.concatenate([rng.uniform(-180, 180, (40, 1)),
                           rng.uniform(-90, 90, (40, 1))], -1)
    dirs = np.concatenate([dirs, _EDGE_DIRS[:4]]).astype(np.float32)
    cart = np.asarray(jgeo.unit_sph2cart(dirs, degrees=True))
    np.testing.assert_allclose(tgeo.unit_sph2cart(dirs, degrees=True), cart,
                               atol=1e-6)
    np.testing.assert_allclose(
        tgeo.unit_sph2cart_torch(torch.from_numpy(dirs)).numpy(), cart,
        atol=1e-6)
    xyz = rng.standard_normal((40, 3))
    np.testing.assert_allclose(tgeo.cart2sph(xyz, degrees=True),
                               np.asarray(jgeo.cart2sph(xyz, degrees=True)),
                               rtol=1e-12, atol=1e-12)
    u = (xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)).astype(np.float32)
    ref = np.asarray(jgeo.unit_cart2sph(jnp.asarray(u), degrees=True))
    np.testing.assert_allclose(tgeo.unit_cart2sph(u, degrees=True), ref,
                               atol=1e-4)
    np.testing.assert_allclose(
        tgeo.unit_cart2sph_torch(torch.from_numpy(u)).numpy(), ref, atol=1e-4)
    ypr = rng.uniform(-np.pi, np.pi, (7, 3)).astype(np.float32)
    R = jax.vmap(lambda r: jgeo.yaw_pitch_roll2_rzyx(r[0], r[1], r[2]))(
        jnp.asarray(ypr))
    np.testing.assert_allclose(
        tgeo.yaw_pitch_roll2_rzyx_torch(torch.from_numpy(ypr)).numpy(),
        np.asarray(R), atol=1e-6)


def test_rotate_dirs_vs_jax():
    """Row convention src_rot = src_row @ Rzyx per stream (the JAX package's
    process_ri_batched; binauraliser.c:238-241), yaw 40, pitch -15, roll 10
    on the C-golden sources in stream 0."""
    rng = np.random.default_rng(4)
    dirs = np.concatenate([rng.uniform(-180, 180, (3, 5, 1)),
                           rng.uniform(-90, 90, (3, 5, 1))], -1)
    dirs[0, :2] = [[30.0, 0.0], [-45.0, 10.0]]
    dirs = dirs.astype(np.float32)
    ypr = rng.uniform(-1, 1, (3, 3)).astype(np.float32)
    ypr[0] = np.deg2rad([40.0, -15.0, 10.0])
    R = jax.vmap(lambda r: jgeo.yaw_pitch_roll2_rzyx(r[0], r[1], r[2]))(
        jnp.asarray(ypr))
    u = jnp.einsum("zsj,zji->zsi",
                   jgeo.unit_sph2cart(jnp.asarray(dirs), degrees=True), R,
                   precision=jax.lax.Precision.HIGHEST)
    ref = np.asarray(jgeo.unit_cart2sph(u, degrees=True))
    got = tbin.rotate_dirs(torch.from_numpy(dirs), torch.from_numpy(ypr))
    # compare as unit vectors: an azimuth at the ±180° seam may flip sign
    np.testing.assert_allclose(
        tgeo.unit_sph2cart_torch(got).numpy(),
        np.asarray(jgeo.unit_sph2cart(ref, degrees=True)), atol=1e-6)


def _stream_inputs(rng, S, n_src):
    """Per-(stream, source) directions with the edges of _EDGE_DIRS in
    stream 0, per-stream yaw/pitch/roll and gains, and chunks of 4, 4 and
    2 hops (H < 9 and H < 15)."""
    dirs = np.concatenate([rng.uniform(-180, 180, (S, n_src, 1)),
                           rng.uniform(-90, 90, (S, n_src, 1))], -1)
    k = min(n_src, 4)
    dirs[0, :k] = _EDGE_DIRS[:k]
    ypr = rng.uniform(-1, 1, (S, 3))
    gains = rng.uniform(0.5, 1.5, (S, n_src))
    xs = [rng.uniform(-1, 1, (S, n_src, h * 128)) for h in (4, 4, 2)]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(dirs), f32(ypr), f32(gains), [f32(x) for x in xs]


@pytest.mark.parametrize("n_src", [3, 17])
@pytest.mark.parametrize("mode", MODES)
def test_process_ri_batched_vs_jax(exact_jax, mode, n_src):
    """Head rotation on, per-source gains, two streams: the port's kernel
    route (the plain versions on the CPU) vs the JAX Pallas route in
    interpret mode at exact fp32, on the JAX design's weights.  3 sources
    take the one-pass kernel, 17 the (d, g) pair, both with per-stream
    taps."""
    kw = dict(n_sources=n_src, interp_mode=mode, enable_rotation=True)
    jcfg, tcfg = jbin.BinauraliserConfig(**kw), tbin.BinauraliserConfig(**kw)
    dirs, ypr, gains, xs = _stream_inputs(np.random.default_rng(n_src), 2,
                                          n_src)
    jw = jbin.BinauraliserWeightsRI(*(jnp.asarray(a)
                                      for a in _jax_design(mode)))
    jst = jbin.init_state_batched(jcfg, 2)
    tst = tbin.init_state_batched(tcfg, 2, device="cpu")
    for x in xs:
        jy, jst = jbin.process_ri_batched(
            jcfg, jw, jst, jnp.asarray(x), jnp.asarray(dirs),
            jnp.asarray(gains), jnp.asarray(ypr), use_pallas=True,
            interpret=True)
        ty, tst = tbin.process_ri_batched(
            tcfg, _port_weights(mode), tst, torch.from_numpy(x),
            torch.from_numpy(dirs), torch.from_numpy(gains),
            torch.from_numpy(ypr))
        assert tuple(ty.shape) == (2, 2, x.shape[-1])
        assert np.abs(np.asarray(jy) - ty.numpy()).max() <= RENDER_TOL
    assert np.abs(np.asarray(jst.ola_tail)
                  - tst.ola_tail.numpy()).max() <= RENDER_TOL
    np.testing.assert_array_equal(np.asarray(jst.in_tail),
                                  tst.in_tail.numpy())


@pytest.mark.parametrize("n_src", [1, 17])
def test_fused_path_vs_plain_path(n_src):
    """The port's kernel route vs its einsum reference path from a random
    non-zero state (state_from_numpy), rotation on."""
    rng = np.random.default_rng(20 + n_src)
    cfg = tbin.BinauraliserConfig(n_sources=n_src, enable_rotation=True)
    w = _port_weights(jbin.INTERP_TRI)
    dirs, ypr, _, xs = _stream_inputs(rng, 2, n_src)
    st0 = tbin.state_from_numpy(rng.uniform(-1, 1, (2, n_src, 15 * 128)),
                                rng.uniform(-1, 1, (2, 2, 9 * 128)), "cpu")
    outs = []
    for fused in (True, False):
        st, ys = st0, []
        for x in xs:
            y, st = tbin.process_ri_batched(
                cfg, w, st, torch.from_numpy(x), torch.from_numpy(dirs),
                ypr=torch.from_numpy(ypr), fused=fused)
            ys.append(y.numpy())
        outs.append((ys, st))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert np.abs(a - b).max() <= RENDER_TOL
    assert torch.equal(outs[0][1].in_tail, outs[1][1].in_tail)
    assert (outs[0][1].ola_tail - outs[1][1].ola_tail).abs().max() <= RENDER_TOL


def test_rotation_off_ignores_ypr():
    """enable_rotation False: ypr is not applied (as in the JAX package)."""
    rng = np.random.default_rng(5)
    cfg = tbin.BinauraliserConfig(n_sources=2)
    w = _port_weights(jbin.INTERP_TRI)
    dirs, ypr, _, xs = _stream_inputs(rng, 2, 2)
    x, d = torch.from_numpy(xs[0]), torch.from_numpy(dirs)
    st = tbin.init_state_batched(cfg, 2, device="cpu")
    y0, _ = tbin.process_ri_batched(cfg, w, st, x, d)
    y1, _ = tbin.process_ri_batched(cfg, w, st, x, d,
                                    ypr=torch.from_numpy(ypr))
    assert torch.equal(y0, y1)


@pytest.mark.parametrize("entry", ["design", "init_state", "process"])
def test_single_stream_entry_points_are_not_ported(entry):
    """They are ported now (the test keeps its name): each entry point has
    the JAX function's parameters, in order, plus ``device``, and no module
    carries the old message.  ``tests/test_torch_single_stream.py`` holds
    their outputs against the JAX package."""
    import inspect

    ref = [p for p in inspect.signature(getattr(jbin, entry)).parameters
           if not p.startswith("_")]
    got = [p for p in inspect.signature(getattr(tbin, entry)).parameters
           if p != "device"]
    assert got == ref
    assert not hasattr(tbin, "_SINGLE_STREAM")
