"""binauraliser_nf in the PyTorch port vs the JAX package on the CPU: the
DVF band gains (near-field clamp at 0.15 m, the DVF range, the far-field
bypass at head_radius · 34 = 3.09 m; the (|H|, arg H) scale), and the
batched render over three chunks with state carried, rotation and gains on,
on both routes (≤ 16 sources: the one-pass kernel's plain version with
per-stream taps; more: the (d, g) pair's).  The JAX side runs its Pallas
kernels in interpret mode.

Run alone with ``python -m pytest -q tests/test_torch_binauraliser_nf.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import binauraliser as jbin
from spatial_audio_framework_tpu.models import binauraliser_nf as jnf
from spatial_audio_framework_tpu.ops import precision as jprec
from spatial_audio_framework_tpu_torch.models import binauraliser as tbin
from spatial_audio_framework_tpu_torch.models import binauraliser_nf as tnf
from spatial_audio_framework_tpu_torch.modules import hrir as thrir

# the gains: float32 on both sides, magnitudes up to ~10 (20 dB shelves),
# phases in radians
GAIN_TOL = 1e-5
# time-domain outputs: fp32 on both sides, the JAX side through its Pallas
# kernels in interpret mode at exact fp32
RENDER_TOL = 2e-5
MODES = [jbin.INTERP_TRI, jbin.INTERP_TRI_PS]


@functools.lru_cache(maxsize=None)
def _jax_design(mode):
    w = jnf.design_ri(jnf.BinauraliserNFConfig(interp_mode=mode))
    return tuple(np.asarray(a) for a in w)


def _weights(mode):
    ref = _jax_design(mode)
    return (jbin.BinauraliserWeightsRI(*(jnp.asarray(a) for a in ref)),
            tnf.weights_from_numpy(*ref, device="cpu"))


@pytest.fixture
def exact_jax():
    """The JAX package's process-default matmul mode at exact fp32 for the
    test's duration (its default is the TPU's bf16 f32x3 split)."""
    old = jprec.hot_mode()
    jprec.set_hot_precision("highest")
    yield
    jprec.set_hot_precision(old)


def test_config_vs_jax():
    j, t = jnf.BinauraliserNFConfig(), tnf.BinauraliserNFConfig()
    assert isinstance(t, tbin.BinauraliserConfig)
    assert t.head_radius == j.head_radius == 0.09096
    assert t.nearfield_limit_m == j.nearfield_limit_m == 0.15
    assert t.far_field_thresh_m == j.far_field_thresh_m
    assert abs(t.far_field_thresh_m - 3.09264) < 1e-9
    t2 = tnf.BinauraliserNFConfig(head_radius=0.1)
    assert t2.far_field_thresh_m == jnf.BinauraliserNFConfig(
        head_radius=0.1).far_field_thresh_m


def _dirs_dists(rng, shape):
    """Directions over the sphere and distances 0.05–4 m: below the
    near-field limit, in the DVF range and beyond the far-field threshold;
    the first entries sit on the limits and on the median plane."""
    dirs = np.concatenate([rng.uniform(-180, 180, shape + (1,)),
                           rng.uniform(-90, 90, shape + (1,))], -1)
    dists = rng.uniform(0.05, 4.0, shape)
    flat_d, flat_r = dirs.reshape(-1, 2), dists.reshape(-1)
    edge_d = [[0.0, 0.0], [90.0, 0.0], [-90.0, 0.0], [180.0, 45.0]]
    edge_r = [0.15, 0.05, 0.09096 * 34.0, 3.0926, 3.0927, 0.1]
    flat_d[:4] = edge_d[:len(flat_d)]
    flat_r[:6] = edge_r[:len(flat_r)]
    return dirs.astype(np.float32), dists.astype(np.float32)


@pytest.mark.parametrize("fs", [48000.0, 44100.0])
def test_dvf_band_gains_ri_vs_jax(fs):
    jcfg = jnf.BinauraliserNFConfig(n_sources=12, fs=fs)
    tcfg = tnf.BinauraliserNFConfig(n_sources=12, fs=fs)
    freqs = tcfg.afstft.centre_freqs(fs).astype(np.float32)
    dirs, dists = _dirs_dists(np.random.default_rng(0), (12,))
    ref = jnf._dvf_band_gains_ri(jcfg, jnp.asarray(freqs), jnp.asarray(dirs),
                                 jnp.asarray(dists))
    got = tnf._dvf_band_gains_ri(tcfg, torch.from_numpy(freqs),
                                 torch.from_numpy(dirs),
                                 torch.from_numpy(dists))
    for a, b in zip(ref, got):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape == (133, 2, 12)
        assert np.abs(a - b.numpy()).max() <= GAIN_TOL
    mag, ph = (g.numpy() for g in got)
    far = dists >= tcfg.far_field_thresh_m
    assert far.sum() >= 2 and (~far).sum() >= 6
    assert (mag[:, :, far] == 1.0).all() and (ph[:, :, far] == 0.0).all()
    assert np.abs(mag[:, :, ~far] - 1.0).max() > 0.5
    # 0.05 m and 0.1 m are clamped to 0.15 m: same gains at one direction
    d2 = np.repeat(dirs[:1], 3, 0)
    r2 = np.array([0.15, 0.05, 0.1], np.float32)
    m2, p2 = tnf._dvf_band_gains_ri(
        tnf.BinauraliserNFConfig(n_sources=3, fs=fs),
        torch.from_numpy(freqs), torch.from_numpy(d2), torch.from_numpy(r2))
    assert torch.equal(m2[..., 0], m2[..., 1])
    assert torch.equal(p2[..., 0], p2[..., 2])


def test_dvf_band_gains_ri_batched_over_streams_vs_jax():
    """A leading stream axis gives each stream what the JAX package's vmap
    over streams gives it."""
    jcfg = jnf.BinauraliserNFConfig(n_sources=5)
    tcfg = tnf.BinauraliserNFConfig(n_sources=5)
    freqs = tcfg.afstft.centre_freqs(48000.0).astype(np.float32)
    dirs, dists = _dirs_dists(np.random.default_rng(1), (3, 5))
    ref = jax.vmap(lambda d, r: jnf._dvf_band_gains_ri(
        jcfg, jnp.asarray(freqs), d, r))(jnp.asarray(dirs),
                                         jnp.asarray(dists))
    got = tnf._dvf_band_gains_ri(tcfg, torch.from_numpy(freqs),
                                 torch.from_numpy(dirs),
                                 torch.from_numpy(dists))
    for a, b in zip(ref, got):
        assert tuple(b.shape) == (3, 133, 2, 5)
        assert np.abs(np.asarray(a) - b.numpy()).max() <= GAIN_TOL


def _stream_inputs(rng, S, n_src):
    """Directions, distances, per-stream yaw/pitch/roll, gains, and chunks
    of 4, 4 and 2 hops (H < 9 and H < 15)."""
    dirs, dists = _dirs_dists(rng, (S, n_src))
    ypr = rng.uniform(-1, 1, (S, 3))
    gains = rng.uniform(0.5, 1.5, (S, n_src))
    xs = [rng.uniform(-1, 1, (S, n_src, h * 128)) for h in (4, 4, 2)]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dirs, dists, f32(ypr), f32(gains), [f32(x) for x in xs]


@pytest.mark.parametrize("n_src", [3, 17])
@pytest.mark.parametrize("mode", MODES)
def test_process_ri_batched_vs_jax(exact_jax, mode, n_src):
    """Two streams, rotation and gains on, three chunks with state carried.
    3 sources take the one-pass kernel, 17 the (d, g) pair, both with
    per-stream taps."""
    kw = dict(n_sources=n_src, interp_mode=mode, enable_rotation=True)
    jcfg, tcfg = jnf.BinauraliserNFConfig(**kw), tnf.BinauraliserNFConfig(**kw)
    dirs, dists, ypr, gains, xs = _stream_inputs(
        np.random.default_rng(n_src), 2, n_src)
    jw, tw = _weights(mode)
    jst = jnf.init_state_batched(jcfg, 2)
    tst = tnf.init_state_batched(tcfg, 2, device="cpu")
    for x in xs:
        jy, jst = jnf.process_ri_batched(
            jcfg, jw, jst, jnp.asarray(x), jnp.asarray(dirs),
            jnp.asarray(dists), jnp.asarray(gains), jnp.asarray(ypr),
            use_pallas=True, interpret=True)
        ty, tst = tnf.process_ri_batched(
            tcfg, tw, tst, torch.from_numpy(x), torch.from_numpy(dirs),
            torch.from_numpy(dists), torch.from_numpy(gains),
            torch.from_numpy(ypr))
        assert tuple(ty.shape) == (2, 2, x.shape[-1])
        assert bool(torch.isfinite(ty).all())
        assert np.abs(np.asarray(jy) - ty.numpy()).max() <= RENDER_TOL
    assert np.abs(np.asarray(jst.ola_tail)
                  - tst.ola_tail.numpy()).max() <= RENDER_TOL
    np.testing.assert_array_equal(np.asarray(jst.in_tail),
                                  tst.in_tail.numpy())


@pytest.mark.parametrize("n_src", [2, 17])
def test_fused_path_vs_plain_path(n_src):
    """The port's kernel route vs its einsum reference path from a random
    non-zero state, rotation off (ypr given but not applied)."""
    rng = np.random.default_rng(40 + n_src)
    cfg = tnf.BinauraliserNFConfig(n_sources=n_src)
    _, w = _weights(jbin.INTERP_TRI)
    dirs, dists, ypr, _, xs = _stream_inputs(rng, 2, n_src)
    st0 = tnf.state_from_numpy(rng.uniform(-1, 1, (2, n_src, 15 * 128)),
                               rng.uniform(-1, 1, (2, 2, 9 * 128)), "cpu")
    outs = []
    for fused in (True, False):
        st, ys = st0, []
        for x in xs:
            y, st = tnf.process_ri_batched(
                cfg, w, st, torch.from_numpy(x), torch.from_numpy(dirs),
                torch.from_numpy(dists), ypr=torch.from_numpy(ypr),
                fused=fused)
            ys.append(y.numpy())
        outs.append((ys, st))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert np.abs(a - b).max() <= RENDER_TOL
    assert torch.equal(outs[0][1].in_tail, outs[1][1].in_tail)
    assert (outs[0][1].ola_tail - outs[1][1].ola_tail).abs().max() <= RENDER_TOL


def test_far_field_sources_render_as_the_binauraliser():
    """Every source beyond the far-field threshold: the DVF is bypassed and
    the output is the far-field binauraliser's, bit for bit."""
    rng = np.random.default_rng(2)
    cfg = tnf.BinauraliserNFConfig(n_sources=3, enable_rotation=True)
    _, w = _weights(jbin.INTERP_TRI)
    dirs, _, ypr, gains, xs = _stream_inputs(rng, 2, 3)
    x = torch.from_numpy(np.concatenate(xs + xs, -1))  # 20 hops: past the
    dirs, gains, ypr = (torch.from_numpy(a)            # bank's 9-hop delay
                        for a in (dirs, gains, ypr))
    st = tnf.init_state_batched(cfg, 2, device="cpu")
    y_nf, _ = tnf.process_ri_batched(cfg, w, st, x, dirs,
                                     torch.full((2, 3), 3.5), gains, ypr)
    y_ff, _ = tbin.process_ri_batched(cfg, w, st, x, dirs, gains, ypr)
    assert torch.equal(y_nf, y_ff) and float(y_ff.abs().max()) > 0.1
    y_near, _ = tnf.process_ri_batched(cfg, w, st, x, dirs,
                                       torch.full((2, 3), 0.3), gains, ypr)
    assert (y_near - y_ff).abs().max() > 1e-2


def test_design_ri_is_the_binauralisers():
    h, d, fs = thrir.default_hrirs()
    h, d = h[::8], d[::8]
    cfg = tnf.BinauraliserNFConfig()
    a = tnf.design_ri(cfg, h, d, fs, device="cpu")
    b = tbin.design_ri(cfg, h, d, fs, device="cpu")
    assert type(a) is tbin.BinauraliserWeightsRI
    assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize("entry", ["design", "init_state", "process"])
def test_single_stream_entry_points_are_not_ported(entry):
    """They are ported now (the test keeps its name): each entry point has
    the JAX function's parameters, in order, plus ``device``, and no module
    carries the old message.  ``tests/test_torch_single_stream.py`` holds
    their outputs against the JAX package."""
    import inspect

    ref = [p for p in inspect.signature(getattr(jnf, entry)).parameters
           if not p.startswith("_")]
    got = [p for p in inspect.signature(getattr(tnf, entry)).parameters
           if p != "device"]
    assert got == ref
    assert not hasattr(tnf, "_SINGLE_STREAM")
