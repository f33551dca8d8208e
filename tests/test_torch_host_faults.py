"""Per-chunk paths of the port that must neither fail where the JAX package
returns nor copy host data to the device on every call:

* ``binauraliser.interp_hrtfs_ri`` at directions whose table row is NaN,
  negative or outside the VBAP table, against the JAX package's
  ``interp_hrtfs_ri`` (whose ``jnp.take`` fills an outside row with NaN and
  whose float → int conversion takes NaN to row 0), TRI and TRI_PS, with
  and without head rotation;
* the FuMa conversion of ``ambi_bin.process_ri_batched`` and the complex
  ``AfSTFT.analysis`` / ``synthesis``: one cached device tensor per
  constant, reused from call to call, and no tensor made from host data
  once the caches are warm;
* the per-chunk paths of panner, ambi_enc, binauraliser_nf (its DVF table)
  and roombinauraliser: after one warm chunk, no tensor made from host
  data.

Run alone with ``python -m pytest -q tests/test_torch_host_faults.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import binauraliser as jbin
from spatial_audio_framework_tpu.utils import geometry as jgeo
from spatial_audio_framework_tpu_torch.models import ambi_bin as tab
from spatial_audio_framework_tpu_torch.models import ambi_enc as tenc
from spatial_audio_framework_tpu_torch.models import binauraliser as tbin
from spatial_audio_framework_tpu_torch.models import binauraliser_nf as tnf
from spatial_audio_framework_tpu_torch.models import panner as tpan
from spatial_audio_framework_tpu_torch.models import roombinauraliser as trb
from spatial_audio_framework_tpu_torch.ops import afstft as tafstft

INTERP_TOL = 1e-6   # as tests/test_torch_binauraliser.py: f32 gathers and
                    # sums of three products; NaN where JAX gives NaN
MODES = [jbin.INTERP_TRI, jbin.INTERP_TRI_PS]

# (azimuth, elevation) of the first of two sources; the second is an
# ordinary direction.  95° and 1e9° fall past the table's last row, -100°
# gives a negative row (counted from the table's end, as jnp.take does), a
# NaN azimuth, elevation or infinite azimuth gives row 0.
_BAD_DIRS = {
    "elevation 95": [10.0, 95.0],
    "elevation -100": [10.0, -100.0],
    "NaN azimuth": [np.nan, 10.0],
    "NaN elevation": [10.0, np.nan],
    "elevation 1e9": [10.0, 1e9],
    "infinite azimuth": [np.inf, 3.0],
}


@functools.lru_cache(maxsize=None)
def _jax_design(mode):
    w = jbin.design_ri(jbin.BinauraliserConfig(interp_mode=mode))
    return tuple(np.asarray(a) for a in w)


def _both(mode, n_src=2):
    kw = dict(n_sources=n_src, interp_mode=mode)
    jw = jbin.BinauraliserWeightsRI(*(jnp.asarray(a)
                                      for a in _jax_design(mode)))
    tw = tbin.weights_from_numpy(*_jax_design(mode), device="cpu")
    return jbin.BinauraliserConfig(**kw), jw, tbin.BinauraliserConfig(**kw), tw


def _assert_same(ref, got, n_src):
    for a, b in zip(ref, got):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape and a.shape[-2:] == (2, n_src)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=INTERP_TOL,
                                   equal_nan=True)


@pytest.mark.parametrize("case", list(_BAD_DIRS))
@pytest.mark.parametrize("mode", MODES)
def test_interp_hrtfs_ri_bad_directions_vs_jax(mode, case):
    jcfg, jw, tcfg, tw = _both(mode)
    dirs = np.array([_BAD_DIRS[case], [30.0, 0.0]], np.float32)
    ref = jbin.interp_hrtfs_ri(jcfg, jw, jnp.asarray(dirs))
    got = tbin.interp_hrtfs_ri(tcfg, tw, torch.from_numpy(dirs))
    _assert_same(ref, got, 2)
    # the ordinary source is untouched; the bad one is NaN exactly where
    # JAX says so (past the table) and finite elsewhere
    assert all(bool(torch.isfinite(h[..., 1]).all()) for h in got)
    nan = np.isnan(np.asarray(ref[0])[..., 0]).all()
    assert nan == (case in ("elevation 95", "elevation 1e9"))


@pytest.mark.parametrize("mode", MODES)
def test_interp_hrtfs_ri_nan_head_rotation_vs_jax(mode):
    """Rotation on with a NaN in one stream's yaw/pitch/roll: every rotated
    direction of that stream is NaN, so its sources take row 0 in both
    packages; the other stream is unaffected."""
    jcfg, jw, tcfg, tw = _both(mode)
    dirs = np.array([[[30.0, 0.0], [-45.0, 10.0]],
                     [[30.0, 0.0], [-45.0, 10.0]]], np.float32)
    ypr = np.array([[np.nan, 0.2, -0.1], [0.3, 0.2, -0.1]], np.float32)
    R = jax.vmap(lambda r: jgeo.yaw_pitch_roll2_rzyx(r[0], r[1], r[2]))(
        jnp.asarray(ypr))
    u = jnp.einsum("zsj,zji->zsi",
                   jgeo.unit_sph2cart(jnp.asarray(dirs), degrees=True), R,
                   precision=jax.lax.Precision.HIGHEST)
    jdirs = jgeo.unit_cart2sph(u, degrees=True)
    ref = jax.vmap(lambda d: jbin.interp_hrtfs_ri(jcfg, jw, d))(jdirs)
    tdirs = tbin.rotate_dirs(torch.from_numpy(dirs), torch.from_numpy(ypr))
    assert bool(torch.isnan(tdirs[0]).all())
    got = tbin.interp_hrtfs_ri(tcfg, tw, tdirs)
    _assert_same([np.asarray(r)[0] for r in ref], [g[0] for g in got], 2)
    for g in got:
        assert bool(torch.isfinite(g).all())


@pytest.fixture
def no_host_tensors(monkeypatch):
    """Makes every way of building a tensor from host data that the port's
    per-chunk code could take raise, for the test's duration."""
    def refuse(*args, **kwargs):
        raise AssertionError("a tensor was made from host data per call")

    def arm():
        for mod in (torch, tafstft, tab):
            for name in ("from_numpy", "tensor", "as_tensor", "f32_tensor"):
                if hasattr(mod, name):
                    monkeypatch.setattr(mod, name, refuse)

    return arm


def test_fuma_conversion_is_cached(no_host_tensors):
    """The FuMa conversion tensor is made once per (order, convention,
    device) and reused by every chunk."""
    cfg = tab.AmbiBinConfig(order=2, ch_ordering="fuma", norm="fuma")
    a = tab._fuma_conv(cfg.order, cfg.ch_ordering, cfg.norm,
                       torch.device("cpu"))
    assert a is tab._fuma_conv(cfg.order, cfg.ch_ordering, cfg.norm,
                               torch.device("cpu"))
    assert tuple(a.shape) == (9, 9) and a.dtype == torch.float32
    assert tab._fuma_conv(2, "acn", "sn3d", torch.device("cpu")) is None
    rng = np.random.default_rng(2)
    w = tab.weights_from_numpy(*rng.standard_normal((2, 133, 2, 9)), "cpu")
    st = tab.init_state_batched(cfg, 2, device="cpu")
    xs = [torch.from_numpy(rng.uniform(-1, 1, (2, 9, 512)).astype(np.float32))
          for _ in range(3)]
    for fused in (True, False):                             # warm the caches
        tab.process_ri_batched(cfg, w, st, xs[0], fused=fused)
    no_host_tensors()
    for x in xs[1:]:
        for fused in (True, False):
            y, _ = tab.process_ri_batched(cfg, w, st, x, fused=fused)
            assert bool(torch.isfinite(y).all())


@pytest.mark.parametrize("hybrid,low_delay", [(True, False), (False, True),
                                              (True, True)])
def test_afstft_constants_are_cached(no_host_tensors, hybrid, low_delay):
    """AfSTFT.analysis / synthesis take the windows, the low-delay sign and
    the hybrid band-pair sign from device_consts: after one call, chained
    calls build nothing from host data and give the same result as a
    fresh state's first call."""
    bank = tafstft.AfSTFT(hop=128, hybrid=hybrid, low_delay=low_delay)
    k = tafstft.device_consts(128, low_delay, torch.device("cpu"))
    assert k is tafstft.device_consts(128, low_delay, torch.device("cpu"))
    np.testing.assert_array_equal(k["pair_sign"].numpy(), [-1, 1, -1, 1])
    rng = np.random.default_rng(int(hybrid) + 2 * int(low_delay))
    xs = [torch.from_numpy(rng.uniform(-1, 1, (3, 4 * 128)).astype(np.float32))
          for _ in range(3)]
    st = bank.init_state(3, 3, device="cpu")
    spec, st = bank.analysis(st, xs[0])
    y_ref, _ = bank.synthesis(st, spec)
    st0 = bank.init_state(3, 3, device="cpu")
    no_host_tensors()
    spec2, _ = bank.analysis(st0, xs[0])
    y2, _ = bank.synthesis(st0, spec2)
    assert torch.equal(spec, spec2) and torch.equal(y_ref, y2)
    for x in xs[1:]:
        spec, st = bank.analysis(st, x)
        y, st = bank.synthesis(st, spec)
        assert tuple(y.shape) == (3, 4 * 128) and bool(torch.isfinite(y).all())


def _chunk_runner(model):
    """(warm-up inputs made, a callable running one chunk of ``model`` on
    both routes) at a small size, on random weights of the right shapes."""
    rng = np.random.default_rng(6)
    f32 = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.uniform(-1, 1, shape).astype(np.float32))
    dirs = f32(2, 3, 2) * torch.tensor([180.0, 90.0])
    ypr = f32(2, 3)
    x = f32(2, 3, 512)
    if model == "panner":
        cfg = tpan.PannerConfig(n_sources=3, n_loudspeakers=5, azi_res=10,
                                elev_res=10)
        w = tpan.weights_from_numpy(rng.uniform(0, 1, (37 * 19, 5)),
                                    rng.uniform(1, 2, 133), "cpu")
        st = tpan.init_state_batched(cfg, 2, 5, device="cpu")
        return lambda fused: tpan.process_ri_batched(cfg, w, st, x, dirs, ypr,
                                                     fused=fused)[0]
    if model == "ambi_enc":
        cfg = tenc.AmbiEncConfig(order=2, n_sources=3, frame_size=512)
        conv = tenc.design(cfg, device="cpu")
        st = tenc.init_state(cfg, np.zeros((3, 2)), device="cpu")
        return lambda fused: tenc.process(cfg, conv, st, x[0], dirs[0],
                                          ypr[0])[0]
    bw = (rng.standard_normal((3, 133, 2, 30)),) * 3
    table = (rng.uniform(0, 1, (181 * 37, 3)),
             rng.integers(0, 30, (181 * 37, 3)),
             np.linspace(0, 24e3, 133))
    if model == "binauraliser_nf":
        cfg = tnf.BinauraliserNFConfig(n_sources=3, enable_rotation=True)
        w = tnf.weights_from_numpy(*(b[0] for b in bw),
                                   rng.uniform(-5e-4, 5e-4, 30), *table,
                                   device="cpu")
        st = tnf.init_state_batched(cfg, 2, device="cpu")
        dists = f32(2, 3).abs() * 4.0
        return lambda fused: tnf.process_ri_batched(
            cfg, w, st, x, dirs, dists, None, ypr, fused=fused)[0]
    cfg = trb.RoomBinauraliserConfig(n_sources=3, interp_mode="tri_ps")
    w = trb.weights_from_numpy(*bw, rng.uniform(-5e-4, 5e-4, (3, 30)),
                               *table, device="cpu")
    st = trb.init_state_batched(cfg, 2, device="cpu")
    return lambda fused: trb.process_ri_batched(cfg, w, st, x, None, ypr,
                                                fused=fused)[0]


@pytest.mark.parametrize("model", ["panner", "ambi_enc", "binauraliser_nf",
                                   "roombinauraliser"])
def test_new_models_build_nothing_from_host_data_per_chunk(no_host_tensors,
                                                           model):
    """After one warm chunk (the afSTFT constants, the DVF table), a chunk
    of each new model makes no tensor from host data on either route."""
    run = _chunk_runner(model)
    warm = [run(fused) for fused in (True, False)]
    no_host_tensors()
    for fused, ref in zip((True, False), warm):
        y = run(fused)
        assert torch.equal(y, ref) and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("order", [1, 3, 4])
def test_kernel_routes_get_dense_rows_from_a_block_view(monkeypatch, order):
    """A block that is a view of a longer signal (render_signal's blocks, a
    frame of a larger buffer) has strides the CUDA kernels refuse
    ("contiguous and 16-byte aligned"); the render routes must hand each
    kernel dense rows, as the JAX package accepts any layout.  On the CPU
    the wrappers take their plain versions, so the check wraps them."""
    from spatial_audio_framework_tpu_torch.ops import afstft_ri

    seen = []

    def dense(fn):
        def wrapped(*args, **kw):
            for a in args:
                if isinstance(a, torch.Tensor):
                    seen.append(a.is_contiguous())
            return fn(*args, **kw)
        return wrapped

    # the kernels that read the caller's block: the one-pass render and the
    # fronts of the two-kernel route
    for name in ("render_full_ri", "analysis_front_ri",
                 "analysis_front_dg_ri"):
        monkeypatch.setattr(afstft_ri, name, dense(getattr(afstft_ri, name)))
    cfg = tab.AmbiBinConfig(order=order)
    rng = np.random.default_rng(order)
    M = rng.standard_normal((2, 133, 2, cfg.nsh)).astype(np.float32)
    w = tab.weights_from_numpy(M[0], M[1], "cpu")
    sig = torch.from_numpy(rng.uniform(-1, 1, (2, cfg.nsh, 4 * 256)).astype(
        np.float32))
    block = sig[..., 256:512]
    assert not block.is_contiguous()
    y, _ = tab.process_ri_batched(cfg, w, tab.init_state_batched(
        cfg, 2, device="cpu"), block)
    ref, _ = tab.process_ri_batched(cfg, w, tab.init_state_batched(
        cfg, 2, device="cpu"), block.contiguous())
    assert seen and all(seen)
    assert torch.equal(y, ref)
