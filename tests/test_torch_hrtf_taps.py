"""The binauraliser's per-block taps entry, ``binauraliser.hrtf_taps_ri``,
on the CPU: its plain version is the chain it replaces (rotation, HRTF
interpolation, ``decode_taps``) bit for bit, meets the JAX package's chain
at edge and bad directions, and agrees with a numpy mirror of the CUDA
kernel's per-(stream, source) arithmetic and tap layout
(``csrc/hrtf_taps_ri.cu``); the batched render on that entry equals the
plain path.

The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import binauraliser as jbin
from spatial_audio_framework_tpu.ops import pallas_afstft as jpa
from spatial_audio_framework_tpu_torch.models import binauraliser as tbin
from spatial_audio_framework_tpu_torch.ops import afstft_kernels as tak

MODES = [tbin.INTERP_TRI, tbin.INTERP_TRI_PS]
TAP_TOL = 1e-6      # relative to the largest tap: f32 sums of three products
RENDER_TOL = 1e-5   # time-domain outputs, fp32 on both sides
N_BANDS = 133

# (azimuth, elevation): both poles, the ±180° seam, exact half-step rows
# and columns (round half up), azimuths outside [-180, 180]
# (tests/test_torch_binauraliser.py), then NaN, infinite, past-the-table
# and negative-row directions (tests/test_torch_host_faults.py)
_EDGE_DIRS = np.array([
    [180.0, 90.0], [-180.0, -90.0], [180.0, -90.0], [-180.0, 90.0],
    [179.9, 0.0], [-179.9, 0.0], [-179.0, -87.5], [1.0, 2.5],
    [0.0, 89.9], [359.0, 45.0], [-541.0, -45.0], [720.5, 12.5],
    [30.0, 0.0], [-45.0, 10.0]], np.float32)
_BAD_DIRS = np.array([
    [10.0, 95.0], [10.0, -100.0], [np.nan, 10.0], [10.0, np.nan],
    [10.0, 1e9], [np.inf, 3.0], [-np.inf, 3.0], [10.0, -np.inf]],
    np.float32)


def _random_weights(rng, n_dirs=40, azi_res=2, elev_res=5):
    """Weights of the full 2° x 5° table size over a small random HRTF
    grid, a few table indices outside it (clamped by every version)."""
    n_table = (int(360 / azi_res + 0.5) + 1) * (int(180 / elev_res + 0.5) + 1)
    idx = rng.integers(0, n_dirs, (n_table, 3))
    idx[::97, 1] = n_dirs + 3
    idx[::89, 2] = -2
    return tbin.weights_from_numpy(
        rng.standard_normal((N_BANDS, 2, n_dirs)),
        rng.standard_normal((N_BANDS, 2, n_dirs)),
        rng.uniform(0, 1, (N_BANDS, 2, n_dirs)),
        rng.uniform(-1e-3, 1e-3, n_dirs), rng.dirichlet(np.ones(3), n_table),
        idx, np.linspace(0, 24e3, N_BANDS), "cpu")


def _controls(rng, S, n_src, bad=True):
    """Directions over the sphere with the edge (and ``bad``) directions
    in stream 0, and a head pose a stream."""
    dirs = np.stack([rng.uniform(-180, 180, (S, n_src)),
                     rng.uniform(-90, 90, (S, n_src))], -1).astype(np.float32)
    edges = np.concatenate([_EDGE_DIRS, _BAD_DIRS] if bad else [_EDGE_DIRS])
    k = min(n_src, len(edges))
    dirs[0, :k] = edges[rng.permutation(len(edges))[:k]]
    ypr = rng.uniform(-np.pi, np.pi, (S, 3)).astype(np.float32)
    return torch.from_numpy(dirs), torch.from_numpy(ypr)


def _chain(cfg, w, dirs, ypr):
    """Today's chain on the binauraliser's batched path, as it ran."""
    if cfg.enable_rotation and ypr is not None:
        dirs = tbin.rotate_dirs(dirs, ypr)
    return tak.decode_taps(*tbin.interp_hrtfs_ri(cfg, w, dirs), hybrid=True)


@pytest.mark.parametrize("n_src", [1, 6, 16, 17, 64])
@pytest.mark.parametrize("rotation", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_plain_version_is_the_chain_bit_for_bit(mode, rotation, n_src):
    rng = np.random.default_rng(n_src + 100 * rotation)
    cfg = tbin.BinauraliserConfig(n_sources=n_src, interp_mode=mode,
                                  enable_rotation=rotation)
    w = _random_weights(rng)
    dirs, ypr = _controls(rng, 3, n_src)
    got = tbin.hrtf_taps_ri(cfg, w, dirs, ypr)
    ref = _chain(cfg, w, dirs, ypr)
    assert tuple(got.shape) == (3, n_src, 2, 4, 129)
    assert got.is_contiguous() and got.dtype == torch.float32
    assert torch.equal(got.isnan(), ref.isnan())
    assert torch.equal(got.nan_to_num(), ref.nan_to_num())
    assert tak.LAUNCHES["hrtf_taps_ri"] == 0        # no kernel on the CPU


def test_rotation_needs_the_flag_and_a_pose():
    """Without ``enable_rotation`` the pose is ignored, as on the plain
    path; with it and no pose the directions are taken as they are."""
    rng = np.random.default_rng(1)
    w = _random_weights(rng)
    dirs, ypr = _controls(rng, 2, 5)
    off = tbin.BinauraliserConfig(n_sources=5)
    on = tbin.BinauraliserConfig(n_sources=5, enable_rotation=True)
    plain = tbin.hrtf_taps_ri(off, w, dirs)
    assert torch.equal(tbin.hrtf_taps_ri(off, w, dirs, ypr).nan_to_num(),
                       plain.nan_to_num())
    assert torch.equal(tbin.hrtf_taps_ri(on, w, dirs).nan_to_num(),
                       plain.nan_to_num())
    assert not torch.equal(tbin.hrtf_taps_ri(on, w, dirs, ypr).nan_to_num(),
                           plain.nan_to_num())


@functools.lru_cache(maxsize=None)
def _jax_design(mode):
    w = jbin.design_ri(jbin.BinauraliserConfig(interp_mode=mode))
    return tuple(np.asarray(a) for a in w)


@pytest.mark.parametrize("dirs", ["edge", "bad"])
@pytest.mark.parametrize("mode", MODES)
def test_meets_the_jax_chain_at_edge_directions(mode, dirs):
    """The JAX package's ``interp_hrtfs_ri`` → ``decode_taps`` on the
    design's tables, one stream: NaN taps exactly where JAX's take fills a
    row past the table with NaN, the same taps elsewhere."""
    d = _EDGE_DIRS if dirs == "edge" else _BAD_DIRS
    kw = dict(n_sources=len(d), interp_mode=mode)
    jw = jbin.BinauraliserWeightsRI(*(jnp.asarray(a)
                                      for a in _jax_design(mode)))
    ref = np.asarray(jpa.decode_taps(
        *jbin.interp_hrtfs_ri(jbin.BinauraliserConfig(**kw), jw,
                              jnp.asarray(d)), hybrid=True))
    got = tbin.hrtf_taps_ri(tbin.BinauraliserConfig(**kw),
                           tbin.weights_from_numpy(*_jax_design(mode),
                                                   device="cpu"),
                           torch.from_numpy(d)[None])[0].numpy()
    assert got.shape == ref.shape == (len(d), 2, 4, 129)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.abs(np.nan_to_num(got - ref)).max() <= TAP_TOL * np.nanmax(
        np.abs(ref))
    if dirs == "bad":
        # past the table (elevation 95, 1e9, +inf): NaN but for the zero B
        # taps outside the split bands
        nan = np.isnan(got).any(axis=(1, 2, 3))
        np.testing.assert_array_equal(nan, [1, 0, 0, 0, 1, 0, 0, 1])


# -- a numpy mirror of csrc/hrtf_taps_ri.cu ----------------------------------

F32 = np.float32


def _remainder(a, b):
    """The kernel's remainder: fmod, moved into b's sign."""
    m = np.fmod(a, b)
    return np.where((m != 0) & ((b < 0) != (m < 0)), m + b, m).astype(F32)


def _mirror_lookup(cfg, w, dirs, ypr):
    """The kernel's ``lookup`` for every (stream, source): → (indices
    (S, n, 3), weights (S, n, 3), ITD (S, n), the azimuth and elevation
    coordinates before rounding (S, n) each)."""
    az, el = dirs[..., 0], dirs[..., 1]
    if ypr is not None:
        c, s = np.cos(ypr), np.sin(ypr)
        cy, cp, cr = (c[:, i, None] for i in range(3))
        sy, sp, sr = (s[:, i, None] for i in range(3))
        R = [[cp * cy, cp * sy, -sp],
             [sr * sp * cy - cr * sy, sr * sp * sy + cr * cy, sr * cp],
             [cr * sp * cy + sr * sy, cr * sp * sy - sr * cy, cr * cp]]
        azr, elr = az * F32(np.pi / 180), el * F32(np.pi / 180)
        ce = np.cos(elr)
        u = [ce * np.cos(azr), ce * np.sin(azr), np.sin(elr)]
        v = [(u[0] * R[0][i] + u[1] * R[1][i]) + u[2] * R[2][i]
             for i in range(3)]
        az = np.arctan2(v[1], v[0]) * F32(180 / np.pi)
        el = np.arctan2(v[2], np.sqrt(v[0] * v[0] + v[1] * v[1])) * F32(
            180 / np.pi)
    a = _remainder(az + F32(180), F32(360)) / F32(cfg.azi_res) + F32(0.5)
    e = (el + F32(90)) / F32(cfg.elev_res) + F32(0.5)
    n_azi = int(360.0 / cfg.azi_res + 0.5) + 1
    n_table, n_dirs = w.table_w.shape[0], w.hrtf_mag_by_dir.shape[0]
    r = np.floor(e) * F32(n_azi) + np.floor(a)
    r = np.where(np.isnan(r), F32(0), r)
    r = np.where(np.isinf(r), np.sign(r) * np.finfo(F32).max, r)
    row = np.clip(r, -n_table - 1, n_table).astype(np.int64)
    row = np.where(row < 0, row + n_table, row)
    outside = (row < 0) | (row >= n_table)
    row = np.clip(row, 0, n_table - 1)
    wk = np.where(outside[..., None], F32(np.nan),
                  w.table_w.numpy()[row]).astype(F32)
    ik = np.clip(w.table_idx.numpy()[row], 0, n_dirs - 1)
    itds = w.itds.numpy()[ik] * wk
    itd = (itds[..., 0] + itds[..., 1]) + itds[..., 2]
    return ik, wk, itd, a, e


@np.errstate(invalid="ignore")     # NaN and infinite directions
def _mirror(cfg, w, dirs, ypr=None):
    """The kernel's taps (S, n, 2, 4, 129): each (stream, source)'s lookup
    once, then per (ear, uniform band) the interpolated hybrid bands and
    their collapse, stored at [pair][ear][A_re, A_im, B_re, B_im][band]."""
    dirs = dirs.numpy()
    ypr = (ypr.numpy() if cfg.enable_rotation and ypr is not None
           else None)
    ik, wk, itd, a, e = _mirror_lookup(cfg, w, dirs, ypr)
    ri = w.hrtf_ri_by_dir.numpy()                   # (nDirs, 2, 133, 2)

    def interp(tab):                                # → (S, n, 2, 133)
        p = tab[ik] * wk[..., None, None]           # (S, n, 3, 2, 133)
        return (p[..., 0, :, :] + p[..., 1, :, :]) + p[..., 2, :, :]

    if cfg.interp_mode == tbin.INTERP_TRI:
        Mre, Mim = interp(ri[..., 0]), interp(ri[..., 1])
    else:
        f = w.freqs.numpy()
        t = (F32(2 * np.pi) * f) * itd[..., None] + F32(np.pi)
        ipd = (_remainder(t, F32(2 * np.pi)) - F32(np.pi)) / F32(2)
        ipd = np.where(f < 1.5e3, ipd, F32(0))
        ph = np.stack([ipd, -ipd], axis=-2)         # ear 0: +, ear 1: −
        mag = interp(w.hrtf_mag_by_dir.numpy())
        Mre, Mim = mag * np.cos(ph), mag * np.sin(ph)
    s = np.array([-1, 1, -1, 1], F32)
    taps = np.empty(dirs.shape[:2] + (2, 4, 129), F32)
    for c, M in ((0, Mre), (1, Mim)):
        lo, hi = M[..., 1:9:2], M[..., 2:10:2]
        taps[..., c, :] = np.concatenate(
            [M[..., :1], F32(0.5) * (lo + hi), M[..., 9:]], axis=-1)
        z = np.zeros_like(M[..., :1])
        taps[..., c + 2, :] = np.concatenate(
            [z, s * (lo - hi), np.zeros_like(M[..., 9:])], axis=-1)
    # a (stream, source) whose coordinate lies within 1e-4 of a table step's
    # rounding boundary after rotation: numpy's and torch's sin / atan2 may
    # round it apart, so its row is not held
    near = np.zeros(dirs.shape[:2], bool)
    if ypr is not None:
        for x in (a, e):
            near |= np.abs(x - np.round(x)) < 1e-4
    return taps, near


@pytest.mark.parametrize("n_src", [6, 17])
@pytest.mark.parametrize("rotation", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_numpy_mirror_of_the_kernel_meets_the_plain_version(mode, rotation,
                                                            n_src):
    rng = np.random.default_rng(7 * n_src + rotation)
    cfg = tbin.BinauraliserConfig(n_sources=n_src, interp_mode=mode,
                                  enable_rotation=rotation)
    w = _random_weights(rng)
    dirs, ypr = _controls(rng, 4, n_src)
    want, near = _mirror(cfg, w, dirs, ypr)
    got = tbin.hrtf_taps_ri(cfg, w, dirs, ypr).numpy()
    assert near.mean() < 0.05
    keep = ~near
    np.testing.assert_array_equal(np.isnan(got[keep]), np.isnan(want[keep]))
    scale = np.nanmax(np.abs(want))
    assert np.abs(np.nan_to_num(got[keep] - want[keep])).max() <= (
        TAP_TOL * scale)


def test_numpy_mirror_rows_at_exact_boundaries():
    """Unrotated, the mirror's row arithmetic is the plain version's
    exactly: half steps round up, the seam and the poles, NaN and infinite
    directions, rows past the table and below it."""
    rng = np.random.default_rng(11)
    d = np.concatenate([_EDGE_DIRS, _BAD_DIRS])
    steps = np.stack([rng.integers(-200, 200, 42) * 1.0 + 0.5,
                      rng.integers(-20, 20, 42) * 2.5], -1).astype(F32)
    d = torch.from_numpy(np.concatenate([d, steps]))[None]
    for mode in MODES:
        cfg = tbin.BinauraliserConfig(n_sources=d.shape[1], interp_mode=mode)
        w = _random_weights(rng)
        want, _ = _mirror(cfg, w, d)
        got = tbin.hrtf_taps_ri(cfg, w, d).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.abs(np.nan_to_num(got - want)).max() <= (
            TAP_TOL * np.nanmax(np.abs(want)))


def test_direction_major_tables():
    """``hrtf_ri_by_dir`` holds each direction's (ear, band) (re, im) pairs
    contiguously, ``hrtf_mag_by_dir`` its magnitudes: the layouts the
    kernel reads."""
    w = _random_weights(np.random.default_rng(2), n_dirs=7)
    ri, mag = w.hrtf_ri_by_dir, w.hrtf_mag_by_dir
    assert tuple(ri.shape) == (7, 2, N_BANDS, 2) and ri.is_contiguous()
    assert tuple(mag.shape) == (7, 2, N_BANDS) and mag.is_contiguous()
    for d in range(7):
        assert torch.equal(ri[d, ..., 0], w.hrtf_re[:, :, d].T)
        assert torch.equal(ri[d, ..., 1], w.hrtf_im[:, :, d].T)
        assert torch.equal(mag[d], w.hrtf_mag[:, :, d].T)


@pytest.mark.parametrize("n_src", [6, 64])
@pytest.mark.parametrize("rotation", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_fused_render_equals_the_plain_path(mode, rotation, n_src):
    """``process_ri_batched(fused=True)`` takes its taps from
    ``hrtf_taps_ri`` (6 sources: the one-pass route, 64: the (d, g) pair)
    and renders what ``fused=False`` renders, from a random state, over
    blocks of 4 and 2 hops."""
    rng = np.random.default_rng(30 + n_src + rotation)
    cfg = tbin.BinauraliserConfig(n_sources=n_src, interp_mode=mode,
                                  enable_rotation=rotation)
    w = _random_weights(rng)
    dirs, ypr = _controls(rng, 2, n_src, bad=False)
    st0 = tbin.state_from_numpy(rng.uniform(-1, 1, (2, n_src, 15 * 128)),
                                rng.uniform(-1, 1, (2, 2, 9 * 128)), "cpu")
    gains = torch.from_numpy(rng.uniform(0.5, 1.5, (2, n_src)).astype(F32))
    xs = [torch.from_numpy(rng.uniform(-1, 1, (2, n_src, h * 128))
                           .astype(F32)) for h in (4, 2)]
    outs = []
    for fused in (True, False):
        st, ys = st0, []
        for x in xs:
            y, st = tbin.process_ri_batched(cfg, w, st, x, dirs, gains, ypr,
                                            fused=fused)
            ys.append(y)
        outs.append((ys, st))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert bool(torch.isfinite(a).all())
        assert (a - b).abs().max().item() <= RENDER_TOL
    assert torch.equal(outs[0][1].in_tail, outs[1][1].in_tail)
    assert (outs[0][1].ola_tail
            - outs[1][1].ola_tail).abs().max().item() <= RENDER_TOL


def test_fused_render_takes_the_entry_once_a_block(monkeypatch):
    """The kernel route calls ``hrtf_taps_ri`` once a block and none of
    the chain it replaces; ``fused=False`` calls the chain, not the entry."""
    calls = {"taps": 0, "chain": 0}

    def counted(name, key):
        real = getattr(tbin, name)

        @functools.wraps(real)
        def call(*args):
            calls[key] += 1
            return real(*args)
        monkeypatch.setattr(tbin, name, call)

    counted("hrtf_taps_ri", "taps")
    counted("rotate_dirs", "chain")
    counted("interp_hrtfs_ri", "chain")
    rng = np.random.default_rng(4)
    cfg = tbin.BinauraliserConfig(n_sources=3, enable_rotation=True)
    w = _random_weights(rng)
    dirs, ypr = _controls(rng, 2, 3, bad=False)
    for fused, want in ((True, {"taps": 3, "chain": 0}),
                        (False, {"taps": 3, "chain": 6})):
        st = tbin.init_state_batched(cfg, 2, device="cpu")
        for _ in range(3):
            x = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 256)).astype(F32))
            _, st = tbin.process_ri_batched(cfg, w, st, x, dirs, ypr=ypr,
                                            fused=fused)
        assert calls == want
