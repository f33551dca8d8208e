"""models/spreader in the PyTorch port vs the JAX reference (CPU), in its
three modes: the design (weights and the lattice from the C's rand()
stream), ``process`` frame by frame, ``process_chunk`` and
``process_chunk`` with an instance axis (the batched filterbank with its
kernels' plain versions, ``fused`` both ways; the JAX side ``jax.vmap`` of
process_chunk, as its bench runs it), with the JAX state handed across at
a frame boundary (``state_from_numpy``).

Tolerances, relative to max(1, |ref|): 1e-5 for naive mode (filterbank
and sums only), 2e-4 for OM and EVD (CDF4SAP / eigendecomposition chains
in float32 on both sides)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import spreader as J
from spatial_audio_framework_tpu.modules.hrir import default_hrirs
from spatial_audio_framework_tpu_torch.models import spreader as T

MODES = (J.MODE_NAIVE, J.MODE_OM, J.MODE_EVD)
F = 256


def _tol(mode):
    return 1e-5 if mode == J.MODE_NAIVE else 2e-4


def _err(ref, got):
    ref = np.asarray(ref)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(ref - got).max() / max(1.0, np.abs(ref).max()))


def _np(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(_np(t) for t in tree)
    return np.asarray(tree)


@pytest.fixture(scope="module")
def setup():
    h, d, fs = default_hrirs()
    h, d = h[::8], d[::8]
    out = {}
    for mode in MODES:
        kw = dict(n_sources=2, mode=mode, cov_avg_coeff=0.5)
        jc, tc = J.SpreaderConfig(**kw), T.SpreaderConfig(**kw)
        wj = J.design(jc, h, d, fs, c_rand_offset=11)
        wt = T.design(tc, h, d, fs, c_rand_offset=11, device="cpu")
        out[mode] = (jc, tc, wj, wt)
    dirs = np.array([[40.0, 10.0], [-100.0, -20.0]], np.float32)
    spread = np.array([60.0, 120.0], np.float32)
    return out, dirs, spread


def _state(sj):
    s = _np(sj)
    return T.state_from_numpy(s[0], s[1], *s[2:], device="cpu")


def test_design_equals_jax(setup):
    jc, tc, wj, wt = setup[0][J.MODE_OM]
    for name in ("H_re", "H_im", "HHH_re", "HHH_im", "grid_u", "freqs"):
        assert _err(getattr(wj, name), getattr(wt, name)) <= 1e-5, name
    for k in ("b", "a", "delays", "filtered"):
        assert np.array_equal(wj.lattice[k], wt.lattice[k]), k
    w2 = T.weights_from_numpy(*(np.asarray(getattr(wj, n)) for n in (
        "H_re", "H_im", "HHH_re", "HHH_im", "grid_u", "freqs")),
        dict(wj.lattice), device="cpu")
    assert torch.equal(w2.HHH_re, torch.from_numpy(np.array(wj.HHH_re)))


@pytest.mark.parametrize("mode", MODES)
def test_process_and_chunk_vs_jax(setup, mode):
    cfgs, dirs, spread = setup
    jc, tc, wj, wt = cfgs[mode]
    dj, sj_ = jnp.asarray(dirs), jnp.asarray(spread)
    dt, st_ = torch.from_numpy(dirs), torch.from_numpy(spread)
    rng = np.random.default_rng(len(mode))
    x = rng.uniform(-1, 1, (7, 2, F)).astype(np.float32)
    sj, st = J.init_state(jc, wj), T.init_state(tc, wt, device="cpu")
    for f in range(3):
        if f == 1:
            st = _state(sj)
        yj, sj = J.process(jc, wj, sj, jnp.asarray(x[f]), dj, sj_)
        yt, st = T.process(tc, wt, st, torch.from_numpy(x[f]), dt, st_)
        assert yt.shape == (2, F) and _err(yj, yt) <= _tol(mode), f
    yj, cj = J.process_chunk(jc, wj, sj, jnp.asarray(x[3:]), dj, sj_)
    yt, ct = T.process_chunk(tc, wt, _state(sj), torch.from_numpy(x[3:]),
                             dt, st_)
    assert yt.shape == (4, 2, F) and _err(yj, yt) <= _tol(mode)
    # the covariance averages; the mixing matrices are not held: OM's
    # prototype covariance is rank one (+1e-5 I), where CDF4SAP's M is free
    # on the null space (the output, M applied to the prototype, is not)
    for a, b in zip(_np(cj)[2:6], ct[2:6]):
        assert _err(a, b) <= _tol(mode)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode", [J.MODE_OM, J.MODE_EVD])
def test_chunk_instances_vs_jax(setup, mode, fused):
    """2 instances, 2 calls of 3 frames; between them the JAX state handed
    across (its vmapped single-stream filterbank state → the batched one:
    the analysis tail from the last 15 hops of each instance's input)."""
    cfgs, dirs, spread = setup
    jc, tc, wj, wt = cfgs[mode]
    dj, sj_ = jnp.asarray(dirs), jnp.asarray(spread)
    dt, st_ = torch.from_numpy(dirs), torch.from_numpy(spread)
    rng = np.random.default_rng(5)
    N = 2
    xs = [rng.uniform(-1, 1, (N, 3, 2, F)).astype(np.float32)
          for _ in range(2)]
    sj = jax.tree_util.tree_map(lambda a: jnp.stack([a] * N),
                                J.init_state(jc, wj))
    st = T.init_state(tc, wt, n_instances=N, device="cpu")
    run = jax.vmap(lambda s, xx: J.process_chunk(jc, wj, s, xx, dj, sj_))
    for call, x in enumerate(xs):
        if call == 1:
            hist = xs[0].transpose(0, 2, 1, 3).reshape(N, 2, -1)
            hist = np.concatenate([np.zeros((N, 2, 15 * 128), np.float32),
                                   hist], -1)[..., -15 * 128:]
            s = _np(sj)
            st = T.state_from_numpy((hist, s[0][3]), s[1], *s[2:],
                                    device="cpu")
        yj, sj = run(sj, jnp.asarray(x))
        yt, st = T.process_chunk(tc, wt, st, torch.from_numpy(x), dt, st_,
                                 fused=fused)
        assert yt.shape == (N, 3, 2, F) and _err(yj, yt) <= _tol(mode), call
    # an instance equals the single-instance chunk on it alone
    y1, _ = T.process_chunk(tc, wt, T.init_state(tc, wt, device="cpu"),
                            torch.from_numpy(xs[0][1]), dt, st_)
    yb, _ = T.process_chunk(tc, wt, T.init_state(tc, wt, n_instances=N,
                                                 device="cpu"),
                            torch.from_numpy(xs[0]), dt, st_, fused=fused)
    assert _err(y1.numpy(), yb[1]) <= _tol(mode)
