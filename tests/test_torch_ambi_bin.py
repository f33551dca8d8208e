"""ambi_bin in the PyTorch port vs the JAX reference (CPU): the design, and
the batched render on identical weights and inputs."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import ambi_bin as jab
from spatial_audio_framework_tpu_torch.models import ambi_bin as tab

DESIGN_TOL = 1e-4
RENDER_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _jax_design(order, method, preproc="eq"):
    cfg = jab.AmbiBinConfig(order=order, method=method, hrir_preproc=preproc)
    return tuple(np.asarray(m) for m in jab.design_ri(cfg))


@pytest.mark.parametrize("order,method,preproc", [
    (1, "magls", "eq"), (3, "magls", "eq"), (1, "ls", "eq"),
    (1, "lsdiffeq", "eq"), (1, "ta", "eq"), (1, "magls", "all"),
    (7, "magls", "eq")])
def test_design_ri_vs_jax(order, method, preproc):
    ref = _jax_design(order, method, preproc)
    got = tab.design_ri(tab.AmbiBinConfig(order=order, method=method,
                                          hrir_preproc=preproc),
                        device="cpu")
    for a, b in zip(ref, got):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
        assert np.abs(a - b.numpy()).max() <= DESIGN_TOL


def _chunks(rng, S, nsh):
    """3 chained chunks of 8 hops, then one of 4 (H < 9 and H < 15)."""
    return [rng.uniform(-1, 1, (S, nsh, h * 128)).astype(np.float32)
            for h in (8, 8, 8, 4)]


def _run_jax(cfg, w, xs):
    st = jab.init_state_batched(cfg, xs[0].shape[0])
    ys = []
    for x in xs:
        y, st = jab.process_ri_batched(cfg, w, st, jnp.asarray(x),
                                       use_pallas=True, interpret=True)
        ys.append(np.asarray(y))
    return ys, st


def _run_port(cfg, w, xs, fused=True):
    st = tab.init_state_batched(cfg, xs[0].shape[0], device="cpu")
    ys = []
    for x in xs:
        y, st = tab.process_ri_batched(cfg, w, st, torch.from_numpy(x),
                                       fused=fused)
        ys.append(y.numpy())
    return ys, st


def _assert_close(ys_a, st_a, ys_b, st_b, tol):
    for a, b in zip(ys_a, ys_b):
        assert a.shape == b.shape and np.abs(a - b).max() <= tol
    assert np.abs(np.asarray(st_a.ola_tail) - np.asarray(st_b.ola_tail)).max() <= tol
    np.testing.assert_array_equal(np.asarray(st_a.in_tail),
                                  np.asarray(st_b.in_tail))


def test_process_ri_batched_vs_jax_on_its_weights():
    """The slice on the JAX design's weights: port (CPU) vs the JAX Pallas
    path in interpret mode at exact fp32 ("highest")."""
    Mre, Mim = _jax_design(1, "magls")
    jcfg = jab.AmbiBinConfig(order=1, mxu_precision="highest")
    tcfg = tab.AmbiBinConfig(order=1, mxu_precision="highest")
    xs = _chunks(np.random.default_rng(0), 2, 4)
    ys_j, st_j = _run_jax(jcfg, (jnp.asarray(Mre), jnp.asarray(Mim)), xs)
    ys_t, st_t = _run_port(tcfg, tab.weights_from_numpy(Mre, Mim, "cpu"), xs)
    _assert_close(ys_j, st_j, ys_t, st_t, RENDER_TOL)


def test_process_ri_batched_order7_vs_jax_on_its_weights():
    """The order-7 slice (64 SH inputs: the two-kernel (d, g) route) on the
    JAX design's weights: port (CPU) vs the JAX Pallas path in interpret
    mode at exact fp32 ("highest"), chunks of 8, 8, 8 and 4 hops."""
    Mre, Mim = _jax_design(7, "magls")
    jcfg = jab.AmbiBinConfig(order=7, mxu_precision="highest")
    tcfg = tab.AmbiBinConfig(order=7, mxu_precision="highest")
    xs = _chunks(np.random.default_rng(7), 2, 64)
    ys_j, st_j = _run_jax(jcfg, (jnp.asarray(Mre), jnp.asarray(Mim)), xs)
    ys_t, st_t = _run_port(tcfg, tab.weights_from_numpy(Mre, Mim, "cpu"), xs)
    _assert_close(ys_j, st_j, ys_t, st_t, RENDER_TOL)


def test_process_ri_batched_fuma_vs_jax():
    """FuMa input: the conversion is applied in process, not at design."""
    rng = np.random.default_rng(4)
    M = rng.standard_normal((2, 133, 2, 4)).astype(np.float32)
    kw = dict(order=1, ch_ordering="fuma", norm="fuma",
              mxu_precision="highest")
    xs = _chunks(rng, 2, 4)
    ys_j, st_j = _run_jax(jab.AmbiBinConfig(**kw),
                          (jnp.asarray(M[0]), jnp.asarray(M[1])), xs)
    ys_t, st_t = _run_port(tab.AmbiBinConfig(**kw),
                           tab.weights_from_numpy(M[0], M[1], "cpu"), xs)
    _assert_close(ys_j, st_j, ys_t, st_t, RENDER_TOL)


def test_fused_path_vs_plain_path():
    """The port's kernel path (its plain version on the CPU) vs its einsum
    reference path, from a random non-zero state (state_from_numpy)."""
    rng = np.random.default_rng(5)
    Mre, Mim = _jax_design(1, "magls")
    cfg = tab.AmbiBinConfig(order=1)
    w = tab.weights_from_numpy(Mre, Mim, "cpu")
    st0 = tab.state_from_numpy(
        rng.uniform(-1, 1, (2, 4, 15 * 128)), rng.uniform(-1, 1, (2, 2, 9 * 128)),
        "cpu")
    xs = _chunks(rng, 2, 4)
    outs = []
    for fused in (True, False):
        st, ys = st0, []
        for x in xs:
            y, st = tab.process_ri_batched(cfg, w, st, torch.from_numpy(x),
                                           fused=fused)
            ys.append(y.numpy())
        outs.append((ys, st))
    _assert_close(*outs[0], *outs[1], RENDER_TOL)
