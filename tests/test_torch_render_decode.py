"""The two-kernel TF-matrix pipeline: the plain versions of
analysis_front_dg_ri, render_decode_synthesis_ri and
render_decode_synthesis_dg_ri vs the JAX Pallas kernels run in interpret
mode (CPU), the route each render shape takes, and render_tf_matrix_fused
at a width past the one-pass kernel vs the JAX package and the port's
plain path."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.ops import afstft as jaf
from spatial_audio_framework_tpu.ops import afstft_ri as jri
from spatial_audio_framework_tpu.ops import pallas_afstft as jpa
from spatial_audio_framework_tpu_torch.ops import afstft as taf
from spatial_audio_framework_tpu_torch.ops import afstft_kernels as tak
from spatial_audio_framework_tpu_torch.ops import afstft_ri as tri

# "highest" is exact fp32 on both sides, so only the order of the sums
# differs (the port sums the decode over cin in one reduction, the TPU's
# _render_kernel channel by channel: ~1 ulp·√cin).  Time-domain inputs are
# white noise at half full scale, so the spectra stay below |X| ~ 14 where
# 1e-5 is about 10 float32 ulps; random taps are scaled by √(16/cin) above
# 16 inputs so the outputs keep the flagship's scale (|y| ≲ 4).
TOL = 1e-5
AMP = 0.5
# (S, cin, cout, H): one pass-width render, the order-4 width at H < 9 and
# an odd width with three ears and a single hop
SHAPES = [(3, 5, 2, 8), (2, 25, 2, 4), (2, 17, 3, 1)]


def _u(rng, shape, amp=AMP):
    return (amp * rng.uniform(-1, 1, shape)).astype(np.float32)


def _maxerr(a, b):
    return float(np.abs(np.asarray(a) - b.numpy()).max())


def _taps(rng, S, cin, cout, per_stream, hybrid):
    """decode_taps of random (n_bands, cout, cin) matrices as numpy."""
    shape = ((S,) if per_stream else ()) + (133 if hybrid else 129, cout, cin)
    M = _u(rng, (2,) + shape, amp=min(1.0, np.sqrt(16 / cin)))
    return tak.decode_taps(torch.from_numpy(M[0]), torch.from_numpy(M[1]),
                           hybrid=hybrid).contiguous().numpy()


def _front(rng, S, cin, H, low_delay, dg):
    """Spectra of half-scale noise from the port's plain front: the H+6-hop
    spectra, or with ``dg`` the (d, g) pair, as (S, cin, ...) numpy."""
    tail = torch.from_numpy(_u(rng, (S * cin, 15 * 128)))
    x = torch.from_numpy(_u(rng, (S * cin, H * 128)))
    fn = (tak.analysis_front_dg_ri_reference if dg
          else tak.analysis_front_ri_reference)
    return [np.ascontiguousarray(t.reshape(S, cin, *t.shape[1:]).numpy())
            for t in fn(tail, x, low_delay=low_delay)]


@pytest.mark.parametrize("low_delay", [False, True])
@pytest.mark.parametrize("S,cin,cout,H", SHAPES)
def test_analysis_front_dg_reference_vs_jax(S, cin, cout, H, low_delay):
    """Rows = S·cin (not multiples of the TPU kernel's 8), two chained calls
    carrying the 15-hop input tail."""
    rng = np.random.default_rng(S * cin + H)
    tail = _u(rng, (S * cin, 15 * 128))
    for _ in range(2):
        x = _u(rng, (S * cin, H * 128))
        jout = jpa.analysis_front_dg_ri(jnp.asarray(tail), jnp.asarray(x),
                                        low_delay=low_delay, interpret=True,
                                        mxu_mode="highest")
        tout = tak.analysis_front_dg_ri_reference(
            torch.from_numpy(tail), torch.from_numpy(x), low_delay=low_delay)
        for j, t, n in zip(jout, tout, (129, 129, 16, 16)):
            assert t.shape == (S * cin, H, n) == j.shape
            assert _maxerr(j, t) <= TOL
        tail = np.ascontiguousarray(
            np.concatenate([tail, x], axis=-1)[:, H * 128:])


@pytest.mark.parametrize("hybrid", [True, False])
@pytest.mark.parametrize("low_delay", [False, True])
@pytest.mark.parametrize("per_stream", [False, True])
@pytest.mark.parametrize("S,cin,cout,H", SHAPES)
def test_render_decode_synthesis_reference_vs_jax(S, cin, cout, H,
                                                  per_stream, low_delay,
                                                  hybrid):
    """From the front's H+6-hop spectra, two chained calls carrying the
    overlap tail."""
    rng = np.random.default_rng(S * cin + H + 1)
    taps = _taps(rng, S, cin, cout, per_stream, hybrid)
    ola = _u(rng, (S, cout, 9, 128), amp=1.0)
    jt, tt = jnp.asarray(ola), torch.from_numpy(ola)
    kw = dict(low_delay=low_delay, hybrid=hybrid, per_stream=per_stream)
    for _ in range(2):
        sre, sim = _front(rng, S, cin, H, low_delay, dg=False)
        jy, jt = jpa.render_decode_synthesis_ri(
            jnp.asarray(sre), jnp.asarray(sim), jt, jnp.asarray(taps),
            interpret=True, mxu_mode="highest", **kw)
        ty, tt = tak.render_decode_synthesis_ri_reference(
            torch.from_numpy(sre), torch.from_numpy(sim), tt,
            torch.from_numpy(taps), **kw)
        assert ty.shape == (S, cout, H * 128) and tt.shape == (S, cout, 9, 128)
        assert _maxerr(jy, ty) <= TOL and _maxerr(jt, tt) <= TOL


@pytest.mark.parametrize("low_delay", [False, True])
@pytest.mark.parametrize("per_stream", [False, True])
@pytest.mark.parametrize("S,cin,cout,H", SHAPES)
def test_render_decode_synthesis_dg_reference_vs_jax(S, cin, cout, H,
                                                     per_stream, low_delay):
    """From the front's (d, g) pair, two chained calls carrying the overlap
    tail."""
    rng = np.random.default_rng(S * cin + H + 2)
    taps = _taps(rng, S, cin, cout, per_stream, True)
    ola = _u(rng, (S, cout, 9, 128), amp=1.0)
    jt, tt = jnp.asarray(ola), torch.from_numpy(ola)
    kw = dict(low_delay=low_delay, per_stream=per_stream)
    for _ in range(2):
        dg = _front(rng, S, cin, H, low_delay, dg=True)
        jy, jt = jpa.render_decode_synthesis_dg_ri(
            *(jnp.asarray(t) for t in dg), jt, jnp.asarray(taps),
            interpret=True, mxu_mode="highest", **kw)
        ty, tt = tak.render_decode_synthesis_dg_ri_reference(
            *(torch.from_numpy(t) for t in dg), tt, torch.from_numpy(taps),
            **kw)
        assert ty.shape == (S, cout, H * 128) and tt.shape == (S, cout, 9, 128)
        assert _maxerr(jy, ty) <= TOL and _maxerr(jt, tt) <= TOL


def test_cpu_wrappers_are_the_references_and_not_counted():
    rng = np.random.default_rng(3)
    S, cin, cout, H = 2, 3, 2, 5
    taps = torch.from_numpy(_taps(rng, S, cin, cout, False, True))
    ola = torch.from_numpy(_u(rng, (S, cout, 9, 128)))
    tail = torch.from_numpy(_u(rng, (S * cin, 15 * 128)))
    x = torch.from_numpy(_u(rng, (S * cin, H * 128)))
    sre, sim = (torch.from_numpy(t) for t in _front(rng, S, cin, H, False,
                                                    dg=False))
    dg = [torch.from_numpy(t) for t in _front(rng, S, cin, H, False, dg=True)]
    names = ("analysis_front_dg_ri", "render_decode_synthesis_ri",
             "render_decode_synthesis_dg_ri")
    before = [tak.LAUNCHES[n] for n in names]
    pairs = [
        (tak.analysis_front_dg_ri(tail, x),
         tak.analysis_front_dg_ri_reference(tail, x)),
        (tak.render_decode_synthesis_ri(sre, sim, ola, taps),
         tak.render_decode_synthesis_ri_reference(sre, sim, ola, taps)),
        (tak.render_decode_synthesis_dg_ri(*dg, ola, taps),
         tak.render_decode_synthesis_dg_ri_reference(*dg, ola, taps))]
    for got, ref in pairs:
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert [tak.LAUNCHES[n] for n in names] == before


_WRAPPERS = ("analysis_front_ri", "analysis_front_dg_ri",
             "render_decode_synthesis_ri", "render_decode_synthesis_dg_ri",
             "render_full_ri", "synthesis_back_ri")


@pytest.mark.parametrize("cin,cout,bank,per_stream,expect", [
    (16, 2, {}, False, ["render_full_ri"]),
    (25, 2, {}, False,
     ["analysis_front_dg_ri", "render_decode_synthesis_dg_ri"]),
    (25, 2, {"low_delay": True}, True,
     ["analysis_front_dg_ri", "render_decode_synthesis_dg_ri"]),
    (25, 2, {"hybrid": False}, False,
     ["analysis_front_ri", "render_decode_synthesis_ri"]),
    (16, 9, {}, False, ["analysis_front_ri", "synthesis_back_ri"]),
])
def test_render_routes(monkeypatch, cin, cout, bank, per_stream, expect):
    """render_tf_matrix_ri(fused=True): cin ≤ 16 reaches only the one-pass
    kernel, wider inputs only the two-kernel pipeline of their bank, and
    cout·cin > 128 only the filterbank pair; each route matches the plain
    path."""
    calls = []
    for name in _WRAPPERS:
        real = getattr(tri, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(tri, name, spy)
    rng = np.random.default_rng(5)
    tb = taf.AfSTFT(**bank)
    S, H = 2, 3
    shape = ((S,) if per_stream else ()) + (tb.n_bands, cout, cin)
    M = torch.from_numpy(_u(rng, (2,) + shape, amp=min(1.0, np.sqrt(16 / cin))))
    st = tri.init_state_batched(tb, S, cin, cout, device="cpu")
    x = torch.from_numpy(_u(rng, (S, cin, H * 128)))
    y, _ = tri.render_tf_matrix_ri(tb, st, x, M[0], M[1])
    assert calls == expect and y.shape == (S, cout, H * 128)
    calls.clear()
    yp, _ = tri.render_tf_matrix_ri(tb, st, x, M[0], M[1], fused=False)
    assert calls == [] and (y - yp).abs().max().item() <= TOL


@pytest.mark.parametrize("bank", [{}, {"hybrid": False}, {"low_delay": True}])
def test_render_tf_matrix_fused_two_pass_vs_jax(bank):
    """render_tf_matrix_fused at cin = 25 (the two-kernel route) vs the JAX
    render_tf_matrix_fused in interpret mode at "highest" and vs the port's
    plain path, two chained blocks of 6 hops (H < 9, H < 15)."""
    rng = np.random.default_rng(6)
    S, cin, cout, H = 2, 25, 2, 6
    jb, tb = jaf.AfSTFT(**bank), taf.AfSTFT(**bank)
    M = _u(rng, (2, tb.n_bands, cout, cin), amp=0.8)
    jst = jri.init_state_batched(jb, S, cin, cout)
    tst = pst = tri.init_state_batched(tb, S, cin, cout, device="cpu")
    for _ in range(2):
        x = _u(rng, (S, cin, H * 128))
        jy, jst = jri.render_tf_matrix_fused(
            jb, jst, jnp.asarray(x), jnp.asarray(M[0]), jnp.asarray(M[1]),
            interpret=True, mxu_mode="highest")
        ty, tst = tri.render_tf_matrix_fused(
            tb, tst, torch.from_numpy(x), torch.from_numpy(M[0]),
            torch.from_numpy(M[1]))
        py, pst = tri.render_tf_matrix_ri(
            tb, pst, torch.from_numpy(x), torch.from_numpy(M[0]),
            torch.from_numpy(M[1]), fused=False)
        assert _maxerr(jy, ty) <= TOL
        assert (ty - py).abs().max().item() <= TOL
    assert _maxerr(jst.ola_tail, tst.ola_tail) <= TOL
    np.testing.assert_array_equal(np.asarray(jst.in_tail),
                                  tst.in_tail.numpy())
