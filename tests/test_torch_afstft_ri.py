"""The port's plain afSTFT paths vs the JAX package on the CPU: the complex
filterbank, and the stream-batched analysis → per-band matrix → synthesis
path that the CUDA kernel is checked against."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.ops import afstft as jaf
from spatial_audio_framework_tpu.ops import afstft_ri as jri
from spatial_audio_framework_tpu_torch.ops import afstft as taf
from spatial_audio_framework_tpu_torch.ops import afstft_kernels as tak
from spatial_audio_framework_tpu_torch.ops import afstft_ri as tri

BANKS = {"hybrid": dict(hybrid=True, low_delay=False),
         "non_hybrid": dict(hybrid=False, low_delay=False),
         "low_delay": dict(hybrid=True, low_delay=True)}
TOL = 1e-5          # time-domain outputs (|y| ~ 1), fp32 on both sides
SPEC_TOL = 1e-4     # spectra (|X| up to ~20): the same relative bound


def _u(rng, shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("bank", list(BANKS))
def test_complex_afstft_round_trip_vs_jax(bank):
    """AfSTFT.analysis/synthesis (the design-time complex filterbank) over
    two chained blocks."""
    kw = BANKS[bank]
    jb, tb = jaf.AfSTFT(**kw), taf.AfSTFT(**kw)
    rng = np.random.default_rng(0)
    js, ts = jb.init_state(3, 3), tb.init_state(3, 3, device="cpu")
    for _ in range(2):
        x = _u(rng, (3, 4 * 128))
        jX, js = jb.analysis(js, jnp.asarray(x))
        tX, ts = tb.analysis(ts, torch.from_numpy(x))
        assert np.abs(np.asarray(jX) - tX.numpy()).max() <= SPEC_TOL
        jy, js = jb.synthesis(js, jX)
        ty, ts = tb.synthesis(ts, tX)
        assert np.abs(np.asarray(jy) - ty.numpy()).max() <= TOL


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("bank", list(BANKS))
def test_batched_analysis_and_synthesis_vs_jax(bank, packed):
    kw = BANKS[bank]
    jb, tb = jaf.AfSTFT(**kw), taf.AfSTFT(**kw)
    rng = np.random.default_rng(1)
    S, C, H = 2, 3, 5
    in_tail, ola = _u(rng, (S, C, 15 * 128)), _u(rng, (S, C, 9 * 128))
    x = _u(rng, (S, C, H * 128))
    jst = jri.AfSTFTStateBatched(jnp.asarray(in_tail), jnp.asarray(ola))
    tst = tri.AfSTFTStateBatched(torch.from_numpy(in_tail),
                                 torch.from_numpy(ola))
    jspec, jst = jri.analysis_ri_batched(jb, jst, jnp.asarray(x),
                                         use_pallas=False, packed=packed,
                                         mxu_mode="highest")
    tspec, tst = tri.analysis_ri_batched(tb, tst, torch.from_numpy(x),
                                         packed=packed)
    pairs = [(jspec, tspec)] if packed else list(zip(jspec, tspec))
    for a, b in pairs:
        assert a.shape == tuple(b.shape)
        assert np.abs(np.asarray(a) - b.numpy()).max() <= SPEC_TOL
    np.testing.assert_array_equal(np.asarray(jst.in_tail), tst.in_tail.numpy())
    # synthesis of the same (JAX) spectra on both sides
    spec_np = (np.array(jspec) if packed
               else tuple(np.array(s) for s in jspec))
    jy, jst = jri.synthesis_ri_batched(
        jb, jst, jspec, use_pallas=False, packed=packed, mxu_mode="highest")
    ty, tst = tri.synthesis_ri_batched(
        tb, tst, (torch.from_numpy(spec_np) if packed
                  else tuple(torch.from_numpy(s) for s in spec_np)),
        packed=packed)
    assert np.abs(np.asarray(jy) - ty.numpy()).max() <= TOL
    assert np.abs(np.asarray(jst.ola_tail) - tst.ola_tail.numpy()).max() <= TOL


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("matrix", ["complex", "real", "per_stream"])
def test_render_tf_matrix_vs_jax(matrix, fused):
    """render_tf_matrix_ri — the port's einsum reference path
    (fused=False) and its kernel path, which takes the kernel's plain
    version on the CPU (fused=True) — vs the JAX einsum path, two chained
    blocks of 6 hops."""
    rng = np.random.default_rng(2)
    S, cin, cout, H = 2, 3, 2, 6
    shape = ((S,) if matrix == "per_stream" else ()) + (133, cout, cin)
    Mre = rng.standard_normal(shape).astype(np.float32)
    Mim = (None if matrix == "real"
           else rng.standard_normal(shape).astype(np.float32))
    jb, tb = jaf.AfSTFT(), taf.AfSTFT()
    jst = jri.init_state_batched(jb, S, cin, cout)
    tst = tri.init_state_batched(tb, S, cin, cout, device="cpu")
    jM = (jnp.asarray(Mre), None if Mim is None else jnp.asarray(Mim))
    tM = (torch.from_numpy(Mre), None if Mim is None else torch.from_numpy(Mim))
    for _ in range(2):
        x = _u(rng, (S, cin, H * 128))
        jy, jst = jri.render_tf_matrix_ri(jb, jst, jnp.asarray(x), *jM,
                                          use_pallas=False, mxu_mode="highest")
        ty, tst = tri.render_tf_matrix_ri(tb, tst, torch.from_numpy(x), *tM,
                                          fused=fused)
        assert np.abs(np.asarray(jy) - ty.numpy()).max() <= TOL
    assert np.abs(np.asarray(jst.ola_tail) - tst.ola_tail.numpy()).max() <= TOL


# the kernel entries the TF-matrix routes call: every entry of
# afstft_kernels.LAUNCHES that afstft_ri imports (all but the binauraliser's
# hrtf_taps_ri)
_KERNEL_ENTRIES = tuple(n for n in tak.LAUNCHES if hasattr(tri, n))


@pytest.mark.parametrize("shape", ["one_pass", "two_pass", "wide"])
def test_hop64_dispatch_takes_the_plain_path(shape, monkeypatch):
    """Every kernel takes hop 128 only; at hop 64 the kernel route
    (fused=True, use_kernel=True) decides from the bank, before any launch,
    to run the plain path, as the JAX package does (its afstft_ri.py:397,
    :489, :611, :708).  The kernel wrappers are made to refuse: the result
    equals fused=False and the JAX package's own dispatch (use_pallas=True)
    at the same hop."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called at hop 64")

    for name in _KERNEL_ENTRIES:
        monkeypatch.setattr(tri, name, refuse)
    cin, cout = {"one_pass": (3, 2), "two_pass": (17, 2), "wide": (17, 9)}[shape]
    rng = np.random.default_rng(64)
    S, H = 2, 6
    jb, tb = jaf.AfSTFT(hop=64), taf.AfSTFT(hop=64)
    M = rng.standard_normal((2, S, tb.n_bands, cout, cin)).astype(np.float32)
    tM = torch.from_numpy(M)
    jst = jri.init_state_batched(jb, S, cin, cout)
    sts = {f: tri.init_state_batched(tb, S, cin, cout, device="cpu")
           for f in (True, False)}
    for _ in range(2):
        x = _u(rng, (S, cin, H * 64))
        ys = {}
        for f in (True, False):
            ys[f], sts[f] = tri.render_tf_matrix_ri(
                tb, sts[f], torch.from_numpy(x), tM[0], tM[1], fused=f)
        jy, jst = jri.render_tf_matrix_ri(jb, jst, jnp.asarray(x),
                                          jnp.asarray(M[0]), jnp.asarray(M[1]),
                                          use_pallas=True, mxu_mode="highest")
        assert torch.equal(ys[True], ys[False])
        assert np.abs(np.asarray(jy) - ys[True].numpy()).max() <= TOL
    assert torch.equal(sts[True].ola_tail, sts[False].ola_tail)
    # the filterbank halves on their own, and the fused entry point
    spec, st = tri.analysis_ri_batched(tb, sts[True], torch.from_numpy(x),
                                       packed=True, use_kernel=True)
    tri.synthesis_ri_batched(tb, st, spec[:, :cout].contiguous(),
                             packed=True, use_kernel=True)
    tri.render_tf_matrix_fused(tb, sts[True], torch.from_numpy(x), tM[0],
                               tM[1])
