"""QMF, STFT and veclib in the port against the JAX package (CPU): the same
inputs through both, the JAX state handed across at a block boundary."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.ops import qmf as jqmf
from spatial_audio_framework_tpu.ops import stft as jstft
from spatial_audio_framework_tpu.ops import veclib as jV
from spatial_audio_framework_tpu_torch.ops import qmf as tqmf
from spatial_audio_framework_tpu_torch.ops import stft as tstft
from spatial_audio_framework_tpu_torch.ops import veclib as tV

TOL = 1e-5          # float32, another order of sums
TOL64 = 1e-10       # float64


def _close(a, b, tol=TOL, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, atol=tol * max(1.0, np.abs(b).max()),
                               rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# QMF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hop,hybrid", [(128, True), (128, False), (64, True),
                                        (256, True)])
def test_qmf_matches_jax(hop, hybrid):
    jb, tb = jqmf.QMF(hop, hybrid), tqmf.QMF(hop, hybrid)
    assert (tb.n_bands, tb.proc_delay) == (jb.n_bands, jb.proc_delay)
    np.testing.assert_array_equal(tb.centre_freqs(48e3),
                                  jb.centre_freqs(48e3))
    rng = np.random.default_rng(hop + hybrid)
    xs = [rng.uniform(-1, 1, (3, h * hop)).astype(np.float32)
          for h in (8, 3, 5)]
    js = jb.init_state(3, 3)
    ana, syn = jax.jit(jb.analysis), jax.jit(jb.synthesis)
    ts = tb.init_state(3, 3, device="cpu")
    for i, x in enumerate(xs):
        if i == 1:   # hand the JAX state across at a block boundary
            ts = tb.state_from_numpy([np.asarray(a) for a in js], "cpu")
        jspec, js = ana(js, jnp.asarray(x))
        tspec, ts = tb.analysis(ts, torch.from_numpy(x))
        _close(tspec.numpy(), jspec, what=f"spectra, block {i}")
        jy, js = syn(js, jspec)
        ty, ts = tb.synthesis(ts, torch.from_numpy(np.array(jspec)))
        _close(ty.numpy(), jy, what=f"output, block {i}")
    for a, b in zip(ts, js):
        _close(a.numpy(), b, what="state")


@pytest.mark.parametrize("hybrid", [False, True])
def test_qmf_reconstruction(hybrid):
    cfg = tqmf.QMF(hop=128, hybrid=hybrid)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 40 * 128)).astype(
        np.float32)
    st = cfg.init_state(2, 2, device="cpu")
    spec, st = cfg.analysis(st, torch.from_numpy(x))
    y, _ = cfg.synthesis(st, spec)
    d = cfg.proc_delay
    assert np.abs(y.numpy()[:, d:] - x[:, :x.shape[1] - d]).max() < 0.01


def test_qmf_fir_to_filterbank_coeffs_matches_jax():
    h = np.random.default_rng(1).standard_normal((3, 2, 200)).astype(
        np.float32)
    _close(tqmf.qmf_fir_to_filterbank_coeffs(h, 128),
           jqmf.qmf_fir_to_filterbank_coeffs(h, 128))


def test_qmf_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tqmf.QMF().init_state(1, 1)


# ---------------------------------------------------------------------------
# STFT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("win,hop", [(128, 128), (128, 64), (256, 64)])
def test_stft_matches_jax(win, hop):
    jst = jstft.STFT(winsize=win, hopsize=hop, n_ch_in=2, n_ch_out=2)
    tst = tstft.STFT(winsize=win, hopsize=hop, n_ch_in=2, n_ch_out=2)
    rng = np.random.default_rng(win + hop)
    xs = [rng.uniform(-1, 1, (2, h * hop)).astype(np.float32)
          for h in (6, 4, 8)]
    js, ts = jst.init_state(), tst.init_state(device="cpu")
    fwd, bwd = jax.jit(jst.forward), jax.jit(jst.backward)
    for i, x in enumerate(xs):
        if i == 1:
            ts = tst.state_from_numpy(*(np.asarray(a) for a in js), "cpu")
        jspec, js = fwd(js, jnp.asarray(x))
        tspec, ts = tst.forward(ts, torch.from_numpy(x))
        _close(tspec.numpy(), jspec, what=f"spectra {i}")
        jy, js = bwd(js, jspec)
        ty, ts = tst.backward(ts, torch.from_numpy(np.array(jspec)))
        _close(ty.numpy(), jy, what=f"output {i}")


def test_stft_lti_roundtrip():
    st = tstft.STFT(winsize=128, hopsize=128, n_ch_in=2, n_ch_out=2)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 16 * 128)).astype(
        np.float32)
    s = st.init_state(device="cpu")
    spec, s = st.forward(s, torch.from_numpy(x))
    assert tuple(spec.shape) == (129, 2, 16)
    y, _ = st.backward(s, spec)
    np.testing.assert_allclose(y.numpy(), x, atol=1e-5)


# ---------------------------------------------------------------------------
# veclib: every function on numpy and on torch against the JAX module
# ---------------------------------------------------------------------------

def _inputs(dtype):
    rng = np.random.default_rng(0)
    cplx = np.dtype(dtype).kind == "c"
    rnd = (lambda *s: (rng.standard_normal(s) + 1j * rng.standard_normal(s))
           ) if cplx else (lambda *s: rng.standard_normal(s))
    A = rnd(2, 5, 5)
    H = A @ np.conj(np.swapaxes(A, -1, -2)) + 5 * np.eye(5)
    return {"A": A.astype(dtype), "H": H.astype(dtype),
            "B": rnd(2, 5, 3).astype(dtype), "Bt": rnd(2, 3, 5).astype(dtype),
            "v": rnd(2, 7).astype(dtype), "w": rnd(2, 7).astype(dtype),
            "pos": (np.abs(rng.standard_normal((2, 7))) + 0.5).astype(
                np.float32 if dtype in (np.float32, np.complex64)
                else np.float64)}


# name -> (args, real dtypes only); every function of ops/veclib
CALLS = {
    "iminv": ("v",), "imaxv": ("v",), "vvdot": ("v", "w"),
    "svd": ("A",), "seig": ("H",), "glslv": ("A", "B"),
    "glslvt": ("A", "Bt"), "slslv": ("H", "B"), "pinv": ("A",),
    "chol": ("H",), "det": ("A",), "inv": ("A",), "vabs": ("v",),
    "vrecip": ("v",), "vconj": ("v",), "vneg": ("v",), "vvcopy": ("v",),
    "vvadd": ("v", "w"), "vvsub": ("v", "w"), "vvmul": ("v", "w"),
}
SCALAR_CALLS = ("svsmul", "svsdiv", "svsadd", "svssub", "vsadd")
DTYPES = (np.float32, np.float64, np.complex64, np.complex128)


def _ref(name, args):
    """The JAX module's result: on jnp inputs for float32 / complex64 (the
    device path), on numpy inputs for float64 / complex128 (its host
    path; JAX runs without x64)."""
    return getattr(jV, name)(*args)


def _outs(r):
    return [np.asarray(o) for o in (r if isinstance(r, tuple) else (r,))]


def _fix_signs(U):
    """Eigen/singular vectors up to a unit phase per column: rotate each
    column so its largest-magnitude entry is real and positive."""
    U = np.asarray(U)
    idx = np.abs(U).argmax(axis=-2)[..., None, :]
    ph = np.take_along_axis(U, idx, axis=-2)
    return U * (np.conj(ph) / np.abs(ph))


# vmod and sv2cv_inds are real-only in the reference (utility_svmod,
# utility_ssv2cv_inds)
CASES = [(n, d) for n in list(CALLS) + list(SCALAR_CALLS)
         + ["vmod", "sv2cv_inds", "eig", "eigmp"] for d in DTYPES
         if n not in ("vmod", "sv2cv_inds") or np.dtype(d).kind == "f"]


@pytest.mark.parametrize("name,dtype", CASES,
                         ids=[f"{n}-{np.dtype(d).name}" for n, d in CASES])
def test_veclib_numpy_and_torch_match_jax(name, dtype):
    d = _inputs(dtype)
    single = dtype in (np.float32, np.complex64)
    tol = TOL if single else TOL64
    cplx = np.dtype(dtype).kind == "c"
    if name == "vmod" or name == "sv2cv_inds":
        args = ((d["v"], d["pos"]) if name == "vmod"
                else (d["v"], np.array([6, 0, 3])))
    elif name in SCALAR_CALLS:
        args = (d["v"], dtype(1.7) if not cplx else dtype(1.7 - 0.4j))
    elif name in ("eig", "eigmp"):
        args = (d["A"],) if name == "eig" else (d["A"], d["H"])
    else:
        args = tuple(d[a] for a in CALLS[name])
    jargs = tuple(jnp.asarray(a) if single and isinstance(a, np.ndarray)
                  and a.dtype.kind != "i" else a for a in args)
    ref = _outs(_ref(name, jargs))
    for as_tensor in (False, True):
        targs = tuple(torch.from_numpy(a) if as_tensor and isinstance(
            a, np.ndarray) else a for a in args)
        got = _outs(tuple(o.numpy() if isinstance(o, torch.Tensor) else o
                          for o in (lambda r: r if isinstance(r, tuple)
                                    else (r,))(getattr(tV, name)(*targs))))
        assert len(got) == len(ref)
        want = ref
        if name in ("eig", "eigmp"):   # host LAPACK on both sides
            got, want = [np.sort_complex(got[0])], [np.sort_complex(ref[0])]
        if name == "svd":
            got = [_fix_signs(got[0]), got[1], _fix_signs(got[2])]
            want = [_fix_signs(ref[0]), ref[1], _fix_signs(ref[2])]
        if name == "seig":
            got = [_fix_signs(got[0]), got[1]]
            want = [_fix_signs(ref[0]), ref[1]]
        for k, (g, r) in enumerate(zip(got, want)):
            if r.dtype.kind == "i":
                np.testing.assert_array_equal(g, r)
            else:
                _close(g, r, tol, what=f"{name} out {k} torch={as_tensor}")


def test_veclib_cabs1_and_seig_order_on_torch():
    a = torch.tensor([2.2 + 0.0j, 1.5 + 1.5j])
    assert int(tV.imaxv(a)) == 1 and int(tV.iminv(a)) == 0
    H = torch.diag(torch.tensor([1.0, 3.0, 2.0]))
    V, d = tV.seig(H)
    assert d.tolist() == [3.0, 2.0, 1.0]
    assert tV.seig(H, sort_decreasing=False)[1].tolist() == [1.0, 2.0, 3.0]
