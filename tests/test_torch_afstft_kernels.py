"""analysis_front_ri and synthesis_back_ri: the port's plain versions vs the
JAX Pallas kernels run in interpret mode (CPU), the batched filterbank's
kernel route vs the JAX package's Pallas route, the wrappers' CPU contract,
the kernel seam and the TF-matrix dispatch."""
import ast
import ctypes
from pathlib import Path

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
# differs.  Inputs are white noise at half full scale: the analysis spectra
# then stay below |X| ~ 14, where 1e-5 is about 10 float32 ulps.
TOL = 1e-5
# the JAX Pallas route's default mode is the TPU's bf16 f32x3 split
# (pallas_afstft.py:51-64), ~4e-6 relative per product
HIGH_TOL = 2e-4
AMP = 0.5
BANKS = {"hybrid": dict(hybrid=True, low_delay=False),
         "non_hybrid": dict(hybrid=False, low_delay=False),
         "low_delay": dict(hybrid=True, low_delay=True)}


def _u(rng, shape, amp=AMP):
    return (amp * rng.uniform(-1, 1, shape)).astype(np.float32)


def _maxerr(a, b):
    return float(np.abs(np.asarray(a) - b.numpy()).max())


@pytest.mark.parametrize("t_hops", [9, 15])
@pytest.mark.parametrize("low_delay", [False, True])
@pytest.mark.parametrize("H", [4, 16])
def test_analysis_front_reference_vs_jax(H, low_delay, t_hops):
    """B = 5 rows (not a multiple of the TPU kernel's 8); the batched
    path's 15-hop tail and the contract's least, 9 hops."""
    rng = np.random.default_rng(0)
    tail, x = _u(rng, (5, t_hops * 128)), _u(rng, (5, H * 128))
    jre, jim = jpa.analysis_front_ri(jnp.asarray(tail), jnp.asarray(x),
                                     low_delay=low_delay, interpret=True,
                                     mxu_mode="highest")
    tre, tim = tak.analysis_front_ri_reference(
        torch.from_numpy(tail), torch.from_numpy(x), low_delay=low_delay)
    assert tre.shape == (5, H + t_hops - 9, 129) == jre.shape
    assert _maxerr(jre, tre) <= TOL and _maxerr(jim, tim) <= TOL


@pytest.mark.parametrize("hybrid", [True, False])
@pytest.mark.parametrize("low_delay", [False, True])
@pytest.mark.parametrize("H", [4, 16])
def test_synthesis_back_reference_vs_jax(H, low_delay, hybrid):
    """Two chained calls carrying the overlap tail (H = 4 < 9 included)."""
    rng = np.random.default_rng(1)
    nb = 133 if hybrid else 129
    tail = _u(rng, (5, 9, 128))
    jt, tt = jnp.asarray(tail), torch.from_numpy(tail)
    for _ in range(2):
        spec = _u(rng, (5, H, 2 * nb), amp=10.0)
        jy, jt = jpa.synthesis_back_ri(jnp.asarray(spec), jt,
                                       low_delay=low_delay, hybrid=hybrid,
                                       interpret=True, mxu_mode="highest")
        ty, tt = tak.synthesis_back_ri_reference(
            torch.from_numpy(spec), tt, low_delay=low_delay, hybrid=hybrid)
        assert ty.shape == (5, H, 128) and tt.shape == (5, 9, 128)
        assert _maxerr(jy, ty) <= TOL and _maxerr(jt, tt) <= TOL


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("bank", list(BANKS))
def test_batched_kernel_route_vs_jax_pallas(bank, packed):
    """analysis_ri_batched / synthesis_ri_batched with use_kernel (on the
    CPU: the kernels' plain versions) vs the JAX package's Pallas route in
    interpret mode, default precision; H = 5 < 15 exercises the in-tail
    concatenation."""
    kw = BANKS[bank]
    jb, tb = jaf.AfSTFT(**kw), taf.AfSTFT(**kw)
    rng = np.random.default_rng(2)
    S, C, H = 2, 3, 5
    in_tail, ola = _u(rng, (S, C, 15 * 128)), _u(rng, (S, C, 9 * 128))
    x = _u(rng, (S, C, H * 128))
    jst = jri.AfSTFTStateBatched(jnp.asarray(in_tail), jnp.asarray(ola))
    tst = tri.AfSTFTStateBatched(torch.from_numpy(in_tail),
                                 torch.from_numpy(ola))
    jspec, jst = jri.analysis_ri_batched(jb, jst, jnp.asarray(x),
                                         use_pallas=True, interpret=True,
                                         packed=packed)
    tspec, tst = tri.analysis_ri_batched(tb, tst, torch.from_numpy(x),
                                         packed=packed, use_kernel=True)
    pairs = [(jspec, tspec)] if packed else list(zip(jspec, tspec))
    for a, b in pairs:
        assert a.shape == tuple(b.shape)
        assert _maxerr(a, b) <= HIGH_TOL
    np.testing.assert_array_equal(np.asarray(jst.in_tail), tst.in_tail.numpy())
    spec_np = (np.array(jspec) if packed
               else tuple(np.array(s) for s in jspec))
    jy, jst = jri.synthesis_ri_batched(jb, jst, jspec, use_pallas=True,
                                       interpret=True, packed=packed)
    ty, tst = tri.synthesis_ri_batched(
        tb, tst, (torch.from_numpy(spec_np) if packed
                  else tuple(torch.from_numpy(s) for s in spec_np)),
        packed=packed, use_kernel=True)
    assert _maxerr(jy, ty) <= HIGH_TOL
    assert _maxerr(jst.ola_tail, tst.ola_tail) <= HIGH_TOL


@pytest.mark.parametrize("bank", list(BANKS))
def test_kernel_route_matches_plain_route(bank):
    """On the CPU both routes are plain torch; they differ only in the
    order of the rDFT's sums (two half-K products vs one)."""
    tb = taf.AfSTFT(**BANKS[bank])
    rng = np.random.default_rng(3)
    S, C, H = 3, 2, 17
    st = tri.AfSTFTStateBatched(torch.from_numpy(_u(rng, (S, C, 15 * 128))),
                                torch.from_numpy(_u(rng, (S, C, 9 * 128))))
    x = torch.from_numpy(_u(rng, (S, C, H * 128)))
    ks, kst = tri.analysis_ri_batched(tb, st, x, packed=True, use_kernel=True)
    ps, pst = tri.analysis_ri_batched(tb, st, x, packed=True)
    assert (ks - ps).abs().max().item() <= TOL
    assert torch.equal(kst.in_tail, pst.in_tail)
    ky, kst = tri.synthesis_ri_batched(tb, st, ps, packed=True,
                                       use_kernel=True)
    py, pst = tri.synthesis_ri_batched(tb, st, ps, packed=True)
    assert (ky - py).abs().max().item() <= TOL
    assert (kst.ola_tail - pst.ola_tail).abs().max().item() <= TOL


def test_cpu_wrappers_are_the_references_and_not_counted():
    rng = np.random.default_rng(4)
    tail, x = torch.from_numpy(_u(rng, (3, 15 * 128))), \
        torch.from_numpy(_u(rng, (3, 4 * 128)))
    spec = torch.from_numpy(_u(rng, (3, 4, 266)))
    ola = torch.from_numpy(_u(rng, (3, 9, 128)))
    before = (tak.LAUNCHES["analysis_front_ri"],
              tak.LAUNCHES["synthesis_back_ri"])
    for a, b in zip(tak.analysis_front_ri(tail, x),
                    tak.analysis_front_ri_reference(tail, x)):
        assert torch.equal(a, b)
    for a, b in zip(tak.synthesis_back_ri(spec, ola),
                    tak.synthesis_back_ri_reference(spec, ola)):
        assert torch.equal(a, b)
    assert (tak.LAUNCHES["analysis_front_ri"],
            tak.LAUNCHES["synthesis_back_ri"]) == before


def _imports(path: Path) -> set[str]:
    """Every module and name a source file imports, at its top or inside a
    function, as dotted paths."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            out.update(f"{node.module}.{a.name}" for a in node.names)
    return out


def test_the_kernel_layer_imports_point_down():
    """The kernel module imports neither the routes above it nor a model,
    the spans and counters import nothing of the package, and no code
    reaches behind a decorator for the function it wraps."""
    pkg = Path(tak.__file__).resolve().parents[1]
    name = pkg.name
    assert not {m for m in _imports(pkg / "ops" / "afstft_kernels.py")
                if m.startswith((f"{name}.ops.afstft_ri", f"{name}.models"))}
    assert not {m for m in _imports(pkg / "utils" / "profiling.py")
                if m.startswith(name)}
    assert not [f for f in pkg.rglob("*.py") if "__wrapped__" in f.read_text()]


def test_the_seam_passes_each_kind_as_its_c_type():
    """A launch passes a tensor as its data pointer, None as a null
    pointer, an int or a bool as a C int and a float as a C float, with the
    stream last; the entry's argument types are set at its first call and
    kept.  An entry given a tensor on a device that is neither the CPU nor
    CUDA raises before any launch."""
    seen = []

    @ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p)
    def entry(ptr, null, n, flag, scale, stream):
        seen.append((ptr, null, n, flag, scale, stream))
        return len(seen)

    # a symbol with no declared types, as a loaded library's is
    c_fn = ctypes.CFUNCTYPE(ctypes.c_int)(
        ctypes.cast(entry, ctypes.c_void_p).value)
    a, b = torch.zeros(4), torch.ones(3)
    assert tak._call(c_fn, (a, None, 7, True, 0.25), 12345) == 1
    types = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_void_p]
    assert list(c_fn.argtypes) == types
    assert tak._call(c_fn, (b, a, -3, False, 1.5), 678) == 2
    assert list(c_fn.argtypes) == types
    assert seen == [(a.data_ptr(), None, 7, 1, 0.25, 12345),
                    (b.data_ptr(), a.data_ptr(), -3, 0, 1.5, 678)]
    with pytest.raises(TypeError, match="no C type"):
        tak._c_type("hybrid")
    before = dict(tak.LAUNCHES)
    with pytest.raises(ValueError, match="unsupported device meta"):
        tak.analysis_front_ri(torch.zeros((2, 15 * 128), device="meta"),
                              torch.zeros((2, 4 * 128), device="meta"))
    assert tak.LAUNCHES == before


@pytest.mark.parametrize("low_delay", [False, True])
@pytest.mark.parametrize("hybrid", [True, False])
def test_synthesis_constants_vs_jax(hybrid, low_delay):
    """AB = [P·A; P·B] with the low-delay sign folded in, built row-major
    (the kernel indexes it so; _rdft_mats' A and B are Fortran-ordered)."""
    from spatial_audio_framework_tpu.ops.fft import _rdft_mats as jmats

    nb = 133 if hybrid else 129
    P = jpa._hybrid_inverse_mtx(nb, 128)
    np.testing.assert_array_equal(tak._hybrid_inverse_mtx(nb, 128), P)
    _, _, A, B = jmats(256)
    if low_delay:
        sign = np.where(np.arange(129) % 2, -1.0, 1.0)[:, None]
        A, B = A * sign, B * sign
    ref = np.concatenate([P @ A, P @ B], axis=0).astype(np.float32)
    c = tak._syn_consts(128, low_delay, hybrid, torch.device("cpu"))
    assert c["AB"].is_contiguous() and c["w_syn"].is_contiguous()
    np.testing.assert_array_equal(c["AB"].numpy(), ref)


def test_kernel_hop_check_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tak._check_hop("analysis_front_ri", 64)
    tak._check_hop("analysis_front_ri", 128)


def _spy(monkeypatch, calls):
    """Record every call of the four kernel wrappers as afstft_ri sees
    them, passing through to the real wrappers."""
    for name in ("analysis_front_ri", "wide_mix_ri", "synthesis_back_ri",
                 "render_full_ri"):
        real = getattr(tri, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(tri, name, spy)


@pytest.mark.parametrize("fused,cin,cout,expect", [
    (True, 16, 9, ["analysis_front_ri", "wide_mix_ri", "synthesis_back_ri"]),
    (True, 4, 2, ["render_full_ri"]),
    (False, 16, 9, []),
    (False, 4, 2, []),
])
def test_render_dispatch(monkeypatch, fused, cin, cout, expect):
    """fused=True: cout·cin > 128 takes the analysis, wide-mix and
    synthesis kernels and never render_full_ri, ≤ 128 the one-pass kernel;
    fused=False reaches no kernel wrapper at all."""
    calls = []
    _spy(monkeypatch, calls)
    rng = np.random.default_rng(5)
    bank = taf.AfSTFT()
    st = tri.init_state_batched(bank, 2, cin, cout, device="cpu")
    M = torch.from_numpy(_u(rng, (133, cout, cin)))
    x = torch.from_numpy(_u(rng, (2, cin, 3 * 128)))
    y, _ = tri.render_tf_matrix_ri(bank, st, x, M, fused=fused)
    assert calls == expect and y.shape == (2, cout, 3 * 128)
