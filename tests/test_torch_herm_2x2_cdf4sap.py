"""The 2×2 half of ops/herm_ri and modules/cdf4sap in the PyTorch port vs
the JAX reference (CPU), on the cases of tests/test_herm_ri_2x2.py and
tests/test_cgesv_ri.py: the closed-form eigendecompositions (cheev_2x2
against LAPACK cheev itself, signs included), the 2×2 SVD across rank
deficiency, LAPACK-faithful cgesv against the C's solutions, and CDF4SAP's
generic (real, complex, embedded) and entrywise 2×2 paths.

Tolerances: 2e-4 relative to max(1, |ref|) for the solve / SVD chains
(float32 on both sides, one op order: elementwise closed forms agree far
closer, held at 1e-5); the generic CDF path on float64 host inputs 1e-9;
cgesv against the C's LAPACK 2e-6, the JAX test's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import lapack

from spatial_audio_framework_tpu.modules import cdf4sap as JC
from spatial_audio_framework_tpu.ops import herm_ri as JH
from spatial_audio_framework_tpu_torch.modules import cdf4sap as TC
from spatial_audio_framework_tpu_torch.ops import herm_ri as TH
from test_cgesv_ri import load_rows

TOL = 1e-5
CHAIN_TOL = 2e-4


def _join(ri):
    return np.asarray(ri[0]) + 1j * np.asarray(ri[1])


def _tsplit(C):
    return TH.split(C, "cpu")


def _err(ref, got):
    ref = np.asarray(ref)
    return float(np.abs(ref - np.asarray(got)).max()
                 / max(1.0, np.abs(ref).max()))


def _herm(rng, B, n=2):
    A = rng.standard_normal((B, n, n)) + 1j * rng.standard_normal((B, n, n))
    return (A @ A.conj().swapaxes(-1, -2)).astype(np.complex64)


def test_herm_eig_2x2_vs_jax_and_numpy():
    C = _herm(np.random.default_rng(0), 400)
    wj, Vj = JH.herm_eig_2x2(JH.split(C))
    w, V = TH.herm_eig_2x2(_tsplit(C))
    assert _err(wj, w) <= TOL and _err(_join(Vj), TH.join(V)) <= TOL
    w = w.numpy()
    Vc = TH.join(V)
    np.testing.assert_allclose(w, np.linalg.eigvalsh(C)[..., ::-1],
                               rtol=1e-5, atol=1e-5 * np.abs(w).max())
    R = np.einsum("bij,bj,bkj->bik", Vc, w, Vc.conj())
    assert np.abs(R - C).max() <= 1e-5 * np.abs(C).max()


@pytest.mark.parametrize("ratio", [1.0, 1e-2, 3e-5, 1e-5, 1e-6, 0.0])
def test_svd_2x2_across_rank_deficiency(ratio):
    rng = np.random.default_rng(int(ratio * 1e7) + 3)
    q1, _ = np.linalg.qr(rng.standard_normal((2, 2))
                         + 1j * rng.standard_normal((2, 2)))
    q2, _ = np.linalg.qr(rng.standard_normal((2, 2))
                         + 1j * rng.standard_normal((2, 2)))
    A = (q1 @ np.diag([1.0, ratio]) @ q2.conj().T).astype(np.complex64)
    A = np.broadcast_to(A, (8, 2, 2))
    Uj, sj, Vj = JH.svd_2x2(JH.split(A))
    U, s, V = TH.svd_2x2(_tsplit(A))
    Uc, Vc = TH.join(U), TH.join(V)
    for M in (Uc, Vc):
        I = np.einsum("bij,bik->bjk", M.conj(), M)
        assert np.abs(I - np.eye(2)).max() <= 1e-4, ratio
    R = np.einsum("bij,bj,bkj->bik", Uc, s.numpy(), Vc.conj())
    assert np.abs(R - A).max() <= 1e-4
    if ratio >= 1e-2:       # well conditioned: the same values and vectors
        assert _err(sj, s.numpy()) <= TOL
        assert _err(_join(Uj), Uc) <= TOL and _err(_join(Vj), Vc) <= TOL
    Ch = TH.chermitian(_tsplit(A[0]))
    np.testing.assert_array_equal(TH.join(Ch), A[0].conj().T)


def test_cheev_2x2_matches_lapack_and_jax():
    """Bit-faithful to LAPACK cheev (the reference's utility_cseig):
    eigenvalues descending by value and eigenvector signs, including
    indefinite and real-off-diagonal (clarfg early-exit) cases."""
    rng = np.random.default_rng(7)
    As = []
    for _ in range(300):
        X = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
        A = X @ X.conj().T
        if rng.random() < 0.2:
            A[0, 1] = A[0, 1].real
            A[1, 0] = A[0, 1]
        if rng.random() < 0.3:
            A = A - rng.uniform(0, 2) * np.trace(A).real * np.eye(2)
        As.append(((A + A.conj().T) / 2).astype(np.complex64))
    As = np.stack(As)
    lam, V = TH.cheev_2x2(_tsplit(As))
    lj, Vj = jax.jit(JH.cheev_2x2)((jnp.asarray(As.real),
                                    jnp.asarray(As.imag)))
    lam, Vc = lam.numpy(), TH.join(V)
    assert np.abs(lam - np.asarray(lj)).max() <= 1e-5 * np.abs(lam).max()
    assert np.abs(Vc - _join(Vj)).max() <= 1e-5
    for i in range(len(As)):
        w, Vl, info = lapack.cheev(As[i], compute_v=1)
        assert info == 0
        scale = max(1.0, float(np.abs(As[i]).max()))
        assert np.abs(lam[i] - w[::-1]).max() <= 2e-4 * scale, i
        assert np.abs(Vc[i] - Vl[:, ::-1]).max() <= 3e-4, i


def test_cgesv_ri_tracks_lapack_and_jax():
    rows = load_rows()
    worst = 0.0
    for A, b, x in rows:
        xr, xi = TH.cgesv_ri(
            (torch.from_numpy(A[..., 0]), torch.from_numpy(A[..., 1])),
            (torch.from_numpy(b[:, 0]), torch.from_numpy(b[:, 1])))
        ours = np.stack([xr.numpy(), xi.numpy()], -1)
        worst = max(worst, float(np.abs(ours - x).max() / np.abs(x).max()))
        jr, ji = JH.cgesv_ri((jnp.asarray(A[..., 0]), jnp.asarray(A[..., 1])),
                             (jnp.asarray(b[:, 0]), jnp.asarray(b[:, 1])))
        assert _err(np.stack([jr, ji], -1), ours) <= 1e-6
    assert worst < 2e-6, worst
    # batched == per system, and several right-hand sides share one LU
    Ar = torch.from_numpy(np.stack([A[..., 0] for A, _, _ in rows]))
    Ai = torch.from_numpy(np.stack([A[..., 1] for A, _, _ in rows]))
    br = torch.from_numpy(np.stack([b[:, 0] for _, b, _ in rows]))
    bi = torch.from_numpy(np.stack([b[:, 1] for _, b, _ in rows]))
    xr, xi = TH.cgesv_ri((Ar, Ai), (br, bi))
    x2r, x2i = TH.cgesv_ri((Ar, Ai), (torch.stack([br, -bi], -1),
                                      torch.stack([bi, br], -1)))
    for k in range(len(rows)):
        sr, si = TH.cgesv_ri((Ar[k], Ai[k]), (br[k], bi[k]))
        assert torch.equal(xr[k], sr) and torch.equal(xi[k], si)
        assert torch.equal(x2r[k, :, 0], sr)


def test_cgesv_ri_solves_hermitian_like_herm_solve():
    rng = np.random.default_rng(5)
    X = (rng.standard_normal((3, 6, 6)) + 1j * rng.standard_normal((3, 6, 6))
         ).astype(np.complex64)
    C = X @ X.conj().transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.complex64)
    b = (rng.standard_normal((3, 6)) + 1j * rng.standard_normal((3, 6))
         ).astype(np.complex64)
    x = TH.cgesv_ri(_tsplit(C), _tsplit(b))
    h = TH.herm_solve(_tsplit(C), _tsplit(b[..., None]))
    assert np.abs(TH.join(x) - TH.join(h)[..., 0]).max() < 1e-5
    y = TH._sladiv(*(torch.tensor([v], dtype=torch.float32)
                     for v in (1.0, 2.0, 0.0, 0.0)))
    assert all(bool(torch.isfinite(t).all()) for t in y)


@pytest.mark.parametrize("use_energy", [False, True])
@pytest.mark.parametrize("cplx", [False, True])
def test_formulate_generic_vs_jax(use_energy, cplx):
    """The generic path on numpy (float64, as the JAX package's numpy
    branch) and on float32 tensors (torch.linalg.svd)."""
    rng = np.random.default_rng(int(cplx) + 2 * use_energy)
    nX, nY = 4, 3

    def m(*s):
        a = rng.standard_normal(s)
        return a + 1j * rng.standard_normal(s) if cplx else a

    A, B = m(5, nX, nX), m(5, nY, nY)
    # loaded so the float32 chain's error is float32 rounding, not the
    # conditioning of random covariances
    Cx = A @ A.conj().swapaxes(-1, -2) + nX * np.eye(nX)
    Cy = B @ B.conj().swapaxes(-1, -2) + nY * np.eye(nY)
    Q = m(5, nY, nX)
    fj = JC.formulate_M_and_Cr_cmplx if cplx else JC.formulate_M_and_Cr
    ft = TC.formulate_M_and_Cr_cmplx if cplx else TC.formulate_M_and_Cr
    Mj, Crj = fj(Cx, Cy, Q, use_energy, 0.01)
    Mt, Crt = ft(Cx, Cy, Q, use_energy, 0.01)
    assert isinstance(Mt, np.ndarray)
    assert _err(Mj, Mt) <= 1e-9 and _err(Crj, Crt) <= 1e-9
    dt = np.complex64 if cplx else np.float32
    Mt, Crt = ft(*(torch.from_numpy(a.astype(dt)) for a in (Cx, Cy, Q)),
                 use_energy, 0.01)
    assert _err(Mj, Mt.numpy()) <= CHAIN_TOL
    assert _err(Crj, Crt.numpy()) <= CHAIN_TOL


@pytest.mark.parametrize("use_energy", [False, True])
@pytest.mark.parametrize("n", [2, 3])
def test_formulate_ri_vs_jax(use_energy, n):
    """formulate_M_and_Cr_ri: 2×2 on the entrywise closed forms (held
    against the JAX package and against the generic embedded path, as
    tests/test_herm_ri_2x2.py holds it), 3×3 on the embedding."""
    rng = np.random.default_rng(7 + n)
    Cx, Cy = _herm(rng, 200, n), _herm(rng, 200, n)
    Q = (rng.standard_normal((200, n, n))
         + 1j * rng.standard_normal((200, n, n))).astype(np.complex64)
    Mj, Crj = JC.formulate_M_and_Cr_ri(JH.split(Cx), JH.split(Cy),
                                       JH.split(Q), use_energy, 0.01)
    Mt, Crt = TC.formulate_M_and_Cr_ri(_tsplit(Cx), _tsplit(Cy), _tsplit(Q),
                                       use_energy, 0.01)
    assert _err(_join(Mj), TH.join(Mt)) <= CHAIN_TOL
    assert _err(_join(Crj), TH.join(Crt)) <= CHAIN_TOL
    if n == 2:
        Mg_e, Crg_e = TC.formulate_M_and_Cr(
            TH.herm_embed(_tsplit(Cx)), TH.herm_embed(_tsplit(Cy)),
            TH.embed_general(_tsplit(Q)), use_energy, 0.01)
        Mg = TH.join(TH.extract_embedded(Mg_e, 2, 2))
        assert np.abs(TH.join(Mt) - Mg).max() <= CHAIN_TOL * np.abs(Mg).max()
