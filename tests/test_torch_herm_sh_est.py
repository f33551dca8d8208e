"""ops/herm_ri (the map half), modules/sh_est and the sector half of
modules/sh in the PyTorch port vs the JAX reference (CPU), on the same
seeded numpy inputs.

Tolerances: the host code (complex maps, peak finding, ESPRIT, Wigner 3j,
Gaunt, sector coefficients) is the same numpy on both sides and must agree
to 1e-12 (float64) or exactly; the split real/imaginary algebra 1e-5 of the
scale where it is products and solves (float32 on both sides), the JAX
test's own rtol 1e-3 for the MVDR and MUSIC maps and 1e-3 with 1e-5 of the
largest for CroPaC (tests/test_herm_ri.py: a solve and an eigh of a
float32 matrix, in LAPACK on both sides but through different drivers).
Eigenvectors are compared as the projectors they span, never as ``V``: a
Hermitian matrix's real embedding doubles every eigenvalue, so the basis of
each pair is arbitrary."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.modules import sh as jsh
from spatial_audio_framework_tpu.modules import sh_est as jest
from spatial_audio_framework_tpu.ops import herm_ri as JH
from spatial_audio_framework_tpu.utils import presets
from spatial_audio_framework_tpu_torch.modules import sh as tsh
from spatial_audio_framework_tpu_torch.modules import sh_est as test_
from spatial_audio_framework_tpu_torch.ops import herm_ri as TH


def _rand_herm(n, seed=0, batch=()):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=batch + (n, 3 * n))
         + 1j * rng.normal(size=batch + (n, 3 * n)))
    return (X @ np.swapaxes(X.conj(), -1, -2) / (3 * n)).astype(np.complex64)


def _jri(C):
    return jnp.asarray(C.real), jnp.asarray(C.imag)


def _tri(C):
    return (torch.from_numpy(np.ascontiguousarray(C.real)),
            torch.from_numpy(np.ascontiguousarray(C.imag)))


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30)


def _rand_c(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def test_elementwise_and_products_vs_jax():
    a, b = _rand_c((3, 5, 4), 1), _rand_c((3, 4, 6), 2)
    c = _rand_c((3, 5, 4), 3)
    for name in ("cmul", "cdiv"):
        pj = getattr(JH, name)(_jri(a), _jri(c))
        pt = getattr(TH, name)(_tri(a), _tri(c))
        assert max(_rel(x, y) for x, y in zip(pj, pt)) <= 1e-6, name
    assert _rel(JH.cabs2(_jri(a)), TH.cabs2(_tri(a))) <= 1e-6
    assert all(_rel(x, y) == 0 for x, y in zip(JH.conj(_jri(a)),
                                               TH.conj(_tri(a))))
    pj, pt = JH.cmatmul(_jri(a), _jri(b)), TH.cmatmul(_tri(a), _tri(b))
    assert max(_rel(x, y) for x, y in zip(pj, pt)) <= 1e-5
    pj = JH.ceinsum("bij,bjk->bik", _jri(a), _jri(b))
    pt = TH.ceinsum("bij,bjk->bik", _tri(a), _tri(b))
    assert max(_rel(x, y) for x, y in zip(pj, pt)) <= 1e-5
    # embeddings and their inverse
    assert _rel(JH.herm_embed(_jri(a[:, :4])), TH.herm_embed(_tri(a[:, :4]))) \
        == 0
    E = TH.embed_general(_tri(a))
    assert _rel(JH.embed_general(_jri(a)), E) == 0
    for x, y in zip(JH.extract_embedded(jnp.asarray(E.numpy()), 5, 4),
                    TH.extract_embedded(E, 5, 4)):
        assert _rel(x, y) == 0
    # split / join through the host
    pair = TH.split(a, device="cpu")
    assert np.array_equal(TH.join(pair), JH.join(JH.split(a)))


@pytest.mark.parametrize("n", [2, 12])
def test_herm_solve_and_inv_vs_jax(n):
    """n = 2 takes the closed form, wider the solve of the embedding."""
    C = _rand_herm(n, n, (3,))
    B = _rand_c((3, n, 5), n + 1)
    Xj = JH.herm_solve(_jri(C), _jri(B))
    Xt = TH.herm_solve(_tri(C), _tri(B))
    assert max(_rel(x, y) for x, y in zip(Xj, Xt)) <= 1e-5
    ref = np.linalg.solve(C.astype(np.complex128), B)
    assert _rel(ref, Xt[0].numpy() + 1j * Xt[1].numpy()) <= 1e-4
    inv_j, inv_t = JH.herm_inv(_jri(C)), TH.herm_inv(_tri(C))
    assert max(_rel(x, y) for x, y in zip(inv_j, inv_t)) <= 1e-5


def test_eigen_parts_vs_jax():
    """Eigenvalues, Rayleigh refinement, the noise projector and the MUSIC
    quadratic form; eigenvectors only through what they span."""
    n, K = 10, 2
    C = _rand_herm(n, 5, (2,))
    wj, _ = JH.herm_eigh_embedded(_jri(C))
    wt, Vt = TH.herm_eigh_embedded(_tri(C))
    assert _rel(wj, wt) <= 1e-5
    lj, _ = JH.herm_eig_pairs(_jri(C))
    lt, Vp = TH.herm_eig_pairs(_tri(C))
    assert _rel(lj, lt) <= 1e-5
    # the complex eigenvectors solve C v = λ v
    assert _rel(lt, TH.rayleigh_refine(_tri(C), Vp)) <= 1e-5
    Pj, Pt = JH.noise_projector(_jri(C), K), TH.noise_projector(_tri(C), K)
    assert max(_rel(x, y) for x, y in zip(Pj, Pt)) <= 1e-5
    Y = np.random.default_rng(6).normal(size=(n, 30)).astype(np.float32)
    qj = JH.signal_subspace_quadform(_jri(C), K, jnp.asarray(Y))
    qt = TH.signal_subspace_quadform(_tri(C), K, torch.from_numpy(Y))
    assert _rel(qj, qt) <= 1e-5
    W = _rand_c((2, n, 7), 9)
    for name in ("herm_quadform", "quadform_trans"):
        assert _rel(getattr(JH, name)(_jri(C), _jri(W)),
                    getattr(TH, name)(_tri(C), _tri(W))) <= 1e-5, name
    assert _rel(JH.herm_quadform_real(_jri(C), jnp.asarray(Y)),
                TH.herm_quadform_real(_tri(C), torch.from_numpy(Y))) <= 1e-5


@pytest.mark.parametrize("batch", [(), (3,)])
def test_ri_maps_vs_jax(batch):
    n, g = 16, 40
    C = _rand_herm(n, 7, batch)
    Y = np.random.default_rng(8).normal(size=(n, g)).astype(np.float32)
    Cj, Ct = _jri(C), _tri(C)
    Yj, Yt = jnp.asarray(Y), torch.from_numpy(Y)
    assert _rel(jest.generate_pwd_map_ri(Cj, Yj),
                test_.generate_pwd_map_ri(Ct, Yt)) <= 1e-5
    for name, kw in (("generate_mvdr_map_ri", {}),
                     ("generate_music_map_ri", {"n_sources": 2}),
                     ("generate_music_map_ri", {"n_sources": 2,
                                                "log_scale": True}),
                     ("generate_minnorm_map_ri", {"n_sources": 2}),
                     ("generate_minnorm_map_ri", {"n_sources": 3,
                                                  "log_scale": True})):
        pj = np.asarray(getattr(jest, name)(Cj, Yj, **kw))
        pt = getattr(test_, name)(Ct, Yt, **kw).numpy()
        np.testing.assert_allclose(pt, pj, rtol=1e-3, err_msg=name)
    n9 = 9
    C9 = _rand_herm(n9, 9, batch)
    Y9 = np.random.default_rng(10).normal(size=(n9, 30)).astype(np.float32)
    cj = np.asarray(jest.generate_cropac_lcmv_map_ri(_jri(C9),
                                                     jnp.asarray(Y9)))
    ct = test_.generate_cropac_lcmv_map_ri(_tri(C9),
                                           torch.from_numpy(Y9)).numpy()
    np.testing.assert_allclose(ct, cj, rtol=1e-3, atol=1e-5 * np.abs(cj).max())
    mj, wj = jest.generate_mvdr_map_ri(Cj, Yj, 8.0, return_weights=True)
    mt, wt = test_.generate_mvdr_map_ri(Ct, Yt, 8.0, return_weights=True)
    assert max(_rel(x, y) for x, y in zip(wj, wt)) <= 1e-3


def _plant(order, dirs, powers, diff=1e-4):
    Y = jsh.get_rsh(order, np.asarray(dirs, np.float64))
    return ((Y * np.asarray(powers)) @ Y.T
            + diff * np.eye(Y.shape[0])).astype(np.complex64)


def test_host_maps_and_estimators_equal_jax():
    """The complex (host) maps, the grid estimators with von-Mises peak
    masking and ESPRIT: the same numpy code on both sides."""
    grid = presets.tdesign(21)
    src = np.array([[40.0, 10.0], [-110.0, -20.0]])
    Cx = _plant(3, src, [1.0, 0.7])
    dirs_rad = np.stack([np.radians(grid[:, 0]),
                         np.pi / 2 - np.radians(grid[:, 1])], -1)
    Y = tsh.get_sh_real(3, dirs_rad).astype(np.complex64)
    for name, kw in (("generate_pwd_map", {}), ("generate_mvdr_map", {}),
                     ("generate_cropac_lcmv_map", {}),
                     ("generate_music_map", {"n_sources": 2}),
                     ("generate_minnorm_map", {"n_sources": 2,
                                               "log_scale": True})):
        pj = np.asarray(getattr(jest, name)(Cx, Y, **kw))
        pt = np.asarray(getattr(test_, name)(Cx, Y, **kw))
        assert _rel(pj, pt) <= 1e-5, name
    for name in ("sph_pwd", "sph_music"):
        (kj, pj), (kt, pt) = (getattr(jest, name)(Cx, grid, 2),
                              getattr(test_, name)(Cx, grid, 2))
        assert np.array_equal(np.asarray(kj), kt) and _rel(pj, pt) <= 1e-5
    p = np.random.default_rng(3).uniform(size=grid.shape[0])
    assert np.array_equal(jest.find_peaks_vonmises(p, grid, 3),
                          test_.find_peaks_vonmises(p, grid, 3))
    src3 = np.array([[35.0, 15.0], [-70.0, -25.0], [150.0, 40.0]])
    r = np.stack([np.radians(src3[:, 0]),
                  np.pi / 2 - np.radians(src3[:, 1])], -1)
    Yc = jsh.get_sh_complex(3, r).conj()
    C = (Yc * [1.0, 0.8, 0.6]) @ Yc.conj().T + 1e-6 * np.eye(16)
    Us = np.linalg.eigh(C)[1][:, ::-1][:, :3]
    assert np.abs(np.asarray(jest.sph_esprit(Us))
                  - test_.sph_esprit(Us)).max() <= 1e-9


def test_sector_half_of_sh_equals_jax():
    for args in ((1, 1, 2, 0, 1, -1), (2, 3, 4, 1, -2, 1), (3, 3, 3, 0, 0, 0),
                 (2, 2, 5, 0, 0, 0), (4, 2, 3, -3, 1, 2)):
        assert abs(tsh.wigner_3j(*args) - jsh.wigner_3j(*args)) <= 1e-14
    assert np.abs(tsh.gaunt_mtx(2, 1, 3) - jsh.gaunt_mtx(2, 1, 3)).max() \
        <= 1e-12
    for o in (1, 2, 3):
        assert np.abs(tsh.compute_vel_coeffs_mtx(o)
                      - jsh.compute_vel_coeffs_mtx(o)).max() <= 1e-12
    A = tsh.compute_vel_coeffs_mtx(2)
    b = tsh.beam_weights_max_ev(2)
    for fn in ("beam_weights_velocity_patterns_complex",
               "beam_weights_velocity_patterns_real"):
        assert np.abs(np.asarray(getattr(tsh, fn)(2, b, 0.3, -0.2, A))
                      - np.asarray(getattr(jsh, fn)(2, b, 0.3, -0.2, A))
                      ).max() <= 1e-12, fn
    assert np.array_equal(tsh.WXYZ_COEFFS, jsh.WXYZ_COEFFS)
    dirs = presets.tdesign(6)
    for pat in (tsh.SECTOR_PATTERN_PWD, tsh.SECTOR_PATTERN_MAXRE,
                tsh.SECTOR_PATTERN_CARDIOID):
        for order, ep in ((0, True), (1, True), (2, False), (3, True)):
            st, nt = tsh.compute_sector_coeffs(order, pat, dirs, ep)
            sj, nj = jsh.compute_sector_coeffs(order, pat, dirs, ep)
            assert np.array_equal(st, np.asarray(sj)) and nt == nj, (pat, order)
