"""Linear-algebra kernel layer (counterpart of
``spatial_audio_framework_tpu/ops/veclib.py`` and of the reference's
``saf_utility_veclib``).

The reference's 114 ``utility_?xxx`` functions wrap CBLAS/LAPACK per dtype
prefix (s/c/d/z).  Here the backend axis collapses to NumPy (host design
work, float64) and torch (``torch.linalg`` on the input's device, batched):
both dispatch through the same functions, and every op accepts leading
batch dimensions.  ``eig`` and ``eigmp`` run on the host (numpy / SciPy)
whatever the input, as in the JAX package.

Naming maps 1:1 (minus the dtype prefix): e.g. ``utility_ssvd``/``csvd`` →
``svd``; ``utility_cglslv`` → ``glslv``; ``utility_spinv`` → ``pinv``.
"""
from __future__ import annotations

import numpy as np
import torch


def _is_torch(*arrays) -> bool:
    return any(isinstance(a, torch.Tensor) for a in arrays)


def _xp(*arrays):
    """torch when any argument is a tensor, else numpy."""
    return torch if _is_torch(*arrays) else np


def _conj(x):
    """Complex conjugate; on a tensor a materialised one (torch.conj's lazy
    view cannot be read into numpy)."""
    return torch.conj_physical(x) if _is_torch(x) else np.conj(x)


def _scalar(x, s):
    """A numpy scalar as a Python number when x is a tensor (torch drops
    the imaginary part of a numpy complex scalar)."""
    return s.item() if _is_torch(x) and isinstance(s, np.generic) else s


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


# -- index of min/max (utility_siminv/simaxv and friends) --------------------

def _cabs1(x):
    """BLAS's complex 'absolute value' |Re|+|Im| (cabs1), used by
    icamin/icamax — NOT the modulus; real inputs are |x|."""
    xp = _xp(x)
    cplx = x.is_complex() if xp is torch else np.iscomplexobj(x)
    return xp.abs(x.real) + xp.abs(x.imag) if cplx else xp.abs(x)


def iminv(x):
    """Index of the element with the minimum absolute value (utility_?iminv).
    Complex inputs compare by cabs1 = |Re|+|Im| as cblas_icamin does."""
    return _xp(x).argmin(_cabs1(x), -1)


def imaxv(x):
    """Index of the element with the maximum absolute value (utility_?imaxv).
    Complex inputs compare by cabs1 = |Re|+|Im| as cblas_icamax does."""
    return _xp(x).argmax(_cabs1(x), -1)


# -- elementwise (utility_?vabs/vmod/vrecip/vconj/vvcopy/vvadd/...) ----------

def vvdot(a, b, conj: bool = False):
    """Dot product (utility_?vvdot; conj=CONJ/NO_CONJ flag)."""
    return ((_conj(a) if conj else a) * b).sum(-1)


# -- decompositions ----------------------------------------------------------

def svd(A, full_matrices: bool = True):
    """SVD returning (U, S, V) with V NOT transposed — MATLAB convention,
    matching utility_?svd."""
    xp = _xp(A)
    U, s, Vh = xp.linalg.svd(A, full_matrices=full_matrices)
    return U, s, _conj(xp.swapaxes(Vh, -1, -2))


def seig(A, sort_decreasing: bool = True):
    """Symmetric/Hermitian EVD (utility_?seig): returns (V, D) with columns
    sorted by decreasing eigenvalue when sort_decreasing."""
    d, V = _xp(A).linalg.eigh(A)
    if sort_decreasing:
        if _is_torch(A):
            return V.flip(-1), d.flip(-1)
        d, V = d[..., ::-1], V[..., ::-1]
    return V, d


def eig(A):
    """General EVD (utility_?eig) → (eigenvalues, right eigenvectors), on
    the host."""
    return np.linalg.eig(_host(A))


def eigmp(A, B):
    """Generalised EVD A·V = B·V·D (utility_?eigmp) — host SciPy."""
    from scipy.linalg import eig as geig

    d, V = geig(_host(A), _host(B))
    return d, V


# -- solvers -------------------------------------------------------------------

def glslv(A, B):
    """General linear solve A·X = B (utility_?glslv)."""
    return _xp(A, B).linalg.solve(A, B)


def glslvt(A, B):
    """Transposed solve X·A = B (utility_sglslvt)."""
    xp = _xp(A, B)
    return xp.swapaxes(xp.linalg.solve(xp.swapaxes(A, -1, -2),
                                       xp.swapaxes(B, -1, -2)), -1, -2)


def slslv(A, B):
    """Symmetric-positive-definite solve (utility_?slslv; LAPACK posv)."""
    if not _is_torch(A, B):
        from scipy.linalg import solve

        return solve(np.asarray(A), np.asarray(B), assume_a="pos")
    return torch.cholesky_solve(B, torch.linalg.cholesky(A))


def pinv(A, rcond: float = 1e-15):
    """Moore-Penrose pseudo-inverse (utility_?pinv): singular values at or
    below rcond × the largest are dropped."""
    if _is_torch(A):
        return torch.linalg.pinv(A, rtol=rcond)
    return np.linalg.pinv(A, rcond=rcond)


def chol(A):
    """Cholesky, MATLAB convention X s.t. Xᴴ X = A (utility_?chol)."""
    xp = _xp(A)
    L = xp.linalg.cholesky(A)
    return _conj(xp.swapaxes(L, -1, -2))


def det(A):
    """Determinant (utility_?det)."""
    return _xp(A).linalg.det(A)


def inv(A):
    """Matrix inverse (utility_?inv)."""
    return _xp(A).linalg.inv(A)


# -- elementwise vector ops (utility_?vabs/vmod/vrecip/vconj/vvcopy/vvadd/
#    vvsub/vvmul/svsmul/svsdiv/svsadd/svssub; saf_utility_veclib.h:150-860).
#    Kept for API parity.

def vabs(x):
    return _xp(x).abs(x)


def vmod(a, b):
    """Elementwise modulus a % b with the divisor's sign (utility_?vmod)."""
    return torch.remainder(a, b) if _is_torch(a, b) else np.mod(a, b)


def vrecip(x):
    return 1.0 / x


def vconj(x):
    return _conj(x)


def vneg(x):
    return -x


def vvcopy(x):
    return x.clone() if _is_torch(x) else np.array(x, copy=True)


def vvadd(a, b):
    return a + b


def vvsub(a, b):
    return a - b


def vvmul(a, b):
    return a * b


def svsmul(x, s):
    """Vector × scalar (utility_?svsmul)."""
    return x * _scalar(x, s)


def svsdiv(x, s):
    return x / _scalar(x, s)


def svsadd(x, s):
    return x + _scalar(x, s)


def svssub(x, s):
    return x - _scalar(x, s)


def vsadd(x, s):
    """In the reference vsadd == svsadd with accumulate variants; alias."""
    return x + _scalar(x, s)


def sv2cv_inds(sv, inds):
    """Gather: cv[i] = sv[inds[i]] (utility_ssv2cv_inds; the MKL path uses
    cblas_sgthr, the portable path an unrolled copy loop)."""
    if not _is_torch(sv):
        return np.take(sv, inds, axis=-1)
    idx = torch.as_tensor(inds, dtype=torch.int64).to(sv.device)
    return sv.index_select(-1, idx)
