"""Complex linear algebra in split real/imaginary arithmetic (counterpart of
the map half of ``spatial_audio_framework_tpu/ops/herm_ri.py``).

A complex matrix C = A + iB is a pair ``(A, B)`` of real tensors, and a
Hermitian C embeds isomorphically as the real-symmetric
``[[A, -B], [B, A]]`` (A symmetric, B antisymmetric).  Solves and
eigendecompositions of the embedding are real ops; each complex eigenpair
of C appears twice in the embedding with the same eigenvalue, so subspace
projectors need no de-duplication: a complex d-dim subspace is exactly a
real 2d-dim one.  The activity maps (``modules/sh_est``) use these
formulations because the C goldens pin them.

On the card: :func:`herm_solve` takes ``torch.linalg.solve_ex`` without its
error check, which does not make the host wait; ``torch.linalg.eigh``
(:func:`herm_eigh_embedded` and what calls it) does, reading its info flags
back.  Shapes are (..., n, n) batched throughout.  The 2×2 eigen/SVD
solvers and ``cgesv_ri`` of the JAX module serve HADES only and are not
ported with this half.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul

Cmplx = Tuple[torch.Tensor, torch.Tensor]  # (real, imag), same shapes


# ---------------------------------------------------------------------------
# elementwise complex arithmetic on (re, im) pairs
# ---------------------------------------------------------------------------

def cmul(a: Cmplx, b: Cmplx) -> Cmplx:
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def conj(a: Cmplx) -> Cmplx:
    return a[0], -a[1]


def cabs2(a: Cmplx) -> torch.Tensor:
    return a[0] * a[0] + a[1] * a[1]


def cdiv(a: Cmplx, b: Cmplx, eps: float = 0.0) -> Cmplx:
    d = cabs2(b) + eps
    return ((a[0] * b[0] + a[1] * b[1]) / d,
            (a[1] * b[0] - a[0] * b[1]) / d)


def cmatmul(a: Cmplx, b: Cmplx) -> Cmplx:
    """(..., m, k) @ (..., k, n) complex matmul as four real matmuls."""
    with fp32_matmul():
        return (a[0] @ b[0] - a[1] @ b[1], a[0] @ b[1] + a[1] @ b[0])


def ceinsum(subscripts: str, a: Cmplx, b: Cmplx) -> Cmplx:
    e = torch.einsum
    with fp32_matmul():
        return (e(subscripts, a[0], b[0]) - e(subscripts, a[1], b[1]),
                e(subscripts, a[0], b[1]) + e(subscripts, a[1], b[0]))


# ---------------------------------------------------------------------------
# Hermitian embedding
# ---------------------------------------------------------------------------

def herm_embed(C: Cmplx) -> torch.Tensor:
    """Hermitian (..., n, n) → real-symmetric (..., 2n, 2n)
    [[A, -B], [B, A]]."""
    A, B = C
    top = torch.cat([A, -B], dim=-1)
    bot = torch.cat([B, A], dim=-1)
    return torch.cat([top, bot], dim=-2)


def embed_general(A: Cmplx) -> torch.Tensor:
    """Any complex (..., m, n) → real (..., 2m, 2n) [[Ar, -Ai], [Ai, Ar]].
    The embedding is a ring homomorphism: matmul and elementwise-real ops
    on embeddings correspond exactly to the complex ops."""
    return herm_embed(A)


def extract_embedded(E: torch.Tensor, m: int, n: int) -> Cmplx:
    """Inverse of embed_general, averaging the two redundant blocks so f32
    noise that breaks exact embedding structure is symmetrised away."""
    re = 0.5 * (E[..., :m, :n] + E[..., m:, n:])
    im = 0.5 * (E[..., m:, :n] - E[..., :m, n:])
    return re, im


def herm_eigh_embedded(C: Cmplx):
    """eigh of the real embedding: (w, V) with w (..., 2n) ascending and V
    (..., 2n, 2n) real.  Eigenvalues of C each appear twice (adjacent after
    sorting); columns 2k/2k+1 span the embedded complex eigenvector ray.
    On the card ``torch.linalg.eigh`` reads its convergence flags back, so
    the host waits for the device here."""
    return torch.linalg.eigh(herm_embed(C))


def herm_eig_pairs(C: Cmplx):
    """Eigendecomposition of Hermitian C via the embedding: (λ (..., n)
    ascending, V (..., n, n) complex pair).  Column k of the embedded
    eigenbasis at even index maps to the complex eigenvector up to a phase
    (irrelevant for square roots, projectors and subspaces)."""
    n = C[0].shape[-1]
    w, V = herm_eigh_embedded(C)
    return w[..., ::2], (V[..., :n, ::2], V[..., n:, ::2])


def rayleigh_refine(C: Cmplx, V: Cmplx) -> torch.Tensor:
    """One Rayleigh-quotient pass: λ_k = Re(v_kᴴ C v_k) / v_kᴴ v_k per
    eigenvector column of V (..., n, k) → (..., k)."""
    CV = cmatmul(C, V)
    num = (V[0] * CV[0] + V[1] * CV[1]).sum(dim=-2)
    den = (V[0] * V[0] + V[1] * V[1]).sum(dim=-2)
    return num / den


def herm_solve(C: Cmplx, B: Cmplx) -> Cmplx:
    """Solve C X = B for Hermitian C; B: (..., n, k) complex pair.

    n == 2 takes a closed form (Cramer): det = c00·c11 − |c01|² is real for
    Hermitian C, so the whole solve is elementwise.  The generic path solves
    the real embedding with ``torch.linalg.solve_ex`` without its error
    check (as ``jnp.linalg.solve``, no host read of the LU's info)."""
    n = B[0].shape[-2]
    if n == 2:
        c00 = C[0][..., 0, 0, None]          # real (Hermitian diagonal)
        c11 = C[0][..., 1, 1, None]
        r01 = C[0][..., 0, 1, None]
        i01 = C[1][..., 0, 1, None]
        det = c00 * c11 - (r01 * r01 + i01 * i01)
        b0 = (B[0][..., 0, :], B[1][..., 0, :])
        b1 = (B[0][..., 1, :], B[1][..., 1, :])
        # x0 = (c11·b0 − c01·b1)/det ; x1 = (c00·b1 − conj(c01)·b0)/det
        x0 = ((c11 * b0[0] - (r01 * b1[0] - i01 * b1[1])) / det,
              (c11 * b0[1] - (r01 * b1[1] + i01 * b1[0])) / det)
        x1 = ((c00 * b1[0] - (r01 * b0[0] + i01 * b0[1])) / det,
              (c00 * b1[1] - (r01 * b0[1] - i01 * b0[0])) / det)
        return (torch.stack([x0[0], x1[0]], dim=-2),
                torch.stack([x0[1], x1[1]], dim=-2))
    M = herm_embed(C)
    rhs = torch.cat([B[0], B[1]], dim=-2)
    X = torch.linalg.solve_ex(M, rhs, check_errors=False)[0]
    return X[..., :n, :], X[..., n:, :]


def herm_inv(C: Cmplx) -> Cmplx:
    n = C[0].shape[-1]
    eye = torch.eye(n, dtype=C[0].dtype, device=C[0].device).expand(
        C[0].shape[:-2] + (n, n))
    return herm_solve(C, (eye, torch.zeros_like(eye)))


def noise_projector(C: Cmplx, n_sources: int) -> Cmplx:
    """Projector onto the noise subspace (the n - n_sources smallest
    eigenvalues) of Hermitian C, returned as a complex (re, im) pair.

    P_emb = V_n V_nᵀ over the 2(n-K) smallest embedded eigenvectors equals
    the embedding [[Re P, -Im P], [Im P, Re P]] of the complex projector.
    """
    n = C[0].shape[-1]
    _, V = herm_eigh_embedded(C)
    Vn = V[..., :2 * (n - n_sources)]      # ascending: smallest first
    with fp32_matmul():
        P = Vn @ Vn.transpose(-1, -2)      # (..., 2n, 2n)
    return P[..., :n, :n], P[..., n:, :n]  # (Re P, Im P)


def signal_subspace_quadform(C: Cmplx, n_sources: int,
                             Y: torch.Tensor) -> torch.Tensor:
    """‖V_nᵀ [Y; 0]‖² per steering column for REAL steering Y (n, g): the
    MUSIC denominator yᴴ P_n y without forming the projector."""
    n = C[0].shape[-1]
    _, V = herm_eigh_embedded(C)
    Vn = V[..., :2 * (n - n_sources)]      # (..., 2n, 2(n-K))
    # [y; 0] only meets the top row-block of Vnᵀ
    with fp32_matmul():
        VnY = torch.einsum("...sk,sg->...kg", Vn[..., :n, :], Y)
    return torch.sum(VnY ** 2, dim=-2)


def herm_quadform_real(C: Cmplx, Y: torch.Tensor) -> torch.Tensor:
    """real(yᵀ C y) per column of REAL Y (n, g): only Re C contributes
    (Im C is antisymmetric)."""
    with fp32_matmul():
        return torch.einsum("sg,...st,tg->...g", Y, C[0], Y)


def _tq(M, x, y):
    with fp32_matmul():
        return torch.einsum("...sg,...st,...tg->...g", x, M, y)


def herm_quadform(C: Cmplx, W: Cmplx) -> torch.Tensor:
    """real(wᴴ C w) per column of complex W (..., n, g), Hermitian C."""
    A, B = C
    u, v = W
    return _tq(A, u, u) + _tq(A, v, v) - _tq(B, u, v) + _tq(B, v, u)


def quadform_trans(C: Cmplx, W: Cmplx) -> torch.Tensor:
    """real(wᵀ C w): NO conjugate on the first factor, matching the
    reference's generatePWDmap NO_CONJ dot (saf_sh.c:1563-1578), which the
    MVDR/CroPaC maps inherit when fed complex beamforming weights."""
    A, B = C
    u, v = W
    return _tq(A, u, u) - _tq(A, v, v) - _tq(B, u, v) - _tq(B, v, u)


def split(x, device: torch.device | str | None = None) -> Cmplx:
    """numpy complex array → (re, im) float32 pair on ``device`` (default:
    the card)."""
    from spatial_audio_framework_tpu_torch import f32_tensor

    x = np.asarray(x)
    return f32_tensor(x.real, device), f32_tensor(x.imag, device)


def join(x: Cmplx) -> np.ndarray:
    """(re, im) pair → host numpy complex."""
    return x[0].cpu().numpy() + 1j * x[1].cpu().numpy()
