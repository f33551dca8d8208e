"""Complex linear algebra in split real/imaginary arithmetic (counterpart of
``spatial_audio_framework_tpu/ops/herm_ri.py``).

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
back.  Shapes are (..., n, n) batched throughout.

The 2×2 half (:func:`cheev_2x2`, :func:`herm_eig_2x2`, :func:`svd_2x2`,
:func:`_sladiv`, :func:`cgesv_ri`) serves HADES, CDF4SAP and the spreader:
closed forms and a fixed-size LU, elementwise tensor ops only, so they
never call ``torch.linalg`` and never make the host wait.
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


# ---------------------------------------------------------------------------
# 2×2 closed forms (elementwise: no torch.linalg, no host read)
# ---------------------------------------------------------------------------

def cheev_2x2(C: Cmplx):
    """LAPACK-``cheev``-convention eigendecomposition of Hermitian 2×2
    batches: closed form, branchless, bit-matching the reference's
    ``utility_cseig`` (OpenBLAS cheev) including eigenvector SIGNS:

    * chetrd/clarfg: the off-diagonal is made real as
      e = −sign(Re α)·|α| with phase φ = α/e, EXCEPT when Im α == 0, where
      clarfg takes its early exit and e keeps α's own sign with φ = 1.
    * steqr's 2×2 block solves via slaev2, whose (cs1, sn1) sign logic is
      reproduced verbatim; v(rt1) = (cs1·φ, sn1), v(rt2) = (−sn1·φ, cs1)
      where rt1 is the larger-|·| eigenvalue.

    Returns (λ (..., 2) DESCENDING BY VALUE — utility_cseig sortDecFLAG=1 —
    and V (..., 2, 2) complex pair with columns matching λ)."""
    a = C[0][..., 0, 0]
    c = C[0][..., 1, 1]
    r01 = C[0][..., 0, 1]
    i01 = C[1][..., 0, 1]
    tiny = 1e-30
    mag = torch.sqrt(r01 * r01 + i01 * i01)
    real_case = i01 == 0.0
    sgn_r = torch.where(r01 >= 0.0, 1.0, -1.0)
    e = torch.where(real_case, r01, -sgn_r * mag)
    e_safe = torch.where(e == 0.0, 1.0, e)
    phi = (torch.where(real_case, 1.0, r01 / e_safe),
           torch.where(real_case, 0.0, i01 / e_safe))

    # --- slaev2(a, e, c), verbatim branch structure -------------------------
    sm = a + c
    df = a - c
    adf = df.abs()
    tb = e + e
    ab = tb.abs()
    adf_s = adf.clamp_min(tiny)
    ab_s = ab.clamp_min(tiny)
    rt = torch.where(
        adf > ab, adf * torch.sqrt(1.0 + (ab / adf_s) ** 2),
        torch.where(adf < ab, ab * torch.sqrt(1.0 + (adf / ab_s) ** 2),
                    ab * float(np.float32(np.sqrt(2.0)))))
    sgn1 = torch.where(sm < 0.0, -1.0, 1.0)
    rt1 = torch.where(sm < 0.0, 0.5 * (sm - rt),
                      torch.where(sm > 0.0, 0.5 * (sm + rt), 0.5 * rt))
    bigger_a = a.abs() > c.abs()          # slaev2: strict '>' picks a
    acmx = torch.where(bigger_a, a, c)    # signed larger-|.| diagonal
    acmn = torch.where(bigger_a, c, a)
    rt1_s = torch.where(rt1 == 0.0, 1.0, rt1)
    rt2 = torch.where(sm == 0.0, -0.5 * rt,
                      acmx / rt1_s * acmn - (e / rt1_s) * e)
    cs = torch.where(df >= 0.0, df + rt, df - rt)
    sgn2 = torch.where(df >= 0.0, 1.0, -1.0)
    acs = cs.abs()
    cs_safe = torch.where(cs == 0.0, 1.0, cs)
    tb_safe = torch.where(tb == 0.0, 1.0, tb)
    ct = -tb / cs_safe
    sn1_a = 1.0 / torch.sqrt(1.0 + ct * ct)
    cs1_a = ct * sn1_a
    tn = -cs / tb_safe
    cs1_b = 1.0 / torch.sqrt(1.0 + tn * tn)
    sn1_b = tn * cs1_b
    cs1 = torch.where(acs > ab, cs1_a, torch.where(ab == 0.0, 1.0, cs1_b))
    sn1 = torch.where(acs > ab, sn1_a, torch.where(ab == 0.0, 0.0, sn1_b))
    swap = sgn1 == sgn2
    cs1, sn1 = torch.where(swap, -sn1, cs1), torch.where(swap, cs1, sn1)

    # columns: v(rt1) = (cs1·φ, sn1), v(rt2) = (−sn1·φ, cs1); sort
    # descending BY VALUE (rt1 is larger-|·|, not necessarily larger)
    zero = torch.zeros_like(sn1)
    v1 = ((cs1 * phi[0], sn1), (cs1 * phi[1], zero))
    v2 = ((-sn1 * phi[0], cs1), (-sn1 * phi[1], zero))
    first = rt1 >= rt2
    lam = torch.stack([torch.where(first, rt1, rt2),
                       torch.where(first, rt2, rt1)], dim=-1)

    def col(i, part):
        hi = (v1[part][i], v2[part][i])
        return torch.stack([torch.where(first, hi[0], hi[1]),
                            torch.where(first, hi[1], hi[0])], dim=-1)

    Vre = torch.stack([col(0, 0), col(1, 0)], dim=-2)
    Vim = torch.stack([col(0, 1), col(1, 1)], dim=-2)
    return lam, (Vre, Vim)


def herm_eig_2x2(C: Cmplx):
    """Closed-form eigendecomposition of (..., 2, 2) Hermitian RI pairs:
    ``(w, V)`` with eigenvalues ``w`` (..., 2) in DESCENDING order and
    unitary eigenvector columns ``V`` (a Cmplx pair); one square root."""
    re, im = C
    a = re[..., 0, 0]
    b = re[..., 1, 1]
    cr = re[..., 0, 1]
    ci = im[..., 0, 1]
    c2 = cr * cr + ci * ci
    tr = a + b
    d = a - b
    rad = torch.sqrt(d * d + 4.0 * c2)
    l1 = 0.5 * (tr + rad)
    l2 = 0.5 * (tr - rad)
    # eigenvector for λ is [c, λ − a]ᵀ; |c|² at/below the f32 noise floor
    # of the diagonal scale → treat as diagonal (identity pairing, ordered
    # so w stays descending)
    small = c2 <= 1e-12 * torch.clamp_min(a * a + b * b, 1e-30)
    swap = small & (a < b)

    def col(lam):
        n = torch.sqrt(c2 + (lam - a) ** 2).clamp_min(1e-30)
        return cr / n, ci / n, (lam - a) / n

    v1r0, v1i0, v1r1 = col(l1)
    v2r0, v2i0, v2r1 = col(l2)
    one = torch.ones_like(a)
    zero = torch.zeros_like(a)
    v1r0 = torch.where(small, torch.where(swap, zero, one), v1r0)
    v1i0 = torch.where(small, zero, v1i0)
    v1r1 = torch.where(small, torch.where(swap, one, zero), v1r1)
    v2r0 = torch.where(small, torch.where(swap, one, zero), v2r0)
    v2i0 = torch.where(small, zero, v2i0)
    v2r1 = torch.where(small, torch.where(swap, zero, one), v2r1)
    w = torch.stack([l1, l2], dim=-1)
    Vre = torch.stack([torch.stack([v1r0, v2r0], -1),
                       torch.stack([v1r1, v2r1], -1)], -2)
    Vim = torch.stack([torch.stack([v1i0, v2i0], -1),
                       torch.stack([zero, zero], -1)], -2)
    return w, (Vre, Vim)


def chermitian(A: Cmplx) -> Cmplx:
    """Conjugate transpose of an RI pair."""
    return A[0].transpose(-1, -2), -A[1].transpose(-1, -2)


def svd_2x2(A: Cmplx):
    """Closed-form SVD of general (..., 2, 2) complex RI pairs:
    A = U diag(s) Vᴴ with s descending.  Returns (U, s, V).

    From the closed-form eigendecomposition of AᴴA; left vectors are
    U = A V / s with an orthogonal-complement fallback for (near-)rank-1
    inputs (where u₂ is defined only up to phase: any valid completion, as
    LAPACK chooses one arbitrarily)."""
    B = cmatmul(chermitian(A), A)
    s2, V = herm_eig_2x2(B)
    s = torch.sqrt(s2.clamp_min(0.0))
    AV = cmatmul(A, V)
    # left vectors normalised by their ACTUAL column norms (near rank
    # deficiency the f32 direction survives, the eigenvalues' magnitude not)
    norms = torch.sqrt((AV[0] ** 2 + AV[1] ** 2).sum(-2))
    scale = norms.clamp_min(1e-30)[..., None, :]
    u_re = AV[0] / scale
    u_im = AV[1] / scale
    tiny = norms <= 1e-6 * s[..., :1].clamp_min(1e-30)
    # u1 fallback (A ≈ 0): e1
    e1_re = torch.stack([torch.ones_like(u_re[..., 0, 0]),
                         torch.zeros_like(u_re[..., 1, 0])], -1)
    u1_re = torch.where(tiny[..., 0][..., None], e1_re, u_re[..., 0])
    u1_im = torch.where(tiny[..., 0][..., None], 0.0, u_im[..., 0])
    # u2: Gram-Schmidt against u1 unconditionally, then the exact
    # orthogonal complement [-conj(u1[1]), conj(u1[0])] when the
    # orthogonalised residual is negligible
    dot_re = (u1_re * u_re[..., 1] + u1_im * u_im[..., 1]).sum(-1)
    dot_im = (u1_re * u_im[..., 1] - u1_im * u_re[..., 1]).sum(-1)
    g_re = (u_re[..., 1] - dot_re[..., None] * u1_re
            + dot_im[..., None] * u1_im)
    g_im = (u_im[..., 1] - dot_re[..., None] * u1_im
            - dot_im[..., None] * u1_re)
    g_norm = torch.sqrt((g_re * g_re + g_im * g_im).sum(-1))
    c_re = torch.stack([-u1_re[..., 1], u1_re[..., 0]], -1)
    c_im = torch.stack([u1_im[..., 1], -u1_im[..., 0]], -1)
    use_c = (tiny[..., 1] | (g_norm <= 1e-3))[..., None]
    gs = g_norm.clamp_min(1e-30)[..., None]
    u2_re = torch.where(use_c, c_re, g_re / gs)
    u2_im = torch.where(use_c, c_im, g_im / gs)
    U = (torch.stack([u1_re, u2_re], -1), torch.stack([u1_im, u2_im], -1))
    return U, s, V


# ---------------------------------------------------------------------------
# bit-faithful LAPACK cgesv for small static n (C-parity noise matching)
# ---------------------------------------------------------------------------

def _sladiv(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
            d: torch.Tensor):
    """(a+ib)/(c+id) in the operation order of LAPACK sladiv/cladiv
    (Baudin-Smith; LAPACK >= 3.5, as bundled by the OpenBLAS the C
    reference goldens link).  The R==0 / B*R==0 sub-branches of SLADIV2
    are numerically identical to the main path when they trigger, so only
    the |d| <= |c| swap is materialised.  float32, elementwise, batched.

    Divergence from LAPACK on singular input: a zero (or fully cancelling)
    denominator is guarded to 1.0 so the batch stays NaN-free; LAPACK
    would give inf/NaN.  :func:`cgesv_ri` on an exactly singular pivot
    therefore returns unspecified finite values."""
    swap = d.abs() > c.abs()
    aa = torch.where(swap, b, a)
    bb = torch.where(swap, a, b)
    cc = torch.where(swap, d, c)
    dd = torch.where(swap, c, d)
    # SLADIV1: R = D/C; T = 1/(C + D*R); P = (A + B*R)*T; Q = (B - A*R)*T
    r = dd / torch.where(cc == 0.0, 1.0, cc)
    den = cc + dd * r
    t = 1.0 / torch.where(den == 0.0, 1.0, den)
    p = (aa + bb * r) * t
    q = (bb + (-aa) * r) * t
    return p, torch.where(swap, -q, q)


def cgesv_ri(A: Cmplx, b: Cmplx) -> Cmplx:
    """Solve A x = b exactly as LAPACK's f32 cgesv does, batched.

    Mirrors the unblocked factorization the reference's utility_cglslv →
    LAPACKE_cgesv runs for small n (OpenBLAS dispatches small n to the
    reference-LAPACK cgetf2 + cgetrs):

    * partial pivoting on CABS1 = |re| + |im| (icamax, the first maximum),
      full-row swaps;
    * column scaling by ``1/a_jj`` computed ONCE via cladiv then multiplied
      through (cscal), not a division per element;
    * rank-1 trailing update (cgeru), then unit-lower forward and
      non-unit-upper backward substitution in ctrsm's k-ordering.

    Everything stays float32 in the same operation order, so the rounding
    tracks the C's.  The row swaps are masked selects from a one-hot of the
    pivot (no gather, no host read).  A: (..., n, n) complex pair; b:
    (..., n) or (..., n, k) complex pair, one factorization for all k
    right-hand sides; n small (the loops unroll).  Returns x with b's
    shape.  An exactly singular pivot gives unspecified finite values (see
    :func:`_sladiv`)."""
    Ar, Ai = A
    br, bi = b
    vec = br.ndim == Ar.ndim - 1
    if vec:
        br, bi = br[..., None], bi[..., None]
    n = Ar.shape[-1]
    rows = torch.arange(n, device=Ar.device)
    col = rows

    def swap_rows(M, row_j, row_p, is_j, is_p):
        # M with rows j and p exchanged, as pure elementwise selects
        return torch.where(is_j, row_p, torch.where(is_p, row_j, M))

    for j in range(n):
        # icamax over rows j.. of column j: the FIRST max, as argmax
        cab1 = Ar[..., :, j].abs() + Ai[..., :, j].abs()
        p = torch.argmax(torch.where(rows >= j, cab1, -1.0), dim=-1)
        is_p1 = rows == p[..., None]                       # (..., n)
        onehot_p = is_p1.to(Ar.dtype)
        is_p = is_p1[..., None]                            # (..., n, 1)
        is_j = (rows == j)[:, None]                        # (n, 1)
        # row p extracted as a masked reduction (no gather)
        rowp_r = (Ar * onehot_p[..., None]).sum(-2, keepdim=True)
        rowp_i = (Ai * onehot_p[..., None]).sum(-2, keepdim=True)
        Ar = swap_rows(Ar, Ar[..., j:j + 1, :], rowp_r, is_j, is_p)
        Ai = swap_rows(Ai, Ai[..., j:j + 1, :], rowp_i, is_j, is_p)
        # pivot the rhs too (cgetrs applies the interchanges via claswp)
        bp_r = (br * onehot_p[..., None]).sum(-2, keepdim=True)
        bp_i = (bi * onehot_p[..., None]).sum(-2, keepdim=True)
        br = swap_rows(br, br[..., j:j + 1, :], bp_r, is_j, is_p)
        bi = swap_rows(bi, bi[..., j:j + 1, :], bp_i, is_j, is_p)
        # cgetf2 column scale: alpha = 1/a_jj (cladiv), cscal on rows j+1..
        ajj_r, ajj_i = Ar[..., j, j], Ai[..., j, j]
        inv_r, inv_i = _sladiv(torch.ones_like(ajj_r), torch.zeros_like(ajj_r),
                               ajj_r, ajj_i)
        colr, coli = Ar[..., :, j], Ai[..., :, j]
        sr = colr * inv_r[..., None] - coli * inv_i[..., None]
        si = colr * inv_i[..., None] + coli * inv_r[..., None]
        below = rows > j
        colr = torch.where(below, sr, colr)
        coli = torch.where(below, si, coli)
        colmask = col == j
        Ar = torch.where(colmask, colr[..., None], Ar)
        Ai = torch.where(colmask, coli[..., None], Ai)
        # cgeru trailing update: A[i,k] -= A[i,j]*A[j,k]  (i>j, k>j)
        lr = torch.where(below, colr, 0.0)[..., :, None]
        li = torch.where(below, coli, 0.0)[..., :, None]
        right = col > j
        ur = torch.where(right, Ar[..., j, :], 0.0)[..., None, :]
        ui = torch.where(right, Ai[..., j, :], 0.0)[..., None, :]
        Ar = Ar - (lr * ur - li * ui)
        Ai = Ai - (lr * ui + li * ur)
    # ctrsm 'Left, Lower, NoTrans, Unit': b[i] -= b[k]*L[i,k], k ascending
    for k in range(n - 1):
        below = (rows > k)[:, None]
        lr = torch.where(below, Ar[..., :, k:k + 1], 0.0)
        li = torch.where(below, Ai[..., :, k:k + 1], 0.0)
        bkr, bki = br[..., k:k + 1, :], bi[..., k:k + 1, :]
        br = br - (bkr * lr - bki * li)
        bi = bi - (bkr * li + bki * lr)
    # ctrsm 'Left, Upper, NoTrans, NonUnit': divide then eliminate upward
    for k in range(n - 1, -1, -1):
        qr, qi = _sladiv(br[..., k, :], bi[..., k, :],
                         Ar[..., k, k, None], Ai[..., k, k, None])
        is_k = (rows == k)[:, None]
        br = torch.where(is_k, qr[..., None, :], br)
        bi = torch.where(is_k, qi[..., None, :], bi)
        above = (rows < k)[:, None]
        ur = torch.where(above, Ar[..., :, k:k + 1], 0.0)
        ui = torch.where(above, Ai[..., :, k:k + 1], 0.0)
        br = br - (qr[..., None, :] * ur - qi[..., None, :] * ui)
        bi = bi - (qr[..., None, :] * ui + qi[..., None, :] * ur)
    if vec:
        return br[..., 0], bi[..., 0]
    return br, bi


def split(x, device: torch.device | str | None = None) -> Cmplx:
    """numpy complex array → (re, im) float32 pair on ``device`` (default:
    the card)."""
    from spatial_audio_framework_tpu_torch import f32_tensor

    x = np.asarray(x)
    return f32_tensor(x.real, device), f32_tensor(x.imag, device)


def join(x: Cmplx) -> np.ndarray:
    """(re, im) pair → host numpy complex."""
    return x[0].cpu().numpy() + 1j * x[1].cpu().numpy()
