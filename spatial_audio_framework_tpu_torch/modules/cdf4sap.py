"""Covariance-Domain Framework for Spatial Audio Processing (CDF4SAP)
(counterpart of ``spatial_audio_framework_tpu/modules/cdf4sap.py``;
``saf_cdf4sap``, Vilkamo, Backstrom & Kuntz 2013): given an input
covariance Cx, a target covariance Cy and a prototype matrix Q, find the
mixing matrix M (and the residual covariance Cr) with M·Cx·Mᴴ ≈ Cy while M
stays as close to Q as it can.

Batched over leading axes: every op works on the last two, so an (nBands,
...) stack solves every band in one call.

* :func:`formulate_M_and_Cr` — the generic path (saf_cdf4sap.c:270, the
  real and the complex variant in one implementation) on tensors, by three
  ``torch.linalg.svd`` calls, computed in float64 whatever the input's
  precision: near-rank-1 covariances (HADES's SCMs) leave the SVDs a
  near-degenerate subspace whose float32 rotation is chaotic (the HADES
  golden ``hds`` lands 7.3e-4 from the C in float32, 4.2e-4 in float64,
  where the C's own one-ulp chaos radius is 5.3e-4).  On the card the SVD
  reads its convergence flags back, so this path makes the host wait, as
  powermap's eigh does.  Numpy inputs come back as numpy (the design-time
  use).
* :func:`formulate_M_and_Cr_ri` — the complex variant in split (re, im)
  arithmetic.  The binaural case (2 × 2, Q = 2: HADES and the spreader)
  takes :func:`formulate_M_and_Cr_2x2_entrywise`, closed forms on the four
  scalar entries of each 2×2 with elementwise ops only: no ``torch.linalg``
  call, no host wait.  Other sizes run the generic path on the real
  embedding.
"""
from __future__ import annotations

import numpy as np
import torch

from spatial_audio_framework_tpu_torch.ops import herm_ri as H
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul


def _tensors(*arrays):
    """The inputs as float64 / complex128 tensors of one dtype, and the
    dtype to hand back: None for numpy inputs (numpy comes back)."""
    host = not any(isinstance(a, torch.Tensor) for a in arrays)
    ts = [torch.as_tensor(np.asarray(a) if host else a) for a in arrays]
    out = None
    for t in ts:
        out = t.dtype if out is None else torch.promote_types(out, t.dtype)
    work = torch.complex128 if out.is_complex else torch.float64
    return [t.to(work) for t in ts], None if host else out


def formulate_M_and_Cr(Cx, Cy, Q, use_energy: bool = False,
                       reg: float = 1e-2):
    """Returns (M, Cr).

    Cx: (..., nX, nX), Cy: (..., nY, nY), Q: (..., nY, nX) — real or
    complex tensors (or numpy arrays, computed in float64 on the CPU).
    M: (..., nY, nX); Cr: (..., nY, nY) (zeros if use_energy), in the
    inputs' precision, computed in float64.  On the card the three SVDs
    make the host wait for the device."""
    (Cx, Cy, Q), out_dtype = _tensors(Cx, Cy, Q)
    nX = Cx.shape[-1]
    nY = Cy.shape[-1]
    cplx = Cx.is_complex()

    def Hm(a):
        a = a.transpose(-1, -2)
        return a.conj() if cplx else a

    def diag_re(a):
        d = torch.diagonal(a, dim1=-2, dim2=-1)
        return d.real if cplx else d

    with fp32_matmul():
        # Ky = U_Cy sqrt(S_Cy)  (saf_cdf4sap.c:293-300)
        U_cy, s_cy, _ = torch.linalg.svd(Cy)
        Ky = U_cy * torch.sqrt(s_cy.clamp_min(2.23e-20))[..., None, :]
        # Kx = U_Cx sqrt(S_Cx); regularised inverse (saf_cdf4sap.c:302-326)
        U_cx, s_cx, _ = torch.linalg.svd(Cx)
        s_sqrt = torch.sqrt(s_cx.clamp_min(2.23e-20))
        Kx = U_cx * s_sqrt[..., None, :]
        limit = s_sqrt.amax(-1, keepdim=True) * reg + 2.23e-13
        s_inv = 1.0 / torch.maximum(s_sqrt, limit)
        Kx_reg_inv = s_inv[..., :, None] * Hm(U_cx)
        # normalisation matrix G_hat (saf_cdf4sap.c:328-344)
        g_diag = diag_re(Q @ Cx @ Hm(Q))
        g_lim = g_diag.amax(-1, keepdim=True) * 0.001 + 2.23e-13
        cy_diag = diag_re(Cy)
        g_hat = torch.sqrt(cy_diag.clamp_min(2.23e-13)
                           / torch.maximum(g_diag, g_lim))
        # optimal P via the SVD of Kxᴴ Qᴴ G_hatᴴ Ky (saf_cdf4sap.c:346-375)
        A = Hm(Kx) @ Hm(Q) @ (g_hat[..., :, None].to(Ky.dtype) * Ky)
        U, _, Vh = torch.linalg.svd(A)
        lam = torch.eye(nY, nX, dtype=A.dtype, device=A.device)
        P = Hm(Vh) @ lam @ Hm(U)
        # M and the residual covariance (saf_cdf4sap.c:377-390)
        M = Ky @ P @ Kx_reg_inv
        Cy_tilde = M @ Cx @ Hm(M)
    Cr = Cy - Cy_tilde
    if use_energy:
        g = torch.sqrt(cy_diag.clamp_min(2.23e-20)
                       / (diag_re(Cy_tilde) + 2.23e-7))
        M = g[..., :, None].to(M.dtype) * M
        Cr = torch.zeros_like(Cr)
    if out_dtype is None:
        return M.numpy(), Cr.numpy()
    return M.to(out_dtype), Cr.to(out_dtype)


def formulate_M_and_Cr_cmplx(Cx, Cy, Q, use_energy: bool = False,
                             reg: float = 1e-2):
    """The complex variant (saf_cdf4sap.c:404): the same math on complex
    inputs; kept for API parity."""
    if isinstance(Cx, torch.Tensor):
        Cx = Cx.to(torch.complex128 if Cx.dtype == torch.float64
                   else torch.complex64)
    else:
        Cx = np.asarray(Cx).astype(np.complex128)
    return formulate_M_and_Cr(Cx, Cy, Q, use_energy, reg)


def formulate_M_and_Cr_ri(Cx_ri, Cy_ri, Q_ri, use_energy: bool = False,
                          reg: float = 1e-2):
    """Complex formulate_M_and_Cr in split real/imaginary arithmetic.

    2×2 (the binaural case) takes the closed-form entrywise path.  Other
    sizes run the real implementation on the [[A, -B], [B, A]] embeddings:
    the embedding is a *-ring homomorphism and the CDF construction is
    invariant to the unitary choice of the square roots and to orthogonal
    mixing inside the embedding's duplicated singular pairs, so this yields
    the embedding of the complex result (the top-2k singular cut lands on a
    pair boundary because the embedded spectrum is doubled)."""
    nY, nX = Q_ri[0].shape[-2:]
    if nX == 2 and nY == 2:
        return formulate_M_and_Cr_2x2_entrywise(Cx_ri, Cy_ri, Q_ri,
                                                use_energy, reg)
    M_e, Cr_e = formulate_M_and_Cr(H.herm_embed(Cx_ri), H.herm_embed(Cy_ri),
                                   H.embed_general(Q_ri), use_energy, reg)
    return H.extract_embedded(M_e, nY, nX), H.extract_embedded(Cr_e, nY, nY)


# ---------------------------------------------------------------------------
# Entrywise 2×2 path: the closed forms with every 2×2 held as FOUR scalar
# complex entries (((e00, e01), (e10, e11)) of (re, im) tensors, the batch
# axes as they come) instead of (..., 2, 2) tensors.
# ---------------------------------------------------------------------------

def _s_mul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _s_add(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _s_conj(a):
    return (a[0], -a[1])


def _s_scale(r, a):
    """real r × complex a."""
    return (r * a[0], r * a[1])


def _m2_mul(A, B):
    """2×2 entry-form matmul."""
    return tuple(
        tuple(_s_add(_s_mul(A[i][0], B[0][j]), _s_mul(A[i][1], B[1][j]))
              for j in (0, 1))
        for i in (0, 1))


def _m2_herm(A):
    return ((_s_conj(A[0][0]), _s_conj(A[1][0])),
            (_s_conj(A[0][1]), _s_conj(A[1][1])))


def _m2_from(C_ri):
    """(..., 2, 2) RI pair → entry form."""
    return tuple(
        tuple((C_ri[0][..., i, j], C_ri[1][..., i, j]) for j in (0, 1))
        for i in (0, 1))


def _m2_to(A):
    re = torch.stack([torch.stack([A[0][0][0], A[0][1][0]], -1),
                      torch.stack([A[1][0][0], A[1][1][0]], -1)], -2)
    im = torch.stack([torch.stack([A[0][0][1], A[0][1][1]], -1),
                      torch.stack([A[1][0][1], A[1][1][1]], -1)], -2)
    return re, im


def _herm_eig_2x2_e(a, b, cr, ci):
    """herm_ri.herm_eig_2x2 in entry form: Hermitian [[a, c], [c̄, b]] →
    (l1, l2 descending, V entry-form with a real second row)."""
    c2 = cr * cr + ci * ci
    tr = a + b
    d = a - b
    rad = torch.sqrt(d * d + 4.0 * c2)
    l1 = 0.5 * (tr + rad)
    l2 = 0.5 * (tr - rad)
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
    V = (((v1r0, v1i0), (v2r0, v2i0)),
         ((v1r1, zero), (v2r1, zero)))
    return l1, l2, V


def _svd_2x2_e(A):
    """herm_ri.svd_2x2 in entry form → (U, (s1, s2), V), same fallbacks."""
    B = _m2_mul(_m2_herm(A), A)           # Hermitian
    s21, s22, V = _herm_eig_2x2_e(B[0][0][0], B[1][1][0], *B[0][1])
    s1 = torch.sqrt(s21.clamp_min(0.0))
    s2 = torch.sqrt(s22.clamp_min(0.0))
    AV = _m2_mul(A, V)

    def colnorm(k):
        return torch.sqrt(AV[0][k][0] ** 2 + AV[0][k][1] ** 2
                          + AV[1][k][0] ** 2 + AV[1][k][1] ** 2)

    n1 = colnorm(0)
    n2 = colnorm(1)
    inv1 = 1.0 / n1.clamp_min(1e-30)
    inv2 = 1.0 / n2.clamp_min(1e-30)
    u1 = (_s_scale(inv1, AV[0][0]), _s_scale(inv1, AV[1][0]))
    u2r = (_s_scale(inv2, AV[0][1]), _s_scale(inv2, AV[1][1]))
    tiny1 = n1 <= 1e-6 * s1.clamp_min(1e-30)
    tiny2 = n2 <= 1e-6 * s1.clamp_min(1e-30)
    one = torch.ones_like(n1)
    zero = torch.zeros_like(n1)
    u1 = ((torch.where(tiny1, one, u1[0][0]),
           torch.where(tiny1, zero, u1[0][1])),
          (torch.where(tiny1, zero, u1[1][0]),
           torch.where(tiny1, zero, u1[1][1])))
    # Gram-Schmidt u2 against u1, with the orthogonal-complement fallback
    dot = _s_add(_s_mul(_s_conj(u1[0]), u2r[0]),
                 _s_mul(_s_conj(u1[1]), u2r[1]))
    g0 = (u2r[0][0] - (dot[0] * u1[0][0] - dot[1] * u1[0][1]),
          u2r[0][1] - (dot[0] * u1[0][1] + dot[1] * u1[0][0]))
    g1 = (u2r[1][0] - (dot[0] * u1[1][0] - dot[1] * u1[1][1]),
          u2r[1][1] - (dot[0] * u1[1][1] + dot[1] * u1[1][0]))
    g_norm = torch.sqrt(g0[0] ** 2 + g0[1] ** 2 + g1[0] ** 2 + g1[1] ** 2)
    c0 = (-u1[1][0], u1[1][1])            # svd_2x2: (-u1_re[1], u1_im[1])
    c1 = (u1[0][0], -u1[0][1])
    use_c = tiny2 | (g_norm <= 1e-3)
    ginv = 1.0 / g_norm.clamp_min(1e-30)
    u2 = ((torch.where(use_c, c0[0], g0[0] * ginv),
           torch.where(use_c, c0[1], g0[1] * ginv)),
          (torch.where(use_c, c1[0], g1[0] * ginv),
           torch.where(use_c, c1[1], g1[1] * ginv)))
    U = ((u1[0], u2[0]), (u1[1], u2[1]))
    return U, (s1, s2), V


def formulate_M_and_Cr_2x2_entrywise(Cx_ri, Cy_ri, Q_ri, use_energy: bool,
                                     reg: float):
    """The CDF4SAP recipe for 2×2 (re, im) pairs with every 2×2 in entry
    form end to end: the closed-form eigendecompositions of Cx and Cy and
    the closed-form SVD, elementwise ops only."""
    Cx = _m2_from(Cx_ri)
    Cy = _m2_from(Cy_ri)
    Q = _m2_from(Q_ri)

    # Ky = U_Cy sqrt(S_Cy)
    sy1, sy2, Uy = _herm_eig_2x2_e(Cy[0][0][0], Cy[1][1][0], *Cy[0][1])
    ry1 = torch.sqrt(sy1.clamp_min(2.23e-20))
    ry2 = torch.sqrt(sy2.clamp_min(2.23e-20))
    Ky = ((_s_scale(ry1, Uy[0][0]), _s_scale(ry2, Uy[0][1])),
          (_s_scale(ry1, Uy[1][0]), _s_scale(ry2, Uy[1][1])))
    # Kx and its regularised inverse
    sx1, sx2, Ux = _herm_eig_2x2_e(Cx[0][0][0], Cx[1][1][0], *Cx[0][1])
    sq1 = torch.sqrt(sx1.clamp_min(2.23e-20))
    sq2 = torch.sqrt(sx2.clamp_min(2.23e-20))
    Kx = ((_s_scale(sq1, Ux[0][0]), _s_scale(sq2, Ux[0][1])),
          (_s_scale(sq1, Ux[1][0]), _s_scale(sq2, Ux[1][1])))
    limit = torch.maximum(sq1, sq2) * reg + 2.23e-13
    si1 = 1.0 / torch.maximum(sq1, limit)
    si2 = 1.0 / torch.maximum(sq2, limit)
    UxH = _m2_herm(Ux)
    Kxri = ((_s_scale(si1, UxH[0][0]), _s_scale(si1, UxH[0][1])),
            (_s_scale(si2, UxH[1][0]), _s_scale(si2, UxH[1][1])))
    # normalisation g_hat (rows scaled)
    G = _m2_mul(_m2_mul(Q, Cx), _m2_herm(Q))
    g0 = G[0][0][0]
    g1 = G[1][1][0]
    g_lim = torch.maximum(g0, g1) * 0.001 + 2.23e-13
    cy0 = Cy[0][0][0]
    cy1 = Cy[1][1][0]
    gh0 = torch.sqrt(cy0.clamp_min(2.23e-13) / torch.maximum(g0, g_lim))
    gh1 = torch.sqrt(cy1.clamp_min(2.23e-13) / torch.maximum(g1, g_lim))
    gKy = ((_s_scale(gh0, Ky[0][0]), _s_scale(gh0, Ky[0][1])),
           (_s_scale(gh1, Ky[1][0]), _s_scale(gh1, Ky[1][1])))
    A = _m2_mul(_m2_mul(_m2_herm(Kx), _m2_herm(Q)), gKy)
    U, _s, V = _svd_2x2_e(A)
    P = _m2_mul(V, _m2_herm(U))
    M = _m2_mul(_m2_mul(Ky, P), Kxri)
    Cyt = _m2_mul(_m2_mul(M, Cx), _m2_herm(M))
    Cr = tuple(tuple((Cy[i][j][0] - Cyt[i][j][0], Cy[i][j][1] - Cyt[i][j][1])
                     for j in (0, 1)) for i in (0, 1))
    if use_energy:
        e0 = torch.sqrt(cy0.clamp_min(2.23e-20) / (Cyt[0][0][0] + 2.23e-7))
        e1 = torch.sqrt(cy1.clamp_min(2.23e-20) / (Cyt[1][1][0] + 2.23e-7))
        M = ((_s_scale(e0, M[0][0]), _s_scale(e0, M[0][1])),
             (_s_scale(e1, M[1][0]), _s_scale(e1, M[1][1])))
        z = torch.zeros_like(cy0)
        Cr = (((z, z), (z, z)), ((z, z), (z, z)))
    return _m2_to(M), _m2_to(Cr)
