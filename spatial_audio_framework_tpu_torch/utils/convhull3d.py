"""Bit-faithful reimplementation of the reference's vendored 3-D quickhull
(``framework/resources/convhull_3d/convhull_3d.c:367`` ``convhull_3d_build``);
counterpart of ``spatial_audio_framework_tpu/utils/convhull3d.py``.

Why this exists
---------------
``scipy.spatial.ConvexHull`` (Qhull) and convhull_3d produce the *same hull*
but can split coplanar quads — ubiquitous on regular loudspeaker/HRIR grids —
along *different diagonals*.  VBAP gains interpolated across a quad depend on
which diagonal was chosen, so e2e parity with the compiled C reference
(binauraliser INTERP_TRI, binauraliser_nf, panner on regular grids) needs the
C's exact triangulation.  convhull_3d breaks coplanarity ties with jitter
drawn from unseeded libc ``rand()`` (convhull_3d.c:400:
``p += CH_NOISE_VAL*rand()/RAND_MAX``); glibc's ``rand()`` without ``srand``
is deterministic (seed 1), so the tie-breaks are reproducible — provided the
generator and its call order are reproduced exactly, which this module does.

Scope: host/design-time only (NumPy, float64 like ``CH_FLOAT``); the result
feeds the device-side VBAP gather tables.  Only the decisions the C makes are
replicated: jitter values, insertion order, visibility tests, horizon
construction order, face storage order and the orientation vertex swaps.
"""
from __future__ import annotations

import numpy as np

RAND_MAX = 2147483647          # glibc
CH_NOISE_VAL = 1e-7            # convhull_3d.c:75 (double precision build)


def glibc_rand(seed: int = 1):
    """Generator reproducing glibc ``rand()`` (TYPE_3 additive feedback,
    34-word state, first 310 outputs discarded).  ``rand()`` with no
    ``srand`` call behaves as ``srand(1)``."""
    r = [0] * 34
    r[0] = seed
    for i in range(1, 31):
        # r[i] = (16807 * r[i-1]) % 2147483647 via Schrage (glibc initstate)
        hi, lo = divmod(r[i - 1], 127773)
        v = 16807 * lo - 2836 * hi
        if v < 0:
            v += 2147483647
        r[i] = v
    for i in range(31, 34):
        r[i] = r[i - 31]
    i = 34
    while True:
        v = (r[(i - 31) % 34] + r[(i - 3) % 34]) & 0xFFFFFFFF
        r[i % 34] = v
        if i >= 344:
            yield v >> 1
        i += 1


def glibc_rand_at(offset: int, seed: int = 1):
    """A :func:`glibc_rand` stream advanced past ``offset`` draws — models a
    C process whose earlier components already consumed that many ``rand()``
    calls (decorrelator/spreader C-parity design paths)."""
    s = glibc_rand(seed)
    for _ in range(offset):
        next(s)
    return s


def _det_4x4(m: np.ndarray) -> float:
    """Exact expansion used by the C (convhull_3d.c:216 ``det_4x4``);
    m: flat row-major 16."""
    return (
        m[3] * m[6] * m[9] * m[12] - m[2] * m[7] * m[9] * m[12] -
        m[3] * m[5] * m[10] * m[12] + m[1] * m[7] * m[10] * m[12] +
        m[2] * m[5] * m[11] * m[12] - m[1] * m[6] * m[11] * m[12] -
        m[3] * m[6] * m[8] * m[13] + m[2] * m[7] * m[8] * m[13] +
        m[3] * m[4] * m[10] * m[13] - m[0] * m[7] * m[10] * m[13] -
        m[2] * m[4] * m[11] * m[13] + m[0] * m[6] * m[11] * m[13] +
        m[3] * m[5] * m[8] * m[14] - m[1] * m[7] * m[8] * m[14] -
        m[3] * m[4] * m[9] * m[14] + m[0] * m[7] * m[9] * m[14] +
        m[1] * m[4] * m[11] * m[14] - m[0] * m[5] * m[11] * m[14] -
        m[2] * m[5] * m[8] * m[15] + m[1] * m[6] * m[8] * m[15] +
        m[2] * m[4] * m[9] * m[15] - m[0] * m[6] * m[9] * m[15] -
        m[1] * m[4] * m[10] * m[15] + m[0] * m[5] * m[10] * m[15])


def _plane_3d(p: np.ndarray):
    """Plane through 3 points (convhull_3d.c:244 ``plane_3d``).
    p: (3, 3) rows of points → (c (3,), d)."""
    pdiff = p[1:3] - p[0:2]                      # (2, 3)
    c = np.empty(3, np.float64)
    sign = 1.0
    for i in range(3):
        cols = [k for k in range(3) if k != i]
        det = (pdiff[0, cols[0]] * pdiff[1, cols[1]]
               - pdiff[1, cols[0]] * pdiff[0, cols[1]])
        c[i] = sign * det
        sign = -sign
    norm_c = np.sqrt(c[0] * c[0] + c[1] * c[1] + c[2] * c[2])
    c = c / norm_c
    d = -(p[0, 0] * c[0] + p[0, 1] * c[1] + p[0, 2] * c[2])
    return c, d


def _det_simplex(pts4: np.ndarray, face, p_idx: int) -> float:
    """det of [face points; point p] in homogeneous coords (the C's A)."""
    A = np.empty((4, 4), np.float64)
    A[0] = pts4[face[0]]
    A[1] = pts4[face[1]]
    A[2] = pts4[face[2]]
    A[3] = pts4[p_idx]
    return _det_4x4(A.ravel())


def convhull_3d_build(in_vertices: np.ndarray, rand_stream=None):
    """3-D quickhull with convhull_3d's exact decision sequence.

    in_vertices: (nVert, 3); values are used at float64 (the caller is
    responsible for any float32 pre-rounding, as saf_vbap does).
    rand_stream: a ``glibc_rand()`` generator; a fresh one (seed 1, position
    0 — i.e. a C process whose first ``rand()`` call is this one) if None.

    Returns faces (nFaces, 3) int array — same face order and per-face
    vertex order as the C.  Returns None when the C would fail (n<=3)."""
    verts = np.asarray(in_vertices, np.float64)
    n = verts.shape[0]
    d = 3
    if n <= d:
        return None
    if rand_stream is None:
        rand_stream = glibc_rand()

    # jitter: row-major rand() draws, (NOISE * rand) / RAND_MAX exactly
    pts4 = np.empty((n, 4), np.float64)
    for i in range(n):
        for j in range(d):
            pts4[i, j] = verts[i, j] + (CH_NOISE_VAL * next(rand_stream)) / RAND_MAX
        pts4[i, 3] = 1.0
    pts = pts4[:, :3]

    span = pts.max(axis=0) - pts.min(axis=0)
    assert np.all(span > 1e-8), "convhull_3d: degenerate span"

    # initial simplex: 4 faces over points 0..3 (convhull_3d.c:428)
    faces = [[a for a in range(d + 1) if a != i] for i in range(d + 1)]
    cf = []
    df = []
    for f in faces:
        c, dd = _plane_3d(pts[f])
        cf.append(c)
        df.append(dd)

    # orient the initial simplex (convhull_3d.c:461)
    for k in range(d + 1):
        v = _det_simplex(pts4, faces[k], k)
        if v < 0:
            faces[k][1], faces[k][2] = faces[k][2], faces[k][1]
            cf[k] = -cf[k]
            df[k] = -df[k]

    # insertion order: descending span-normalised distance from the mean of
    # points d+1.. (convhull_3d.c:498-531)
    meanp = pts[d + 1:].mean(axis=0)
    reldist = (((pts[d + 1:] - meanp) / span) ** 2).sum(axis=1)
    ind = np.argsort(-reldist, kind="stable")
    pleft = [int(ix) + d + 1 for ix in ind]

    # main quickhull loop (convhull_3d.c:556) — numpy arrays throughout; the
    # decision sequence (face order, horizon-edge order, vertex order) is
    # identical to the C's list manipulation
    faces = np.asarray(faces, np.int64)
    cf = np.asarray(cf, np.float64)
    df = np.asarray(df, np.float64)
    for i in pleft:
        vis = (cf @ pts[i] + df) > 0.0
        if not vis.any():
            continue
        visible = np.flatnonzero(vis)
        nonvis = ~vis
        nonvis_faces = faces[nonvis]                   # (nNonvis, 3), C order

        # horizon: for each visible face (ascending index), each nonvisible
        # face (ascending) sharing exactly 2 vertices contributes the shared
        # edge IN THE NONVISIBLE FACE'S vertex storage order
        # (convhull_3d.c:629-672)
        horizon = []
        for vface in visible:
            mem = np.isin(nonvis_faces, faces[vface])  # (nNonvis, 3)
            rows = np.flatnonzero(mem.sum(axis=1) == d - 1)
            for r in rows:
                horizon.append(nonvis_faces[r][mem[r]])
        horizon = (np.asarray(horizon, np.int64) if horizon
                   else np.zeros((0, 2), np.int64))    # (nNew, 2)

        # drop visible faces (order among survivors preserved) and append the
        # new faces (edge0, edge1, new point) (convhull_3d.c:674-721)
        start = nonvis_faces.shape[0]
        new_faces = np.concatenate(
            [horizon, np.full((horizon.shape[0], 1), i, np.int64)], axis=1)
        faces = np.concatenate([nonvis_faces, new_faces], axis=0)

        # plane coefficients of the new faces — _plane_3d vectorised over
        # faces (identical arithmetic per face)
        p3 = pts[new_faces]                            # (nNew, 3, 3)
        pdiff = p3[:, 1:3] - p3[:, 0:2]                # (nNew, 2, 3)
        c12 = (pdiff[:, 0, 1] * pdiff[:, 1, 2] - pdiff[:, 1, 1] * pdiff[:, 0, 2])
        c02 = (pdiff[:, 0, 0] * pdiff[:, 1, 2] - pdiff[:, 1, 0] * pdiff[:, 0, 2])
        c01 = (pdiff[:, 0, 0] * pdiff[:, 1, 1] - pdiff[:, 1, 0] * pdiff[:, 0, 1])
        cn = np.stack([c12, -c02, c01], axis=1)
        norm_c = np.sqrt(cn[:, 0] ** 2 + cn[:, 1] ** 2 + cn[:, 2] ** 2)
        cn = cn / norm_c[:, None]
        dn = -(p3[:, 0] * cn).sum(axis=1)
        cf = np.concatenate([cf[nonvis], cn], axis=0)
        df = np.concatenate([df[nonvis], dn], axis=0)

        # orient new faces: candidate "points" are 0..nFaces-1 excluding the
        # face's vertex ids — the C reuses face indices as point indices here
        # (convhull_3d.c:724-757, hVec/pp).  The candidate loop almost always
        # accepts pp[0] (jitter makes det==0.0 a measure-zero event), matching
        # the C's while(detA==0.0) walk.
        n_faces = faces.shape[0]
        for k in range(start, n_faces):
            fvid = faces[k]
            detA = 0.0
            index = 0
            while detA == 0.0:
                while index in (fvid[0], fvid[1], fvid[2]):
                    index += 1          # pp skips the face's own vertex ids
                assert index < n_faces
                detA = _det_simplex(pts4, fvid, index)
                index += 1
            if detA < 0.0:
                faces[k, 1], faces[k, 2] = faces[k, 2], faces[k, 1]
                cf[k] = -cf[k]
                df[k] = -df[k]

    return faces.astype(int)
