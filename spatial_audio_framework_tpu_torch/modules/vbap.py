"""Vector-Base Amplitude Panning in 3-D and 2-D (counterpart of
``spatial_audio_framework_tpu/modules/vbap.py``, ``saf_vbap``).

Design-time gain tables in NumPy: triangulation of the loudspeaker set
(the C's vendored convhull_3d, ``utils/convhull3d.py``), the per-triangle
inverses, per-source gains with optional MDAP spread, and the regular
azimuth/elevation grid table with its compression and interpolation forms
(the binauraliser's HRTF interpolation table); the pairwise 2-D panning of
planar layouts with its azimuth-grid table, and the frequency-dependent
normalisation exponents of the panner (``get_p_values``).

Behavioural parity notes (framework/modules/saf_vbap/saf_vbap.c):

* dummy loudspeakers are inserted at ±90° elevation when no speaker lies
  beyond ±60° (ADD_DUMMY_LIMIT, saf_vbap_internal.h:46), and their gains
  are dropped afterwards (saf_vbap.c:52-170).
* triangles whose normals point away from their centroid are discarded
  (saf_vbap.c:499-...); optional aperture filter (omitLargeTriangles).
* per-source gains are taken from the first triangle whose inverted gains
  are all > -0.001, normalised to unit RMS (saf_vbap.c:786 ``vbap3D``);
  spread > 0.1° engages MDAP with 8 spread sources on 1 ring
  (saf_vbap.c ``getSpreadSrcDirs3D``).
"""
from __future__ import annotations

import numpy as np

from spatial_audio_framework_tpu_torch.utils.convhull3d import \
    convhull_3d_build

ADD_DUMMY_LIMIT = 60.0
APERTURE_LIMIT_DEG = 180.0


def _unit_vecs(dirs_deg: np.ndarray) -> np.ndarray:
    a = np.radians(np.asarray(dirs_deg, np.float64))
    return np.stack([np.cos(a[:, 1]) * np.cos(a[:, 0]),
                     np.cos(a[:, 1]) * np.sin(a[:, 0]),
                     np.sin(a[:, 1])], -1)


def find_ls_triplets(ls_dirs_deg: np.ndarray, omit_large_triangles: bool = False,
                     method: str = "c_parity", rand_stream=None):
    """Triangulate a loudspeaker setup (saf_vbap.c:499 ``findLsTriplets``).
    Returns (vertices (L,3), faces (nFaces,3)).

    Reproduces the reference's vendored convhull_3d quickhull exactly,
    including the unseeded-rand() jitter that decides which diagonal splits
    a coplanar quad on regular grids; pass ``rand_stream=`` a
    ``glibc_rand()`` generator to model several calls in one C process.
    method='qhull' uses scipy's Qhull: same hull, potentially different
    coplanar-quad diagonals."""
    if np.asarray(ls_dirs_deg).shape[0] < 4:
        # the C's "Failed to compute the Convex Hull of the specified
        # vertices." (saf_vbap.c:533-537)
        raise ValueError(
            "find_ls_triplets: 3-D triangulation needs >= 4 loudspeaker "
            f"directions, got {np.asarray(ls_dirs_deg).shape[0]} "
            "(saf_vbap.c findLsTriplets)")
    if method == "c_parity":
        # the C stores float32-rounded unit vectors (saf_vbap.c:522-529)
        verts = _unit_vecs(ls_dirs_deg).astype(np.float32).astype(np.float64)
        faces = convhull_3d_build(verts, rand_stream=rand_stream)
        # drop faces whose normal opposes the centroid (saf_vbap.c:586-609);
        # convhull_3d's faces are already outward-oriented so this only
        # removes degenerate slivers
        v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
        normal = np.cross(v1 - v0, v2 - v1)
        centroid = (v0 + v1 + v2) / 3.0
        faces = faces[(normal * centroid).sum(-1) > 0.0]
    elif method == "qhull":
        from scipy.spatial import ConvexHull

        verts = _unit_vecs(ls_dirs_deg)
        faces = ConvexHull(verts).simplices.astype(int)
        # scipy's simplices have arbitrary orientation: orient them outward
        # as convhull_3d's are (the C's centroid test is then a no-op for a
        # hull of on-sphere points)
        v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
        normal = np.cross(v1 - v0, v2 - v1)
        centroid = (v0 + v1 + v2) / 3.0
        flip = (normal * centroid).sum(-1) < 0.0
        faces[flip] = faces[flip][:, ::-1]
    else:
        raise ValueError(f"find_ls_triplets: unknown method {method!r} "
                         "(c_parity or qhull)")
    # Drop degenerate faces whose three unit vectors are coplanar with the
    # origin: their VBAP matrices are singular.  The reference leaves these
    # in and relies on the gain validity check to skip them (saf_vbap.c:786).
    det = np.linalg.det(verts[faces].transpose(0, 2, 1))
    faces = faces[np.abs(det) > 1e-8]
    if omit_large_triangles:
        lim = np.radians(APERTURE_LIMIT_DEG)
        v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
        a = np.arccos(np.clip((v0 * v1).sum(-1), -1, 1))
        b = np.arccos(np.clip((v1 * v2).sum(-1), -1, 1))
        c = np.arccos(np.clip((v2 * v0).sum(-1), -1, 1))
        faces = faces[(a < lim) & (b < lim) & (c < lim)]
    return verts, faces


def invert_ls_mtx_3d(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Per-triangle inverse of the column-stacked speaker unit vectors
    (saf_vbap.c:676 ``invertLsMtx3D``).  → (nFaces, 3, 3)."""
    U = verts[faces].transpose(0, 2, 1)  # columns = speaker vectors
    return np.linalg.inv(U)


def get_spread_src_dirs_3d(azi_rad: float, elev_rad: float, spread_deg: float,
                           num_src: int = 8, num_rings: int = 1) -> np.ndarray:
    """MDAP spread source directions (saf_vbap.c:707 ``getSpreadSrcDirs3D``).
    → (num_rings*num_src + 1, 3), original direction appended last."""
    u = np.array([np.cos(elev_rad) * np.cos(azi_rad),
                  np.cos(elev_rad) * np.sin(azi_rad),
                  np.sin(elev_rad)])
    uxu = np.outer(u, u)
    ux = np.array([[0.0, -u[2], u[1]], [u[2], 0.0, -u[0]], [-u[1], u[0], 0.0]])
    theta = 2.0 * np.pi / num_src
    R = np.sin(theta) * ux + (1 - np.cos(theta)) * uxu + np.cos(theta) * np.eye(3)
    base = np.zeros((num_src, 3))
    if abs(elev_rad) > np.pi / 2 - 0.01:
        base[0] = [1.0, 0.0, 0.0]
    else:
        uu2 = np.cross(u, [0.0, 0.0, 1.0])
        base[0] = uu2 / np.linalg.norm(uu2)
    for ns in range(1, num_src):
        base[ns] = R @ base[ns - 1]
    spread_rad = (spread_deg / 2.0) * np.pi / 180.0
    ring_rad = spread_rad / num_rings
    out = np.zeros((num_rings * num_src + 1, 3))
    for nr in range(num_rings):
        out[nr * num_src:(nr + 1) * num_src] = u + base * np.tan(ring_rad * (nr + 1))
    out[:num_rings * num_src] /= np.linalg.norm(out[0])
    out[-1] = u
    return out


def vbap_3d(src_dirs_deg: np.ndarray, verts: np.ndarray, faces: np.ndarray,
            inv_mtx: np.ndarray, spread: float = 0.0) -> np.ndarray:
    """Per-source VBAP gains (saf_vbap.c:786 ``vbap3D``).
    → (nSrc, L) with L = verts.shape[0]."""
    src_dirs_deg = np.atleast_2d(np.asarray(src_dirs_deg, np.float64))
    n_src, L = src_dirs_deg.shape[0], verts.shape[0]
    out = np.zeros((n_src, L))

    if spread > 0.1:
        for ns in range(n_src):
            azi, elev = np.radians(src_dirs_deg[ns])
            U = get_spread_src_dirs_3d(azi, elev, spread)  # (9, 3)
            g_all = np.einsum("fij,sj->sfi", inv_mtx, U)  # (9, nFaces, 3)
            valid = g_all.min(-1) > -0.001
            rms = np.linalg.norm(g_all, axis=-1)
            contrib = np.where(valid[..., None],
                               g_all / np.maximum(rms[..., None], 1e-20), 0.0)
            gains = np.zeros(L)
            np.add.at(gains, faces.ravel(), contrib.sum(0).ravel())
            out[ns] = np.maximum(gains / max(np.linalg.norm(gains), 1e-20), 0.0)
        return out.astype(np.float32)

    u = _unit_vecs(src_dirs_deg)  # (nSrc, 3)
    g_all = np.einsum("fij,sj->sfi", inv_mtx, u)  # (nSrc, nFaces, 3)
    valid = g_all.min(-1) > -0.001  # (nSrc, nFaces)
    first = np.argmax(valid, axis=1)  # first valid face (0 if none)
    has = valid.any(axis=1)
    for ns in range(n_src):
        gains = np.zeros(L)
        if has[ns]:
            f = first[ns]
            g = g_all[ns, f]
            gains[faces[f]] = g / max(np.linalg.norm(g), 1e-20)
        out[ns] = np.maximum(gains / max(np.linalg.norm(gains), 1e-20), 0.0)
    return out.astype(np.float32)


def generate_vbap_gain_table_3d_srcs(src_dirs_deg: np.ndarray,
                                     ls_dirs_deg: np.ndarray,
                                     omit_large_triangles: bool = False,
                                     enable_dummies: bool = False,
                                     spread: float = 0.0,
                                     rand_stream=None) -> np.ndarray:
    """(nSrc, L) VBAP gain table (saf_vbap.c:52 ``generateVBAPgainTable3D_srcs``)."""
    ls_dirs_deg = np.asarray(ls_dirs_deg, np.float64)
    L = ls_dirs_deg.shape[0]
    dirs = ls_dirs_deg
    if enable_dummies:
        extra = []
        if not (ls_dirs_deg[:, 1] <= -ADD_DUMMY_LIMIT).any():
            extra.append([0.0, -90.0])
        if not (ls_dirs_deg[:, 1] >= ADD_DUMMY_LIMIT).any():
            extra.append([0.0, 90.0])
        if extra:
            dirs = np.concatenate([ls_dirs_deg, np.asarray(extra)], axis=0)
    verts, faces = find_ls_triplets(dirs, omit_large_triangles,
                                    rand_stream=rand_stream)
    inv_mtx = invert_ls_mtx_3d(verts, faces)
    g = vbap_3d(src_dirs_deg, verts, faces, inv_mtx, spread)
    return g[:, :L]  # drop dummy columns


def generate_vbap_gain_table_3d(ls_dirs_deg: np.ndarray, az_res_deg: int = 1,
                                el_res_deg: int = 1,
                                omit_large_triangles: bool = False,
                                enable_dummies: bool = False,
                                spread: float = 0.0,
                                rand_stream=None) -> np.ndarray:
    """Regular-grid gain table (saf_vbap.c:171 ``generateVBAPgainTable3D``):
    grid azi -180..180 (step az_res), elev -90..90 (step el_res), azimuth
    varying fastest.  → (N_azi*N_ele, L)."""
    n_azi = int(360.0 / az_res_deg + 1.5)
    n_ele = int(180.0 / el_res_deg + 1.5)
    azi = -180.0 + np.arange(n_azi) * az_res_deg
    ele = -90.0 + np.arange(n_ele) * el_res_deg
    grid = np.stack(np.meshgrid(azi, ele), -1).reshape(-1, 2)
    return generate_vbap_gain_table_3d_srcs(grid, ls_dirs_deg,
                                            omit_large_triangles,
                                            enable_dummies, spread,
                                            rand_stream=rand_stream)


def compress_vbap_gain_table_3d(gtable: np.ndarray):
    """Keep the ≤3 non-zero gains + indices per row, amplitude-normalised
    (saf_vbap.c:312 ``compressVBAPgainTable3D``).
    → (comp (nTable,3) float32, idx (nTable,3) int32)."""
    n_table = gtable.shape[0]
    comp = np.zeros((n_table, 3), np.float32)
    idx = np.zeros((n_table, 3), np.int32)
    for nt in range(n_table):
        nz = np.flatnonzero(gtable[nt] > 1e-7)[:3]
        g = gtable[nt, nz]
        comp[nt, :len(nz)] = np.maximum(g / g.sum(), 0.0)
        idx[nt, :len(nz)] = nz
    return comp, idx


def vbap_gain_table_to_interp_table(gtable: np.ndarray) -> np.ndarray:
    """Amplitude-normalise each row to sum 1
    (saf_vbap.c:369 ``VBAPgainTable2InterpTable``)."""
    s = gtable.sum(-1, keepdims=True)
    return (gtable / np.maximum(s, 1e-20)).astype(np.float32)


# ---------------------------------------------------------------------------
# 2-D (pairwise) panning
# ---------------------------------------------------------------------------

def find_ls_pairs(ls_dirs_deg: np.ndarray) -> np.ndarray:
    """Adjacent pairs by sorted azimuth, wrapping (saf_vbap.c:898)."""
    order = np.argsort(np.asarray(ls_dirs_deg, np.float64)[:, 0], kind="stable")
    order = np.concatenate([order, order[:1]])
    return np.stack([order[:-1], order[1:]], -1)


def vbap_2d(src_azis_deg: np.ndarray, ls_dirs_deg: np.ndarray) -> np.ndarray:
    """Pairwise 2-D VBAP gains (saf_vbap.c:962 ``vbap2D``) → (nSrc, L)."""
    ls_dirs_deg = np.asarray(ls_dirs_deg, np.float64)
    L = ls_dirs_deg.shape[0]
    pairs = find_ls_pairs(ls_dirs_deg)
    a = np.radians(ls_dirs_deg[:, 0])
    verts = np.stack([np.cos(a), np.sin(a)], -1)
    U = verts[pairs].transpose(0, 2, 1)  # (nPairs, 2, 2), columns = speakers
    inv_mtx = np.linalg.inv(U)
    src = np.atleast_1d(np.asarray(src_azis_deg, np.float64))
    out = np.zeros((src.shape[0], L))
    for ns, azi_deg in enumerate(src):
        azi = np.radians(azi_deg)
        u = np.array([np.cos(azi), np.sin(azi)])
        gains = np.zeros(L)
        for f, pair in enumerate(pairs):
            g = inv_mtx[f] @ u
            if g.min() > -0.001:
                gains[pair] = g / max(np.linalg.norm(g), 1e-20)
        out[ns] = np.maximum(gains / max(np.linalg.norm(gains), 1e-20), 0.0)
    return out.astype(np.float32)


def generate_vbap_gain_table_2d(ls_dirs_deg: np.ndarray,
                                az_res_deg: int = 1) -> np.ndarray:
    """Regular-azimuth-grid 2-D table (saf_vbap.c:428): -180..180."""
    n_azi = int(360.0 / az_res_deg + 1.5)
    azi = -180.0 + np.arange(n_azi) * az_res_deg
    return vbap_2d(azi, ls_dirs_deg)


def get_p_values(dtt: float, freq: np.ndarray) -> np.ndarray:
    """Frequency-dependent VBAP normalisation exponent p
    (saf_vbap.c:475 ``getPvalues``; Laitinen et al. 2014)."""
    freq = np.asarray(freq, np.float64)
    a1, a2 = 0.00045, 0.000085
    p0 = 1.5 - 0.5 * np.cos(4.7 * np.tanh(a1 * freq)) * np.maximum(0.0, 1.0 - a2 * freq)
    return ((p0 - 2.0) * np.sqrt(dtt) + 2.0).astype(np.float32)
