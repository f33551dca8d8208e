"""The plain reference's own design: what a renderer's set-up derives from
the HRIR set, worked out again without the program.

A frozen copy of the arithmetic of SAF v1.3.0's initCodec for the two
deployments the benchmark runs (``ambi_bin``: afSTFT HRTFs, Voronoi
weights, diffuse-field EQ, the MagLS decoder with max-rE, SN3D input;
``binauraliser``: afSTFT HRTFs, diffuse-field EQ and the compressed 2° × 5°
VBAP interpolation table over the HRIR grid, triangulated by the C's
vendored quickhull).  Host numpy and CPU torch, float32 where the C is
float32.  It imports nothing of the program.
"""
from __future__ import annotations

import functools
import math
from pathlib import Path

import numpy as np
import torch

DATA = Path(__file__).resolve().parent.parent / "data"
HOP = 128
TOTAL_HOPS = 10
COEFF1 = 0.031273141818515176604   # afSTFT_internal.h:73-76
COEFF2 = 0.28127313041521179171
EQ_NORMAL = 2.0 / np.sqrt(5.487604141)   # afSTFT_internal.c:124-146


def load_hrirs():
    """The benchmark's HRIR set → (hrirs (N, 2, L) float32, dirs (N, 2)
    degrees, fs)."""
    with np.load(DATA / "default_hrirs.npz") as z:
        return z["hrirs"].copy(), z["dirs_deg"].copy(), int(z["fs"])


def window(hop: int = HOP) -> np.ndarray:
    """The analysis (= synthesis) window of the normal-delay afSTFT:
    the prototype, decimated to 10·hop, time-reversed and scaled."""
    with np.load(DATA / "afstft_proto.npz") as z:
        proto = z["proto1024"][::1024 // hop]
    return (proto[::-1] * EQ_NORMAL).astype(np.float32)


def centre_freqs(fs: float, hop: int = HOP) -> np.ndarray:
    """Hybrid band centre frequencies (afSTFTlib.c:96-107, 545-590)."""
    uni = np.arange(hop + 1, dtype=np.float64) * fs / (2.0 * hop)
    stft2hyb = np.array([1.0, 0.7501, 1.2499, 0.8751, 1.1249, 0.9167,
                         1.0833, 0.9375, 1.0625])
    src = np.array([0, 1, 1, 2, 2, 3, 3, 4, 4])
    return np.concatenate([stft2hyb * uni[src], uni[5:]]).astype(np.float32)


def _analyse(sig: np.ndarray, hop: int = HOP) -> np.ndarray:
    """One-shot hybrid afSTFT analysis from a zero state, complex, in
    float32 on the CPU as the C designs: sig (n_ch, n) → (n_bands, n_ch,
    ceil(n / hop))."""
    n_ch, n = sig.shape
    H = int(np.ceil(n / hop))
    x = torch.zeros((n_ch, (H + TOTAL_HOPS - 1) * hop), dtype=torch.float32)
    x[:, (TOTAL_HOPS - 1) * hop:(TOTAL_HOPS - 1) * hop + n] = \
        torch.from_numpy(np.asarray(sig, np.float32))
    w = torch.from_numpy(window(hop).copy())
    hops = x.reshape(n_ch, H + TOTAL_HOPS - 1, hop)
    seg = torch.stack([hops[:, k:k + H] for k in range(TOTAL_HOPS)], dim=2)
    frames = seg.reshape(n_ch, H, TOTAL_HOPS * hop) * w
    folded = frames.reshape(n_ch, H, TOTAL_HOPS // 2, 2 * hop).sum(dim=2)
    spec = torch.fft.rfft(folded, n=2 * hop, dim=-1)
    full = torch.cat([torch.zeros((n_ch, 6, hop + 1), dtype=spec.dtype),
                      spec], dim=1)
    d3 = full[:, 3:3 + H]
    b = slice(1, 5)
    hb = 1j * (COEFF1 * (full[:, 6:6 + H, b] - full[:, 0:H, b])
               + COEFF2 * (full[:, 4:4 + H, b] - full[:, 2:2 + H, b]))
    c = 0.5 * d3[..., b]
    s = torch.tensor([-1.0, 1.0, -1.0, 1.0])
    pairs = torch.stack([c + s * hb, c - s * hb], dim=-1).reshape(
        n_ch, H, 8)
    out = torch.cat([d3[..., :1], pairs, d3[..., 5:]], dim=-1)
    return out.permute(2, 0, 1).numpy()


def filterbank_hrtfs(hrirs: np.ndarray, hop: int = HOP) -> np.ndarray:
    """HRIRs → afSTFT filterbank coefficients (afSTFTlib.c:592-675): the
    energy ratio to a centred impulse's response and the phase of their
    cross-correlation.  (N, 2, L) → (n_bands, 2, N) complex64."""
    n_dirs, n_ch, ir_len = hrirs.shape
    T = max(ir_len, hop) + 1024
    idx_del = int(np.mean(np.argmax(hrirs[0], axis=-1)) + 1.5)
    center = np.zeros((1, T), np.float32)
    center[0, idx_del] = 1.0
    D = _analyse(center, hop)[:, 0]
    d_energy = np.maximum((np.abs(D) ** 2).sum(-1), 2.23e-8)
    sig = np.zeros((n_dirs * n_ch, T), np.float32)
    sig[:, :ir_len] = hrirs.reshape(n_dirs * n_ch, ir_len)
    X = _analyse(sig, hop)
    gain = np.sqrt((np.abs(X) ** 2).sum(-1) / d_energy[:, None])
    cross = np.einsum("bct,bt->bc", X, D.conj())
    g = gain * np.exp(1j * np.angle(cross))
    return g.reshape(-1, n_dirs, n_ch).transpose(0, 2, 1).astype(np.complex64)


# -- Voronoi weights (saf_utility_geometry.c sphDelaunay / sphVoronoi /
#    sphVoronoiAreas) -------------------------------------------------------

def unit_vectors(dirs_deg: np.ndarray) -> np.ndarray:
    a = np.radians(np.asarray(dirs_deg, np.float64))
    return np.stack([np.cos(a[..., 1]) * np.cos(a[..., 0]),
                     np.cos(a[..., 1]) * np.sin(a[..., 0]),
                     np.sin(a[..., 1])], -1)


def voronoi_weights(dirs_deg: np.ndarray) -> np.ndarray:
    """Spherical Voronoi cell areas of the directions, summing to 4π."""
    from scipy.spatial import ConvexHull

    verts = unit_vectors(dirs_deg)
    faces = ConvexHull(verts).simplices.astype(int)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    normal = np.cross(v1 - v0, v2 - v0)
    vor = normal / np.linalg.norm(normal, axis=-1, keepdims=True)
    flip = (vor * (v0 - verts.mean(axis=0))).sum(-1) < 0.0
    vor[flip] = -vor[flip]
    n_vert = vor.shape[0]
    dup = np.zeros(n_vert, int)
    for n in range(n_vert):
        if dup[n] == 0:
            close = (np.abs(vor - vor[n]) < 1e-5).all(axis=1)
            close[n] = False
            dup[close] = n
    areas = np.empty(verts.shape[0], np.float32)
    for m in range(verts.shape[0]):
        inc = np.nonzero((faces == m).any(axis=1))[0]
        d = verts[m]
        a = (np.array([1.0, 0.0, 0.0]) if abs(d[0]) < 0.9
             else np.array([0.0, 1.0, 0.0]))
        t1 = np.cross(d, a)
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(d, t1)
        ring = inc[np.argsort(np.arctan2(vor[inc] @ t2, vor[inc] @ t1))]
        cell, seen = [], set()
        for i in ring:
            i = int(dup[i]) if dup[i] != 0 else int(i)
            if i not in seen:
                seen.add(i)
                cell.append(i)
        N = len(cell)
        if N < 3:
            areas[m] = 0.0
            continue
        theta = 0.0
        for n in range(N):
            p0, p1, p2 = vor[cell[n - 1]], vor[cell[n]], vor[cell[(n + 1) % N]]
            t10 = np.cross(np.cross(p1, p0), p1)
            t12 = np.cross(np.cross(p1, p2), p1)
            t10 /= np.linalg.norm(t10)
            t12 /= np.linalg.norm(t12)
            theta += np.arccos(np.clip(t10 @ t12, -1.0, 1.0))
        areas[m] = theta - (N - 2) * np.pi
    return areas


def diffuse_field_eq(H: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Diffuse-field equalisation (saf_hrir.c:175-244), magnitude only."""
    H = np.array(H, np.complex128)
    w = np.asarray(weights, np.float64)
    diff = np.sqrt(np.maximum(
        np.einsum("bed,d->be", np.abs(H) ** 2, w / (4.0 * np.pi)), 1e-5))
    return (H / (diff[..., None] + 2.23e-8)).astype(np.complex64)


# -- real spherical harmonics (saf_sh.c getSHreal, saf_hoa.c getRSH) --------

def _norm_legendre(order: int, x: np.ndarray) -> np.ndarray:
    s = np.sqrt(np.maximum(1.0 - x * x, 0.0))
    out = np.zeros((order + 1, order + 1) + x.shape, x.dtype)
    nmm = np.full(x.shape, 1.0 / math.sqrt(4.0 * math.pi), x.dtype)
    out[0, 0] = nmm
    for m in range(1, order + 1):
        nmm = nmm * math.sqrt((2.0 * m + 1.0) / (2.0 * m)) * s
        out[m, m] = nmm
    for m in range(order + 1):
        if m + 1 <= order:
            out[m + 1, m] = x * math.sqrt(2.0 * m + 3.0) * out[m, m]
        for n in range(m + 2, order + 1):
            a = math.sqrt((4.0 * n * n - 1.0) / (n * n - m * m))
            b = math.sqrt(((2.0 * n + 1.0) * (n - 1.0 - m) * (n - 1.0 + m))
                          / ((2.0 * n - 3.0) * (n * n - m * m)))
            out[n, m] = a * x * out[n - 1, m] - b * out[n - 2, m]
    return out


def real_sh(order: int, dirs_deg: np.ndarray) -> np.ndarray:
    """Real SH scaled by √(4π) (N3D), ACN: dirs (N, 2) [azi, elev] degrees
    → (nSH, N)."""
    d = np.asarray(dirs_deg, np.float64)
    azi = np.radians(d[..., 0])
    N = _norm_legendre(order, np.cos(np.pi / 2 - np.radians(d[..., 1])))
    rows = []
    for n in range(order + 1):
        for m in range(-n, n + 1):
            base = N[n, abs(m)]
            if m < 0:
                rows.append(math.sqrt(2.0) * base * np.sin(-m * azi))
            elif m == 0:
                rows.append(base)
            else:
                rows.append(math.sqrt(2.0) * base * np.cos(m * azi))
    return np.stack(rows, axis=0) * math.sqrt(4.0 * math.pi)


def max_re_weights(order: int) -> np.ndarray:
    """Per-channel max-rE weights P_n(cos(137.9° / (order + 1.51)))."""
    x = np.cos(np.float32(137.9) * (np.pi / 180.0)
               / (order + np.float32(1.51)))
    out = []
    for n in range(order + 1):
        pn = _norm_legendre(n, np.array([float(x)]))[n, 0, 0]
        pn *= math.sqrt(4.0 * math.pi / (2.0 * n + 1.0))
        out += [float(pn)] * (2 * n + 1)
    return np.asarray(out, np.float32)


def magls_decoder(H: np.ndarray, dirs_deg: np.ndarray, order: int,
                  freqs: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Magnitude-least-squares binaural decoder (saf_hoa_internal.c:525):
    complex LS up to the band nearest 1.5 kHz, then per band the previous
    band's phase with this band's magnitude.  → (n_bands, 2, nSH)."""
    Y = real_sh(order, dirs_deg)
    YW = Y * np.asarray(weights, np.float64)[None, :]
    A_inv = np.linalg.inv(YW @ Y.T)
    H = np.asarray(H)
    bc = int(np.argmin(np.abs(np.asarray(freqs) - 1500.0)))
    dec = np.zeros((H.shape[0], 2, Y.shape[0]), np.complex128)
    for band in range(H.shape[0]):
        if band <= bc:
            target = H[band]
        else:
            target = np.abs(H[band]) * np.exp(1j * np.angle(dec[band - 1] @ Y))
        dec[band] = (A_inv @ (YW @ target.conj().T)).conj().T
    return dec.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def ambi_bin_decoder(order: int, fs: float) -> np.ndarray:
    """SAF ambi_bin's decoder for MagLS, EQ preprocessing, max-rE and ACN /
    SN3D input: (n_bands, 2, nSH) complex64, applied to SN3D signals."""
    hrirs, dirs, hrir_fs = load_hrirs()
    if hrir_fs != fs:
        raise ValueError(f"the HRIR set is at {hrir_fs} Hz, the deployment "
                         f"at {fs}")
    freqs = centre_freqs(fs)
    w = voronoi_weights(dirs)
    H = diffuse_field_eq(filterbank_hrtfs(hrirs), w)
    dec = magls_decoder(H, dirs, order, freqs, w)
    dec = dec * max_re_weights(order)[None, None, :]
    ns = np.concatenate([[n] * (2 * n + 1) for n in range(order + 1)])
    sn3d_to_n3d = np.sqrt(2.0 * ns + 1.0).astype(np.float32)
    return (dec.astype(np.complex64) * sn3d_to_n3d).astype(np.complex64)


# -- the binauraliser's interpolation table --------------------------------

def _glibc_rand():
    """glibc ``rand()`` without ``srand`` (seed 1)."""
    r = [0] * 34
    r[0] = 1
    for i in range(1, 31):
        hi, lo = divmod(r[i - 1], 127773)
        v = 16807 * lo - 2836 * hi
        r[i] = v + 2147483647 if v < 0 else v
    for i in range(31, 34):
        r[i] = r[i - 31]
    i = 34
    while True:
        v = (r[(i - 31) % 34] + r[(i - 3) % 34]) & 0xFFFFFFFF
        r[i % 34] = v
        if i >= 344:
            yield v >> 1
        i += 1


def _det4(m: np.ndarray) -> float:
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


def _plane(p: np.ndarray):
    pd = p[1:3] - p[0:2]
    c = np.array([pd[0, 1] * pd[1, 2] - pd[1, 1] * pd[0, 2],
                  -(pd[0, 0] * pd[1, 2] - pd[1, 0] * pd[0, 2]),
                  pd[0, 0] * pd[1, 1] - pd[1, 0] * pd[0, 1]])
    c = c / np.sqrt(c[0] * c[0] + c[1] * c[1] + c[2] * c[2])
    return c, -(p[0, 0] * c[0] + p[0, 1] * c[1] + p[0, 2] * c[2])


def _convhull(verts: np.ndarray) -> np.ndarray:
    """The C's vendored quickhull (convhull_3d.c:367), its decisions
    reproduced: glibc ``rand()`` jitter, insertion order, horizon order and
    orientation swaps, so coplanar quads of a regular grid split along the
    same diagonals as in the C.  → faces (nFaces, 3)."""
    n = verts.shape[0]
    rnd = _glibc_rand()
    pts4 = np.empty((n, 4), np.float64)
    for i in range(n):
        for j in range(3):
            pts4[i, j] = verts[i, j] + (1e-7 * next(rnd)) / 2147483647
        pts4[i, 3] = 1.0
    pts = pts4[:, :3]
    span = pts.max(axis=0) - pts.min(axis=0)

    def det_simplex(face, p):
        return _det4(np.stack([pts4[face[0]], pts4[face[1]], pts4[face[2]],
                               pts4[p]]).ravel())

    faces = [[a for a in range(4) if a != i] for i in range(4)]
    cf, df = zip(*(_plane(pts[f]) for f in faces))
    cf, df = list(cf), list(df)
    for k in range(4):
        if det_simplex(faces[k], k) < 0:
            faces[k][1], faces[k][2] = faces[k][2], faces[k][1]
            cf[k], df[k] = -cf[k], -df[k]
    meanp = pts[4:].mean(axis=0)
    reldist = (((pts[4:] - meanp) / span) ** 2).sum(axis=1)
    faces = np.asarray(faces, np.int64)
    cf = np.asarray(cf, np.float64)
    df = np.asarray(df, np.float64)
    for i in (int(ix) + 4 for ix in np.argsort(-reldist, kind="stable")):
        vis = (cf @ pts[i] + df) > 0.0
        if not vis.any():
            continue
        nonvis = faces[~vis]
        horizon = []
        for vface in np.flatnonzero(vis):
            mem = np.isin(nonvis, faces[vface])
            for r in np.flatnonzero(mem.sum(axis=1) == 2):
                horizon.append(nonvis[r][mem[r]])
        horizon = (np.asarray(horizon, np.int64) if horizon
                   else np.zeros((0, 2), np.int64))
        start = nonvis.shape[0]
        new = np.concatenate(
            [horizon, np.full((horizon.shape[0], 1), i, np.int64)], axis=1)
        faces = np.concatenate([nonvis, new], axis=0)
        planes = [_plane(pts[f]) for f in new]
        cf = np.concatenate([cf[~vis]] + [p[0][None] for p in planes])
        df = np.concatenate([df[~vis], [p[1] for p in planes]])
        for k in range(start, faces.shape[0]):
            fv = faces[k]
            detA, index = 0.0, 0
            while detA == 0.0:
                while index in (fv[0], fv[1], fv[2]):
                    index += 1
                detA = det_simplex(fv, index)
                index += 1
            if detA < 0.0:
                faces[k, 1], faces[k, 2] = faces[k, 2], faces[k, 1]
                cf[k], df[k] = -cf[k], -df[k]
    return faces.astype(int)


def vbap_table(dirs_deg: np.ndarray, azi_res: int, elev_res: int):
    """The compressed VBAP gain table over a regular azimuth × elevation
    grid (saf_vbap.c generateVBAPgainTable3D with omitLargeTriangles and
    no dummies, then compressVBAPgainTable3D): per grid point the three
    non-zero gains, amplitude-normalised, and their direction indices."""
    verts = unit_vectors(dirs_deg).astype(np.float32).astype(np.float64)
    faces = _convhull(verts)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    faces = faces[(np.cross(v1 - v0, v2 - v1) * (v0 + v1 + v2) / 3.0)
                  .sum(-1) > 0.0]
    faces = faces[np.abs(np.linalg.det(verts[faces].transpose(0, 2, 1)))
                  > 1e-8]
    lim = np.pi   # the 180° aperture limit
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    ang = [np.arccos(np.clip((p * q).sum(-1), -1, 1))
           for p, q in ((v0, v1), (v1, v2), (v2, v0))]
    faces = faces[(ang[0] < lim) & (ang[1] < lim) & (ang[2] < lim)]
    inv = np.linalg.inv(verts[faces].transpose(0, 2, 1))
    n_azi = int(360.0 / azi_res + 1.5)
    n_ele = int(180.0 / elev_res + 1.5)
    grid = np.stack(np.meshgrid(-180.0 + np.arange(n_azi) * azi_res,
                                -90.0 + np.arange(n_ele) * elev_res),
                    -1).reshape(-1, 2)
    g_all = np.einsum("fij,sj->sfi", inv, unit_vectors(grid))
    valid = g_all.min(-1) > -0.001
    first = np.argmax(valid, axis=1)
    has = valid.any(axis=1)
    L = verts.shape[0]
    comp = np.zeros((grid.shape[0], 3), np.float32)
    idx = np.zeros((grid.shape[0], 3), np.int64)
    for ns in range(grid.shape[0]):
        gains = np.zeros(L)
        if has[ns]:
            g = g_all[ns, first[ns]]
            gains[faces[first[ns]]] = g / max(np.linalg.norm(g), 1e-20)
        gains = np.maximum(gains / max(np.linalg.norm(gains), 1e-20), 0.0)
        gains = gains.astype(np.float32)
        nz = np.flatnonzero(gains > 1e-7)[:3]
        comp[ns, :len(nz)] = np.maximum(gains[nz] / gains[nz].sum(), 0.0)
        idx[ns, :len(nz)] = nz
    return comp, idx


@functools.lru_cache(maxsize=None)
def binauraliser_tables(fs: float, azi_res: int, elev_res: int):
    """SAF binauraliser's design with diffuse-field EQ: (HRTFs (n_bands, 2,
    N) complex64, table weights (nTable, 3), table indices (nTable, 3))."""
    hrirs, dirs, hrir_fs = load_hrirs()
    if hrir_fs != fs:
        raise ValueError(f"the HRIR set is at {hrir_fs} Hz, the deployment "
                         f"at {fs}")
    H = diffuse_field_eq(filterbank_hrtfs(hrirs), voronoi_weights(dirs))
    comp, idx = vbap_table(np.asarray(dirs, np.float64), azi_res, elev_res)
    return H, comp, idx
