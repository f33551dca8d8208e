"""The plain reference of SAF ambi_dec's loudspeaker decode: its own design
of the dual-band decoder, and the render through
:class:`portbench.reference.render.Reference`.

The design is a frozen copy of the arithmetic of SAF v1.3.0's initCodec
(ambi_dec.c:255-345, 520-540) for AllRAD in both bands: per band a
decoder from the VBAP gains of a dense t-design over the layout's hull
(saf_hoa_internal.c getAllRAD) truncated to the band's order, max-rE
weights, the energy-preserving normalisation from a sweep of plane waves
through orthonormal real SH over a t-design of degree 30, the low decoder
below the transition frequency (by band centre frequency) and the high
one above it, and the SN3D input converted to N3D.  Host numpy, float32
where the C is float32.  It imports nothing of the program.

Departures from SAF, none of which changes a number:

* the t-designs (degrees 30 and 100) and the 22.x directions are read from
  ``portbench/data`` (``tdesign_dirs_deg.npz``, ``ls_22x_dirs_deg.json``),
  copies of SAF's tables held equal to the program's by the tests;
* the hull is ``design._convhull`` (the C's quickhull), whose fresh glibc
  ``rand()`` stream a call is replaced here by one stream for the whole
  design: the C draws both hulls from one stream, d = 0 then d = 1;
* every band takes the master order (ambi_dec's default orders per band).
"""
from __future__ import annotations

import contextlib
import functools
import json
import math

import numpy as np
import torch

from portbench.reference import design as ref_design
from portbench.reference.design import (DATA, _convhull, centre_freqs,
                                        max_re_weights, real_sh,
                                        unit_vectors)

SETTINGS = {"dec_method": ["allrad", "allrad"], "enable_max_re": [True, True],
            "diff_eq": ["energy", "energy"], "ch_ordering": "acn",
            "norm": "sn3d", "layout": "22.x", "binauralise_ls": False,
            "hop": 128}


def layout_dirs_deg(layout: str) -> np.ndarray:
    """A layout's loudspeaker directions (nLS, 2) [azimuth, elevation] in
    degrees, float32, from its data file."""
    name = "ls_" + layout.replace(".", "") + "_dirs_deg.json"
    doc = json.loads((DATA / name).read_text())
    return np.asarray(doc["dirs_deg"], np.float32)


def tdesign(degree: int) -> np.ndarray:
    with np.load(DATA / "tdesign_dirs_deg.npz") as z:
        return z[f"degree_{degree}"].copy()


@contextlib.contextmanager
def _one_rand_stream():
    """Within it every ``_convhull`` continues one glibc ``rand()``
    stream, as the C's process does."""
    stream = ref_design._glibc_rand()
    fresh = ref_design._glibc_rand
    ref_design._glibc_rand = lambda: stream
    try:
        yield
    finally:
        ref_design._glibc_rand = fresh


def _vbap_gains(ls_dirs_deg: np.ndarray, src_dirs_deg: np.ndarray
                ) -> np.ndarray:
    """VBAP gains (nSrc, nLS) over the layout's hull, no dummy loudspeakers
    and no aperture limit (saf_vbap.c findLsTriplets, invertLsMtx3D,
    vbap3D): per source the first triangle whose gains all exceed -0.001,
    its gains over their norm, the row over its norm, clipped at 0."""
    verts = unit_vectors(ls_dirs_deg).astype(np.float32).astype(np.float64)
    faces = _convhull(verts)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    faces = faces[(np.cross(v1 - v0, v2 - v1) * (v0 + v1 + v2) / 3.0)
                  .sum(-1) > 0.0]
    faces = faces[np.abs(np.linalg.det(verts[faces].transpose(0, 2, 1)))
                  > 1e-8]
    inv = np.linalg.inv(verts[faces].transpose(0, 2, 1))
    g_all = np.einsum("fij,sj->sfi", inv, unit_vectors(src_dirs_deg))
    valid = g_all.min(-1) > -0.001
    first = np.argmax(valid, axis=1)
    out = np.zeros((src_dirs_deg.shape[0], verts.shape[0]))
    for s in np.flatnonzero(valid.any(axis=1)):
        g = g_all[s, first[s]]
        out[s, faces[first[s]]] = g / max(np.linalg.norm(g), 1e-20)
    norm = np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-20)
    return np.maximum(out / norm, 0.0).astype(np.float32)


def allrad(order: int, ls_dirs_deg: np.ndarray) -> np.ndarray:
    """The AllRAD decoder (nLS, nSH) for N3D input: the VBAP gains of the
    degree-100 t-design times its orthonormal real SH, times 4π / nDirs."""
    t = tdesign(100).astype(np.float64)
    G = _vbap_gains(ls_dirs_deg, t)
    Y = real_sh(order, t) / math.sqrt(4.0 * math.pi)
    return ((G.T @ Y.T) * (4.0 * math.pi / t.shape[0])).astype(np.float32)


def energy_gain(M: np.ndarray, order: int) -> float:
    """The energy-preserving gain (ambi_dec.c:305-335): plane waves from
    the degree-30 t-design through orthonormal real SH and the decoder,
    1 / sqrt of their mean energy."""
    Y = real_sh(order, tdesign(30).astype(np.float64)) / math.sqrt(
        4.0 * math.pi)
    g = M @ Y
    return float(np.sqrt(1.0 / ((g ** 2).sum(0).mean() + 2.23e-6)))


@functools.lru_cache(maxsize=None)
def decoder(order: int, fs: float, transition_freq: float,
            layout: str) -> np.ndarray:
    """SAF ambi_dec's decoder with AllRAD, max-rE and energy preservation
    in both bands, applied to ACN / SN3D signals: (nBands, nLS, nSH)
    float32."""
    ls = layout_dirs_deg(layout)
    with _one_rand_stream():
        masters = [allrad(order, ls) for _ in range(2)]    # d = 0, then 1
    per_d = []
    for M in masters:
        gain = energy_gain(M, order)
        per_d.append(M * max_re_weights(order)[None, :] * np.float32(gain))
    ns = np.concatenate([[n] * (2 * n + 1) for n in range(order + 1)])
    sn3d_to_n3d = np.sqrt(2.0 * ns + 1.0).astype(np.float32)
    freqs = centre_freqs(fs)
    return np.stack([per_d[0 if f < transition_freq else 1] * sn3d_to_n3d
                     for f in freqs]).astype(np.float32)


def render(ref, x: torch.Tensor, M: torch.Tensor,
           hops_per_block: int) -> torch.Tensor:
    """x (S, nSH, n) from silence through the real decoder M (nBands, nLS,
    nSH) on ``ref`` (a ``Reference``) → (S, nLS, n)."""
    Mre = M[None, None]
    return ref.render(x, Mre, torch.zeros_like(Mre), hops_per_block)
