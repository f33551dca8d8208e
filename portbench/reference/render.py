"""The plain reference's render: the hybrid afSTFT, a per-band complex
mixing matrix and the synthesis, in plain torch, float32, over a signal
that starts from silence.

The afSTFT pipeline is a finite filter: an output hop depends on the
input of the 24 hops before it (15 of the analysis tail, 9 of the
overlap-add) and on its own, and on no earlier state.  So the
output of block k of a stream whose state was carried from the start is
rendered exactly by starting from a zero state ``history_blocks`` blocks
earlier (``history_blocks(H)``); the reference follows those blocks with
their own inputs and mixing matrices.

Every product over the signal is a matrix product (``_mm``).  In
``precision="tf32"`` its operands are first rounded to TF32 (10 mantissa
bits, what the tensor cores read in TF32), the benchmark's control.
Imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.design import COEFF1, COEFF2, HOP, TOTAL_HOPS, window

TAIL_HOPS = 15          # 9 hops of framing and 6 of the hybrid stage
MEMORY_HOPS = 24        # hops before an output hop that it depends on


def history_blocks(hops_per_block: int) -> int:
    """Blocks to render before block k so that block k is exact."""
    return -(-MEMORY_HOPS // hops_per_block)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10-bit mantissa, to nearest (ties away)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


class Reference:
    """The reference pipeline on one device at one precision
    (``"fp32"``, or ``"tf32"`` for the control)."""

    def __init__(self, device, precision: str = "fp32", hop: int = HOP):
        if precision not in ("fp32", "tf32"):
            raise ValueError(precision)
        self.device = torch.device(device)
        self.tf32 = precision == "tf32"
        self.hop = hop
        n = 2 * hop
        k = np.arange(hop + 1)
        t = np.arange(n)
        ang = 2.0 * np.pi * np.outer(t, k) / n
        c = np.where((k == 0) | (k == hop), 1.0, 2.0)

        def dev(a):
            return torch.tensor(np.ascontiguousarray(a, np.float32),
                                device=self.device)

        self.C = dev(np.cos(ang))                   # (2·hop, hop+1)
        self.S = dev(-np.sin(ang))
        self.A = dev(c[:, None] * np.cos(ang).T / n)  # (hop+1, 2·hop)
        self.B = dev(-c[:, None] * np.sin(ang).T / n)
        self.w = dev(window(hop))

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = _tf32(a), _tf32(b)
        return torch.matmul(a, b)

    def analysis(self, x: torch.Tensor):
        """x (R, n) from a zero state → hybrid spectra (re, im), each
        (R, n / hop, hop + 5)."""
        hop = self.hop
        R, n = x.shape
        H = n // hop
        buf = torch.cat([x.new_zeros((R, TAIL_HOPS * hop)), x], dim=-1)
        hops = buf.reshape(R, H + TAIL_HOPS, hop)
        He = H + 6
        folded = x.new_zeros((R, He, 2 * hop))
        for j in range(TOTAL_HOPS):
            half = (j % 2) * hop
            folded[..., half:half + hop] += (hops[:, j:j + He]
                                             * self.w[j * hop:(j + 1) * hop])
        fr = self._mm(folded, self.C)               # (R, He, hop+1)
        fi = self._mm(folded, self.S)
        return self._hybrid(fr, fi, H)

    @staticmethod
    def _hybrid(fr, fi, H):
        """Half-band split of bands 1-4 along hop-time
        (afSTFT_internal.c:523-641), 3 hops of group delay."""
        b = slice(1, 5)
        sign = fr.new_tensor([-1.0, 1.0, -1.0, 1.0])

        def inner(f):
            return (COEFF1 * (f[:, 6:6 + H, b] - f[:, 0:H, b])
                    + COEFF2 * (f[:, 4:4 + H, b] - f[:, 2:2 + H, b]))

        out = []
        for d3, hb in ((fr[:, 3:3 + H], -inner(fi)), (fi[:, 3:3 + H],
                                                       inner(fr))):
            c = 0.5 * d3[..., b]
            pairs = torch.stack([c + sign * hb, c - sign * hb], dim=-1)
            out.append(torch.cat([d3[..., :1], pairs.flatten(-2),
                                  d3[..., 5:]], dim=-1))
        return out

    def synthesis(self, yr: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
        """Hybrid spectra (R, H, hop + 5) from a zero state → (R, H·hop)."""
        hop = self.hop

        def merge(y):
            return torch.cat([y[..., :1], y[..., 1:9].unflatten(
                -1, (4, 2)).sum(-1), y[..., 9:]], dim=-1)

        frame = self._mm(merge(yr), self.A) + self._mm(merge(yi), self.B)
        R, H = frame.shape[:2]
        acc = frame.new_zeros((R, H + TOTAL_HOPS - 1, hop))
        for j in range(TOTAL_HOPS):
            half = (j % 2) * hop
            acc[:, j:j + H] += (frame[..., half:half + hop]
                                * self.w[j * hop:(j + 1) * hop])
        return acc.reshape(R, -1)[:, :H * hop]

    def render(self, x: torch.Tensor, Mre: torch.Tensor, Mim: torch.Tensor,
               hops_per_block: int) -> torch.Tensor:
        """x (S, cin, n) from silence; per-band mixing matrices
        (S, nBlocks, n_bands, cout, cin) re and im, one for each block of
        ``hops_per_block`` hops → (S, cout, n)."""
        S, cin, n = x.shape
        H = n // self.hop
        nb = H // hops_per_block
        sr, si = self.analysis(x.reshape(S * cin, n))
        B = sr.shape[-1]
        # (S, cin, nb, Hb, B) → (S, nb, B, cin, Hb)
        sr, si = (s.reshape(S, cin, nb, hops_per_block, B)
                  .permute(0, 2, 4, 1, 3) for s in (sr, si))
        yr = self._mm(Mre, sr) - self._mm(Mim, si)   # (S, nb, B, cout, Hb)
        yi = self._mm(Mre, si) + self._mm(Mim, sr)
        cout = yr.shape[-2]
        yr, yi = (y.permute(0, 3, 1, 4, 2).reshape(S * cout, H, B)
                  for y in (yr, yi))
        return self.synthesis(yr, yi).reshape(S, cout, n)


def rotation(ypr: torch.Tensor) -> torch.Tensor:
    """Yaw-pitch-roll (radians, (..., 3)) → the row-vector rotation
    R = Rx(roll) Ry(pitch) Rz(yaw) (saf_utility_geometry.c), (..., 3, 3):
    a head-relative direction is u @ R."""
    cy, cp, cr = torch.cos(ypr).unbind(-1)
    sy, sp, sr = torch.sin(ypr).unbind(-1)
    rows = [cp * cy, cp * sy, -sp,
            sr * sp * cy - cr * sy, sr * sp * sy + cr * cy, sr * cp,
            cr * sp * cy + sr * sy, cr * sp * sy - sr * cy, cr * cp]
    return torch.stack(rows, dim=-1).unflatten(-1, (3, 3))


def sph2cart(dirs_deg: torch.Tensor) -> torch.Tensor:
    a = dirs_deg * (math.pi / 180.0)
    ce = torch.cos(a[..., 1])
    return torch.stack([ce * torch.cos(a[..., 0]), ce * torch.sin(a[..., 0]),
                        torch.sin(a[..., 1])], dim=-1)


def cart2sph(u: torch.Tensor) -> torch.Tensor:
    azi = torch.atan2(u[..., 1], u[..., 0])
    elev = torch.atan2(u[..., 2], torch.sqrt(u[..., 0] ** 2 + u[..., 1] ** 2))
    return torch.stack([azi, elev], dim=-1) * (180.0 / math.pi)


def interp_hrtfs(Hre, Him, comp, idx, dirs_deg, azi_res, elev_res):
    """Triangular interpolation of the HRTFs (binauraliser_interpHRTFs):
    dirs (..., nSrc, 2) degrees → (re, im) each (..., n_bands, 2, nSrc).
    The table row is the C's (int)(x + 0.5f) of the azimuth index modulo
    360 and of the elevation index."""
    n_azi = int(360.0 / azi_res + 0.5) + 1
    ai = torch.floor(torch.remainder(dirs_deg[..., 0] + 180.0, 360.0)
                     / azi_res + 0.5)
    ei = torch.floor((dirs_deg[..., 1] + 90.0) / elev_res + 0.5)
    row = (ei * n_azi + ai).long()
    w3 = comp[row]                                   # (..., nSrc, 3)
    i3 = idx[row]

    def gather(T):                                   # (B, 2, N)
        g = T[:, :, i3]                              # (B, 2, ..., nSrc, 3)
        return (g * w3).sum(-1).movedim((0, 1), (-3, -2))

    return gather(Hre), gather(Him)
