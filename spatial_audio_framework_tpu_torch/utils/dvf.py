"""Distance-variation function (DVF) near-field filters (counterpart of
``spatial_audio_framework_tpu/utils/dvf.py``, ``saf_utility_dvf``; Romblom
& Cook 2008 high-shelf approximation).

Torch functions, vectorised over sources and ears, that run on their
inputs' device in their inputs' dtype, so the per-chunk path of
binauraliser_nf updates its filters from distances and angles that live on
the card.  The coefficient lookup table (10° azimuth steps,
saf_utility_dvf.c:37-51) is one cached tensor per (device, dtype): a chunk
gathers from it and copies nothing from the host.

Some table entries are large (``_P23``: 3404, 10336; ``_P33``: −1699,
16818), so :func:`calc_dvf_shelf_params` cancels in float32 near those
azimuths: float32 results agree with a float64 evaluation to a relative
~1e-4, not to an absolute tolerance.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

# rows: P11, P21, Q11, Q21 (g0); P12, P22, Q12, Q22 (gInf); P13, P23, P33,
# Q13, Q23 (fc)
_TABLE = np.array([
    [12.97, 13.19, 12.13, 11.19, 9.91, 8.328, 6.493, 4.455, 2.274, 0.018, -2.24, -4.43, -6.49, -8.34, -9.93, -11.3, -12.2, -12.8, -13.0],
    [-9.69, 234.2, -11.2, -9.03, -7.87, -7.42, -7.31, -7.28, -7.29, -7.48, -8.04, -9.23, -11.6, -17.4, -48.4, 9.149, 1.905, -0.75, -1.32],
    [-1.14, 18.48, -1.25, -1.02, -0.83, -0.67, -0.5, -0.32, -0.11, -0.13, 0.395, 0.699, 1.084, 1.757, 4.764, -0.64, 0.109, 0.386, 0.45],
    [0.219, -8.5, 0.346, 0.336, 0.379, 0.421, 0.423, 0.382, 0.314, 0.24, 0.177, 0.132, 0.113, 0.142, 0.462, -0.14, -0.08, -0.06, -0.05],
    [-4.39, -4.31, -4.18, -4.01, -3.87, -4.1, -3.87, -5.02, -6.72, -8.69, -11.2, -12.1, -11.1, -11.1, -9.72, -8.42, -7.44, -6.78, -6.58],
    [2.123, -2.78, 4.224, 3.039, -0.57, -34.7, 3.271, 0.023, -8.96, -58.4, 11.47, 8.716, 21.8, 1.91, -0.04, -0.66, 0.395, 2.662, 3.387],
    [-0.55, 0.59, -1.01, -0.56, 0.665, 11.39, -1.57, -0.87, 0.37, 5.446, -1.13, -0.63, -2.01, 0.15, 0.243, 0.147, -0.18, -0.67, -0.84],
    [-0.06, -0.17, -0.02, -0.32, -1.13, -8.3, 0.637, 0.325, -0.08, -1.19, 0.103, -0.12, 0.098, -0.4, -0.41, -0.34, -0.18, 0.05, 0.131],
    [0.457, 0.455, -0.87, 0.465, 0.494, 0.549, 0.663, 0.691, 3.507, -27.4, 6.371, 7.032, 7.092, 7.463, 7.453, 8.101, 8.702, 8.925, 9.317],
    [-0.67, 0.142, 3404., -0.91, -0.67, -1.21, -1.76, 4.655, 55.09, 10336., 1.735, 40.88, 23.86, 102.8, -6.14, -18.1, -9.05, -9.03, -6.89],
    [0.174, -0.11, -1699., 0.437, 0.658, 2.02, 6.815, 0.614, 589.3, 16818., -9.39, -44.1, -23.6, -92.3, -1.81, 10.54, 0.532, 0.285, -2.08],
    [-1.75, -0.01, 7354., -2.18, -1.2, -1.59, -1.23, -0.89, 29.23, 1945., -0.06, 5.635, 3.308, 13.88, -0.88, -2.23, -0.96, -0.9, -0.57],
    [0.699, -0.35, -5350., 1.188, 0.256, 0.816, 1.166, 0.76, 59.51, 1707., -1.12, -6.18, -3.39, -12.7, -0.19, 1.295, -0.02, -0.08, -0.4],
])
_N_AZ = 19

A_0 = 0.0875      # reference head radius used to generate the table [m]
A_HEAD = 0.09096  # head radius of this implementation [m]
HEAD_DIM = math.pi * (A_0 / A_HEAD)
SOS_DIV_2PI_A = 343.0 / (2.0 * math.pi * A_HEAD)


@functools.lru_cache(maxsize=None)
def _table(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The (13, 19) coefficient table on ``device``, made once per (device,
    dtype): a host-to-device copy per chunk would make the host wait for
    the device."""
    return torch.tensor(_TABLE, dtype=dtype, device=device)


def calc_dvf_shelf_params(idx: torch.Tensor, rho: torch.Tensor):
    """Shelf params (g0 dB, gInf dB, fc Hz) at table index idx (int64,
    within [0, 18]) (saf_utility_dvf.c ``calcDVFShelfParams``)."""
    rho2 = rho * rho
    (p11, p21, q11, q21, p12, p22, q12, q22,
     p13, p23, p33, q13, q23) = _table(rho.device, rho.dtype)[:, idx]
    g0 = (p11 * rho + p21) / (rho2 + q11 * rho + q21)
    ginf = (p12 * rho + p22) / (rho2 + q12 * rho + q22)
    fc = ((p13 * rho2 + p23 * rho + p33)
          / (rho2 + q13 * rho + q23)) * SOS_DIV_2PI_A
    return g0, ginf, fc


def interp_dvf_shelf_params(theta_deg: torch.Tensor, rho: torch.Tensor):
    """Interpolated shelf params at exact azimuth
    (saf_utility_dvf.c ``interpDVFShelfParams``).  theta_deg: lateral angle
    on the interaural axis [0, 180]; rho: distance / head radius (≥1);
    tensors that broadcast against each other."""
    theta = theta_deg.clamp(0.0, 180.0)
    rho = rho.clamp_min(1.0)
    theta, rho = torch.broadcast_tensors(theta, rho)
    t10 = theta / 10.0
    # a NaN angle takes index 0, as the JAX package's float → int conversion
    lo = torch.nan_to_num(torch.floor(t10), nan=0.0).long().clamp(
        0, _N_AZ - 2)
    g0a, gia, fca = calc_dvf_shelf_params(lo, rho)
    g0b, gib, fcb = calc_dvf_shelf_params(lo + 1, rho)
    f = t10 - lo
    return (g0a + (g0b - g0a) * f, gia + (gib - gia) * f,
            fca + (fcb - fca) * f)


def dvf_shelf_coeffs(g0: torch.Tensor, ginf: torch.Tensor, fc: torch.Tensor,
                     fs: float):
    """Shelf params → 1st-order IIR coeffs (b0, b1, a1)
    (saf_utility_dvf.c ``dvfShelfCoeffs``)."""
    v0 = 10.0 ** (ginf / 20.0)
    g0m = 10.0 ** (g0 / 20.0)
    tanf_ = torch.tan((HEAD_DIM / fs) * fc)
    a_c = (v0 * tanf_ - 1.0) / (v0 * tanf_ + 1.0)
    v = (v0 - 1.0) * 0.5
    b0 = g0m * (v - v * a_c + 1.0)
    b1 = g0m * (v * a_c - v + a_c)
    return b0, b1, a_c


def calc_dvf_coeffs(alpha_deg: torch.Tensor, rho: torch.Tensor, fs: float):
    """Lateral angle + distance → (b (..., 2), a (..., 2)) filter coeffs
    (saf_utility_dvf.h:62 ``calcDVFCoeffs``)."""
    g0, gi, fc = interp_dvf_shelf_params(alpha_deg, rho)
    b0, b1, a1 = dvf_shelf_coeffs(g0, gi, fc, fs)
    return (torch.stack([b0, b1], -1),
            torch.stack([torch.ones_like(a1), a1], -1))


def doa_to_ipsi_interaural(azimuth_deg: torch.Tensor,
                           elevation_deg: torch.Tensor):
    """DoA → ipsilateral interaural-polar angles for (L, R) ears
    (saf_utility_dvf.c ``doaToIpsiInteraural``).  Returns (alphaLR, betaLR)
    each (..., 2) degrees."""
    az = torch.deg2rad(azimuth_deg)
    el = torch.deg2rad(elevation_deg)
    sinaz, cosaz = torch.sin(az), torch.cos(az)
    sinel, cosel = torch.sin(el), torch.cos(el)
    alpha = math.pi / 2.0 - torch.acos((sinaz * cosel).clamp(-1.0, 1.0))
    beta = torch.asin(sinel / torch.sqrt(sinel ** 2 + cosaz ** 2 * cosel ** 2
                                         + 1e-20))
    flip = beta > math.pi / 2.0
    alpha = torch.where(flip, math.pi - alpha, alpha)
    beta = torch.where(flip, math.pi - beta, beta)
    alpha = torch.abs(math.pi / 2.0 - alpha)
    alpha = torch.where(alpha > math.pi, 2 * math.pi - alpha, alpha)
    alpha_deg = torch.rad2deg(alpha)
    beta_deg = torch.rad2deg(beta)
    return (torch.stack([alpha_deg, 180.0 - alpha_deg], -1),
            torch.stack([beta_deg, 180.0 - beta_deg], -1))
