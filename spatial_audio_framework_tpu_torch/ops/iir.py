"""IIR filtering as a log-depth linear recurrence (counterpart of
``spatial_audio_framework_tpu/ops/iir.py``).

The reference applies IIRs sample by sample (saf_utility_filters.c
``applyIIR``, direct form II).  An order-d IIR is the linear recurrence
s_t = A s_{t-1} + B x_t, so:

* :func:`iir_filter` / :func:`iir_filter_batched` evaluate it as a
  doubling scan: ⌈log2 T⌉ steps, each one batched (d × d) product
  s_t += A^k s_{t-k} with k = 1, 2, 4, ... (13 steps at T = 8192), never a
  per-sample loop; the powers A^k are composed in float64 on the host;
* :func:`iir_filter_batched_block` evaluates it in the exact block form
  y = H x + Z zi, s_T = Kx x + AT zi, four dense products whose matrices
  are built once on the host in float64 and cached as device tensors per
  (coefficients, T, device) (:func:`block_mats`).

Both match scipy ``lfilter`` (direct-form-II-transposed semantics)
including initial and final conditions, batched over leading axes.  Every
product runs under :func:`~.precision.fp32_matmul` (TF32 off): repeated
composition of near-unit-circle pole matrices (a 100 Hz high-pass at
48 kHz) at reduced precision goes to NaN.
"""
from __future__ import annotations

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import default_device, f32_tensor
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M (*cb, m, n) applied to v (*lead, *cb, n) → (*lead, *cb, m), with
    the leading axes of v folded into the product's columns (one batched
    matmul over cb; M is never expanded over lead)."""
    k = M.ndim - 2
    lead = v.shape[:v.ndim - 1 - k]
    vv = v.reshape((-1,) + tuple(v.shape[len(lead):]))     # (L, *cb, n)
    out = M @ vv.movedim(0, -1)                              # (*cb, m, L)
    return out.movedim(-1, 0).reshape(tuple(lead) + tuple(M.shape[:-1]))


def _df2t_matrices(b: np.ndarray, a: np.ndarray):
    """The DF2T state matrices for (batched) coefficient arrays.

    b, a: (..., n) host arrays (a[..., 0] normalised away).
    → (A (..., d, d), Bx (..., d), b0 (...,)) float64."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    b = b / a[..., :1]
    a = a / a[..., :1]
    d = a.shape[-1] - 1
    A = np.zeros(a.shape[:-1] + (d, d))
    for i in range(d - 1):
        A[..., i, i + 1] = 1.0
    A[..., :, 0] -= a[..., 1:]
    Bx = b[..., 1:] - a[..., 1:] * b[..., :1]
    return A, Bx, b[..., 0]


_DF2T_CACHE: dict = {}


def _df2t_device(b, a, n_steps: int, dtype: torch.dtype,
                 device: torch.device):
    """:func:`_df2t_matrices` as tensors on ``device``, with A replaced by
    its powers A, A², A⁴, …, A^(2^(n_steps-1)) for the doubling scan, all
    made once per (coefficients, n_steps, dtype, device): a host-to-device
    copy per block would make every block wait for the device to drain.
    The powers are composed in float64 on the host: squaring in float32
    on the device leaves a 100 Hz high-pass at 48 kHz (poles at |z| =
    0.991) 3e-4 of its output's scale off ``lfilter`` over 8192 samples,
    host powers 1.6e-5."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    key = (b.tobytes(), a.tobytes(), b.shape, a.shape, n_steps, dtype,
           str(device))
    hit = _DF2T_CACHE.get(key)
    if hit is None:
        A, Bx, b0 = _df2t_matrices(b, a)
        powers = [A]
        for _ in range(1, n_steps):
            powers.append(powers[-1] @ powers[-1])

        def t(m):
            return torch.tensor(np.ascontiguousarray(m), dtype=dtype,
                                device=device)

        hit = (tuple(map(t, powers)), t(Bx), t(b0))
        _DF2T_CACHE[key] = hit
    return hit


def _doubling_scan(powers, bvec: torch.Tensor) -> torch.Tensor:
    """Cumulative composition of s_t = A s_{t-1} + b_t (s_{-1} = 0; fold
    any initial state into b_0).  powers: (A, A², A⁴, …), each (..., d, d)
    constant in time and broadcastable against bvec's batch axes; bvec:
    (T, ..., d) → s (T, ..., d).  Hillis–Steele doubling: after the step of
    offset k = 2^j, s_t holds the sum over the last 2k inputs."""
    s = bvec
    with fp32_matmul():
        for j, P in enumerate(powers):
            k = 1 << j
            moved = (P @ s[:-k].unsqueeze(-1)).squeeze(-1)
            s = torch.cat([s[:k], s[k:] + moved], dim=0)
    return s


def _filter(b, a, x: torch.Tensor, zi):
    """The shared DF2T recurrence: x (..., T) → (y, zf (..., d))."""
    T = x.shape[-1]
    powers, Bx, b0 = _df2t_device(b, a, max(1, (T - 1).bit_length()),
                                  x.dtype, x.device)
    A = powers[0]
    xt = x.movedim(-1, 0)                                    # (T, ...)
    bvec = xt[..., None] * Bx                                # (T, ..., d)
    if zi is not None:
        with fp32_matmul():
            init = (A @ zi.unsqueeze(-1)).squeeze(-1)
        bvec = torch.cat([(bvec[0] + init)[None], bvec[1:]], dim=0)
    s = _doubling_scan(powers[:(T - 1).bit_length()], bvec)  # state after t
    first = (zi[..., 0] if zi is not None
             else torch.zeros_like(s[0, ..., 0]))
    s_prev0 = torch.cat([first.expand(s.shape[1:-1])[None], s[:-1, ..., 0]],
                        dim=0)
    y = b0 * xt + s_prev0
    return y.movedim(0, -1), s[-1]


def iir_filter(b, a, x: torch.Tensor, zi=None):
    """An IIR filter along the last axis (scipy ``lfilter`` DF2T
    semantics).  b, a: (n,) host arrays; x: (..., T); zi: (..., n-1) or
    None.  → (y, zf)."""
    assert len(b) == len(a) and len(a) >= 2
    return _filter(b, a, x, zi)


def iir_filter_batched(b, a, x: torch.Tensor, zi=None):
    """Batched-coefficient IIR along the last axis.  b, a: (..., n) host
    numpy (one filter per batch element, broadcastable against x's leading
    axes); x: (..., T).  → (y, zf (..., n-1)).  Same semantics as
    scipy ``lfilter``."""
    return _filter(b, a, x, zi)


# ---------------------------------------------------------------------------
# Exact block form: y = H x + Z zi,  s_T = Kx x + AT zi
# ---------------------------------------------------------------------------

def _iir_block_mats(b: np.ndarray, a: np.ndarray, T: int):
    """Design-time unroll of the DF2T recurrence over a fixed block length:

        y[t]  = b0·x[t] + e0ᵀ A^t·zi + Σ_{k<t} (e0ᵀ A^{t-1-k} Bx)·x[k]
        s_T   = A^T·zi + Σ_k A^{T-1-k} Bx·x[k]

    → (H (..., T, T) lower-triangular Toeplitz of the impulse response,
    Z (..., T, d), Kx (..., d, T), AT (..., d, d)), float32 numpy, built in
    float64.  Exact for any decay of h: the state terms carry what the
    T-tap window does not."""
    A, Bx, b0 = _df2t_matrices(b, a)
    batch = A.shape[:-2]
    d = A.shape[-1]
    P = np.zeros((T + 1,) + batch + (d, d))
    P[0] = np.broadcast_to(np.eye(d), batch + (d, d))
    for t in range(1, T + 1):
        P[t] = P[t - 1] @ A
    # impulse response: h[0] = b0; h[j] = e0ᵀ A^{j-1} Bx
    g = np.einsum("t...ij,...j->t...i", P[:T], Bx)[..., 0]   # (T, ...)
    h = np.concatenate([b0[None], g[:-1]], axis=0)           # (T, ...)
    hm = np.moveaxis(h, 0, -1)                                # (..., T)
    H = np.zeros(batch + (T, T))
    for j in range(T):
        ii = np.arange(j, T)
        H[..., ii, ii - j] = hm[..., j:j + 1]
    Z = np.moveaxis(P[:T][..., 0, :], 0, -2)                  # (..., T, d)
    Kx = np.moveaxis(np.einsum("t...ij,...j->t...i", P[T - 1::-1], Bx),
                     0, -1)                                   # (..., d, T)
    AT = P[T]
    return tuple(np.asarray(m, np.float32) for m in (H, Z, Kx, AT))


_BLOCK_DEVICE_CACHE: dict = {}


def block_mats(b, a, T: int, device: torch.device | str | None = None):
    """:func:`_iir_block_mats` as contiguous float32 tensors on ``device``
    (default: the card), made once per (coefficients, T, device).  The
    decorrelator's lattice at T = 64 hops is 133 × 4 × 64 × 64 floats
    (8.7 MB) for H alone: copied from the host per chunk it would
    serialise host and device."""
    device = torch.device(default_device() if device is None else device)
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    key = (b.tobytes(), a.tobytes(), b.shape, a.shape, T, str(device))
    hit = _BLOCK_DEVICE_CACHE.get(key)
    if hit is None:
        hit = tuple(f32_tensor(m, device) for m in _iir_block_mats(b, a, T))
        _BLOCK_DEVICE_CACHE[key] = hit
    return hit


_ONEPOLE_CACHE: dict = {}


def onepole_ewma_mats(lam: float, n: int,
                      device: torch.device | str | None = None):
    """The one-pole EWMA y[t] = lam·y[t-1] + (1-lam)·u[t] over a length-n
    block in exact block form: y = L @ u + p·y0 with L[t,k] = (1-lam)·
    lam^(t-k) (lower triangular) and p[t] = lam^(t+1).  → float32 (L, p)
    on ``device`` (default: the card), made once per (lam, n, device)."""
    device = torch.device(default_device() if device is None else device)
    key = (float(lam), int(n), str(device))
    if key not in _ONEPOLE_CACHE:
        t = np.arange(n)
        L = (1.0 - lam) * np.power(float(lam), np.maximum(
            t[:, None] - t[None, :], 0.0))
        L *= (t[:, None] >= t[None, :])
        _ONEPOLE_CACHE[key] = (f32_tensor(L, device),
                               f32_tensor(np.power(float(lam), t + 1.0),
                                          device))
    return _ONEPOLE_CACHE[key]


def iir_filter_batched_block(b, a, x: torch.Tensor, zi: torch.Tensor):
    """:func:`iir_filter_batched` semantics in the exact block form (fixed
    T = x.shape[-1]).  b, a: (..., n) host numpy; x: (..., batch..., T)
    with the coefficients' batch axes last before T; zi: (..., n-1)."""
    H, Z, Kx, AT = block_mats(b, a, x.shape[-1], x.device)
    with fp32_matmul():
        y = _matvec(H, x) + _matvec(Z, zi)
        zf = _matvec(Kx, x) + _matvec(AT, zi)
    return y, zf
