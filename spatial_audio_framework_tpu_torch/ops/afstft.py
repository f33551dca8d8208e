"""Alias-free STFT filterbank (afSTFT) in PyTorch (counterpart of
``spatial_audio_framework_tpu/ops/afstft.py``).

A complex uniform filterbank with ``hop+1`` bands built from a 10·hop-long
prototype filter, plus the optional "hybrid" stage that splits bands 1–4
with 7-tap half-band filters along hop-time (``hop+5`` bands).  The
filterbank is a function over a block of H hops with an explicit state.

This complex formulation is the design-time one: :func:`analyse` and
:func:`fir_to_filterbank_coeffs` run on the CPU in float32, as the reference
runs them.  The streaming path uses the split real/imaginary form in
``ops/afstft_ri.py``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import (data_path, default_device,
                                               f32_tensor)
from spatial_audio_framework_tpu_torch.ops.fft import (_rdft_mats, irfft_op,
                                                       rfft_op)

# Half-band ("hybrid") filter coefficients, afSTFT_internal.h:73-76.
_COEFF1 = 0.031273141818515176604
_COEFF2 = 0.28127313041521179171

# Prototype-filter energy normalisers, afSTFT_internal.c:124-146.
_EQ_NORMAL = 2.0 / np.sqrt(5.487604141)
_EQ_LD = 2.0 / np.sqrt(4.544559956)

_TOTAL_HOPS = 10  # prototype length = 10 * hop (afSTFT_internal.c:80)


@functools.lru_cache(maxsize=None)
def _load_proto() -> dict[str, np.ndarray]:
    with np.load(data_path("afstft_proto.npz")) as z:
        return {"normal": z["proto1024"].copy(), "ld": z["proto1024_ld"].copy()}


def _windows(hop: int, low_delay: bool) -> tuple[np.ndarray, np.ndarray]:
    """Analysis/synthesis windows of length 10*hop (afSTFT_internal.c:122-148).

    The analysis window is the prototype TIME-REVERSED (the reference stores
    it reversed into ``protoFilter``); the synthesis window is the same in
    normal mode and the forward-order prototype in low-delay mode.
    """
    ds = 1024 // hop
    if 1024 % hop or hop < 32:
        raise ValueError(f"unsupported hop size {hop}")
    proto = _load_proto()["ld" if low_delay else "normal"][::ds]
    eq = _EQ_LD if low_delay else _EQ_NORMAL
    w_ana = (proto[::-1] * eq).astype(np.float32)
    w_syn = (proto * eq).astype(np.float32) if low_delay else w_ana
    return w_ana, w_syn


@functools.lru_cache(maxsize=None)
def device_consts(hop: int, low_delay: bool,
                  device: torch.device) -> dict[str, torch.Tensor]:
    """The windows (``w_ana``, ``w_syn``: (10·hop,)), the real-DFT
    matrices of length 2·hop (``C``, ``S``: (2·hop, hop+1); ``A``, ``B``:
    (hop+1, 2·hop)), the low-delay odd-bin ``sign`` (hop+1,) and the
    hybrid stage's band-pair sign ``pair_sign`` [-1, 1, -1, 1], as
    contiguous float32 tensors on ``device``.  Made once per
    (hop, mode, device): copying them from the host every block would make
    each block wait for the device to drain."""
    w_ana, w_syn = _windows(hop, low_delay)
    C, S, A, B = _rdft_mats(2 * hop)
    sign = np.where(np.arange(hop + 1) % 2, -1.0, 1.0)
    return {name: f32_tensor(a, device) for name, a in (
        ("w_ana", w_ana), ("w_syn", w_syn), ("C", C), ("S", S), ("A", A),
        ("B", B), ("sign", sign), ("pair_sign", [-1.0, 1.0, -1.0, 1.0]))}


class AfSTFTState(NamedTuple):
    in_tail: torch.Tensor   # (n_ch_in, 9*hop) analysis ring-buffer tail
    hyb_tail: torch.Tensor  # (n_ch_in, 6, hop+1) complex hybrid history
    ola_tail: torch.Tensor  # (n_ch_out, 9*hop) synthesis overlap-add tail


def state_from_numpy(in_tail, hyb_tail_re, hyb_tail_im, ola_tail,
                     device: torch.device | str | None = None) -> AfSTFTState:
    """The complex filterbank's state (e.g. the JAX package's) from numpy
    arrays, its hybrid history as an (re, im) pair."""
    return AfSTFTState(
        in_tail=f32_tensor(in_tail, device),
        hyb_tail=torch.complex(f32_tensor(hyb_tail_re, device),
                               f32_tensor(hyb_tail_im, device)),
        ola_tail=f32_tensor(ola_tail, device))


@dataclass(frozen=True)
class AfSTFT:
    """Static configuration (the analogue of afSTFT_create's arguments)."""

    hop: int = 128
    hybrid: bool = True
    low_delay: bool = False

    @property
    def n_bands(self) -> int:
        return self.hop + (5 if self.hybrid else 1)

    @property
    def proc_delay(self) -> int:
        """Latency in samples (afSTFTlib.c:167-169)."""
        if self.low_delay:
            return (7 if self.hybrid else 4) * self.hop
        return (12 if self.hybrid else 9) * self.hop

    @property
    def h_len(self) -> int:
        return _TOTAL_HOPS * self.hop

    def centre_freqs(self, fs: float) -> np.ndarray:
        """Band centre frequencies (afSTFTlib.c:545-590)."""
        uni = np.arange(self.hop + 1, dtype=np.float64) * fs / (2.0 * self.hop)
        if not self.hybrid:
            return uni.astype(np.float32)
        # First 5 uniform bins map to 9 hybrid bands (afSTFTlib.c:96-107).
        stft2hyb = np.array(
            [1.0, 0.7501, 1.2499, 0.8751, 1.1249, 0.9167, 1.0833, 0.9375, 1.0625]
        )
        src = np.array([0, 1, 1, 2, 2, 3, 3, 4, 4])
        return np.concatenate([stft2hyb * uni[src], uni[5:]]).astype(np.float32)

    def init_state(self, n_ch_in: int, n_ch_out: int,
                   device: torch.device | str | None = None) -> AfSTFTState:
        device = default_device() if device is None else device
        hop, h_len = self.hop, self.h_len
        return AfSTFTState(
            in_tail=torch.zeros((n_ch_in, h_len - hop), dtype=torch.float32,
                                device=device),
            hyb_tail=torch.zeros((n_ch_in, 6, hop + 1),
                                 dtype=torch.complex64, device=device),
            ola_tail=torch.zeros((n_ch_out, h_len - hop),
                                 dtype=torch.float32, device=device))

    def analysis(self, state: AfSTFTState, x: torch.Tensor):
        """x: (n_ch, H*hop) → ((n_bands, n_ch, H) complex, state), in the
        reference's BANDS_CH_TIME layout (afSTFTlib.h:84-90)."""
        hop, h_len = self.hop, self.h_len
        n_ch = x.shape[0]
        H = x.shape[1] // hop
        k = device_consts(hop, self.low_delay, x.device)
        buf = torch.cat([state.in_tail, x], dim=-1)
        hops = buf.reshape(n_ch, H + _TOTAL_HOPS - 1, hop)
        seg = torch.stack([hops[:, k:k + H] for k in range(_TOTAL_HOPS)], dim=2)
        frames = seg.reshape(n_ch, H, h_len) * k["w_ana"]
        # fold (time-alias) the windowed segment into a 2*hop frame: hop k of
        # the segment lands at offset (k % 2)*hop (afSTFT_internal.c:266-299)
        folded = frames.reshape(n_ch, H, _TOTAL_HOPS // 2, 2 * hop).sum(dim=2)
        spec = rfft_op(folded, 2 * hop)  # (n_ch, H, hop+1), unnormalised
        new_in_tail = buf[:, H * hop:]
        if not self.hybrid:
            return spec.permute(2, 0, 1), state._replace(in_tail=new_in_tail)
        full = torch.cat([state.hyb_tail, spec], dim=1)  # (n_ch, 6+H, hop+1)
        out = _hybrid_forward(full, H, k["pair_sign"])
        return out.permute(2, 0, 1), state._replace(
            in_tail=new_in_tail, hyb_tail=full[:, H:H + 6])

    def synthesis(self, state: AfSTFTState, Y: torch.Tensor):
        """Y: (n_bands, n_ch, H) complex → ((n_ch, H*hop), state)."""
        hop, h_len = self.hop, self.h_len
        k = device_consts(hop, self.low_delay, Y.device)
        Y = Y.permute(1, 2, 0)  # (n_ch, H, n_bands)
        n_ch, H = Y.shape[:2]
        if self.hybrid:
            Y = _hybrid_inverse(Y)  # (n_ch, H, hop+1)
        if self.low_delay:
            # odd-bin sign flip == circular shift by hop samples
            # (afSTFT_internal.c:364-367)
            Y = Y * k["sign"]
        frame = irfft_op(Y, 2 * hop)  # 1/N-scaled
        # periodic extension × synthesis window; the contribution of hop t
        # spans output hops t..t+9 (afSTFT_internal.c:398-437)
        contrib = frame.repeat(1, 1, _TOTAL_HOPS // 2) * k["w_syn"]
        contrib = contrib.reshape(n_ch, H, _TOTAL_HOPS, hop)
        acc = torch.zeros((n_ch, H + _TOTAL_HOPS - 1, hop), dtype=frame.dtype,
                          device=frame.device)
        for k in range(_TOTAL_HOPS):
            acc[:, k:k + H] += contrib[:, :, k]
        flat = acc.reshape(n_ch, (H + _TOTAL_HOPS - 1) * hop)
        flat[:, :h_len - hop] += state.ola_tail
        return flat[:, :H * hop], state._replace(ola_tail=flat[:, H * hop:])


def _hybrid_forward(full: torch.Tensor, H: int,
                    s: torch.Tensor) -> torch.Tensor:
    """Split bands 1–4 in two via half-band FIRs along hop-time.

    full: (n_ch, 6+H, hop+1) complex with 6 history frames in front; s:
    the band-pair sign [-1, 1, -1, 1] on full's device (``device_consts``).
    Returns (n_ch, H, hop+5).  afSTFT_internal.c:523-641.
    """
    d3 = full[:, 3:3 + H]  # group-delay-aligned main path (t-3)
    b = slice(1, 5)
    hb = 1j * (_COEFF1 * (full[:, 6:6 + H, b] - full[:, 0:H, b])
               + _COEFF2 * (full[:, 4:4 + H, b] - full[:, 2:2 + H, b]))
    c = 0.5 * d3[..., b]
    # the half-band order flips between odd/even source bands so hybrid
    # bands come out in ascending spectral order (afSTFT_internal.c:611-631)
    lo = c + s * hb
    hi = c - s * hb
    pairs = torch.stack([lo, hi], dim=-1).reshape(*lo.shape[:-1], 8)
    return torch.cat([d3[..., :1], pairs, d3[..., 5:]], dim=-1)


def _hybrid_inverse(Y: torch.Tensor) -> torch.Tensor:
    """Merge hybrid band pairs back to uniform bands (afSTFT_internal.c:644-673).

    Y: (..., hop+5) → (..., hop+1).
    """
    pairs = Y[..., 1:9].reshape(*Y.shape[:-1], 4, 2).sum(-1)
    return torch.cat([Y[..., :1], pairs, Y[..., 9:]], dim=-1)


def analyse(sig: np.ndarray, hop: int, low_delay: bool = False,
            hybrid: bool = True) -> np.ndarray:
    """One-shot analysis from zero state (``afAnalyse``, afSTFTlib.c:110-157).

    sig: (n_ch, n_samples) → (n_bands, n_ch, n_slots) complex64,
    n_slots = ceil(n/hop).  Design-time: runs on the CPU in float32.
    """
    cfg = AfSTFT(hop=hop, hybrid=hybrid, low_delay=low_delay)
    n_ch, n = sig.shape
    n_slots = int(np.ceil(n / hop))
    buf = np.zeros((n_ch, n_slots * hop), np.float32)
    buf[:, :n] = sig
    st = cfg.init_state(n_ch, 1, device="cpu")
    out, _ = cfg.analysis(st, torch.from_numpy(buf))
    return out.numpy()


def fir_to_filterbank_coeffs(h_ir: np.ndarray, hop: int, low_delay: bool = False,
                             hybrid: bool = True) -> np.ndarray:
    """FIR filters → per-band complex filterbank coefficients.

    Equivalent of ``afSTFT_FIRtoFilterbankCoeffs`` (afSTFTlib.c:592-675):
    analyse each FIR and a centred unit impulse through the filterbank; the
    per-band coefficient has magnitude sqrt(E_fir/E_impulse) and the phase of
    the cross-correlation between the two subband responses.

    h_ir: (n_dirs, n_ch, ir_len) → (n_bands, n_ch, n_dirs) complex64.
    """
    n_dirs, n_ch, ir_len = h_ir.shape
    ir_pad = 1024
    T = max(ir_len, hop) + ir_pad

    # mean (over channels) peak delay of direction 0, +1.5 (afSTFTlib.c:618-634)
    idx_del = int(np.mean(np.argmax(h_ir[0], axis=-1)) + 1.5)
    center = np.zeros((1, T), np.float32)
    center[0, idx_del] = 1.0
    D = analyse(center, hop, low_delay, hybrid)[:, 0]  # (n_bands, n_slots)
    d_energy = np.maximum((np.abs(D) ** 2).sum(-1), 2.23e-8)

    sig = np.zeros((n_dirs * n_ch, T), np.float32)
    sig[:, :ir_len] = h_ir.reshape(n_dirs * n_ch, ir_len)
    X = analyse(sig, hop, low_delay, hybrid)  # (n_bands, n_dirs*n_ch, n_slots)

    gain = np.sqrt((np.abs(X) ** 2).sum(-1) / d_energy[:, None])
    cross = np.einsum("bct,bt->bc", X, D.conj())
    g = gain * np.exp(1j * np.angle(cross))
    return (g.reshape(-1, n_dirs, n_ch).transpose(0, 2, 1)).astype(np.complex64)
