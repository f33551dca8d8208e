"""Complex hybrid QMF filterbank (counterpart of
``spatial_audio_framework_tpu/ops/qmf.py`` and of ``saf_utility_qmf``).

Complex-modulated K-band filterbank with a 10·hop prototype, plus an
optional hybrid stage that subdivides the 3 lowest bands (8/4/4 subbands →
K+7 hybrid bands; saf_utility_qmf.c:149-313,314-436,437-560).

Pure block-batched functions with an explicit state, as ``ops/afstft``:
the per-hop modulation is a dense (2·hop × K) product — the input is real,
so it is two real matrix products (TF32 off, :func:`fp32_matmul`) — and
the hybrid stage a 13-tap FIR along hop-time.  No kernel: the JAX package
runs this module in XLA too.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import (data_path, default_device,
                                               f32_tensor)
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul

QMF_MAX_HOP = 128
HYB_LEN = 13       # QMF_HYBRID_FILTER_LENGTH
N_SUBDIV = 3       # QMF_NBANDS_2_SUBDIVIDE
_HYB_DELAY = (HYB_LEN - 1) // 2  # 6 hops


@functools.lru_cache(maxsize=None)
def _tables():
    with np.load(data_path("qmf_proto.npz")) as z:
        return {k: z[k].copy() for k in z.keys()}


@functools.lru_cache(maxsize=None)
def _design(hop: int):
    """Prototype window, analysis/synthesis modulators, hybrid FIRs
    (numpy)."""
    t = _tables()
    K, N = hop, 2 * hop
    if hop <= QMF_MAX_HOP:
        h_p = t["proto"][:: QMF_MAX_HOP // hop][: 10 * hop]
    else:
        from spatial_audio_framework_tpu_torch.ops.afstft import (
            _EQ_NORMAL, _load_proto)

        ds = 1024 // hop
        h_p = _load_proto()["normal"][::ds] * _EQ_NORMAL
    k = np.pi / 2.0 / K * (np.arange(K) + 0.5)
    n_a = 2.0 * np.arange(N) - 2.0 * K / QMF_MAX_HOP
    H_a = (QMF_MAX_HOP / (2.0 * hop)) * np.exp(1j * np.outer(k, n_a))  # (K, N)
    n_s = 2.0 * np.arange(N) - (2.0 * QMF_MAX_HOP - 1.0) * K / (QMF_MAX_HOP / 2.0)
    Hs = (2.0 / QMF_MAX_HOP) * np.exp(1j * np.outer(n_s, k))  # (N, K)
    # hybrid FIRs (saf_utility_qmf.c:236-253)
    j = np.arange(HYB_LEN)
    fb8 = (t["fb8"][None, :]
           * np.exp(-1j * np.pi * (j - (HYB_LEN - 1) / 2.0)[None, :] / 8.0
                    * (1.0 + 2.0 * np.arange(8))[:, None]))  # (8, 13)
    fb4 = (t["fb4"][None, :]
           * np.cos(2.0 * np.pi * np.arange(2)[:, None]
                    * (j - (HYB_LEN - 1) / 2.0)[None, :] / 2.0))  # (2, 13)
    H_a = H_a.astype(np.complex64)
    return {"h_p": h_p.astype(np.float32),
            "H_a_re": H_a.real, "H_a_im": H_a.imag,
            "Hs_re": Hs.real.astype(np.float32),
            "Hs_im": Hs.imag.astype(np.float32),
            "fb8": fb8.astype(np.complex64), "fb4": fb4.astype(np.complex64)}


@functools.lru_cache(maxsize=None)
def _consts(hop: int, device: torch.device) -> dict:
    """:func:`_design`'s arrays on ``device``, made once per device."""
    return {k: (torch.tensor(v, device=device) if np.iscomplexobj(v)
                else f32_tensor(v, device))
            for k, v in _design(hop).items()}


class QMFState(NamedTuple):
    in_tail: torch.Tensor     # (n_ch, 9*hop) most-recent input samples
    hyb_tail: torch.Tensor    # (n_ch, 12, 3) past low-band frames
    delay_tail: torch.Tensor  # (n_ch, 6, K-3) past high-band frames
    syn_tail: torch.Tensor    # (n_ch, 9, 2*hop) past synthesis frames


@dataclass(frozen=True)
class QMF:
    hop: int = 128
    hybrid: bool = True

    @property
    def n_bands(self) -> int:
        return self.hop + (7 if self.hybrid else 0)

    @property
    def proc_delay(self) -> int:
        """saf_utility_qmf.c:259-263."""
        return self.hop * 15 + 1 if self.hybrid else self.hop * 9 + 1

    def centre_freqs(self, fs: float) -> np.ndarray:
        """saf_utility_qmf.c ``qmf_getCentreFreqs``: uniform K bands at
        (k+0.5)·fs/(2K); hybrid maps the first 3 via __qmf2hybCentreFreq."""
        K = self.hop
        uni = (np.arange(K) + 0.5) * fs / (2.0 * K)
        if not self.hybrid:
            return uni.astype(np.float32)
        scale = np.array([0.1013, 0.2027, 0.4054, 0.8108, 1.2533, 1.7227,
                          0.9039, 1.1228, 0.9424, 1.0672])
        src = np.array([0, 0, 0, 0, 0, 0, 1, 1, 2, 2])
        return np.concatenate([scale * uni[src], uni[3:]]).astype(np.float32)

    def init_state(self, n_ch_in: int, n_ch_out: int,
                   device: torch.device | str | None = None) -> QMFState:
        """Zero state on ``device`` (default: the card)."""
        device = default_device() if device is None else device
        hop = self.hop
        z = functools.partial(torch.zeros, device=device)
        return QMFState(
            in_tail=z((n_ch_in, 9 * hop), dtype=torch.float32),
            hyb_tail=z((n_ch_in, HYB_LEN - 1, N_SUBDIV),
                       dtype=torch.complex64),
            delay_tail=z((n_ch_in, _HYB_DELAY, hop - N_SUBDIV),
                         dtype=torch.complex64),
            syn_tail=z((n_ch_out, 9, 2 * hop), dtype=torch.float32))

    def state_from_numpy(self, state, device: torch.device | str | None = None
                         ) -> QMFState:
        """A state (e.g. the JAX package's QMFState, as numpy arrays) on
        ``device`` (default: the card)."""
        device = default_device() if device is None else device
        return QMFState(*(torch.tensor(np.asarray(a), device=device)
                          for a in state))

    # -- analysis ------------------------------------------------------------
    def analysis(self, state: QMFState, x: torch.Tensor):
        """x: (n_ch, H*hop) → ((n_bands, n_ch, H) complex, state)."""
        hop = self.hop
        dz = _consts(hop, x.device)
        n_ch = x.shape[0]
        H = x.shape[1] // hop
        buf = torch.cat([state.in_tail, x], dim=-1)
        hops = buf.reshape(n_ch, H + 9, hop)
        seg = torch.stack([hops[:, k: k + H] for k in range(10)], dim=2)
        seg = seg.reshape(n_ch, H, 10 * hop)
        # reversed buffer ordering (qmf_analysis copies the hop with
        # stride -1)
        win = seg.flip(-1) * dz["h_p"]
        ws = win.reshape(n_ch, H, 5, 2 * hop).sum(dim=2)  # (n_ch, H, 2*hop)
        with fp32_matmul():
            B = torch.complex(ws @ dz["H_a_re"].T,
                              ws @ dz["H_a_im"].T)  # (n_ch, H, K)
        new_in_tail = buf[:, H * hop:]
        if not self.hybrid:
            return B.permute(2, 0, 1), state._replace(in_tail=new_in_tail)

        low = B[..., :N_SUBDIV]  # (n_ch, H, 3)
        full = torch.cat([state.hyb_tail, low], dim=1)  # (n_ch, 12+H, 3)
        # 13-tap FIR along hop-time: out[t] = Σ_j c[j]·full[t+j]
        win13 = torch.stack([full[:, j: j + H] for j in range(HYB_LEN)],
                            dim=2)  # (n_ch, H, 13, 3)
        with fp32_matmul():
            s8 = torch.einsum("ij,chj->chi", dz["fb8"], win13[..., 0])
            s4b = torch.einsum("ij,chj->chi", dz["fb4"], win13[..., 1])
            s4c = torch.einsum("ij,chj->chi", dz["fb4"], win13[..., 2])
        hyb_low = torch.stack([
            s8[..., 6], s8[..., 7], s8[..., 0], s8[..., 1],
            s8[..., 2] + s8[..., 5], s8[..., 3] + s8[..., 4],
            s4b[..., 1], s4b[..., 0],          # "Flipped!" (qmf_analysis)
            s4c[..., 0], s4c[..., 1]], dim=-1)  # (n_ch, H, 10)
        # remaining bands delayed by 6 hops
        full_rest = torch.cat([state.delay_tail, B[..., N_SUBDIV:]], dim=1)
        out = torch.cat([hyb_low, full_rest[:, :H]], dim=-1)  # (n_ch, H, K+7)
        return out.permute(2, 0, 1), state._replace(
            in_tail=new_in_tail, hyb_tail=full[:, H: H + HYB_LEN - 1],
            delay_tail=full_rest[:, H: H + _HYB_DELAY])

    # -- synthesis -----------------------------------------------------------
    def synthesis(self, state: QMFState, Y: torch.Tensor):
        """Y: (n_bands, n_ch, H) complex → ((n_ch, H*hop), state)."""
        hop = self.hop
        dz = _consts(hop, Y.device)
        Y = Y.permute(1, 2, 0)  # (n_ch, H, n_bands)
        n_ch, H = Y.shape[:2]
        if self.hybrid:
            low = torch.stack([Y[..., 0:6].sum(-1), Y[..., 6] + Y[..., 7],
                               Y[..., 8] + Y[..., 9]], dim=-1)
            Y = torch.cat([low, Y[..., 10:]], dim=-1)  # (n_ch, H, K)
        with fp32_matmul():
            v = (Y.real @ dz["Hs_re"].T
                 - Y.imag @ dz["Hs_im"].T)  # (n_ch, H, 2*hop)
        full = torch.cat([state.syn_tail, v], dim=1)  # (n_ch, 9+H, 2*hop)
        # out_t[i] = Σ_m h_p[m·hop+i] · v_{t-m}[(m%2)·hop + i]
        hp = dz["h_p"].reshape(10, hop)
        out = 0
        for m in range(10):
            sl = full[:, 9 - m: 9 - m + H, (m % 2) * hop:(m % 2) * hop + hop]
            out = out + sl * hp[m]
        return (out.reshape(n_ch, H * hop),
                state._replace(syn_tail=full[:, H: H + 9]))


def qmf_fir_to_filterbank_coeffs(h_ir: np.ndarray, hop: int,
                                 hybrid: bool = True) -> np.ndarray:
    """FIR → QMF-domain coefficients (saf_utility_qmf.c
    ``qmf_FIRtoFilterbankCoeffs``); same energy/phase fit as the afSTFT
    variant, computed on the host.  h_ir: (n_dirs, n_ch, len) →
    (n_bands, n_ch, n_dirs)."""
    cfg = QMF(hop=hop, hybrid=hybrid)
    n_dirs, n_ch, ir_len = h_ir.shape
    T = max(ir_len, hop) + 1024

    def analyse(sig):
        n = sig.shape[0]
        n_slots = -(-sig.shape[1] // hop)
        buf = np.zeros((n, n_slots * hop), np.float32)
        buf[:, : sig.shape[1]] = sig
        out, _ = cfg.analysis(cfg.init_state(n, 1, device="cpu"),
                              torch.from_numpy(buf))
        return out.numpy()

    idx_del = int(np.mean(np.argmax(h_ir[0], axis=-1)) + 1.5)
    center = np.zeros((1, T), np.float32)
    center[0, idx_del] = 1.0
    D = analyse(center)[:, 0]
    d_energy = np.maximum((np.abs(D) ** 2).sum(-1), 2.23e-8)
    sig = np.zeros((n_dirs * n_ch, T), np.float32)
    sig[:, :ir_len] = h_ir.reshape(n_dirs * n_ch, ir_len)
    X = analyse(sig)
    gain = np.sqrt((np.abs(X) ** 2).sum(-1) / d_energy[:, None])
    cross = np.einsum("bct,bt->bc", X, D.conj())
    g = gain * np.exp(1j * np.angle(cross))
    return (g.reshape(-1, n_dirs, n_ch).transpose(0, 2, 1)).astype(np.complex64)
