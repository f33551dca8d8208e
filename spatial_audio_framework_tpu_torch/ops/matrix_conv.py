"""FFT-domain convolution engines (counterpart of
``spatial_audio_framework_tpu/ops/matrix_conv.py``;
``saf_utility_matrixConv``).

* ``MatrixConv`` — nCHout×nCHin filter matrix, uniformly partitioned
  (default) or non-partitioned overlap-add (saf_utility_matrixConv.c:50-235).
* ``MultiConv`` — one filter per channel (saf_utility_matrixConv.c:237-437).
* ``TVConv`` — time-varying partitioned convolution with a linear crossfade
  between filter sets on a position change (saf_utility_matrixConv.c:
  439-660).

Filters are partitioned and transformed at design time; a block of H hops
runs at once: every hop's spectrum by one ``torch.fft.rfft`` of the padded
2·hop frame, the spectral multiply-accumulate over (partitions × inputs) as
one product batched over bins (:func:`_mac`), one ``irfft`` and the
overlap-add as shifts.  The JAX package's two MAC cores (a sliding-window
einsum below 8 instances, a grouped 1-D convolution above) compute the same
sums; this is the one form here.  Its matmul DFT exists for the TPU only.

Two forms, as in the JAX package: complex spectra (``design`` /
``init_state`` / ``apply_block``), and spectra packed as float32 [re | im]
with the filters as an (re, im) pair (``design_ri`` / ``init_state_ri`` /
``apply_block_ri``).  Both run the same complex core.

TVConv never branches on the device: the crossfade convolutions are
computed for every block and selected with ``torch.where`` (the JAX package
skips them with ``lax.cond`` on a device predicate; a Python ``if`` on it
would make the host wait every block).  Filter rows are gathered with
``index_select``.  States and designs from the JAX package (numpy) come
across through :func:`state_from_numpy`, :func:`tv_state_from_numpy` and
:func:`design_from_numpy`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import default_device, f32_tensor
from spatial_audio_framework_tpu_torch.ops.fft import irfft_op, rfft_op
from spatial_audio_framework_tpu_torch.ops.herm_ri import split as _ri
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def partition_filters(H: np.ndarray, hop: int) -> np.ndarray:
    """(..., length_h) filters → (..., P, hop+1) partition spectra, where
    P = ceil(length_h / hop); each hop-length segment is zero-padded to
    2·hop and rFFT'd (saf_utility_matrixConv.c:100-130)."""
    length_h = H.shape[-1]
    P = _cdiv(length_h, hop)
    pad = np.zeros(H.shape[:-1] + (P * hop,), np.float32)
    pad[..., :length_h] = H
    seg = pad.reshape(H.shape[:-1] + (P, hop))
    seg = np.concatenate([seg, np.zeros_like(seg)], axis=-1)  # zero-pad to 2*hop
    return np.fft.rfft(seg, axis=-1).astype(np.complex64)


def _dev(device):
    return default_device() if device is None else device


def _complex(a: np.ndarray, device) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a, np.complex64),
                        device=_dev(device))


def design_from_numpy(Hf, device: torch.device | str | None = None):
    """A design (e.g. the JAX package's) from numpy: a complex array → the
    complex tensor of ``design``; an (re, im) pair → the float32 pair of
    ``design_ri``."""
    if isinstance(Hf, (tuple, list)):
        return f32_tensor(Hf[0], device), f32_tensor(Hf[1], device)
    return _complex(np.asarray(Hf), device)


def _pack(S: torch.Tensor) -> torch.Tensor:
    """complex (..., nb) → float32 (..., 2·nb) [re | im]."""
    return torch.cat([S.real, S.imag], dim=-1)


def _unpack(S: torch.Tensor) -> torch.Tensor:
    nb = S.shape[-1] // 2
    return torch.complex(S[..., :nb], S[..., nb:])


def _hop_spectra(x: torch.Tensor, hop: int) -> torch.Tensor:
    """x: (..., nh·hop) → (..., nh, hop+1) complex spectra of each hop
    zero-padded to 2·hop."""
    return rfft_op(x.reshape(x.shape[:-1] + (-1, hop)), 2 * hop)


def _windows(full: torch.Tensor, P: int, nh: int, axis: int) -> torch.Tensor:
    """win[t, k] = full[P-1-k+t] along ``axis`` (negative: the hop axis of
    ``full``, nh+P-1 long): the spectrum of hop t-k, stacked as a new axis
    after the hop axis."""
    return torch.stack([full.narrow(axis, P - 1 - k, nh) for k in range(P)],
                       dim=axis)


def _mac(win: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """The spectral multiply-accumulate Y[..., t, o, b] = Σ_p Σ_i
    win[..., t, p, i, b]·H[p, o, i, b] as one complex product batched over
    the bins: (nb, rows, P·i) @ (nb, P·i, o).  win: (..., nh, P, i, nb);
    H: (P, o, i, nb) → (..., nh, o, nb)."""
    P, n_out, n_in, nb = H.shape
    lead = win.shape[:-3]
    A = win.reshape(-1, P * n_in, nb).permute(2, 0, 1)     # (nb, rows, P·i)
    Hb = H.permute(3, 0, 2, 1).reshape(nb, P * n_in, n_out)
    with fp32_matmul():
        Y = torch.bmm(A, Hb)                                # (nb, rows, o)
    return Y.permute(1, 2, 0).reshape(lead + (n_out, nb))


def _ola_heads_tails(z: torch.Tensor, ola: torch.Tensor, hop: int,
                     axis: int):
    """Partitioned overlap-add: z (..., nh along ``axis``, ..., 2·hop) →
    (heads + previous tails, last tail), the previous tail of hop 0 being
    ``ola``."""
    heads, tails = z[..., :hop], z[..., hop:]
    nh = z.shape[axis]
    prev = torch.cat([ola.unsqueeze(axis), tails.narrow(axis, 0, nh - 1)],
                     dim=axis)
    return heads + prev, tails.select(axis, nh - 1)


def _partitioned(mac, P: int, hop: int, X_hist: torch.Tensor,
                 ola: torch.Tensor, x: torch.Tensor):
    """The partitioned block on complex spectra, shared by MatrixConv and
    MultiConv: x (..., n_in, T) → (out (..., n_out, T), new X_hist, new
    ola); ``mac(win)`` maps the (..., nh, P, n_in, nb) windows to the
    (..., nh, n_out, nb) output spectra."""
    T = x.shape[-1]
    nh = T // hop
    S = _hop_spectra(x, hop).movedim(-2, -3)              # (..., nh, i, nb)
    full = torch.cat([X_hist, S], dim=-3)                 # (..., P-1+nh, ...)
    z = irfft_op(mac(_windows(full, P, nh, -3)), 2 * hop)  # (..., nh, o, 2hop)
    out, tail = _ola_heads_tails(z, ola, hop, -3)
    return (out.movedim(-3, -2).reshape(x.shape[:-2] + (z.shape[-2], T)),
            full[..., nh:, :, :], tail)


def _ola_shift_add(z: torch.Tensor, ola: torch.Tensor, hop: int):
    """The non-partitioned overlap-add over a block, without a loop over
    hops: hop t's nfft-long output z[..., t, c, :] lands on hops t..t+nblk-1
    of a shift register that starts as ``ola``; each step emits its first
    hop.  z: (..., nh, c, nfft), ola: (..., c, nfft) → (out (..., c,
    nh·hop), the register after the block)."""
    nh, nfft = z.shape[-3], z.shape[-1]
    nblk = nfft // hop
    lead, c = z.shape[:-3], z.shape[-2]
    acc = z.new_zeros(lead + (c, nh + nblk, hop))
    zs = z.reshape(lead + (nh, c, nblk, hop)).movedim(-4, -2)  # (..., c, nblk, nh, hop)
    for k in range(nblk):
        acc[..., k:k + nh, :] += zs[..., k, :, :]
    # the register's hops 1.. are emitted at steps 0.. (hop 0 left already)
    acc[..., :nblk - 1, :] += ola.reshape(lead + (c, nblk, hop))[..., 1:, :]
    out = acc[..., :nh, :].reshape(lead + (c, nh * hop))
    return out, acc[..., nh - 1:nh - 1 + nblk, :].reshape(lead + (c, nfft))


# ---------------------------------------------------------------------------
# MatrixConv
# ---------------------------------------------------------------------------

class MatrixConvState(NamedTuple):
    X_hist: torch.Tensor  # (..., P-1, n_in, bins) past input spectra (oldest first)
    ola: torch.Tensor     # overlap tail


def state_from_numpy(X_hist, ola, device: torch.device | str | None = None
                     ) -> MatrixConvState:
    """A MatrixConv / MultiConv state (e.g. the JAX package's) from numpy:
    a complex ``X_hist`` for the complex form, a real (packed) one for the
    (re, im) form."""
    X_hist = np.asarray(X_hist)
    X = (_complex(X_hist, device) if np.iscomplexobj(X_hist)
         else f32_tensor(X_hist, device))
    return MatrixConvState(X_hist=X, ola=f32_tensor(ola, device))


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=_dev(device))


@dataclass(frozen=True)
class MatrixConv:
    hop: int
    length_h: int
    n_in: int
    n_out: int
    partitioned: bool = True

    @property
    def n_part(self) -> int:
        return _cdiv(self.length_h, self.hop)

    @property
    def fft_size(self) -> int:
        if self.partitioned:
            return 2 * self.hop
        return _cdiv(self.hop + self.length_h - 1, self.hop) * self.hop

    def design(self, H: np.ndarray,
               device: torch.device | str | None = None) -> torch.Tensor:
        """H: (n_out, n_in, length_h).  → partitioned: (P, n_out, n_in,
        hop+1) complex64; non-partitioned: (n_out, n_in, nBins)."""
        assert H.shape == (self.n_out, self.n_in, self.length_h)
        if self.partitioned:
            Hp = partition_filters(H, self.hop)  # (n_out, n_in, P, hop+1)
            return _complex(Hp.transpose(2, 0, 1, 3), device)
        return _complex(np.fft.rfft(H, n=self.fft_size, axis=-1), device)

    def init_state(self, batch: tuple = (),
                   device: torch.device | str | None = None
                   ) -> MatrixConvState:
        if self.partitioned:
            X = _zeros(batch + (self.n_part - 1, self.n_in, self.hop + 1),
                       torch.complex64, device)
            ola = _zeros(batch + (self.n_out, self.hop), torch.float32, device)
        else:
            X = _zeros(batch + (0, self.n_in, self.fft_size // 2 + 1),
                       torch.complex64, device)
            ola = _zeros(batch + (self.n_out, self.fft_size), torch.float32,
                         device)
        return MatrixConvState(X_hist=X, ola=ola)

    def _partitioned(self, Hf, X_hist, ola, x):
        return _partitioned(lambda win: _mac(win, Hf), self.n_part, self.hop,
                            X_hist, ola, x)

    def apply_block(self, Hf: torch.Tensor, state: MatrixConvState,
                    x: torch.Tensor):
        """x: (..., n_in, T), T = H·hop → ((..., n_out, T), state).  All
        hops of the block at once."""
        if self.partitioned:
            out, X, ola = self._partitioned(Hf, state.X_hist, state.ola, x)
            return out, MatrixConvState(X_hist=X, ola=ola)
        # non-partitioned: every hop's nfft-point product at once, then the
        # overlap-add's shift register as shifts (the JAX package's scan)
        nfft = self.fft_size
        xh = x.reshape(x.shape[:-1] + (-1, self.hop)).movedim(-2, -3)
        X = rfft_op(xh, nfft)                             # (..., nh, i, nb)
        with fp32_matmul():
            Y = torch.einsum("oib,...ib->...ob", Hf, X)
        z = irfft_op(Y, nfft)                             # (..., nh, o, nfft)
        out, ola = _ola_shift_add(z, state.ola, self.hop)
        return out, MatrixConvState(X_hist=state.X_hist, ola=ola)

    # -- split real/imaginary form (partitioned mode only) -------------------

    def design_ri(self, H: np.ndarray,
                  device: torch.device | str | None = None):
        """H: (n_out, n_in, length_h) → (Hre, Him) each (P, n_out, n_in,
        hop+1) float32."""
        assert self.partitioned, "RI path implements the partitioned mode"
        assert H.shape == (self.n_out, self.n_in, self.length_h)
        return _ri(partition_filters(H, self.hop).transpose(2, 0, 1, 3),
                   device)

    def init_state_ri(self, batch: tuple = (),
                      device: torch.device | str | None = None
                      ) -> MatrixConvState:
        assert self.partitioned
        return MatrixConvState(
            X_hist=_zeros(batch + (self.n_part - 1, self.n_in,
                                   2 * (self.hop + 1)), torch.float32, device),
            ola=_zeros(batch + (self.n_out, self.hop), torch.float32, device))

    def apply_block_ri(self, H_ri, state: MatrixConvState, x: torch.Tensor):
        """apply_block on packed [re | im] float32 spectra: H_ri = (Hre,
        Him) from design_ri; X_hist carries (..., P-1, n_in, 2·(hop+1)).
        Batch-tolerant: x (..., n_in, T) with the state from
        init_state_ri(batch=x.shape[:-2])."""
        assert self.partitioned
        out, X, ola = self._partitioned(torch.complex(*H_ri),
                                        _unpack(state.X_hist), state.ola, x)
        return out, MatrixConvState(X_hist=_pack(X), ola=ola)


# ---------------------------------------------------------------------------
# MultiConv — per-channel filters (no matrixing)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MultiConv:
    hop: int
    length_h: int
    n_ch: int
    partitioned: bool = True

    @property
    def n_part(self) -> int:
        return _cdiv(self.length_h, self.hop)

    @property
    def _nfft(self) -> int:
        return _cdiv(self.hop + self.length_h - 1, self.hop) * self.hop

    def design(self, H: np.ndarray,
               device: torch.device | str | None = None) -> torch.Tensor:
        """H: (n_ch, length_h) → (P, n_ch, hop+1) complex64 (partitioned)
        or (n_ch, nBins)."""
        assert H.shape == (self.n_ch, self.length_h)
        if self.partitioned:
            return _complex(partition_filters(H, self.hop).transpose(1, 0, 2),
                            device)
        return _complex(np.fft.rfft(H, n=self._nfft, axis=-1), device)

    def init_state(self, batch: tuple = (),
                   device: torch.device | str | None = None
                   ) -> MatrixConvState:
        if self.partitioned:
            return MatrixConvState(
                X_hist=_zeros(batch + (self.n_part - 1, self.n_ch,
                                       self.hop + 1), torch.complex64, device),
                ola=_zeros(batch + (self.n_ch, self.hop), torch.float32,
                           device))
        return MatrixConvState(
            X_hist=_zeros(batch + (0, self.n_ch, self._nfft // 2 + 1),
                          torch.complex64, device),
            ola=_zeros(batch + (self.n_ch, self._nfft), torch.float32, device))

    def _partitioned(self, Hf, X_hist, ola, x):
        # one filter per channel: the MAC is a product and a sum over P
        return _partitioned(lambda win: (win * Hf).sum(-3), self.n_part,
                            self.hop, X_hist, ola, x)

    def apply_block(self, Hf: torch.Tensor, state: MatrixConvState,
                    x: torch.Tensor):
        """x: (..., n_ch, T) → ((..., n_ch, T), state)."""
        if self.partitioned:
            out, X, ola = self._partitioned(Hf, state.X_hist, state.ola, x)
            return out, MatrixConvState(X_hist=X, ola=ola)
        nfft = state.ola.shape[-1]
        xh = x.reshape(x.shape[:-1] + (-1, self.hop)).movedim(-2, -3)
        z = irfft_op(Hf * rfft_op(xh, nfft), nfft)        # (..., nh, c, nfft)
        out, ola = _ola_shift_add(z, state.ola, self.hop)
        return out, MatrixConvState(X_hist=state.X_hist, ola=ola)

    # -- split real/imaginary form (partitioned mode) ------------------------

    def design_ri(self, H: np.ndarray,
                  device: torch.device | str | None = None):
        assert self.partitioned and H.shape == (self.n_ch, self.length_h)
        return _ri(partition_filters(H, self.hop).transpose(1, 0, 2), device)

    def init_state_ri(self, batch: tuple = (),
                      device: torch.device | str | None = None
                      ) -> MatrixConvState:
        assert self.partitioned
        return MatrixConvState(
            X_hist=_zeros(batch + (self.n_part - 1, self.n_ch,
                                   2 * (self.hop + 1)), torch.float32, device),
            ola=_zeros(batch + (self.n_ch, self.hop), torch.float32, device))

    def apply_block_ri(self, H_ri, state: MatrixConvState, x: torch.Tensor):
        assert self.partitioned
        out, X, ola = self._partitioned(torch.complex(*H_ri),
                                        _unpack(state.X_hist), state.ola, x)
        return out, MatrixConvState(X_hist=_pack(X), ola=ola)


# ---------------------------------------------------------------------------
# TVConv — time-varying partitioned convolution with crossfade
# ---------------------------------------------------------------------------

class TVConvState(NamedTuple):
    X_hist: torch.Tensor     # (..., P-1, bins) past input spectra (oldest first)
    ola: torch.Tensor        # (..., n_out, hop) overlap of current filter set
    ola_last: torch.Tensor   # (..., n_out, hop) overlap of previous filter set
    pos_last: torch.Tensor   # (...,) int32
    pos_last2: torch.Tensor  # (...,) int32


def tv_state_from_numpy(X_hist, ola, ola_last, pos_last, pos_last2,
                        device: torch.device | str | None = None
                        ) -> TVConvState:
    """A TVConv state (e.g. the JAX package's) from numpy: a complex
    ``X_hist`` for the complex form, a real (packed) one for the (re, im)
    form."""
    X_hist = np.asarray(X_hist)
    X = (_complex(X_hist, device) if np.iscomplexobj(X_hist)
         else f32_tensor(X_hist, device))

    def idx(a):
        return torch.tensor(np.asarray(a, np.int32), device=_dev(device))

    return TVConvState(X_hist=X, ola=f32_tensor(ola, device),
                       ola_last=f32_tensor(ola_last, device),
                       pos_last=idx(pos_last), pos_last2=idx(pos_last2))


def _take(H: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """H[idx] for an index tensor of any shape, as one ``index_select``
    (indexing by a device tensor would read it back to the host)."""
    return H.index_select(0, idx.reshape(-1)).reshape(
        idx.shape + H.shape[1:])


@dataclass(frozen=True)
class TVConv:
    """Single input channel → n_out outputs, one filter set per listener
    position, crossfading on a position change
    (saf_utility_matrixConv.c:548)."""
    hop: int
    length_h: int
    n_out: int
    n_irs: int

    @property
    def n_part(self) -> int:
        return _cdiv(self.length_h, self.hop)

    def design(self, H: np.ndarray,
               device: torch.device | str | None = None) -> torch.Tensor:
        """H: (n_irs, n_out, length_h) → (n_irs, P, n_out, hop+1)
        complex64."""
        assert H.shape == (self.n_irs, self.n_out, self.length_h)
        return _complex(partition_filters(H, self.hop).transpose(0, 2, 1, 3),
                        device)

    def _init(self, init_idx, batch, bins, dtype, device) -> TVConvState:
        idx = init_idx if init_idx < self.n_irs else 0
        z = _zeros(batch + (self.n_out, self.hop), torch.float32, device)
        pos = torch.full(batch, idx, dtype=torch.int32, device=_dev(device))
        return TVConvState(
            X_hist=_zeros(batch + (self.n_part - 1, bins), dtype, device),
            ola=z, ola_last=z.clone(), pos_last=pos, pos_last2=pos.clone())

    def init_state(self, init_idx: int = 0, batch: tuple = (),
                   device: torch.device | str | None = None) -> TVConvState:
        return self._init(init_idx, batch, self.hop + 1, torch.complex64,
                          device)

    @staticmethod
    def _fade(hop: int, like: torch.Tensor) -> torch.Tensor:
        n = torch.arange(hop, dtype=torch.float32, device=like.device)
        return n / (hop - 1.0)

    def _hop(self, Hf: torch.Tensor, state: TVConvState, X: torch.Tensor,
             ir_idx: torch.Tensor):
        """One hop on complex spectra: X (..., bins) the hop's spectrum."""
        hop = self.hop
        full = torch.cat([state.X_hist, X.unsqueeze(-2)], dim=-2)  # (..., P, nb)
        win = full.flip(-2)                       # win[k] = spectrum k hops ago
        ir_idx = torch.as_tensor(ir_idx, dtype=torch.int32,
                                 device=X.device).expand(state.pos_last.shape)

        def conv_with(idx):
            Y = (_take(Hf, idx) * win.unsqueeze(-2)).sum(-3)    # (..., o, nb)
            return irfft_op(Y, 2 * hop)                          # (..., o, 2hop)

        z = conv_with(ir_idx)
        z_last = torch.where((ir_idx != state.pos_last)[..., None, None],
                             conv_with(state.pos_last), z)
        z_last2 = torch.where((state.pos_last != state.pos_last2)[..., None,
                                                                   None],
                              conv_with(state.pos_last2), z_last)
        fade_in = self._fade(hop, X)
        out = ((z_last[..., :hop] + state.ola) * fade_in
               + (z_last2[..., :hop] + state.ola_last) * (1.0 - fade_in))
        return out, TVConvState(X_hist=full[..., 1:, :], ola=z[..., hop:],
                                ola_last=z_last[..., hop:],
                                pos_last=ir_idx.to(torch.int32),
                                pos_last2=state.pos_last)

    def apply_hop(self, Hf: torch.Tensor, state: TVConvState,
                  x: torch.Tensor, ir_idx: torch.Tensor):
        """One hop (saf_TVConv_apply).  x: (..., hop); ir_idx: int32 tensor
        of the state's batch shape → ((..., n_out, hop), state)."""
        return self._hop(Hf, state, rfft_op(x, 2 * self.hop), ir_idx)

    @staticmethod
    def _idx_streams(state: TVConvState, ir_idx: torch.Tensor):
        """The crossfade's index recurrences as shifts of the per-hop index
        stream: ir_idx (..., nh), pos_last* (...,)."""
        idx0 = ir_idx.to(torch.int32)
        idx1 = torch.cat([state.pos_last[..., None], idx0[..., :-1]], dim=-1)
        idx2 = torch.cat([state.pos_last2[..., None], idx1[..., :-1]], dim=-1)
        return idx0, idx1, idx2

    def _block(self, Hf: torch.Tensor, state: TVConvState,
               S: torch.Tensor, ir_idx: torch.Tensor):
        """The per-hop-index block on complex spectra S (..., nh, nb) →
        (out (..., n_out, nh·hop), new X_hist, the state's tail).  The
        crossfade rows are computed for every block (two more whole-block
        convolutions) and selected per hop with ``torch.where``."""
        hop, P = self.hop, self.n_part
        nh = S.shape[-2]
        full = torch.cat([state.X_hist, S], dim=-2)
        win = _windows(full, P, nh, -2)                  # (..., nh, P, nb)
        idx0, idx1, idx2 = self._idx_streams(state, ir_idx)

        def conv_all(idx):
            # (..., n_out, nh, 2hop): the o-major layout needs no transpose
            # for the final (n_out, T) reshape
            with fp32_matmul():
                Y = torch.einsum("...tpob,...tpb->...otb", _take(Hf, idx),
                                 win)
            return irfft_op(Y, 2 * hop)

        z0 = conv_all(idx0)
        z_last = torch.where((idx0 != idx1)[..., None, :, None],
                             conv_all(idx1), z0)
        z_last2 = torch.where((idx1 != idx2)[..., None, :, None],
                              conv_all(idx2), z_last)
        out = self._xfade(state, z0, z_last, z_last2)
        return (out.reshape(S.shape[:-2] + (self.n_out, nh * hop)),
                full[..., nh:, :],
                dict(ola=z0[..., -1, hop:], ola_last=z_last[..., -1, hop:],
                     pos_last=idx0[..., -1], pos_last2=idx1[..., -1]))

    def _xfade(self, state, z0, z_last, z_last2):
        """Overlap-add of the current and previous filter sets' streams
        (o-major (..., n_out, nh, 2hop)) and the linear crossfade."""
        hop = self.hop
        out1, _ = _ola_heads_tails(
            torch.cat([z_last[..., :hop], z0[..., hop:]], dim=-1),
            state.ola, hop, -2)
        out2, _ = _ola_heads_tails(
            torch.cat([z_last2[..., :hop], z_last[..., hop:]], dim=-1),
            state.ola_last, hop, -2)
        fade_in = self._fade(hop, z0)
        return out1 * fade_in + out2 * (1.0 - fade_in)

    def apply_block(self, Hf: torch.Tensor, state: TVConvState,
                    x: torch.Tensor, ir_idx: torch.Tensor):
        """x: (..., T) with one position index per hop: ir_idx (..., nh)
        int32; state from init_state(batch=x.shape[:-1]).  All hop spectra
        at once; the sequential pos_last / ola carries are shifts of the
        block's streams.  Leading axes run independent instances."""
        out, X, tail = self._block(Hf, state, _hop_spectra(x, self.hop),
                                   ir_idx)
        return out, TVConvState(X_hist=X, **tail)

    # -- split real/imaginary form -------------------------------------------

    def design_ri(self, H: np.ndarray,
                  device: torch.device | str | None = None):
        assert H.shape == (self.n_irs, self.n_out, self.length_h)
        return _ri(partition_filters(H, self.hop).transpose(0, 2, 1, 3),
                   device)

    def init_state_ri(self, init_idx: int = 0, batch: tuple = (),
                      device: torch.device | str | None = None
                      ) -> TVConvState:
        return self._init(init_idx, batch, 2 * (self.hop + 1), torch.float32,
                          device)

    def apply_hop_ri(self, H_ri, state: TVConvState, x: torch.Tensor,
                     ir_idx: torch.Tensor):
        """apply_hop on packed [re | im] spectra."""
        out, st = self._hop(torch.complex(*H_ri),
                            state._replace(X_hist=_unpack(state.X_hist)),
                            rfft_op(x, 2 * self.hop), ir_idx)
        return out, st._replace(X_hist=_pack(st.X_hist))

    def apply_block_ri(self, H_ri, state: TVConvState, x: torch.Tensor,
                       ir_idx: torch.Tensor):
        """The block path on packed spectra (see apply_block).  x (..., T),
        ir_idx (..., nh); state from init_state_ri(batch=x.shape[:-1])."""
        out, X, tail = self._block(
            torch.complex(*H_ri), state._replace(X_hist=_unpack(state.X_hist)),
            _hop_spectra(x, self.hop), ir_idx)
        return out, TVConvState(X_hist=_pack(X), **tail)

    def apply_block_ri_const(self, H_ri, state: TVConvState, x: torch.Tensor,
                             ir_idx: torch.Tensor):
        """apply_block_ri when the position is constant across the block:
        one index per call, the tvconv example's contract (the C looks the
        filter up once per process call, tvconv_internal
        ``tvconv_findNearestNeigbour``).  x: (..., T), ir_idx: (...,) int32.

        The values of ``apply_block_ri`` with a broadcast index: the filters
        are gathered once per call, the block convolution is one product,
        and the crossfade streams differ from it only in their first one or
        two hops (where the previous filter sets apply), built by splicing
        single-hop convolutions.  Those rows are computed every block and
        selected by the whole-block change predicate with ``torch.where``;
        the splice is exact when indices coincide too (equal filters give
        equal rows)."""
        hop, P = self.hop, self.n_part
        nh = x.shape[-1] // hop
        bshape = x.shape[:-1]
        idxc = ir_idx.to(torch.int32).expand(bshape)
        if nh < 2:
            return self.apply_block_ri(H_ri, state, x, idxc[..., None])
        Hf = torch.complex(*H_ri)
        full = torch.cat([_unpack(state.X_hist), _hop_spectra(x, hop)], dim=-2)
        win = _windows(full, P, nh, -2)                  # (..., nh, P, nb)

        def conv_with(idx, w):
            with fp32_matmul():
                Y = torch.einsum("...pob,...tpb->...otb", _take(Hf, idx), w)
            return irfft_op(Y, 2 * hop)                  # (..., o, t, 2hop)

        z0 = conv_with(idxc, win)
        r0_last = conv_with(state.pos_last, win[..., :1, :, :])
        r0_last2 = conv_with(state.pos_last2, win[..., :1, :, :])
        r1_last = conv_with(state.pos_last, win[..., 1:2, :, :])
        changed = ((idxc != state.pos_last).any()
                   | (state.pos_last != state.pos_last2).any())
        z_last = torch.where(changed, torch.cat([r0_last, z0[..., 1:, :]],
                                                dim=-2), z0)
        z_last2 = torch.where(changed, torch.cat(
            [r0_last2, r1_last, z0[..., 2:, :]], dim=-2), z0)
        out = self._xfade(state, z0, z_last, z_last2)
        return (out.reshape(bshape + (self.n_out, nh * hop)),
                TVConvState(X_hist=_pack(full[..., nh:, :]),
                            ola=z0[..., -1, hop:],
                            ola_last=z_last[..., -1, hop:],
                            pos_last=idxc.clone(), pos_last2=idxc.clone()))
