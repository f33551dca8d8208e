"""Stream-batched afSTFT in split real/imaginary arithmetic (counterpart of
``spatial_audio_framework_tpu/ops/afstft_ri.py``, batched path).

Numerically the reference's afSTFT (same prototype, hybrid stage and
delays; afSTFT_internal.c:237-673) with every complex tensor carried as an
(re, im) pair of float32 tensors, batched over streams.

* :func:`analysis_ri_batched` / :func:`synthesis_ri_batched` — the batched
  filterbank; with ``use_kernel`` at hop 128 its front and back end run on
  the kernels ``analysis_front_ri`` / ``synthesis_back_ri``
  (``ops/afstft_kernels``), otherwise in plain torch.
* :func:`render_tf_matrix_ri` — the TF-matrix renderer.  With ``fused``
  (the default) it dispatches as the JAX package does: cout·cin ≤ 128 at
  hop 128 takes :func:`render_tf_matrix_fused`, where the decode matrix
  becomes uniform-band taps and one of two routes runs: cin ≤ 16 the
  one-pass kernel (:func:`_render_one_pass`), wider inputs the two-kernel
  pipeline (:func:`_render_two_pass`: analysis front, then decode ⊗
  synthesis).  Renders wider than 128 channel pairs take analysis →
  hybrid stage and per-band mix → synthesis on three kernels
  (:func:`_render_wide`).  With
  ``fused=False`` it is the plain reference path, in ordinary torch code.
* :func:`analysis_ri` / :func:`synthesis_ri` — the single-stream
  filterbank with the complex afSTFT's state layout (:class:`AfSTFTStateRI`:
  a 9-hop input tail plus carried hybrid history), for one listener whose
  mixing matrix changes every block.  Plain torch, as in the JAX package:
  none of its kernels serves this path.

Every kernel takes hop 128 only.  As in the JAX package (afstft_ri.py:397,
:489, :611 and :708 there), a bank with another hop takes the plain path
whatever the flag says, decided from the bank before any launch.

On CUDA tensors the kernel routes launch the CUDA kernels or raise; on CPU
tensors they run their plain versions.  Which route runs comes from the
caller's flag and the render's shape only, never from the device.

The TPU package's VMEM models, block fitting, group split and time split
exist only for the TPU and are not ported.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from spatial_audio_framework_tpu_torch import default_device, f32_tensor
from spatial_audio_framework_tpu_torch.ops.afstft import (_COEFF1, _COEFF2,
                                                          _TOTAL_HOPS, AfSTFT,
                                                          device_consts)
from spatial_audio_framework_tpu_torch.ops.afstft_kernels import (
    _KERNEL_HOP, _KERNEL_MAX_CH_PRODUCT, _TAIL_HOPS, analysis_front_dg_ri,
    analysis_front_ri, decode_taps, render_decode_synthesis_dg_ri,
    render_decode_synthesis_ri, render_full_ri, synthesis_back_ri,
    wide_mix_ri)
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul
from spatial_audio_framework_tpu_torch.utils.profiling import count, spanned


class AfSTFTStateBatched(NamedTuple):
    """State for the (n_streams, ...) batched pipeline.

    in_tail carries 15 hops: 9 for framing and 6 so the hybrid stage's
    history spectra are recomputed each block instead of being carried."""
    in_tail: torch.Tensor    # (S, n_ch_in, (10-1+6)*hop)
    ola_tail: torch.Tensor   # (S, n_ch_out, h_len - hop)


class AfSTFTStateRI(NamedTuple):
    """State of the single-stream pipeline: the complex afSTFT's, with the
    hybrid history carried as an (re, im) pair."""
    in_tail: torch.Tensor      # (n_ch_in, h_len - hop)
    hyb_tail_re: torch.Tensor  # (n_ch_in, 6, hop+1)
    hyb_tail_im: torch.Tensor
    ola_tail: torch.Tensor     # (n_ch_out, h_len - hop)


# The widest input the one-pass kernel takes: the JAX package's choice at
# the 64-hop chunk (order 3 runs one pass, orders 4-7 the (d, g) pair).  On
# the H100 the two routes are within 5 % of each other per call at order 3
# and the two-kernel route is 10 % faster at order 7 (PERF.md); the
# threshold stays the reference's until a chunk-level measurement moves it
# (ROADMAP.md, Queue 2, "still open" item 5).
_ONE_PASS_MAX_CIN = 16


def init_state_batched(bank: AfSTFT, n_streams: int, n_ch_in: int,
                       n_ch_out: int, device: torch.device | str | None = None
                       ) -> AfSTFTStateBatched:
    """Zero state of ``n_streams`` streams on ``device`` (default: the
    card)."""
    device = default_device() if device is None else device
    hop, h_len = bank.hop, bank.h_len
    S = n_streams
    return AfSTFTStateBatched(
        in_tail=torch.zeros((S, n_ch_in, _TAIL_HOPS * hop),
                            dtype=torch.float32, device=device),
        ola_tail=torch.zeros((S, n_ch_out, h_len - hop),
                             dtype=torch.float32, device=device))


def init_state_ri(bank: AfSTFT, n_ch_in: int, n_ch_out: int,
                  device: torch.device | str | None = None) -> AfSTFTStateRI:
    """Zero single-stream state on ``device`` (default: the card)."""
    device = default_device() if device is None else device
    hop, h_len = bank.hop, bank.h_len

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return AfSTFTStateRI(in_tail=zeros(n_ch_in, h_len - hop),
                         hyb_tail_re=zeros(n_ch_in, 6, hop + 1),
                         hyb_tail_im=zeros(n_ch_in, 6, hop + 1),
                         ola_tail=zeros(n_ch_out, h_len - hop))


def state_ri_from_numpy(in_tail, hyb_tail_re, hyb_tail_im, ola_tail,
                        device: torch.device | str | None = None
                        ) -> AfSTFTStateRI:
    """A single-stream state (e.g. the JAX package's) from numpy arrays."""
    return AfSTFTStateRI(*(f32_tensor(a, device) for a in (
        in_tail, hyb_tail_re, hyb_tail_im, ola_tail)))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous; a copy it takes counts in ``ops.state_bytes``."""
    if t.is_contiguous():
        return t
    count("ops.state_bytes", _nbytes(t))
    return t.contiguous()


@spanned("ops.next_in_tail")
def _next_in_tail(in_tail: torch.Tensor, x: torch.Tensor, H: int,
                  hop: int) -> torch.Tensor:
    """The 15-hop input tail after block x of H hops (afstft_ri.py:428-432
    of the JAX package): the last 15 hops of [in_tail | x]."""
    if H >= _TAIL_HOPS:
        return _dense(x[..., (H - _TAIL_HOPS) * hop:])
    new_in_tail = torch.cat([in_tail[..., H * hop:], x], dim=-1)
    count("ops.state_bytes", _nbytes(new_in_tail))
    return new_in_tail


def _fold_hops_ri(hops: torch.Tensor, n_frames: int, hop: int,
                  w: torch.Tensor) -> torch.Tensor:
    """Window ⊗ fold of the 10-hop overlapped afSTFT frames as ten
    hop-shifted slice-multiply-adds (parity p accumulates window hops
    p, p+2, ..., p+8), without materialising the 10× frame stack.

    hops: (..., n_frames + 9, hop); w: (10·hop,).  → (..., n_frames, 2·hop).
    """
    even = torch.zeros(hops.shape[:-2] + (n_frames, hop), dtype=hops.dtype,
                       device=hops.device)
    odd = torch.zeros_like(even)
    for p in range(_TOTAL_HOPS // 2):
        k0, k1 = 2 * p, 2 * p + 1
        even = even + (hops[..., k0:k0 + n_frames, :]
                       * w[k0 * hop:(k0 + 1) * hop])
        odd = odd + (hops[..., k1:k1 + n_frames, :]
                     * w[k1 * hop:(k1 + 1) * hop])
    return torch.cat([even, odd], dim=-1)


def _hybrid_segments_ri(fre, fim, H: int):
    """Shared core of the real-pair hybrid filterbank: f*: (..., 6+H, hop+1)
    → ([re segments], [im segments]), each a 3-list [band0, split-pairs,
    bands 5:] to be concatenated on the last axis."""
    b = slice(1, 5)
    d3_re = fre[..., 3:3 + H, :]
    d3_im = fim[..., 3:3 + H, :]

    def inner(f):
        return (_COEFF1 * (f[..., 6:6 + H, b] - f[..., 0:H, b])
                + _COEFF2 * (f[..., 4:4 + H, b] - f[..., 2:2 + H, b]))

    # hb = 1j * inner  →  hb_re = -inner_im, hb_im = inner_re
    hb_re = -inner(fim)
    hb_im = inner(fre)
    s = torch.ones(4, dtype=fre.dtype, device=fre.device)  # [-1, 1, -1, 1]
    s[0::2] = -1.0

    def halves(d3, hb):
        c = 0.5 * d3[..., b]
        lo = c + s * hb
        hi = c - s * hb
        pairs = torch.stack([lo, hi], dim=-1).reshape(*lo.shape[:-1], 8)
        return [d3[..., :1], pairs, d3[..., 5:]]

    return halves(d3_re, hb_re), halves(d3_im, hb_im)


def _hybrid_forward_ri(fre, fim, H: int):
    """Real-pair hybrid forward: f*: (..., 6+H, hop+1) → (..., H, hop+5)×2."""
    seg_re, seg_im = _hybrid_segments_ri(fre, fim, H)
    return torch.cat(seg_re, dim=-1), torch.cat(seg_im, dim=-1)


@spanned("ops.hybrid_forward")
def _hybrid_forward_ri_packed(fre, fim, H: int):
    """:func:`_hybrid_forward_ri` as one packed (..., H, 2·nHyb) tensor
    ([re | im] on the last axis)."""
    seg_re, seg_im = _hybrid_segments_ri(fre, fim, H)
    return torch.cat(seg_re + seg_im, dim=-1)


def _hybrid_inverse_ri(Y):
    pairs = Y[..., 1:9].reshape(*Y.shape[:-1], 4, 2).sum(-1)
    return torch.cat([Y[..., :1], pairs, Y[..., 9:]], dim=-1)


def _front_rows(bank: AfSTFT, state: AfSTFTStateBatched, x: torch.Tensor):
    """:func:`analysis_front_ri` over the flattened (S·n_ch) rows of block
    x → (re, im) each (S·n_ch, H+6, hop+1), and the next input tail."""
    S, n_ch = x.shape[:2]
    sre, sim = analysis_front_ri(
        _dense(state.in_tail).reshape(S * n_ch, -1),
        _dense(x).reshape(S * n_ch, -1), low_delay=bank.low_delay,
        hop=bank.hop)
    return sre, sim, _next_in_tail(state.in_tail, x, x.shape[2] // bank.hop,
                                   bank.hop)


def analysis_ri_batched(bank: AfSTFT, state: AfSTFTStateBatched,
                        x: torch.Tensor, packed: bool = False,
                        use_kernel: bool = False):
    """x: (S, n_ch, H*hop) → ((re, im) each (S, n_ch, H, n_bands), state),
    or with ``packed`` one (S, n_ch, H, 2·n_bands) [re | im] tensor.

    H+6 spectral hops are computed per block, 6 of them from the carried
    tail, so the hybrid stage needs no carried spectral state.  With
    ``use_kernel`` at hop 128 the framing ⊗ window ⊗ fold ⊗ rDFT front
    runs as :func:`analysis_front_ri` over the flattened (S·n_ch) rows;
    otherwise in plain torch (the JAX package's XLA branch, which it also
    takes at any other hop)."""
    hop = bank.hop
    use_kernel = use_kernel and hop == _KERNEL_HOP
    S, n_ch = x.shape[:2]
    H = x.shape[2] // hop
    He = H + 6
    if use_kernel:
        sre, sim, new_in_tail = _front_rows(bank, state, x)
    else:
        buf = torch.cat([state.in_tail, x], dim=-1)       # (S,C,(H+15)·hop)
        new_in_tail = buf[..., H * hop:].contiguous()
        k = device_consts(hop, bank.low_delay, x.device)
        hops = buf.reshape(S * n_ch, H + _TAIL_HOPS, hop)
        folded = _fold_hops_ri(hops, He, hop, k["w_ana"])
        with fp32_matmul():
            sre = folded @ k["C"]
            sim = folded @ k["S"]
    sre = sre.reshape(S, n_ch, He, hop + 1)
    sim = sim.reshape(S, n_ch, He, hop + 1)
    state = state._replace(in_tail=new_in_tail)
    if not bank.hybrid:
        if packed:
            return torch.cat([sre[:, :, 6:], sim[:, :, 6:]], dim=-1), state
        return (sre[:, :, 6:], sim[:, :, 6:]), state
    if packed:
        return _hybrid_forward_ri_packed(sre, sim, H), state
    return _hybrid_forward_ri(sre, sim, H), state


def synthesis_ri_batched(bank: AfSTFT, state: AfSTFTStateBatched, Y,
                         packed: bool = False, use_kernel: bool = False):
    """Y: (re, im) each (S, n_ch, H, n_bands) — or, with ``packed``, one
    (S, n_ch, H, 2·n_bands) [re | im] tensor — → ((S, n_ch, H*hop), state).

    Hybrid inverse, irDFT, synthesis window, overlap-add: with
    ``use_kernel`` at hop 128 as :func:`synthesis_back_ri` over the
    flattened (S·n_ch) rows, otherwise (and at any other hop) in plain
    torch."""
    hop, h_len = bank.hop, bank.h_len
    use_kernel = use_kernel and hop == _KERNEL_HOP
    if use_kernel:
        spec = Y if packed else torch.cat(Y, dim=-1)
        S, n_ch, H = spec.shape[:3]
        tail = _dense(state.ola_tail).reshape(S * n_ch, _TOTAL_HOPS - 1, hop)
        y, new_tail = synthesis_back_ri(
            _dense(spec).reshape(S * n_ch, H, -1), tail,
            low_delay=bank.low_delay, hybrid=bank.hybrid)
        return (y.reshape(S, n_ch, H * hop),
                state._replace(ola_tail=new_tail.reshape(S, n_ch,
                                                         h_len - hop)))
    if packed:
        nb = Y.shape[-1] // 2
        Yre, Yim = Y[..., :nb], Y[..., nb:]
    else:
        Yre, Yim = Y
    y, ola_tail = _synthesis_plain(bank, Yre, Yim, state.ola_tail)
    return y, state._replace(ola_tail=ola_tail.contiguous())


def _synthesis_plain(bank: AfSTFT, Yre: torch.Tensor, Yim: torch.Tensor,
                     ola_tail: torch.Tensor):
    """Hybrid inverse, irDFT, synthesis window and overlap-add in plain
    torch: Y* (..., n_ch, H, n_bands), ola_tail (..., n_ch, 9·hop) →
    ((..., n_ch, H·hop), new tail)."""
    hop, h_len = bank.hop, bank.h_len
    H = Yre.shape[-2]
    k = device_consts(hop, bank.low_delay, Yre.device)
    if bank.hybrid:
        Yre = _hybrid_inverse_ri(Yre)
        Yim = _hybrid_inverse_ri(Yim)
    if bank.low_delay:
        Yre = Yre * k["sign"]
        Yim = Yim * k["sign"]
    with fp32_matmul():
        frame = Yre @ k["A"] + Yim @ k["B"]
    w = k["w_syn"]
    lead = frame.shape[:-2]
    acc = torch.zeros(lead + (H + _TOTAL_HOPS - 1, hop), dtype=frame.dtype,
                      device=frame.device)
    for j in range(_TOTAL_HOPS):
        half = (j % 2) * hop
        acc[..., j:j + H, :] += (frame[..., half:half + hop]
                                 * w[j * hop:(j + 1) * hop])
    flat = acc.reshape(lead + ((H + _TOTAL_HOPS - 1) * hop,))
    flat[..., :h_len - hop] += ola_tail
    return flat[..., :H * hop], flat[..., H * hop:]


def render_tf_matrix_ri(bank: AfSTFT, state: AfSTFTStateBatched,
                        x: torch.Tensor, Mre: torch.Tensor,
                        Mim: Optional[torch.Tensor] = None,
                        fused: bool = True):
    """TF-domain matrix renderer on the batched RI path: afSTFT analysis →
    per-band mixing matrix → afSTFT synthesis, the shape shared by ambi_bin /
    binauraliser / roombinauraliser / ambi_dec.

    x: (S, Cin, T); M: (B, Cout, Cin) shared across streams or
    (S, B, Cout, Cin) per stream; Mim None ⇒ real mixing matrix.
    → ((S, Cout, T), state).

    ``fused`` (the default) takes the kernel route, dispatched as the JAX
    package does (afstft_ri.py:611-638 and 756-855 there): cout·cin ≤ 128
    at hop 128 runs :func:`render_tf_matrix_fused` (the one-pass kernel for
    cin ≤ 16, the two-kernel pipeline above); anything wider runs analysis
    (:func:`analysis_front_ri`) → hybrid stage and per-band mix
    (:func:`wide_mix_ri`) → synthesis (:func:`synthesis_back_ri`).  At a
    hop other than 128 it runs the plain path.  ``False`` runs the plain
    reference path (analysis, einsum, synthesis) on any device.
    """
    cout, cin = Mre.shape[-2], Mre.shape[-1]
    if fused and takes_fused_route(bank, cout, cin):
        return render_tf_matrix_fused(bank, state, x, Mre, Mim)
    if fused and bank.hop == _KERNEL_HOP:
        return _render_wide(bank, state, x, Mre, Mim)
    spec_p, state = analysis_ri_batched(bank, state, x, packed=True)
    out_p = _mix_bands(Mre, Mim, spec_p).flatten(-2)
    return synthesis_ri_batched(bank, state, out_p, packed=True)


@spanned("ops.render_wide")
def _render_wide(bank: AfSTFT, state: AfSTFTStateBatched, x: torch.Tensor,
                 Mre: torch.Tensor, Mim: Optional[torch.Tensor]):
    """:func:`render_tf_matrix_ri`'s kernel route for renders wider than
    128 channel pairs, at hop 128: :func:`analysis_front_ri` over the
    flattened (S·cin) rows, :func:`wide_mix_ri` (the hybrid stage and the
    per-band mix, straight into the packed (S·cout) rows),
    :func:`synthesis_back_ri` over those rows.  A matrix that is a view is
    made dense first (counted in ``ops.state_bytes``).

    Counts in ``ops.spectra_bytes`` the bytes of the spectra the route
    writes between the two filterbank kernels, reckoned from their shapes:
    the front's (re, im) output and the mix's packed rows."""
    S, H = x.shape[0], x.shape[2] // bank.hop
    sre, sim, new_in_tail = _front_rows(bank, state, x)
    rows = wide_mix_ri(sre, sim, _dense(Mre),
                       None if Mim is None else _dense(Mim),
                       hybrid=bank.hybrid)
    count("ops.spectra_bytes", _nbytes(sre) + _nbytes(sim) + _nbytes(rows))
    return synthesis_ri_batched(
        bank, state._replace(in_tail=new_in_tail),
        rows.reshape(S, -1, H, rows.shape[-1]), packed=True, use_kernel=True)


@spanned("ops.mix_bands")
def _mix_bands(Mre: torch.Tensor, Mim: Optional[torch.Tensor],
               spec_p: torch.Tensor) -> torch.Tensor:
    """The per-band mix of packed spectra (S, cin, H, 2·B) by a real
    (Mim None) or complex matrix, shared (B, cout, cin) or per stream
    (S, B, cout, cin) → (S, cout, H, 2, B) in the layout the einsum leaves
    (band-major, not contiguous)."""
    S, cin, H, nb2 = spec_p.shape
    spec5 = spec_p.reshape(S, cin, H, 2, nb2 // 2)
    per_stream = Mre.ndim == 4
    with fp32_matmul():
        if Mim is None:
            eq = "zbes,zshjb->zehjb" if per_stream else "bes,zshjb->zehjb"
            return torch.einsum(eq, Mre, spec5)
        M4 = torch.stack([torch.stack([Mre, -Mim], dim=-1),
                          torch.stack([Mim, Mre], dim=-1)], dim=-2)
        eq = "zbesij,zshjb->zehib" if per_stream else "besij,zshjb->zehib"
        return torch.einsum(eq, M4, spec5)


def takes_fused_route(bank: AfSTFT, cout: int, cin: int) -> bool:
    """Whether ``render_tf_matrix_ri(fused=True)`` renders cin → cout
    channels on :func:`render_tf_matrix_fused`: at most 128 channel pairs,
    at hop 128."""
    return cout * cin <= _KERNEL_MAX_CH_PRODUCT and bank.hop == _KERNEL_HOP


def render_tf_matrix_fused(bank: AfSTFT, state: AfSTFTStateBatched,
                           x: torch.Tensor, Mre: Optional[torch.Tensor] = None,
                           Mim: Optional[torch.Tensor] = None,
                           taps: Optional[torch.Tensor] = None):
    """The TF-matrix renderer on the decode kernels: the hybrid stage and
    the per-band mixing matrix collapse into uniform-band decode taps
    (:func:`decode_taps`).  cin ≤ 16 runs :func:`_render_one_pass`, wider
    inputs :func:`_render_two_pass`.  Same contract as
    :func:`render_tf_matrix_ri`; numerically equivalent to its plain path.
    A bank whose hop is not 128 takes that plain path (JAX afstft_ri.py:708).

    ``taps``, in place of (Mre, Mim): the decode taps made already, shared
    (cin, cout, 4, 129) or per stream (S, cin, cout, 4, 129), e.g. by
    :func:`~spatial_audio_framework_tpu_torch.ops.afstft_kernels.hrtf_taps_ri`
    (hop 128 only)."""
    if bank.hop != _KERNEL_HOP:
        if taps is not None:
            raise ValueError("render_tf_matrix_fused: decode taps are for "
                             f"hop {_KERNEL_HOP}, the bank's hop is "
                             f"{bank.hop}")
        return render_tf_matrix_ri(bank, state, x, Mre, Mim, fused=False)
    route = (_render_one_pass if x.shape[1] <= _ONE_PASS_MAX_CIN
             else _render_two_pass)
    return route(bank, state, x, Mre, Mim, taps)


@spanned("ops.decode_taps")
def _decode_inputs(bank: AfSTFT, Mre: torch.Tensor,
                   Mim: Optional[torch.Tensor]) -> torch.Tensor:
    """→ the decode kernels' taps of the mixing matrix (Mre, Mim)."""
    if Mim is None:
        Mim = torch.zeros_like(Mre)
    return _dense(decode_taps(Mre, Mim, hybrid=bank.hybrid))


def _route_inputs(bank: AfSTFT, state: AfSTFTStateBatched,
                  Mre: Optional[torch.Tensor], Mim: Optional[torch.Tensor],
                  taps: Optional[torch.Tensor]):
    """→ (taps, OLA tail (S, cout, 9, hop)) for the decode kernels: the
    taps given, or those of (Mre, Mim)."""
    if taps is None:
        taps = _decode_inputs(bank, Mre, Mim)
    S, cout = state.ola_tail.shape[:2]
    return taps, state.ola_tail.reshape(S, cout, _TOTAL_HOPS - 1, bank.hop)


@spanned("ops.render_one_pass")
def _render_one_pass(bank: AfSTFT, state: AfSTFTStateBatched,
                     x: torch.Tensor, Mre: Optional[torch.Tensor] = None,
                     Mim: Optional[torch.Tensor] = None,
                     taps: Optional[torch.Tensor] = None):
    """:func:`render_tf_matrix_fused` on the one-pass kernel
    :func:`render_full_ri`: analysis ⊗ decode ⊗ synthesis in one call."""
    hop = bank.hop
    taps, tail = _route_inputs(bank, state, Mre, Mim, taps)
    # the kernel reads its rows densely: a block that is a view of a longer
    # signal (render_signal's, a frame of a larger buffer) is copied first
    y, new_tail = render_full_ri(
        _dense(state.in_tail), _dense(x), tail, taps,
        low_delay=bank.low_delay, hybrid=bank.hybrid,
        per_stream=taps.ndim == 5)
    return y, AfSTFTStateBatched(
        in_tail=_next_in_tail(state.in_tail, x, x.shape[2] // hop, hop),
        ola_tail=new_tail.reshape(state.ola_tail.shape))


@spanned("ops.render_two_pass")
def _render_two_pass(bank: AfSTFT, state: AfSTFTStateBatched,
                     x: torch.Tensor, Mre: Optional[torch.Tensor] = None,
                     Mim: Optional[torch.Tensor] = None,
                     taps: Optional[torch.Tensor] = None):
    """:func:`render_tf_matrix_fused` on two kernels over the flattened
    (S·cin) rows: for hybrid banks :func:`analysis_front_dg_ri` →
    :func:`render_decode_synthesis_dg_ri`, otherwise
    :func:`analysis_front_ri` → :func:`render_decode_synthesis_ri`."""
    hop = bank.hop
    S, cin = x.shape[:2]
    H = x.shape[2] // hop
    taps, tail = _route_inputs(bank, state, Mre, Mim, taps)
    rows = (_dense(state.in_tail).reshape(S * cin, -1),
            _dense(x).reshape(S * cin, -1))
    kw = dict(low_delay=bank.low_delay, per_stream=taps.ndim == 5)
    if bank.hybrid:
        dg = analysis_front_dg_ri(*rows, low_delay=bank.low_delay, hop=hop)
        y, new_tail = render_decode_synthesis_dg_ri(
            *(t.reshape(S, cin, H, -1) for t in dg), tail, taps, **kw)
    else:
        sre, sim = analysis_front_ri(*rows, low_delay=bank.low_delay, hop=hop)
        y, new_tail = render_decode_synthesis_ri(
            sre.reshape(S, cin, H + 6, -1), sim.reshape(S, cin, H + 6, -1),
            tail, taps, hybrid=False, **kw)
    return y, AfSTFTStateBatched(
        in_tail=_next_in_tail(state.in_tail, x, H, hop),
        ola_tail=new_tail.reshape(state.ola_tail.shape))


def analysis_ri(bank: AfSTFT, state: AfSTFTStateRI, x: torch.Tensor):
    """x: (n_ch, H*hop) → ((re, im) each (n_bands, n_ch, H), state), the
    complex :meth:`AfSTFT.analysis` as an (re, im) pair.  The JAX package
    picks between a stacked fold + matmul and a 1-D convolution by size;
    both compute these sums, and this is the one form here."""
    hop = bank.hop
    n_ch = x.shape[0]
    H = x.shape[1] // hop
    k = device_consts(hop, bank.low_delay, x.device)
    buf = torch.cat([state.in_tail, x], dim=-1)
    hops = buf.reshape(n_ch, H + _TOTAL_HOPS - 1, hop)
    folded = _fold_hops_ri(hops, H, hop, k["w_ana"])
    with fp32_matmul():
        sre = folded @ k["C"]
        sim = folded @ k["S"]
    state = state._replace(in_tail=buf[:, H * hop:])
    if not bank.hybrid:
        return (sre.permute(2, 0, 1), sim.permute(2, 0, 1)), state
    fre = torch.cat([state.hyb_tail_re, sre], dim=1)
    fim = torch.cat([state.hyb_tail_im, sim], dim=1)
    ore, oim = _hybrid_forward_ri(fre, fim, H)
    return ((ore.permute(2, 0, 1), oim.permute(2, 0, 1)),
            state._replace(hyb_tail_re=fre[:, H:H + 6],
                           hyb_tail_im=fim[:, H:H + 6]))


def synthesis_ri(bank: AfSTFT, state: AfSTFTStateRI, Y):
    """Y: (re, im) each (n_bands, n_ch, H) → ((n_ch, H*hop), state)."""
    y, ola_tail = _synthesis_plain(bank, Y[0].permute(1, 2, 0),
                                   Y[1].permute(1, 2, 0), state.ola_tail)
    return y, state._replace(ola_tail=ola_tail)
