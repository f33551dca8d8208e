"""Image-source-method (IMS) shoebox room simulator (counterpart of
``spatial_audio_framework_tpu/modules/reverb.py``; ``saf_reverb``).

Host-side scene management and echogram computation (the analogue of the
reference's create/add/update/computeEchograms/renderRIRs API,
saf_reverb.h:105-146), fully vectorised over image sources in NumPy instead
of the reference's per-image loops (saf_reverb_internal.c:269-523).

The reference's streaming time-domain applicator
(``ims_shoebox_applyEchogramTD``: per-image-source circular-buffer taps +
per-source IIR filterbanks + crossfading, saf_reverb.c:297+) is provided two
ways: (a) as *partitioned convolution of the rendered RIRs* with crossfade on
scene updates — ``ops.matrix_conv.TVConv``, see ``models/ambi_roomsim.py`` —
and (b) as a direct equivalent on tensors, :class:`ImsTDApplicator`, which
band-splits each source with the Favrot & Faller IIR filterbank
(``utils/filters.FafIIRFilterbank.apply_device``), reads statically padded
per-image-source delay taps from a rolling buffer (one batched gather and
one einsum per block, Lagrange taps for fractional delays), and linearly
cross-fades previous and current echograms as the reference does.

The scene, the echograms, the RIR render and the tap packing are host
numpy / scipy, the port's own copy of the JAX package's.

Limits follow the reference: ≤128 sources, ≤16 receivers (saf_reverb.h:52-55).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import default_device, f32_tensor
from spatial_audio_framework_tpu_torch.modules import sh as _sh
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul
from spatial_audio_framework_tpu_torch.utils import filters as _filters
from spatial_audio_framework_tpu_torch.utils.misc import lagrange_weights

IMS_MAX_NUM_SOURCES = 128
IMS_MAX_NUM_RECEIVERS = 16
IMS_FIR_FILTERBANK_ORDER = 1000  # saf_reverb_internal.h


@dataclass
class Echogram:
    """One (receiver, source) echogram: value (nCh, nIm), time (nIm,) s,
    order (nIm, 3), coords (nIm, 3) — sorted by propagation time."""
    value: np.ndarray
    time: np.ndarray
    order: np.ndarray
    coords: np.ndarray


def _image_sources_order(max_n: int):
    r = np.arange(-max_n, max_n + 1)
    II, JJ, KK = np.meshgrid(r, r, r, indexing="ij")
    II, JJ, KK = II.ravel(), JJ.ravel(), KK.ravel()
    keep = np.abs(II) + np.abs(JJ) + np.abs(KK) <= max_n
    return II[keep], JJ[keep], KK[keep]


def _image_sources_time(room, d_max):
    Nx = int(d_max / room[0] + 1.0)
    Ny = int(d_max / room[1] + 1.0)
    Nz = int(d_max / room[2] + 1.0)
    II, JJ, KK = np.meshgrid(np.arange(-Nx, Nx + 1), np.arange(-Ny, Ny + 1),
                             np.arange(-Nz, Nz + 1), indexing="ij")
    return II.ravel(), JJ.ravel(), KK.ravel()


def compute_echogram(room, src, rec, c: float = 343.0,
                     max_order: int = -1, max_time_s: float = -1.0) -> Echogram:
    """Pure-propagation omni echogram (saf_reverb_internal.c
    ``ims_shoebox_coreInitT/N``).  src/rec in room coordinates (corner
    origin; the reference's y flip and centre-origin shift are applied
    internally).  Exactly one of max_order / max_time_s must be >= 0."""
    room = np.asarray(room, np.float64)
    src = np.asarray(src, np.float64)
    rec = np.asarray(rec, np.float64)
    # The scene API flips y before coreInit, and coreInit moves the origin to
    # the room centre with its own y flip (saf_reverb.c:205-212 +
    # saf_reverb_internal.c:283-289) — the two compose to plain centring.
    src_o = np.array([src[0] - room[0] / 2, src[1] - room[1] / 2, src[2] - room[2] / 2])
    rec_o = np.array([rec[0] - room[0] / 2, rec[1] - room[1] / 2, rec[2] - room[2] / 2])

    if max_time_s > 0:
        d_max = max_time_s * c
        II, JJ, KK = _image_sources_time(room, d_max)
    else:
        assert max_order >= 0
        II, JJ, KK = _image_sources_order(max_order)

    s = np.stack([II * room[0] + np.where(II % 2 == 0, src_o[0], -src_o[0]) - rec_o[0],
                  JJ * room[1] + np.where(JJ % 2 == 0, src_o[1], -src_o[1]) - rec_o[1],
                  KK * room[2] + np.where(KK % 2 == 0, src_o[2], -src_o[2]) - rec_o[2]],
                 axis=-1)
    d = np.linalg.norm(s, axis=-1)
    if max_time_s > 0:
        keep = d < d_max
        s, d = s[keep], d[keep]
        II, JJ, KK = II[keep], JJ[keep], KK[keep]
    t = d / c
    val = np.where(d <= 1.0, 1.0, 1.0 / np.maximum(d, 1e-9))
    idx = np.argsort(t, kind="stable")
    return Echogram(value=val[idx][None, :], time=t[idx],
                    order=np.stack([II, JJ, KK], -1)[idx], coords=s[idx])


def apply_sh_directivity(ec: Echogram, sh_order: int) -> Echogram:
    """Impose SH receiver directivities (``ims_shoebox_coreRecModuleSH``)."""
    if sh_order == 0:
        return ec
    azi = np.arctan2(ec.coords[:, 1], ec.coords[:, 0])
    elev = np.arctan2(ec.coords[:, 2], np.linalg.norm(ec.coords[:, :2], axis=-1))
    dirs = np.stack([azi, np.pi / 2 - elev], -1)
    Y = _sh.get_sh_real(sh_order, dirs)  # orthonormal (getSHreal_recur)
    return Echogram(value=Y * ec.value[0][None, :], time=ec.time,
                    order=ec.order, coords=ec.coords)


def apply_wall_absorption(ec: Echogram, abs_wall: np.ndarray) -> list[Echogram]:
    """Per-band wall absorption (``ims_shoebox_coreAbsorptionModule``).
    abs_wall: (nBands, 6) absorption [x0,x1,y0,y1,z0,z1] → list of per-band
    echograms."""
    abs_wall = np.atleast_2d(np.asarray(abs_wall, np.float64))
    r = np.sqrt(1.0 - abs_wall)  # (nBands, 6)
    out = []
    o = ec.order  # (nIm, 3)

    def hits(n):  # wall-hit counts (n_lo, n_hi) for one axis order vector
        a = np.abs(n)
        even = (n % 2 == 0)
        lo = np.where(even, a / 2.0, np.where(n > 0, np.ceil(n / 2.0),
                                              np.floor(a / 2.0)))
        hi = np.where(even, a / 2.0, np.where(n > 0, np.floor(n / 2.0),
                                              np.ceil(a / 2.0)))
        return lo, hi

    xl, xh = hits(o[:, 0])
    yl, yh = hits(o[:, 1])
    zl, zh = hits(o[:, 2])
    for band in range(abs_wall.shape[0]):
        g = (r[band, 0] ** xl * r[band, 1] ** xh
             * r[band, 2] ** yl * r[band, 3] ** yh
             * r[band, 4] ** zl * r[band, 5] ** zh)
        out.append(Echogram(value=ec.value * g[None, :], time=ec.time,
                            order=ec.order, coords=ec.coords))
    return out


def render_rir(echograms: list[Echogram], fs: float,
               H_filt: Optional[np.ndarray] = None,
               fractional_delays: bool = False) -> np.ndarray:
    """Accumulate per-band echograms into a broadband RIR
    (``ims_shoebox_renderRIR``): round taps to samples (or Lagrange
    fractional delays), band-filter with the FIR filterbank, sum.
    → (nCh, rir_len).

    Reference-parity note: the reference computes the per-band FIR
    filtering into a scratch buffer but then sums the UNFILTERED band
    echograms (``saf_reverb_internal.c:697-707`` — the ``fftconv`` output
    ``temp`` is never read back), so its multi-band RIR is the plain sum
    of the absorption-scaled band taps.  Pass ``H_filt=None`` (what
    :meth:`ShoeboxRoom.render_rirs` does by default) to match that
    behaviour bit-for-bit; pass the FIR bank explicitly to get the
    physically-intended band-limited render."""
    n_ch = echograms[0].value.shape[0]
    endtime = max(ec.time[-1] for ec in echograms)
    rir_len = int(endtime * fs + 1.0) + 1
    out = np.zeros((n_ch, rir_len))
    for band, ec in enumerate(echograms):
        rir_b = np.zeros((n_ch, rir_len))
        if fractional_delays:
            order = 2
            base = np.floor(ec.time * fs).astype(int)
            frac = ec.time * fs - base
            W = lagrange_weights(order, frac)  # (order+1, nIm)
            for k in range(order + 1):
                idx = np.clip(base + k - order // 2, 0, rir_len - 1)
                np.add.at(rir_b.T, idx, (ec.value * W[k][None, :]).T)
        else:
            idx = np.round(ec.time * fs).astype(int)
            np.add.at(rir_b.T, idx, ec.value.T)
        if H_filt is not None:
            from scipy.signal import fftconvolve

            delay = (H_filt.shape[-1] - 1) // 2
            filt = fftconvolve(rir_b, H_filt[band][None, :], axes=-1)
            rir_b = filt[:, delay:delay + rir_len]
        out += rir_b
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# streaming time-domain applicator (ims_shoebox_applyEchogramTD,
# saf_reverb.c:297-523)
# ---------------------------------------------------------------------------

class EchogramTaps(NamedTuple):
    """Statically-padded tap representation of one (receiver, source) pair's
    per-band echograms: integer sample delays shared across bands, per-band
    per-channel tap values (zero-padded to max_taps)."""
    delays: np.ndarray   # (nTaps,) int32
    values: np.ndarray   # (nBands, nCh, nTaps) float32


def pack_echogram_taps(echograms: list, fs: float, max_taps: int,
                       fractional_delays: bool = False) -> EchogramTaps:
    """Pack per-band echograms (shared time vector) into static-shape tap
    tensors.  Fractional delays are folded in at pack time: each image source
    expands into order-2 Lagrange taps (the same interpolator renderRIR
    uses), so the streaming path needs only integer gathers."""
    times = echograms[0].time
    vals = np.stack([ec.value for ec in echograms])  # (nBands, nCh, nIm)
    if fractional_delays:
        order = 2
        base = np.floor(times * fs).astype(np.int64)
        frac = times * fs - base
        W = lagrange_weights(order, frac)            # (order+1, nIm)
        delays = np.concatenate([np.maximum(base + k - order // 2, 0)
                                 for k in range(order + 1)])
        vals = np.concatenate([vals * W[k][None, None, :]
                               for k in range(order + 1)], axis=-1)
    else:
        delays = np.round(times * fs).astype(np.int64)
    n = delays.shape[0]
    if n > max_taps:
        raise ValueError(f"echogram has {n} taps > max_taps={max_taps}")
    pad = max_taps - n
    delays = np.concatenate([delays, np.zeros(pad, np.int64)])
    vals = np.pad(vals, ((0, 0), (0, 0), (0, pad)))
    return EchogramTaps(delays=delays.astype(np.int32),
                        values=vals.astype(np.float32))


class ImsTDApplicatorState(NamedTuple):
    band_tail: torch.Tensor              # (nSrc, nBands, D) filtered history
    faf_zi: Optional[torch.Tensor]       # the filterbank's state, None for 1 band


def td_state_from_numpy(band_tail, faf_zi=None,
                        device: torch.device | str | None = None
                        ) -> ImsTDApplicatorState:
    """An applicator state (e.g. the JAX package's) from numpy arrays."""
    return ImsTDApplicatorState(
        band_tail=f32_tensor(band_tail, device),
        faf_zi=None if faf_zi is None else f32_tensor(faf_zi, device))


def taps_from_numpy(taps: EchogramTaps,
                    device: torch.device | str | None = None) -> EchogramTaps:
    """Stacked taps (``ShoeboxRoom.pack_taps``) as device tensors: delays
    int64, values float32.  Made once per echogram update, so the per-block
    path copies nothing from the host."""
    device = default_device() if device is None else device
    return EchogramTaps(
        delays=torch.tensor(np.asarray(taps.delays, np.int64), device=device),
        values=f32_tensor(taps.values, device))


@dataclass(frozen=True)
class ImsTDApplicator:
    """``ims_shoebox_applyEchogramTD`` (saf_reverb.c:297-523) on tensors for
    ONE receiver: per source, band-split by the Favrot & Faller IIR
    filterbank (IMS_IIR_FILTERBANK_ORDER=3, saf_reverb_internal.h:50),
    delayed taps read from a rolling buffer, tap values applied per band
    and channel, previous↔current echogram crossfade with the reference's
    linear per-sample ramp (saf_reverb.c:352-357)."""
    fs: float
    n_src: int
    n_ch: int
    band_cutoffs: Optional[tuple]     # None → broadband (single band)
    max_delay: int                    # circular-buffer depth, samples
    iir_order: int = 3

    @property
    def n_bands(self) -> int:
        return 1 if not self.band_cutoffs else len(self.band_cutoffs) + 1

    def _bank(self) -> Optional[_filters.FafIIRFilterbank]:
        if self.n_bands == 1:
            return None
        return _filters.FafIIRFilterbank(self.iir_order,
                                         np.asarray(self.band_cutoffs),
                                         self.fs)

    def init_state(self, device: torch.device | str | None = None
                   ) -> ImsTDApplicatorState:
        device = default_device() if device is None else device
        bank = self._bank()
        return ImsTDApplicatorState(
            band_tail=torch.zeros((self.n_src, self.n_bands, self.max_delay),
                                  dtype=torch.float32, device=device),
            faf_zi=(None if bank is None
                    else bank.init_device_state((self.n_src,), device)))

    def process(self, state: ImsTDApplicatorState, x: torch.Tensor,
                taps_cur: EchogramTaps, taps_prev: EchogramTaps = None,
                xfade: torch.Tensor = None):
        """x: (nSrc, T) → ((nCh, T), state).

        taps_*: stacked over sources, as device tensors
        (:func:`taps_from_numpy`) or numpy: delays (nSrc, nTaps), values
        (nSrc, nBands, nCh, nTaps).  xfade: (nSrc,) float {0,1}; where 1
        the output ramps prev→cur over this block (set it for exactly the
        first block after an echogram update, then pass the updated taps as
        both cur and prev with xfade=0, mirroring applyCrossFadeFLAG).

        Every tap delay must be ≤ max_delay (the rolling-buffer depth):
        deeper taps would alias onto the oldest buffered sample (the read
        index is clipped).  Numpy delays are checked here; device delays
        are not (the check would read them back to the host): check the
        numpy taps before :func:`taps_from_numpy`."""
        taps = []
        for t_ in (taps_cur, taps_prev):
            if t_ is not None and not isinstance(t_.delays, torch.Tensor):
                d_max = int(np.max(np.asarray(t_.delays)))
                if d_max > self.max_delay:
                    raise ValueError(
                        f"echogram tap delay {d_max} exceeds the applicator's "
                        f"max_delay={self.max_delay}; increase max_delay")
                t_ = taps_from_numpy(t_, x.device)
            taps.append(t_)
        taps_cur, taps_prev = taps

        T = x.shape[-1]
        D = self.max_delay
        bank = self._bank()
        if bank is None:
            bands = x[:, None, :]
            new_zi = None
        else:
            bands, new_zi = bank.apply_device(x, state.faf_zi)
            bands = bands.movedim(0, 1)              # (nSrc, nBands, T)
        full = torch.cat([state.band_tail, bands], dim=-1)
        n_src, n_bands = full.shape[:2]

        def tap_sum(delays, values):
            # read idx for output sample t of tap with delay d: D + t - d
            t = torch.arange(T, device=x.device)
            idx = (D + t[None, None, :] - delays[:, :, None]).clamp(0, D + T - 1)
            n_taps = idx.shape[1]
            g = full[:, :, None, :].expand(n_src, n_bands, n_taps, D + T).gather(
                -1, idx[:, None].expand(n_src, n_bands, n_taps, T))
            # g: (nSrc, nBands, nTaps, T); values: (nSrc, nBands, nCh, nTaps)
            with fp32_matmul():
                return torch.einsum("sbit,sbci->sct", g, values)

        out_cur = tap_sum(taps_cur.delays, taps_cur.values)
        if taps_prev is not None and xfade is not None:
            out_prev = tap_sum(taps_prev.delays, taps_prev.values)
            ramp = (torch.arange(1, T + 1, dtype=out_cur.dtype,
                                 device=x.device) / T)
            blended = out_cur * ramp + out_prev * (1.0 - ramp)
            out_cur = torch.where(xfade[:, None, None] > 0, blended, out_cur)
        out = out_cur.sum(0)                         # (nCh, T)
        return out, ImsTDApplicatorState(band_tail=full[..., -D:],
                                         faf_zi=new_zi)


@dataclass
class ShoeboxRoom:
    """Scene container (``ims_shoebox_create``, saf_reverb.h:105-118)."""
    room_dims: np.ndarray
    abs_wall: np.ndarray            # (nBands, 6)
    lowest_octave_band: float = 125.0
    c: float = 343.0
    fs: float = 48000.0
    sources: Dict[int, np.ndarray] = field(default_factory=dict)
    receivers: Dict[int, dict] = field(default_factory=dict)
    echograms: Dict[tuple, list] = field(default_factory=dict)
    rirs: Dict[tuple, np.ndarray] = field(default_factory=dict)

    def __post_init__(self):
        self.room_dims = np.asarray(self.room_dims, np.float64)
        self.abs_wall = np.atleast_2d(np.asarray(self.abs_wall, np.float64))
        self.n_bands = self.abs_wall.shape[0]
        if self.n_bands > 1:
            self.band_centres = self.lowest_octave_band * 2.0 ** np.arange(self.n_bands)
            self.band_cutoffs = _filters.get_octave_band_cutoff_freqs(self.band_centres)
        else:
            self.band_centres = self.band_cutoffs = None

    # -- scene management (saf_reverb.h:202-240) -----------------------------
    def add_source(self, pos) -> int:
        assert len(self.sources) < IMS_MAX_NUM_SOURCES
        sid = (max(self.sources) + 1) if self.sources else 0
        self.sources[sid] = np.asarray(pos, np.float64)
        return sid

    def add_receiver_sh(self, sh_order: int, pos) -> int:
        assert len(self.receivers) < IMS_MAX_NUM_RECEIVERS
        rid = (max(self.receivers) + 1) if self.receivers else 0
        self.receivers[rid] = {"pos": np.asarray(pos, np.float64),
                               "sh_order": sh_order}
        return rid

    def update_source(self, sid: int, pos):
        self.sources[sid] = np.asarray(pos, np.float64)

    def update_receiver(self, rid: int, pos):
        self.receivers[rid]["pos"] = np.asarray(pos, np.float64)

    def remove_source(self, sid: int):
        del self.sources[sid]

    def remove_receiver(self, rid: int):
        del self.receivers[rid]

    # -- compute (saf_reverb.h:136,146) --------------------------------------
    def compute_echograms(self, max_order: int = -1, max_time_ms: float = -1.0):
        for rid, rec in self.receivers.items():
            for sid, src in self.sources.items():
                ec = compute_echogram(self.room_dims, src, rec["pos"], self.c,
                                      max_order=max_order,
                                      max_time_s=max_time_ms / 1000.0)
                ec = apply_sh_directivity(ec, rec["sh_order"])
                self.echograms[(rid, sid)] = apply_wall_absorption(ec, self.abs_wall)

    def render_rirs(self, fractional_delays: bool = False,
                    band_filter: bool = False):
        """``ims_shoebox_renderRIRs``.  band_filter=False (default) matches
        the reference exactly: it sums the absorption-scaled band echograms
        without FIR band-filtering (the reference discards its own filtered
        buffer — see :func:`render_rir`'s parity note).  band_filter=True
        applies the FIR filterbank as physically intended."""
        H_filt = None
        if band_filter and self.n_bands > 1:
            H_filt = _filters.fir_filterbank(IMS_FIR_FILTERBANK_ORDER,
                                             self.band_cutoffs, self.fs)
        for key, ecs in self.echograms.items():
            self.rirs[key] = render_rir(ecs, self.fs, H_filt, fractional_delays)
        return self.rirs

    # -- streaming TD path (ims_shoebox_applyEchogramTD) ---------------------
    def pack_taps(self, rid: int, max_taps: int,
                  fractional_delays: bool = False) -> EchogramTaps:
        """Stack this receiver's per-source echogram taps for
        :class:`ImsTDApplicator`: delays (nSrc, max_taps), values
        (nSrc, nBands, nCh, max_taps); source order = sorted source IDs."""
        per_src = [pack_echogram_taps(self.echograms[(rid, sid)], self.fs,
                                      max_taps, fractional_delays)
                   for sid in sorted(self.sources)]
        return EchogramTaps(
            delays=np.stack([t.delays for t in per_src]),
            values=np.stack([t.values for t in per_src]))

    def td_applicator(self, rid: int, max_delay: int) -> ImsTDApplicator:
        n_ch = (self.receivers[rid]["sh_order"] + 1) ** 2
        return ImsTDApplicator(
            fs=self.fs, n_src=len(self.sources), n_ch=n_ch,
            band_cutoffs=(None if self.n_bands == 1
                          else tuple(self.band_cutoffs)),
            max_delay=max_delay)
