"""decorrelator — multi-channel decorrelator (counterpart of
``spatial_audio_framework_tpu/models/decorrelator.py``;
``examples/src/decorrelator``): afSTFT → optional transient ducking →
lattice all-pass decorrelation (+ fixed per-band delays) → inverse afSTFT,
with a wet/dry ("decorrelation amount") mix.

``process_ri_batched`` runs many streams a chunk on the batched filterbank:
with ``fused=True`` its front and back are the CUDA kernels
``analysis_front_ri`` and ``synthesis_back_ri`` over the (streams ·
channels) rows, the lattice between them is plain torch (block-form
products, ``utils/decor``).  ``process`` is the single-stream complex path.

``design`` returns the host design dict of the JAX package (numpy, the
delays drawn from the C's ``rand()`` stream when ``c_rand_offset`` is
given) with the device data of ``decor.lattice_design_on_device`` added;
``design_from_numpy`` does the same for the JAX package's dict.
``state_from_numpy`` / ``state_batched_from_numpy`` take the JAX package's
states as numpy arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import f32_tensor
from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.ops import afstft_ri as ri
from spatial_audio_framework_tpu_torch.ops.afstft import (AfSTFT, AfSTFTState,
                                                          state_from_numpy as
                                                          _bank_from_numpy)
from spatial_audio_framework_tpu_torch.utils import decor


@dataclass(frozen=True)
class DecorrelatorConfig:
    n_channels: int = 1
    fs: float = 48000.0
    decor_amount: float = 1.0       # decorrelator.h 'decorrelationAmount'
    enable_transient_ducker: bool = False  # decorrelator.c:38 (off by default)
    compensate_level: bool = False         # decorrelator.c:40 (off by default)
    hop: int = 128

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True)

    @property
    def lattice(self) -> decor.LatticeDecorrelator:
        # orders/cutoffs as in decorrelator_internal.c initCodec
        return decor.LatticeDecorrelator(
            fs=self.fs, hop_size=self.hop, n_ch=self.n_channels,
            orders=(20, 15, 6, 3), freq_cutoffs=(600.0, 2.4e3, 4e3, 12e3),
            max_delay=8,            # decorrelator.c:150 'const int maxDelay'
            en_comp_coeff=0.75)     # decorrelator.c:152 last create arg

    def __post_init__(self):
        C.validate_config(self)


class DecorrelatorState(NamedTuple):
    bank: AfSTFTState
    lattice: decor.LatticeDecorState
    ducker: decor.TransientDuckerState


class DecorrelatorStateBatched(NamedTuple):
    bank: ri.AfSTFTStateBatched
    lattice: decor.LatticeDecorStateRI   # leaves carry a leading (S,) axis
    ducker: decor.TransientDuckerState   # leaves carry a leading (S,) axis


def design_from_numpy(design_data: dict,
                      device: torch.device | str | None = None) -> dict:
    """A host design dict (e.g. the JAX package's ``design`` output) with
    the lattice's device data made on ``device`` (default: the card)."""
    decor.lattice_design_on_device(design_data, device)
    return design_data


def design(cfg: DecorrelatorConfig, c_rand_offset: int = None,
           device: torch.device | str | None = None) -> dict:
    """``c_rand_offset`` (optional): position of the C process's unseeded
    glibc rand() stream when its latticeDecorrelator_create ran: the delay
    draws then match the reference bit-exactly (0 for a process whose first
    rand() consumer is the decorrelator)."""
    freqs = cfg.afstft.centre_freqs(cfg.fs)
    stream = None
    if c_rand_offset is not None:
        from spatial_audio_framework_tpu_torch.utils.convhull3d import (
            glibc_rand_at)

        stream = glibc_rand_at(c_rand_offset)
    return design_from_numpy(cfg.lattice.design(freqs, c_rand_stream=stream),
                             device)


def init_state(cfg: DecorrelatorConfig, design_data: dict,
               device: torch.device | str | None = None) -> DecorrelatorState:
    n_bands = cfg.afstft.n_bands
    return DecorrelatorState(
        bank=cfg.afstft.init_state(cfg.n_channels, cfg.n_channels, device),
        lattice=cfg.lattice.init_state(design_data, n_bands, device),
        ducker=decor.transient_ducker_init(n_bands, cfg.n_channels,
                                           device=device))


def state_from_numpy(bank: tuple, lattice: tuple, ducker: tuple,
                     device: torch.device | str | None = None
                     ) -> DecorrelatorState:
    """The single-stream state (e.g. the JAX package's) from numpy arrays:
    ``bank`` (in_tail, hyb_tail_re, hyb_tail_im, ola_tail); ``lattice``
    (delay_buf, iir_state) each as an (re, im) pair, then in_energy and
    out_energy; ``ducker`` (d1, d2)."""
    (db_re, db_im), (iir_re, iir_im), ein, eout = lattice

    def cplx(re, im):
        return torch.complex(f32_tensor(re, device), f32_tensor(im, device))

    return DecorrelatorState(
        bank=_bank_from_numpy(*bank, device=device),
        lattice=decor.LatticeDecorState(
            delay_buf=cplx(db_re, db_im), iir_state=cplx(iir_re, iir_im),
            in_energy=f32_tensor(ein, device),
            out_energy=f32_tensor(eout, device)),
        ducker=decor.TransientDuckerState(*(f32_tensor(a, device)
                                            for a in ducker)))


def process(cfg: DecorrelatorConfig, design_data: dict,
            state: DecorrelatorState, x: torch.Tensor):
    """x: (nCH, T) → ((nCH, T), state)."""
    bank = cfg.afstft
    spec, bank_st = bank.analysis(state.bank, x)   # (nBands, nCH, H)
    frame = orig = spec
    ducker_st = state.ducker
    trans = None
    if cfg.enable_transient_ducker:
        # decorrelate only the residual (decorrelator.c:196-200)
        frame, trans, ducker_st = decor.transient_ducker_apply(ducker_st, frame)
    # the C's ducker path calls the lattice in place (decorrelator.c:199),
    # which flips the input-energy EWMA onto the delayed signal
    wet, lat_st = cfg.lattice.apply(design_data, state.lattice, frame,
                                    aliased_energy=cfg.enable_transient_ducker)
    if cfg.compensate_level:                       # decorrelator.c:205-208
        wet = wet * (0.75 * cfg.n_channels / np.sqrt(cfg.n_channels))
    if trans is not None:
        wet = wet + trans                          # decorrelator.c:211-215
    # wet/dry mix against the ORIGINAL input frame (decorrelator.c:218-221)
    out = cfg.decor_amount * wet + (1.0 - cfg.decor_amount) * orig
    y, bank_st = bank.synthesis(bank_st, out)
    return y, DecorrelatorState(bank=bank_st, lattice=lat_st, ducker=ducker_st)


def init_state_batched(cfg: DecorrelatorConfig, design_data: dict,
                       n_streams: int,
                       device: torch.device | str | None = None
                       ) -> DecorrelatorStateBatched:
    n_bands = cfg.afstft.n_bands
    lead = (n_streams,)
    return DecorrelatorStateBatched(
        bank=ri.init_state_batched(cfg.afstft, n_streams, cfg.n_channels,
                                   cfg.n_channels, device=device),
        lattice=decor.lattice_init_state_ri(cfg.lattice, design_data, n_bands,
                                            lead, device),
        ducker=decor.transient_ducker_init(n_bands, cfg.n_channels, lead,
                                           device))


def state_batched_from_numpy(bank: tuple, lattice: tuple, ducker: tuple,
                             device: torch.device | str | None = None
                             ) -> DecorrelatorStateBatched:
    """The batched state (e.g. the JAX package's) from numpy arrays:
    ``bank`` (in_tail, ola_tail), ``lattice`` (delay_buf, iir_state,
    in_energy, out_energy), ``ducker`` (d1, d2), each with the leading
    stream axis."""
    t = [f32_tensor(a, device) for a in bank + lattice + ducker]
    return DecorrelatorStateBatched(
        bank=ri.AfSTFTStateBatched(*t[:2]),
        lattice=decor.LatticeDecorStateRI(*t[2:6]),
        ducker=decor.TransientDuckerState(*t[6:]))


def process_ri_batched(cfg: DecorrelatorConfig, design_data: dict,
                       state: DecorrelatorStateBatched, x: torch.Tensor,
                       fused: bool = True):
    """Stream-batched process: x (S, nCH, T) → ((S, nCH, T), state).

    ``fused=True``: the filterbank's front and back are the kernels
    ``analysis_front_ri`` / ``synthesis_back_ri`` (their plain versions on
    CPU tensors); ``fused=False`` the plain filterbank on any device."""
    bank = cfg.afstft
    (sre, sim), bank_st = ri.analysis_ri_batched(bank, state.bank, x,
                                                 use_kernel=fused)
    # → per-stream (nBands, nCH, H) frames
    fre = sre.movedim(-1, 1)             # (S, nBands, nCH, H)
    fim = sim.movedim(-1, 1)
    orig_re, orig_im = fre, fim
    ducker_st = state.ducker
    tre = tim = None
    if cfg.enable_transient_ducker:
        # decorrelate only the residual (decorrelator.c:196-200)
        (fre, fim), (tre, tim), ducker_st = decor.transient_ducker_apply_ri(
            state.ducker, fre, fim)
    (wre, wim), lat_st = decor.lattice_apply_ri(
        cfg.lattice, design_data, state.lattice, fre, fim,
        aliased_energy=cfg.enable_transient_ducker)
    if cfg.compensate_level:             # decorrelator.c:205-208
        comp = 0.75 * cfg.n_channels / np.sqrt(cfg.n_channels)
        wre, wim = wre * comp, wim * comp
    if tre is not None:                  # decorrelator.c:211-215
        wre, wim = wre + tre, wim + tim
    # wet/dry mix against the ORIGINAL input frame (decorrelator.c:218-221)
    out_re = cfg.decor_amount * wre + (1.0 - cfg.decor_amount) * orig_re
    out_im = cfg.decor_amount * wim + (1.0 - cfg.decor_amount) * orig_im
    Y = (out_re.movedim(1, -1), out_im.movedim(1, -1))   # (S, nCH, H, nB)
    y, bank_st = ri.synthesis_ri_batched(bank, bank_st, Y, use_kernel=fused)
    return y, DecorrelatorStateBatched(bank=bank_st, lattice=lat_st,
                                       ducker=ducker_st)
