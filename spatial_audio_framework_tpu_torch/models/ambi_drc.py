"""ambi_drc — frequency-dependent dynamic-range compressor in the SH domain
(counterpart of ``spatial_audio_framework_tpu/models/ambi_drc.py``;
``examples/src/ambi_drc``; Vilkamo et al. SMC 2013 design).

Per band and time slot, the gain is computed from the omni (W) channel and
applied to all SH channels (preserving the spatial properties,
ambi_drc.c:181-206).  The attack/release smoother is a per-band sequential
recurrence over the slots (its branch depends on the state), a loop of
three torch ops a slot, as the JAX package's scan.

``process_ri_batched`` runs many streams a chunk on the packed batched
filterbank: with ``fused=True`` the CUDA kernels ``analysis_front_ri`` and
``synthesis_back_ri`` over the (streams · nSH) rows.  ``process`` is the
single-stream complex path.  ``state_from_numpy`` /
``state_batched_from_numpy`` take the JAX package's states.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import default_device, f32_tensor
from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.ops import afstft_ri as ri
from spatial_audio_framework_tpu_torch.ops.afstft import (AfSTFT, AfSTFTState,
                                                          state_from_numpy as
                                                          _bank_from_numpy)

SPECTRAL_FLOOR = 0.1585  # ambi_drc.h:76 (-16 dB)


@dataclass(frozen=True)
class AmbiDrcConfig:
    order: int = 1
    fs: float = 48000.0
    theshold_db: float = 0.0
    ratio: float = 8.0            # ambi_drc.c:66
    knee_db: float = 0.0
    in_gain_db: float = 0.0
    out_gain_db: float = 0.0
    attack_ms: float = 50.0       # ambi_drc.c:70
    release_ms: float = 100.0
    ch_ordering: str = C.CH_ACN
    norm: str = C.NORM_SN3D
    hop: int = 128

    @property
    def nsh(self) -> int:
        return (self.order + 1) ** 2

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True)

    def __post_init__(self):
        C.validate_config(self)


class AmbiDrcState(NamedTuple):
    bank: AfSTFTState
    yl_z1: torch.Tensor  # (nBands,) smoother state


class AmbiDrcStateBatched(NamedTuple):
    bank: ri.AfSTFTStateBatched
    yl_z1: torch.Tensor  # (S, nBands) smoother state


def init_state(cfg: AmbiDrcConfig,
               device: torch.device | str | None = None) -> AmbiDrcState:
    device = default_device() if device is None else device
    return AmbiDrcState(bank=cfg.afstft.init_state(cfg.nsh, cfg.nsh, device),
                        yl_z1=torch.zeros(cfg.afstft.n_bands,
                                          dtype=torch.float32, device=device))


def state_from_numpy(bank: tuple, yl_z1,
                     device: torch.device | str | None = None) -> AmbiDrcState:
    """The single-stream state (e.g. the JAX package's) from numpy arrays:
    ``bank`` (in_tail, hyb_tail_re, hyb_tail_im, ola_tail), ``yl_z1``."""
    return AmbiDrcState(bank=_bank_from_numpy(*bank, device=device),
                        yl_z1=f32_tensor(yl_z1, device))


def _gain_computer(xg, T, R, W):
    """ambi_drc_internal.c:46 ``ambi_drc_gainComputer``."""
    soft = xg + (1.0 / R - 1.0) * (xg - T + W / 2.0) ** 2 / (2.0 * W + 1e-12)
    above = T + (xg - T) / R
    return torch.where(2.0 * (xg - T) < -W, xg,
                       torch.where(2.0 * torch.abs(xg - T) <= W, soft, above))


@functools.lru_cache(maxsize=None)
def _coeffs(cfg: AmbiDrcConfig):
    """The attack and release one-pole coefficients (ambi_drc.c:157-158),
    in float32 as the JAX package evaluates them, on the host once per
    configuration."""
    a = np.exp(np.float32([-1.0 / (ms * 0.001 * cfg.fs / cfg.hop)
                           for ms in (cfg.attack_ms, cfg.release_ms)]))
    return float(a[0]), float(a[1])


def _smooth(cfg: AmbiDrcConfig, yl_z1: torch.Tensor, xl: torch.Tensor):
    """The attack/release smoother over the slots of xl (..., H) from
    yl_z1 (...) → (yl (..., H), last yl)."""
    alpha_a, alpha_r = _coeffs(cfg)
    y = yl_z1
    out = []
    for t in range(xl.shape[-1]):
        x_t = xl[..., t]
        # y + (1 - a)(x - y) = a·y + (1 - a)·x, a the attack coefficient
        # where the level rises, the release coefficient where it falls
        w = torch.where(x_t > y, 1.0 - alpha_a, 1.0 - alpha_r)
        y = torch.lerp(y, x_t, w)
        out.append(y)
    return torch.stack(out, dim=-1), y


def _gain(cfg: AmbiDrcConfig, yl: torch.Tensor) -> torch.Tensor:
    cdb = torch.clamp_min(torch.sqrt(10.0 ** (-yl / 20.0)), SPECTRAL_FLOOR)
    return cdb * 10.0 ** (cfg.out_gain_db / 20.0)


def process(cfg: AmbiDrcConfig, state: AmbiDrcState, x: torch.Tensor):
    """x: (nSH, T) → ((nSH, T), state).  NOTE: the reference applies its gain
    in the (chOrdering, norm) the user selected without converting: the
    omni/W channel is the same in all conventions up to a scale, which the
    threshold absorbs."""
    bank = cfg.afstft
    spec, bank_st = bank.analysis(state.bank, x)  # (nBands, nSH, H)
    spec = spec * 10.0 ** (cfg.in_gain_db / 20.0)
    w = spec[:, 0, :]
    xg = 10.0 * torch.log10(w.real ** 2 + w.imag ** 2 + 2e-13)  # (nBands, H)
    yg = _gain_computer(xg, cfg.theshold_db, cfg.ratio, cfg.knee_db)
    yl, yl_last = _smooth(cfg, state.yl_z1, xg - yg)
    out = spec * _gain(cfg, yl)[:, None, :]
    y, bank_st = bank.synthesis(bank_st, out)
    return y, AmbiDrcState(bank=bank_st, yl_z1=yl_last)


def init_state_batched(cfg: AmbiDrcConfig, n_streams: int,
                       device: torch.device | str | None = None
                       ) -> AmbiDrcStateBatched:
    device = default_device() if device is None else device
    return AmbiDrcStateBatched(
        bank=ri.init_state_batched(cfg.afstft, n_streams, cfg.nsh, cfg.nsh,
                                   device=device),
        yl_z1=torch.zeros((n_streams, cfg.afstft.n_bands),
                          dtype=torch.float32, device=device))


def state_batched_from_numpy(in_tail, ola_tail, yl_z1,
                             device: torch.device | str | None = None
                             ) -> AmbiDrcStateBatched:
    """The batched state (e.g. the JAX package's) from numpy arrays."""
    return AmbiDrcStateBatched(
        bank=ri.AfSTFTStateBatched(in_tail=f32_tensor(in_tail, device),
                                   ola_tail=f32_tensor(ola_tail, device)),
        yl_z1=f32_tensor(yl_z1, device))


def process_ri_batched(cfg: AmbiDrcConfig, state: AmbiDrcStateBatched,
                       x: torch.Tensor, fused: bool = True):
    """Stream-batched process on the packed pipeline: x (S, nSH, T) →
    ((S, nSH, T), state).  The per-(band, slot) gain comes from the omni
    power re² + im² and multiplies both halves of the packed spectrum.
    ``fused=True``: the kernels ``analysis_front_ri`` /
    ``synthesis_back_ri`` (their plain versions on CPU tensors);
    ``fused=False`` the plain filterbank on any device."""
    bank = cfg.afstft
    spec_p, bank_st = ri.analysis_ri_batched(bank, state.bank, x, packed=True,
                                             use_kernel=fused)
    B = spec_p.shape[-1] // 2
    spec_p = spec_p * 10.0 ** (cfg.in_gain_db / 20.0)
    w_pow = spec_p[:, 0, :, :B] ** 2 + spec_p[:, 0, :, B:] ** 2   # (S, H, B)
    xg = 10.0 * torch.log10(w_pow + 2e-13)
    yg = _gain_computer(xg, cfg.theshold_db, cfg.ratio, cfg.knee_db)
    yl, yl_last = _smooth(cfg, state.yl_z1, (xg - yg).transpose(1, 2))
    g = _gain(cfg, yl).transpose(1, 2)[:, None]         # (S, 1, H, B)
    out_p = spec_p * torch.cat([g, g], dim=-1)
    y, bank_st = ri.synthesis_ri_batched(bank, bank_st, out_p, packed=True,
                                         use_kernel=fused)
    return y, AmbiDrcStateBatched(bank=bank_st, yl_z1=yl_last)

