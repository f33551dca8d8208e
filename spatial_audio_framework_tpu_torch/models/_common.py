"""Shared vocabulary for the renderer models (counterpart of
``spatial_audio_framework_tpu/models/_common.py``): channel-order and
normalisation names, frame constants and config validation.

Every model follows the reference's pattern: a frozen ``Config``, a host
``design(cfg) -> weights``, ``init_state`` and a block ``process`` on
tensors with explicit state.
"""
from __future__ import annotations

import numpy as np
import torch

MAX_SH_ORDER = 7                 # _common.h:50
MAX_NUM_CHANNELS = 64            # _common.h:228
DEFAULT_FRAME_SIZE = 128         # per-example FRAME_SIZE
NUM_EARS = 2

# CH_ORDER (_common.h:57-61)
CH_ACN = "acn"
CH_FUMA = "fuma"
# NORM_TYPES (_common.h:72-77)
NORM_N3D = "n3d"
NORM_SN3D = "sn3d"
NORM_FUMA = "fuma"

_CH = {CH_ACN: 0, CH_FUMA: 1}
_NORM = {NORM_N3D: 0, NORM_SN3D: 1, NORM_FUMA: 2}


class SafConfigError(ValueError):
    """Invalid Config field (the analogue of the reference's setter clamps +
    saf_print_error paths)."""


def validate_config(cfg) -> None:
    """saf-style validation of the common Config fields: orders bounded by
    MAX_SH_ORDER, channel counts by MAX_NUM_CHANNELS, known conventions, a
    power-of-two hop and a known precision mode.  Raises SafConfigError."""
    def err(msg):
        raise SafConfigError(f"{type(cfg).__name__}: {msg}")

    def intval(f, v):
        # reject non-integral values rather than truncating them
        if int(v) != v:
            err(f"{f}={v} must be an integer")
        return int(v)

    for f in ("order", "master_order", "sh_order", "input_order",
              "output_order", "decoding_order", "analysis_order"):
        v = getattr(cfg, f, None)
        if v is not None and not (1 <= intval(f, v) <= MAX_SH_ORDER):
            err(f"{f}={v} out of range [1, MAX_SH_ORDER={MAX_SH_ORDER}]")
    fs = getattr(cfg, "fs", None)
    if fs is not None and not (float(fs) > 0):
        err(f"fs={fs} must be positive")
    for f in ("n_sources", "n_channels", "n_loudspeakers", "n_receivers",
              "n_inputs", "n_outputs", "n_beams", "n_ch"):
        v = getattr(cfg, f, None)
        if v is not None and not (1 <= intval(f, v) <= MAX_NUM_CHANNELS):
            err(f"{f}={v} out of range [1, MAX_NUM_CHANNELS="
                f"{MAX_NUM_CHANNELS}]")
    ch = getattr(cfg, "ch_ordering", None)
    if ch is not None and ch not in _CH:
        err(f"ch_ordering={ch!r} not one of {sorted(_CH)}")
    nm = getattr(cfg, "norm", None)
    if nm is not None and nm not in _NORM:
        err(f"norm={nm!r} not one of {sorted(_NORM)}")
    hop = getattr(cfg, "hop", None)
    if hop is not None and (int(hop) <= 0 or (int(hop) & (int(hop) - 1))):
        err(f"hop={hop} must be a positive power of two")
    mxu = getattr(cfg, "mxu_precision", None)
    if mxu is not None:
        from spatial_audio_framework_tpu_torch.ops import precision as _prec
        try:
            _prec.normalize_mode(mxu)
        except ValueError as e:
            err(str(e))


def round_half_up(x: torch.Tensor) -> torch.Tensor:
    """The C's gain-table index rounding ``(int)(x + 0.5f)`` for x ≥ 0
    (e.g. panner.c:242-246, binauraliser_internal.c:76-80): round half UP,
    unlike torch.round's round half to even (112.5 → 113, not 112)."""
    return torch.floor(x + 0.5)


def table_row(row: torch.Tensor, n_rows: int):
    """A gain-table row computed in floating point (``elev_idx * n_azi +
    azi_idx`` of :func:`round_half_up` indices) → (row as int64, clamped
    into the table; ``outside`` mask), as the JAX package converts and
    gathers it (``astype(int32)`` then ``jnp.take``), with device ops only:
    a NaN row is row 0 (XLA's float → int conversion), a negative row
    counts from the table's end, and a row still outside the table is
    flagged ``outside`` (``jnp.take`` fills it with NaN; the caller masks
    what it gathered there).  The returned row always indexes the table, so
    no direction can raise on the CPU or assert on the card."""
    row = torch.nan_to_num(row, nan=0.0)
    row = row.clamp(-n_rows - 1, n_rows).long()
    row = torch.where(row < 0, row + n_rows, row)
    outside = (row < 0) | (row >= n_rows)
    return row.clamp(0, n_rows - 1), outside


def input_conversion_mtx(order: int, ch_ordering: str, norm: str) -> np.ndarray:
    """(nSH, nSH) matrix converting an input SH frame in (ch_ordering, norm)
    to (ACN, N3D) — the conversions at the top of every example's process()
    (e.g. ambi_bin.c:420-430), as one matrix to fold into the decoder."""
    from spatial_audio_framework_tpu_torch.modules import hoa

    nsh = (order + 1) ** 2
    M = np.eye(nsh, dtype=np.float32)
    if _CH[ch_ordering] == _CH[CH_FUMA]:
        P = np.zeros((nsh, nsh), np.float32)
        # FuMa WXYZ → ACN WYZX (saf_hoa.c:58-61); FuMa is 1st order only —
        # rows ≥ 4 stay zero (saf_hoa.c:67-69 memset)
        P[0, 0] = P[1, 2] = P[2, 3] = P[3, 1] = 1.0
        M = P @ M
    g = hoa.norm_gains(order, _NORM[norm], _NORM[NORM_N3D])
    return (g[:, None] * M).astype(np.float32)


def output_conversion_mtx(order: int, ch_ordering: str, norm: str) -> np.ndarray:
    """(nSH, nSH) matrix converting (ACN, N3D) output to (ch_ordering, norm)
    — the conversions at the bottom of the encoder examples."""
    from spatial_audio_framework_tpu_torch.modules import hoa

    nsh = (order + 1) ** 2
    M = np.eye(nsh, dtype=np.float32)
    if _CH[ch_ordering] == _CH[CH_FUMA]:
        P = np.zeros((nsh, nsh), np.float32)
        # ACN WYZX → FuMa WXYZ (saf_hoa.c:63-66: fuma[1]=acn[3],
        # fuma[2]=acn[1], fuma[3]=acn[2]); rows ≥ 4 stay zero
        P[0, 0] = P[1, 3] = P[2, 1] = P[3, 2] = 1.0
        M = P @ M
    g = hoa.norm_gains(order, _NORM[NORM_N3D], _NORM[norm])
    return (M * g[None, :]).astype(np.float32)
