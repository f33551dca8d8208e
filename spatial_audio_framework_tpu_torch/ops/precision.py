"""Matmul precision vocabulary of the port (counterpart of
``spatial_audio_framework_tpu/ops/precision.py``).

The mode names are the reference's: ``"default"``, ``"high"`` and
``"highest"``, with ``"f32x3"`` accepted as an alias of ``"high"``.  On the
TPU they select 1, 3 or 6 bf16 passes of the MXU.  In this port every mode
is computed in full IEEE fp32, which is at least as exact as each mode
promises:

* the hand-written CUDA kernels (``csrc/``) use fp32 FMAs only, no tensor
  cores and no TF32;
* the plain PyTorch versions run their matmuls inside :func:`fp32_matmul`,
  which sets ``torch.backends.cuda.matmul.allow_tf32 = False`` (and the
  cuDNN flag) for their duration.

TF32 variants of ``"default"``/``"high"`` are later performance work.  The
port reads no environment variable: an unset mode resolves to ``"high"``,
the reference's process default.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

VALID_MODES = ("default", "high", "highest")
_ALIASES = {"f32x3": "high"}
_DEFAULT_MODE = "high"


def normalize_mode(mode: str) -> str:
    """Canonical mode string; raises ValueError with the valid vocabulary."""
    m = str(mode).lower()
    m = _ALIASES.get(m, m)
    if m not in VALID_MODES:
        raise ValueError(
            f"invalid MXU precision mode {mode!r}: expected one of "
            f"{'|'.join(VALID_MODES)} (or the alias 'f32x3' == 'high')")
    return m


def resolve_mode(mode: Optional[str] = None) -> str:
    """Per-call mode resolution: an explicit argument wins, else 'high'."""
    return _DEFAULT_MODE if mode is None else normalize_mode(mode)


@contextlib.contextmanager
def fp32_matmul() -> Iterator[None]:
    """Run the enclosed matmuls in full fp32: TF32 off for cuBLAS and
    cuDNN, restored on exit."""
    cuda_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
