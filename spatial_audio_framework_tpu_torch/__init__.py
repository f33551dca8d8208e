"""PyTorch + CUDA port of ``spatial_audio_framework_tpu``.

The JAX package beside this one is the reference; module names mirror it
(``ops.afstft_ri`` here is the counterpart of
``spatial_audio_framework_tpu.ops.afstft_ri`` there).  Plain tensor code is
PyTorch; the TPU's Pallas kernels become hand-written CUDA kernels under
``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).

This package imports ``torch``, numpy and scipy, never ``jax`` and never the
JAX package: importing ``spatial_audio_framework_tpu`` pulls in jax, so the
shared data files are read by path (:func:`data_path`).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

_DATA_DIR = (Path(__file__).resolve().parent.parent
             / "spatial_audio_framework_tpu" / "data")


def data_path(name: str) -> Path:
    """Path of a data file shared with the JAX package (read, never
    imported: see the module docstring)."""
    path = _DATA_DIR / name
    if not path.is_file():
        raise FileNotFoundError(
            f"{path}: the port reads its data files from the JAX package's "
            "data directory beside it; run from a full checkout")
    return path


def default_device() -> torch.device:
    """The device an entry point runs on when the caller names none: the
    first CUDA card.  Raises without one; the CPU is used only when a
    caller asks for it (``device="cpu"``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


def f32_tensor(a, device: torch.device | str | None = None) -> torch.Tensor:
    """A contiguous float32 copy of an array-like (numpy, possibly
    read-only, cached or Fortran-ordered) on ``device`` (default: the card,
    :func:`default_device`).  Contiguity matters: ``torch.tensor`` keeps a
    Fortran-ordered array's strides, and the CUDA kernels index their
    inputs as row-major."""
    return torch.tensor(np.ascontiguousarray(a, dtype=np.float32),
                        device=default_device() if device is None else device)
