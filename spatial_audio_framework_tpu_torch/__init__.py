"""PyTorch + CUDA port of ``spatial_audio_framework_tpu``.

The JAX package beside this one is the reference; module names mirror it
(``ops.afstft_ri`` here is the counterpart of
``spatial_audio_framework_tpu.ops.afstft_ri`` there).  Plain tensor code is
PyTorch; the TPU's Pallas kernels become hand-written CUDA kernels under
``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).

This package imports ``torch``, numpy and scipy, never ``jax`` and never the
JAX package.  It reads its own data files (``data/``, :func:`data_path`),
copies of the JAX package's, and the real-time runtime builds from its own
C++ source (``csrc/saf_runtime.cpp``, ``runtime/native.py``).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

_DATA_DIR = Path(__file__).resolve().parent / "data"


def data_path(name: str) -> Path:
    """Path of one of the port's data files (``data/``: tables, prototype
    filters, the default HRIRs and presets)."""
    path = _DATA_DIR / name
    if not path.is_file():
        raise FileNotFoundError(f"{path}: no such data file in the port")
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
