"""Build and load the port's CUDA kernels.

``spatial_audio_framework_tpu_torch/csrc/*.cu`` are compiled at first use
with ``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain
C interface, which is loaded with ``ctypes``.  The library goes into the
package's git-ignored ``_build/`` directory under a name that carries a
hash of the sources and flags, so a changed source is always rebuilt and an
unchanged one is built once.  ``nvcc``'s ``-Xptxas -v`` report (registers,
shared memory, spills per kernel) is kept beside it as ``<name>.log``.

Nothing here runs at import: building needs ``nvcc``, which only the
machine with the card has.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "$CUDA_HOME/bin, default /usr/local/cuda/bin); the "
                       "port's CUDA kernels are built at first use")


def _sources() -> list[Path]:
    srcs = sorted(SRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsaf_torch_kernels-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile the sources if their library is missing; returns the seconds
    spent compiling (0.0 when the library was already built)."""
    lib = library_path()
    if lib.is_file():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    lib.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return seconds


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's types."""
    build()
    lib = ctypes.CDLL(str(library_path()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.saf_render_full_ri.argtypes = [ptr] * 13 + [i32] * 4 + [ptr]
    lib.saf_render_full_ri.restype = i32
    lib.saf_cuda_error_string.argtypes = [i32]
    lib.saf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.saf_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
