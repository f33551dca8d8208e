"""Build and load the port's CUDA kernels.

``spatial_audio_framework_tpu_torch/csrc/*.cu`` are compiled at first use
with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source, all started
together, and linked into one shared library with a plain C interface,
which is loaded with ``ctypes``.  The library goes into the package's
git-ignored ``_build/`` directory under a name that carries a hash of the
sources, the headers they include (``csrc/*.cuh``) and the flags, so a
changed source or header is always rebuilt and an unchanged one is built
once.  ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills
per kernel) is kept beside it as ``<name>.log``.

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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


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
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(SRC_DIR.glob("*.cuh")):
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
    tag = f"{lib.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    try:
        for src, proc in procs:
            out, _ = proc.communicate(timeout=600)
            log.append(f"== {src.name} (nvcc exit {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
    finally:
        for _, proc in procs:  # none outlives a failed or timed-out build
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True, timeout=600)
        log.append(f"== link (nvcc exit {link.returncode})\n"
                   f"{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    text = "\n".join(log)
    lib.with_suffix(".log").write_text(text)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{text}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return seconds


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's types."""
    build()
    lib = ctypes.CDLL(str(library_path()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.saf_render_full_ri.argtypes = [ptr] * 10 + [i32] * 7 + [ptr]
    lib.saf_render_full_ri.restype = i32
    lib.saf_analysis_front_ri.argtypes = [ptr] * 6 + [i32] * 3 + [ptr]
    lib.saf_analysis_front_ri.restype = i32
    lib.saf_synthesis_back_ri.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    lib.saf_synthesis_back_ri.restype = i32
    lib.saf_analysis_front_dg_ri.argtypes = [ptr] * 8 + [i32] * 3 + [ptr]
    lib.saf_analysis_front_dg_ri.restype = i32
    lib.saf_render_decode_synthesis_ri.argtypes = [ptr] * 9 + [i32] * 7 + [ptr]
    lib.saf_render_decode_synthesis_ri.restype = i32
    lib.saf_render_decode_synthesis_dg_ri.argtypes = ([ptr] * 11 + [i32] * 6
                                                      + [ptr])
    lib.saf_render_decode_synthesis_dg_ri.restype = i32
    lib.saf_hrtf_taps_ri.argtypes = ([ptr] * 9 + [i32] * 5
                                     + [ctypes.c_float] * 2 + [i32, ptr])
    lib.saf_hrtf_taps_ri.restype = i32
    lib.saf_wide_mix_ri.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    lib.saf_wide_mix_ri.restype = i32
    lib.saf_cuda_error_string.argtypes = [i32]
    lib.saf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.saf_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
