"""ctypes bindings for the native streaming runtime (counterpart of
``spatial_audio_framework_tpu/runtime/native.py``).

The C++ source is the port's own ``csrc/saf_runtime.cpp``.  It is
compiled with ``g++`` at first use into the port's git-ignored ``_build/``
directory, under a name that carries a hash of the source and the flags;
the compiler writes a temporary file that is renamed into place, so a
process never loads a half-written library while another is building it.  When no C++ toolchain
is available the same API is served by pure-Python fallbacks.  All classes
here are host-side real-time plumbing; the DSP runs in torch
(``runtime/stream.py``).
"""
from __future__ import annotations

import ctypes as ct
import hashlib
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

# CODEC_STATUS / PROC_STATUS (_common.h:199-224)
CODEC_STATUS_INITIALISED = 0
CODEC_STATUS_NOT_INITIALISED = 1
CODEC_STATUS_INITIALISING = 2
PROC_STATUS_ONGOING = 0
PROC_STATUS_NOT_ONGOING = 1

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "csrc" / "saf_runtime.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib_lock = threading.Lock()
_lib: Optional[ct.CDLL] = None
_lib_failed = False


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libsaf_runtime-{sys.platform}-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    """Compile the source into ``lib``: to a name of this process's own,
    then renamed into place (atomic on one file system)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if tmp.exists():
            tmp.unlink()


def _load() -> Optional[ct.CDLL]:
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not SRC.is_file():
            _lib_failed = True
            return None
        path = library_path()
        if not path.is_file() and not _build(path):
            _lib_failed = True
            return None
        try:
            lib = ct.CDLL(str(path))
        except OSError:
            _lib_failed = True
            return None
        u64, i64, i32, f32p, dbl, voidp = (
            ct.c_uint64, ct.c_int64, ct.c_int32, ct.POINTER(ct.c_float),
            ct.c_double, ct.c_void_p)
        sigs = {
            "saf_rb_create": (voidp, [u64]),
            "saf_rb_destroy": (None, [voidp]),
            "saf_rb_readable": (u64, [voidp]),
            "saf_rb_writable": (u64, [voidp]),
            "saf_rb_write": (u64, [voidp, f32p, u64, i32]),
            "saf_rb_write_planar": (u64, [voidp, f32p, i64, i64, i64]),
            "saf_rb_read": (u64, [voidp, f32p, u64, i32]),
            "saf_rb_overruns": (u64, [voidp]),
            "saf_framer_create": (voidp, [i32, i32, i32]),
            "saf_framer_destroy": (None, [voidp]),
            "saf_framer_push": (i32, [voidp, f32p, i64, f32p, i64, i32,
                                      f32p]),
            "saf_framer_set_output": (None, [voidp, f32p]),
            "saf_framer_frames_completed": (u64, [voidp]),
            "saf_framer_fifo_idx": (i32, [voidp]),
            "saf_status_create": (voidp, []),
            "saf_status_destroy": (None, [voidp]),
            "saf_status_set_codec": (None, [voidp, i32]),
            "saf_status_get_codec": (i32, [voidp]),
            "saf_status_set_proc": (None, [voidp, i32]),
            "saf_status_get_proc": (i32, [voidp]),
            "saf_status_begin_init": (i32, [voidp, i32]),
            "saf_status_end_init": (None, [voidp]),
            "saf_status_try_begin_process": (i32, [voidp]),
            "saf_status_end_process": (None, [voidp]),
            "saf_clock_create": (voidp, [dbl, i32]),
            "saf_clock_destroy": (None, [voidp]),
            "saf_clock_tick": (None, [voidp, i32]),
            "saf_clock_rtf": (dbl, [voidp]),
            "saf_clock_frames": (u64, [voidp]),
            "saf_runtime_abi_version": (i32, []),
        }
        try:
            for name, (res, args) in sigs.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
        except AttributeError:
            # stale/foreign binary missing a symbol: degrade to the pure-
            # Python fallback instead of crashing the caller
            _lib_failed = True
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the C++ runtime library is loaded (built on demand)."""
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ct.POINTER(ct.c_float))


def _rows(x, n_rows: int, what: str) -> np.ndarray:
    """``x`` as (n_rows, n) float32 rows whose samples lie next to each
    other (a column slice of a wider block stays a view; anything else is
    copied), so the native code can copy a row's run with one memcpy."""
    x = np.asarray(x, np.float32)
    if x.ndim != 2 or x.shape[0] != n_rows:
        # validate BEFORE the native call: it reads and writes whole rows
        # unconditionally — a mismatched channel count is heap corruption,
        # not an exception
        raise ValueError(f"{what} expects ({n_rows}, n) input, got "
                         f"{x.shape}")
    if (x.shape[1] > 1 and x.strides[1] != 4
            or x.strides[0] < 4 * x.shape[1] or x.strides[0] % 4):
        x = np.ascontiguousarray(x)
    return x


def _ld(x: np.ndarray) -> int:
    """The row stride of ``_rows``' result, in floats."""
    return x.strides[0] // 4


class RingBuffer:
    """Lock-free SPSC float ring buffer (audio-callback <-> render-thread
    transport). Falls back to a mutex-guarded deque-less Python ring when the
    native library is unavailable."""

    def __init__(self, capacity_floats: int):
        lib = _load()
        self._lib = lib
        if lib is not None:
            self._h = lib.saf_rb_create(capacity_floats)
            if not self._h:
                raise MemoryError("saf_rb_create failed")
        else:
            cap = 1
            while cap < max(capacity_floats, 2):
                cap *= 2
            self._buf = np.zeros(cap, np.float32)
            self._cap = cap
            self._head = 0
            self._tail = 0
            self._overruns = 0
            self._mtx = threading.Lock()

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", 0):
            self._lib.saf_rb_destroy(self._h)
            self._h = 0

    @property
    def readable(self) -> int:
        if self._lib:
            return int(self._lib.saf_rb_readable(self._h))
        with self._mtx:
            return self._head - self._tail

    @property
    def writable(self) -> int:
        if self._lib:
            return int(self._lib.saf_rb_writable(self._h))
        with self._mtx:
            return self._cap - (self._head - self._tail)

    @property
    def overruns(self) -> int:
        if self._lib:
            return int(self._lib.saf_rb_overruns(self._h))
        return self._overruns

    def write(self, x: np.ndarray, partial: bool = False) -> int:
        x = np.ascontiguousarray(x, np.float32).ravel()
        if self._lib:
            return int(self._lib.saf_rb_write(self._h, _fptr(x), x.size,
                                              int(partial)))
        with self._mtx:
            space = self._cap - (self._head - self._tail)
            n = x.size
            if n > space:
                self._overruns += 1
                if not partial:
                    return 0
                n = space
            idx = (self._head + np.arange(n)) & (self._cap - 1)
            self._buf[idx] = x[:n]
            self._head += n
            return n

    def write_planar(self, x: np.ndarray) -> int:
        """Write a planar block ``x`` (n_ch, n) interleaved by sample, as
        ``write(x.T)`` does, without building ``x.T``: all or nothing.
        Returns the floats written (n_ch · n, or 0 and an overrun)."""
        x = np.asarray(x, np.float32)
        if x.ndim != 2:
            raise ValueError(f"write_planar expects (n_ch, n), got {x.shape}")
        if not self._lib:
            return self.write(x.T)
        x = _rows(x, x.shape[0], "write_planar")
        return int(self._lib.saf_rb_write_planar(self._h, _fptr(x),
                                                 x.shape[0], x.shape[1],
                                                 _ld(x)))

    def read(self, n: int, partial: bool = False) -> np.ndarray:
        out = np.empty(n, np.float32)
        if self._lib:
            got = int(self._lib.saf_rb_read(self._h, _fptr(out), n,
                                            int(partial)))
            return out[:got]
        with self._mtx:
            avail = self._head - self._tail
            if n > avail:
                if not partial:
                    return out[:0]
                n = avail
            idx = (self._tail + np.arange(n)) & (self._cap - 1)
            out[:n] = self._buf[idx]
            self._tail += n
            return out[:n]


class FifoFramer:
    """Regroup arbitrary host block sizes into fixed frames with one frame of
    latency (the reference's inFIFO/outFIFO loop, matrixconv.c:117-151).

    ``n_ch`` channels go in and ``n_ch_out`` (default ``n_ch``) come out:
    the output FIFO holds only the rows a process returns.  Samples move a
    run at a time, up to the next frame boundary, one copy a channel."""

    def __init__(self, n_ch: int, frame_size: int,
                 n_ch_out: Optional[int] = None):
        lib = _load()
        self._lib = lib
        self.n_ch, self.frame_size = n_ch, frame_size
        self.n_ch_out = n_ch if n_ch_out is None else n_ch_out
        if lib is not None:
            self._h = lib.saf_framer_create(n_ch, self.n_ch_out, frame_size)
            if not self._h:
                raise MemoryError("saf_framer_create failed")
        else:
            self._in = np.zeros((n_ch, frame_size), np.float32)
            self._out = np.zeros((self.n_ch_out, frame_size), np.float32)
            self._idx = 0
            self._done = 0

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", 0):
            self._lib.saf_framer_destroy(self._h)
            self._h = 0

    def _push(self, x: np.ndarray, out: np.ndarray, full: np.ndarray) -> int:
        """Push ``x`` (``_rows``) and pull as many samples into ``out`` (the
        same layout); completed frames go to ``full[0], full[1], ...``.
        Returns their count."""
        n = x.shape[1]
        if self._lib:
            return int(self._lib.saf_framer_push(
                self._h, _fptr(x), _ld(x), _fptr(out), _ld(out), n,
                _fptr(full)))
        F, k, s = self.frame_size, 0, 0
        while s < n:
            i = self._idx
            take = min(F - i, n - s)
            self._in[:, i:i + take] = x[:, s:s + take]
            out[:, s:s + take] = self._out[:, i:i + take]
            s += take
            self._idx = i + take
            if self._idx == F:
                self._idx = 0
                self._done += 1
                full[k] = self._in
                k += 1
        return k

    def push(self, x: np.ndarray):
        """x: (n_ch, nSamples) → (out (n_ch_out, nSamples), frames (k, n_ch,
        F))."""
        x = _rows(x, self.n_ch, "push")
        n = x.shape[1]
        out = np.empty((self.n_ch_out, n), np.float32)
        full = np.empty((n // self.frame_size + 1, self.n_ch,
                         self.frame_size), np.float32)
        return out, full[:self._push(x, out, full)]

    def push_chunked(self, x: np.ndarray, process_fn):
        """Exact reference semantics (matrixconv.c:132-151): the frame is
        processed at the instant the FIFO fills, so samples later in the same
        host block already read the new output.  Implemented by splitting the
        push at frame boundaries; process_fn((n_ch, F)) -> (n_ch_out, F) runs
        at each boundary and its result is installed before the next chunk.
        ``x`` may be a column slice of a wider block: it is read in place."""
        x = _rows(x, self.n_ch, "push_chunked")
        n = x.shape[1]
        out = np.empty((self.n_ch_out, n), np.float32)
        no_frame = np.empty((0, self.n_ch, self.frame_size), np.float32)
        s = 0
        while s < n:
            take = min(self.frame_size - self.fifo_idx, n - s)
            fills = take == self.frame_size - self.fifo_idx
            full = (np.empty((1, self.n_ch, self.frame_size), np.float32)
                    if fills else no_frame)
            self._push(x[:, s:s + take], out[:, s:s + take], full)
            if fills:
                self.set_output(process_fn(full[0]))
            s += take
        return out

    def set_output(self, frame: np.ndarray):
        frame = np.ascontiguousarray(frame, np.float32)
        if frame.shape != (self.n_ch_out, self.frame_size):
            raise ValueError(f"set_output expects ({self.n_ch_out}, "
                             f"{self.frame_size}), got {frame.shape}")
        if self._lib:
            self._lib.saf_framer_set_output(self._h, _fptr(frame))
        else:
            self._out[...] = frame

    @property
    def frames_completed(self) -> int:
        if self._lib:
            return int(self._lib.saf_framer_frames_completed(self._h))
        return self._done

    @property
    def fifo_idx(self) -> int:
        if self._lib:
            return int(self._lib.saf_framer_fifo_idx(self._h))
        return self._idx


class StatusFlags:
    """CODEC_STATUS/PROC_STATUS handshake so re-initialisation never races the
    audio thread (_common.h:199-224; spin-wait ambi_bin.c:180-186)."""

    def __init__(self):
        lib = _load()
        self._lib = lib
        if lib is not None:
            self._h = lib.saf_status_create()
        else:
            self._codec = CODEC_STATUS_NOT_INITIALISED
            self._proc = PROC_STATUS_NOT_ONGOING
            self._mtx = threading.Lock()

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", 0):
            self._lib.saf_status_destroy(self._h)
            self._h = 0

    @property
    def codec(self) -> int:
        return (int(self._lib.saf_status_get_codec(self._h)) if self._lib
                else self._codec)

    @property
    def proc(self) -> int:
        return (int(self._lib.saf_status_get_proc(self._h)) if self._lib
                else self._proc)

    def begin_init(self, timeout_ms: int = 10000) -> bool:
        """On timeout the previous codec state is RESTORED (both backends):
        leaving it INITIALISING would wedge try_begin_process into emitting
        silence forever."""
        if self._lib:
            return self._lib.saf_status_begin_init(self._h, timeout_ms) == 0
        with self._mtx:
            prev = self._codec
            self._codec = CODEC_STATUS_INITIALISING
        deadline = time.monotonic() + timeout_ms / 1e3
        while True:
            with self._mtx:
                if self._proc == PROC_STATUS_NOT_ONGOING:
                    return True
            if time.monotonic() > deadline:
                with self._mtx:
                    self._codec = prev
                return False
            time.sleep(0.01)

    def end_init(self):
        if self._lib:
            self._lib.saf_status_end_init(self._h)
        else:
            with self._mtx:
                self._codec = CODEC_STATUS_INITIALISED

    def try_begin_process(self) -> bool:
        if self._lib:
            return bool(self._lib.saf_status_try_begin_process(self._h))
        with self._mtx:
            if self._codec != CODEC_STATUS_INITIALISED:
                return False
            self._proc = PROC_STATUS_ONGOING
            return True

    def end_process(self):
        if self._lib:
            self._lib.saf_status_end_process(self._h)
        else:
            with self._mtx:
                self._proc = PROC_STATUS_NOT_ONGOING


class FrameClock:
    """Monotonic frame counter → real-time factor (audio-sec / wall-sec)."""

    def __init__(self, fs: float, frame_size: int):
        lib = _load()
        self._lib = lib
        self.fs, self.frame_size = fs, frame_size
        if lib is not None:
            self._h = lib.saf_clock_create(fs, frame_size)
        else:
            self._t0 = time.perf_counter()
            self._frames = 0

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", 0):
            self._lib.saf_clock_destroy(self._h)
            self._h = 0

    def tick(self, n_frames: int = 1):
        if self._lib:
            self._lib.saf_clock_tick(self._h, n_frames)
        else:
            self._frames += n_frames

    @property
    def frames(self) -> int:
        return (int(self._lib.saf_clock_frames(self._h)) if self._lib
                else self._frames)

    @property
    def rtf(self) -> float:
        if self._lib:
            return float(self._lib.saf_clock_rtf(self._h))
        wall = time.perf_counter() - self._t0
        return (self._frames * self.frame_size / self.fs / wall
                if wall > 0 else 0.0)
