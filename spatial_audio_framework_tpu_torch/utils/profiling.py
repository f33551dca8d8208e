"""Timing, progress reporting and profiling hooks (counterpart of
``spatial_audio_framework_tpu/utils/profiling.py``).

The reference's observability surface is (a) per-unit-test wall timing
(test/src/saf_test.c:54-70) and (b) the init-progress API every example
exposes (``*_getProgressBar0_1`` / ``*_getProgressBarText``, e.g.
roombinauraliser.h:270-278, updated throughout initCodec).  Here:

* :class:`Timer` — wall-clock context with named laps.
* :class:`ProgressReporter` — thread-safe progress fraction + text, the
  analogue of the progressBar getters.
* :func:`span` (and :func:`spanned`, its decorator form) — a named span of
  the program's render path among ``torch.profiler``'s events, on the
  profiler's clock; :func:`count` / :func:`counters` /
  :func:`reset_counters` — the program's counters.  Both are on only while
  a ``torch.profiler`` records, and cost one check otherwise.
  :func:`trace_annotation` is :func:`span`.

A span's name is ``<layer>.<what>``, the layer as the benchmark names it
(``models``, ``ops``, ``kernels``); nesting gives each span its parent.
While on, each span also adds its host time, less that of the spans
nested in it, to the counter ``<layer>.host_ns``.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast


class Timer:
    """Wall-clock timer with named laps (saf_test.c RUN_TEST timing)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._laps: List[Tuple[str, float]] = []

    def lap(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - (self._t0 + sum(d for _, d in self._laps))
        self._laps.append((name, dt))
        return dt

    @property
    def total(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def laps(self) -> Dict[str, float]:
        return dict(self._laps)

    def report(self) -> str:
        lines = [f"  {n}: {1e3 * d:.2f} ms" for n, d in self._laps]
        return "\n".join(lines + [f"  total: {1e3 * self.total:.2f} ms"])


class ProgressReporter:
    """Progress fraction + text, readable from another thread
    (``*_getProgressBar0_1`` / ``*_getProgressBarText``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._text = ""

    def set(self, value: float, text: Optional[str] = None):
        with self._lock:
            self._value = float(min(max(value, 0.0), 1.0))
            if text is not None:
                self._text = text

    @property
    def progress_0_1(self) -> float:
        with self._lock:
            return self._value

    @property
    def text(self) -> str:
        with self._lock:
            return self._text

    def done(self):
        self.set(1.0, "done")


_OFF = contextlib.nullcontext()
_counts: Dict[str, int] = {}
_lock = threading.Lock()
_open = threading.local()     # per thread: the host ns of each open span's
                              # nested spans, innermost last
_tracing = torch.autograd._profiler_enabled


class _Span:
    """A span while a profiler records: a function-scope record function
    (a host event with the span's name, and the parent of every operation
    and launch inside it; unlike ``record_function``'s user scope it puts
    no annotation on the device's timeline), and its self time counted."""

    __slots__ = ("name", "key", "rf", "t0")

    def __init__(self, name: str):
        self.name = name
        self.key = name.split(".", 1)[0] + ".host_ns"

    def __enter__(self):
        self.rf = _RecordFunctionFast(self.name)
        self.rf.__enter__()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        stack.append(0)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        stack = _open.stack
        nested = stack.pop()
        if stack:
            stack[-1] += dt
        _add(self.key, dt - nested)
        return self.rf.__exit__(*exc)


def span(name: str):
    """The span ``name`` around a block of the program while a
    ``torch.profiler`` records; otherwise one shared no-op context (no
    record function is built, nothing is allocated)."""
    return _Span(name) if _tracing() else _OFF


def spanned(name: str):
    """Decorator: the function's every call, entry to return, in
    :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _tracing():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


trace_annotation = span


def _add(name: str, n: int) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if _tracing():
        _add(name, n)


def counters() -> Dict[str, int]:
    """The counters: each span layer's ``<layer>.host_ns``,
    ``ops.state_bytes`` (the bytes the ops layer copies to carry state or
    to lay inputs out for a kernel), ``ops.spectra_bytes`` (the spectra
    the wide route writes between its two kernels) and ``kernels.frames``
    (the frames the one-pass render kernel folds and transforms, from the
    shapes of each call: streams × input channels × passes over the ears ×
    the frames of each hop tile).  The kernels' launches are counted where
    the kernels are declared, not here."""
    with _lock:
        return dict(_counts)


def reset_counters() -> None:
    """Zero every counter of :func:`counters`."""
    with _lock:
        _counts.clear()
