"""Timing, progress reporting and profiling hooks (counterpart of
``spatial_audio_framework_tpu/utils/profiling.py``).

The reference's observability surface is (a) per-unit-test wall timing
(test/src/saf_test.c:54-70) and (b) the init-progress API every example
exposes (``*_getProgressBar0_1`` / ``*_getProgressBarText``, e.g.
roombinauraliser.h:270-278, updated throughout initCodec).  Here:

* :class:`Timer` — wall-clock context with named laps.
* :class:`ProgressReporter` — thread-safe progress fraction + text, the
  analogue of the progressBar getters.
* :func:`trace_annotation` — a ``torch.profiler.record_function`` span, so
  the block appears among ``torch.profiler``'s events (a no-op if the
  profiler cannot be set up).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

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


@contextlib.contextmanager
def trace_annotation(name: str):
    """``torch.profiler.record_function(name)`` around the block, else a
    no-op — safe to leave in production code paths.  Only the
    import/constructor is guarded: wrapping the yield in the except would
    catch exceptions raised by the WITH-BODY and re-yield, destroying the
    user's traceback ("generator didn't stop after throw()")."""
    try:
        from torch.profiler import record_function

        ann = record_function(name)
    except Exception:
        yield
        return
    with ann:
        yield
