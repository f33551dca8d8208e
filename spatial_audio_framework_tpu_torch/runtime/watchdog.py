"""Device wedge detection and a watchdog that makes entry points
un-losable (counterpart of ``spatial_audio_framework_tpu/runtime/watchdog.py``).

A blocking device-to-host read has no timeout in torch, and a Python signal
handler cannot run while the main thread is blocked inside it, so the only
reliable recovery is a *separate watchdog thread* that observes wall-clock
progress and force-exits the process after emitting a diagnostic.

Two tools:

* :func:`probe_device` — fence the card with one tiny kernel and
  ``torch.cuda.synchronize()`` on the calling thread, with a watchdog
  thread enforcing the timeout; on a hang it reports via ``on_wedge`` and
  force-exits.  Call it at entry-point startup so a wedged card is
  detected in seconds, not after an external ``timeout`` kills the run.
* :class:`Watchdog` — a daemon thread monitoring (a) a per-operation
  deadline (``begin(name, timeout_s)`` / ``end()``) and (b) a global
  wall-clock budget.  On expiry it calls the registered
  ``on_expire(reason)`` callback (e.g. print a partial result JSON) and
  then ``os._exit(exit_code)``: ``os._exit`` because the wedged thread can
  never be joined.

Reference analogue for the always-report discipline: the per-test timing of
the reference's test/src/saf_test.c:57-70 — numbers are printed even when a
test fails.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional

import torch

from spatial_audio_framework_tpu_torch import default_device


class DeviceWedgeError(RuntimeError):
    """The device did not complete a trivial fence in time."""


def _default_fence(device: torch.device) -> None:
    v = torch.ones((8, 128), dtype=torch.float32, device=device)
    float((v * 2.0).sum())
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe_device(timeout_s: float = 60.0, reps: int = 3,
                 on_wedge: Optional[Callable[[str], None]] = None,
                 exit_code: int = 0,
                 exit_fn: Callable[[int], None] = os._exit,
                 _fence_fn: Optional[Callable[[], None]] = None,
                 device: torch.device | str | None = None) -> float:
    """Fence ``device`` (default: the card) under a timeout: one tiny
    kernel (``sum(v * 2)`` of an (8, 128) float32 tensor) and
    ``torch.cuda.synchronize()``, ``reps`` times on the CALLING thread;
    returns the median seconds per fence (launch + wait: the round trip of
    cheap work).

    The timeout is enforced by a daemon :class:`Watchdog` thread: if the
    probe has not finished within ``timeout_s``, the watchdog calls
    ``on_wedge(reason)`` (default: print the reason to stderr) and then
    force-exits the process with ``exit_code`` — the blocked thread can
    never be recovered, and exit-with-a-diagnostic beats an external kill.
    The first call includes the CUDA context's start, so give a cold
    process a generous timeout (>= 60 s).

    Raises :class:`DeviceWedgeError` only for probe *errors* (the fence
    raised); a hang never raises — it exits through the watchdog.
    """
    def default_on_wedge(reason: str) -> None:  # pragma: no cover - trivial
        print(f"probe_device: {reason}", file=sys.stderr, flush=True)

    if _fence_fn is None:
        dev = torch.device(default_device() if device is None else device)
        fence = lambda: _default_fence(dev)  # noqa: E731
    else:
        fence = _fence_fn
    wd = Watchdog(on_expire=on_wedge or default_on_wedge, budget_s=None,
                  exit_code=exit_code, exit_fn=exit_fn)
    wd.begin("device_probe (one tiny kernel + torch.cuda.synchronize)",
             timeout_s)
    try:
        fence()  # context start + first fence
        ts = []
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            fence()
            ts.append(time.perf_counter() - t0)
    except Exception as e:
        raise DeviceWedgeError(f"device probe failed: {e!r}") from e
    finally:
        wd.end()
        wd.stop()
    ts.sort()
    return ts[len(ts) // 2]


class Watchdog:
    """Daemon thread enforcing per-operation deadlines + a global budget.

    >>> wd = Watchdog(budget_s=720, on_expire=dump_partial_json)
    >>> wd.begin("flagship", timeout_s=300)   # hang here -> on_expire + exit
    >>> ...
    >>> wd.end()

    ``on_expire(reason: str)`` runs on the watchdog thread; keep it simple
    (print + flush).  After it returns the process exits with ``exit_code``
    (default 0: a diagnosed partial result is a *successful* report, and
    whoever runs the process must receive a parseable line rather than the
    silence of an external timeout).
    """

    def __init__(self, on_expire: Callable[[str], None],
                 budget_s: Optional[float] = None,
                 exit_code: int = 0, poll_s: float = 0.5,
                 exit_fn: Callable[[int], None] = os._exit):
        self._on_expire = on_expire
        self._exit_code = exit_code
        self._exit_fn = exit_fn
        self._poll_s = poll_s
        self._lock = threading.Lock()
        self._op: Optional[str] = None
        self._op_deadline: Optional[float] = None
        self._op_timeout_s: Optional[float] = None
        self._budget_deadline = (time.monotonic() + budget_s
                                 if budget_s else None)
        self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="saf-watchdog")
        self._thread.start()

    def begin(self, name: str, timeout_s: float) -> None:
        with self._lock:
            self._op = name
            self._op_deadline = time.monotonic() + timeout_s
            self._op_timeout_s = timeout_s

    def end(self) -> None:
        with self._lock:
            self._op = None
            self._op_deadline = None
            self._op_timeout_s = None

    def budget_remaining_s(self) -> float:
        if self._budget_deadline is None:
            return float("inf")
        return self._budget_deadline - time.monotonic()

    def stop(self) -> None:
        with self._lock:
            self._stopped = True

    # -- internals ----------------------------------------------------------
    def _run(self) -> None:
        while not self._stopped:
            time.sleep(self._poll_s)
            now = time.monotonic()
            # expiry is DECIDED and latched under the same lock begin()/
            # end()/stop() take, so an op that completed (or a stop()) in
            # the last poll interval can never be force-exited after the
            # fact — op state and the _stopped latch change atomically
            reason = None
            with self._lock:
                if self._stopped:
                    return
                if (self._budget_deadline is not None
                        and now > self._budget_deadline):
                    reason = ("wall-clock budget exhausted"
                              + (f" during '{self._op}'" if self._op else ""))
                elif (self._op_deadline is not None
                        and now > self._op_deadline):
                    reason = (f"operation '{self._op}' exceeded its "
                              f"{self._op_timeout_s:g}s deadline "
                              "(device wedge?)")
                if reason is not None:
                    self._stopped = True
            if reason is not None:
                try:
                    self._on_expire(reason)
                finally:
                    self._exit_fn(self._exit_code)
