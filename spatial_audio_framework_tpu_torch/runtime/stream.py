"""StreamRunner — the executor tying the native runtime plumbing to a
per-frame process function (counterpart of
``spatial_audio_framework_tpu/runtime/stream.py``).

Mirrors the reference's plugin lifecycle (create/initCodec/process,
examples/include/_common.h): arbitrary host block sizes are FIFO-framed to
the model's fixed frame size (matrixconv.c:117-151), a (re)initialisation
thread coordinates with the audio path through the CODEC/PROC status
handshake (ambi_bin.c:180-186), silence is emitted while the codec
initialises (ambi_bin.c:475-477), and a frame clock tracks the achieved
real-time factor.

Frames go in and out as numpy arrays.  The frame function may return a
torch tensor: a tensor on the card is read back through a pinned host
buffer (one device-to-host copy and one wait per frame, the contract's only
host wait; a pageable copy would serialise host and device), and the
seconds spent in that read are kept in :attr:`StreamRunner.read_s`.
:func:`torch_frame_fn` wraps a torch frame function so that its input
reaches the card through a pinned buffer too.

Optionally runs decoupled: :meth:`StreamRunner.start` spawns a render
thread fed by lock-free ring buffers, so a real audio callback only ever
touches ``push`` / ``pull``; the device work happens on the render thread.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import default_device
from spatial_audio_framework_tpu_torch.runtime.native import (FifoFramer,
                                                              FrameClock,
                                                              RingBuffer,
                                                              StatusFlags)

Frame = Union[np.ndarray, torch.Tensor]


class _PinnedReader:
    """Device → host reads through one pinned buffer per (shape, device);
    the wait on its copy's event is the only host wait of a frame."""

    def __init__(self):
        self._bufs = {}

    def __call__(self, y: Frame) -> np.ndarray:
        if not isinstance(y, torch.Tensor):
            return np.asarray(y, np.float32)
        if y.device.type != "cuda":
            return y.detach().to(torch.float32).numpy()
        key = (tuple(y.shape), y.device)
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = (
                torch.empty(y.shape, dtype=torch.float32, pin_memory=True),
                torch.cuda.Event())
        host, done = buf
        host.copy_(y, non_blocking=True)
        done.record(torch.cuda.current_stream(y.device))
        done.synchronize()
        return host.numpy()


def torch_frame_fn(fn: Callable[[torch.Tensor], torch.Tensor], n_ch: int,
                   frame_size: int, device: torch.device | str | None = None
                   ) -> Callable[[np.ndarray], torch.Tensor]:
    """Wrap ``fn((n_ch, frame_size) tensor) -> tensor`` for
    :class:`StreamRunner`: each numpy frame is staged in a pinned host
    buffer and copied to ``device`` (default: the card) without a host
    wait.  A frame that is the transpose of a contiguous (frame_size, n_ch)
    array (the render thread's frame, as it lies in the interleaved ring)
    is staged as it lies and transposed on the card; ``fn`` gets the same
    contiguous tensor either way.  Reusing the staging buffers is safe
    because the runner waits for each frame's output before it hands over
    the next frame."""
    device = torch.device(default_device() if device is None else device)
    if device.type != "cuda":
        return lambda f: fn(torch.from_numpy(np.ascontiguousarray(
            f, np.float32)).to(device))
    dev = torch.empty((n_ch, frame_size), dtype=torch.float32, device=device)
    pinned = {}     # a staging buffer per layout, made at first use

    def run(f: np.ndarray) -> torch.Tensor:
        lies = not f.flags.c_contiguous and f.T.flags.c_contiguous
        src = f.T if lies else f
        host = pinned.get(src.shape)
        if host is None:
            host = pinned[src.shape] = torch.empty(
                src.shape, dtype=torch.float32, pin_memory=True)
        host.numpy()[...] = src
        if lies:
            dev.copy_(host.to(device, non_blocking=True).T)
        else:
            dev.copy_(host, non_blocking=True)
        return fn(dev)

    return run


class StreamRunner:
    def __init__(self, process_frame: Callable[[np.ndarray], Frame],
                 n_ch_in: int, n_ch_out: int, frame_size: int = 128,
                 fs: float = 48000.0, ring_frames: int = 64):
        """process_frame: (n_ch_in, frame_size) float32 -> (n_ch_out,
        frame_size), numpy or a tensor; typically closes over the model's
        state and updates it."""
        self.process_frame = process_frame
        self.n_ch_in, self.n_ch_out = n_ch_in, n_ch_out
        self.frame_size = frame_size
        self.status = StatusFlags()
        self.clock = FrameClock(fs, frame_size)
        self.read_s = 0.0      # seconds spent reading frames off the device
        self._read = _PinnedReader()
        self._silence = np.zeros((n_ch_out, frame_size), np.float32)
        self._framer = FifoFramer(n_ch_in, frame_size, n_ch_out)
        self._in_rb = RingBuffer(ring_frames * n_ch_in * frame_size)
        self._out_rb = RingBuffer(ring_frames * n_ch_out * frame_size)
        self._render_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.status.end_init()  # codec ready once process_frame is supplied

    # -- codec re-initialisation ---------------------------------------------

    def reinit(self, init_fn: Callable[[], Callable[[np.ndarray], Frame]],
               timeout_ms: int = 10000) -> bool:
        """Swap the process function without racing the audio path
        (the initCodec handshake)."""
        if not self.status.begin_init(timeout_ms):
            return False
        try:
            self.process_frame = init_fn()
        finally:
            self.status.end_init()
        return True

    def _run_frame(self, f: np.ndarray) -> np.ndarray:
        y = self.process_frame(f)
        t0 = time.perf_counter()
        y = self._read(y)
        self.read_s += time.perf_counter() - t0
        return y

    # -- synchronous (in-callback) path --------------------------------------

    def process_block(self, x: np.ndarray) -> np.ndarray:
        """x: (n_ch_in, nSamples), any nSamples → (n_ch_out, nSamples) with
        frame_size samples of FIFO latency."""
        def run(f):
            y = self._silence
            if self.status.try_begin_process():
                try:
                    y = self._run_frame(f)
                finally:
                    self.status.end_process()
            self.clock.tick(1)
            return y

        return self._framer.push_chunked(x, run)

    # -- decoupled render-thread path ----------------------------------------

    def start(self):
        """Spawn the render thread (audio callback then uses push/pull)."""
        if self._render_thread is not None:
            return
        self._stop.clear()
        self._render_thread = threading.Thread(target=self._render_loop,
                                               daemon=True)
        self._render_thread.start()

    def stop(self):
        self._stop.set()
        if self._render_thread is not None:
            self._render_thread.join()
            self._render_thread = None

    def push(self, x: np.ndarray) -> int:
        """Audio-callback producer: (n_ch_in, n) samples into the input ring.
        Returns samples accepted (never blocks)."""
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[0] != self.n_ch_in:
            raise ValueError(f"push expects ({self.n_ch_in}, n) input, got "
                             f"{x.shape}")
        return self._in_rb.write_planar(x) // self.n_ch_in

    def pull(self, n: int) -> np.ndarray:
        """Audio-callback consumer: up to n samples from the output ring →
        (n_ch_out, m)."""
        flat = self._out_rb.read(n * self.n_ch_out, partial=True)
        m = flat.size // self.n_ch_out
        return flat[:m * self.n_ch_out].reshape(m, self.n_ch_out).T

    def _render_loop(self):
        need = self.frame_size * self.n_ch_in
        while not self._stop.is_set():
            if self._in_rb.readable < need:
                self._stop.wait(0.0005)
                continue
            # the frame as it lies in the ring, (F, n_ch_in), handed on as
            # its (n_ch_in, F) transpose: a view, not a copy
            frame = self._in_rb.read(need).reshape(self.frame_size,
                                                   self.n_ch_in).T
            y = self._silence
            if self.status.try_begin_process():
                try:
                    y = self._run_frame(frame)
                finally:
                    self.status.end_process()
            self._out_rb.write_planar(y)
            self.clock.tick(1)
