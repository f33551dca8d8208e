"""The port's real-time runtime against the JAX package's: the native ring
buffer, FIFO framer, status handshake and frame clock (and their
pure-Python fallbacks), the library's build into the git-ignored
``_build/``, StreamRunner over the batched ambi_bin render (synchronous and
on the render thread), the watchdog and the device probe, and
render_signal."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import ambi_bin as jab
from spatial_audio_framework_tpu.parallel.streaming import (
    render_signal as jax_render_signal)
from spatial_audio_framework_tpu.runtime import StreamRunner as JaxRunner
from spatial_audio_framework_tpu_torch.models import ambi_bin as tab
from spatial_audio_framework_tpu_torch.parallel.streaming import render_signal
from spatial_audio_framework_tpu_torch.runtime import (
    CODEC_STATUS_INITIALISED, FifoFramer, FrameClock, RingBuffer, StatusFlags,
    StreamRunner, Watchdog, native, native_available, probe_device,
    torch_frame_fn, watchdog)

RENDER_TOL = 1e-5   # the batched render, port vs JAX (test_torch_ambi_bin.py)


def test_native_library_builds_into_the_ports_build_dir():
    assert native_available()
    lib = native.library_path()
    assert lib.is_file() and lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build"
    assert native.BUILD_DIR.parent.name == "spatial_audio_framework_tpu_torch"
    assert native.SRC.name == "saf_runtime.cpp" and native.SRC.is_file()


def test_native_build_is_atomic(tmp_path, monkeypatch):
    """The compiler writes a name of this process's own, renamed into
    place: the target never exists half-written, and no temporary is left
    behind."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    lib = native.library_path()
    assert lib.parent == tmp_path / "_build"
    seen = []
    real_run = native.subprocess.run

    def run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        seen.append(out)
        assert out != str(lib) and not lib.exists()
        return real_run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", run)
    assert native._build(lib)
    assert lib.is_file() and len(seen) == 1
    assert sorted(p.name for p in lib.parent.iterdir()) == [lib.name]


def test_native_build_failure_leaves_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "CXX_FLAGS", ("-O2", "--no-such-flag"))
    lib = native.library_path()
    assert not native._build(lib)
    assert list(lib.parent.iterdir()) == []


def test_ring_buffer_basic():
    rb = RingBuffer(16)
    assert rb.writable >= 16 and rb.readable == 0
    assert rb.write(np.arange(10, dtype=np.float32)) == 10
    assert rb.readable == 10
    np.testing.assert_array_equal(rb.read(4), [0, 1, 2, 3])
    assert rb.read(100).size == 0
    assert rb.read(100, partial=True).size == 6
    cap = rb.writable
    assert rb.write(np.zeros(cap + 1, np.float32)) == 0
    assert rb.overruns == 1


def test_ring_buffer_spsc_threads():
    """200k floats through a small ring from a producer thread, in order."""
    rb = RingBuffer(1 << 10)
    n = 200_000
    src = np.arange(n, dtype=np.float32)

    def produce():
        i = 0
        while i < n:
            i += int(rb.write(src[i:i + 256], partial=True))

    t = threading.Thread(target=produce)
    t.start()
    out = np.empty(n, np.float32)
    i = 0
    while i < n:
        got = rb.read(min(512, n - i), partial=True)
        out[i:i + got.size] = got
        i += got.size
    t.join()
    np.testing.assert_array_equal(out, src)


def test_fifo_framer_latency_and_regrouping():
    F, n_ch = 128, 2
    fr = FifoFramer(n_ch, F)
    T = 48 * 40
    x = np.arange(n_ch * T, dtype=np.float32).reshape(n_ch, T)
    y = np.empty_like(x)
    for s in range(0, T, 48):
        y[:, s:s + 48] = fr.push_chunked(x[:, s:s + 48], lambda f: f)
    n_frames = T // F
    assert fr.frames_completed == n_frames
    valid = n_frames * F
    np.testing.assert_array_equal(y[:, F:valid], x[:, :valid - F])
    np.testing.assert_array_equal(y[:, :F], 0.0)
    with pytest.raises(ValueError):
        fr.push(np.zeros((3, 16), np.float32))
    with pytest.raises(ValueError):
        fr.set_output(np.zeros((3, F), np.float32))


def test_status_handshake_and_timeout_restore():
    st = StatusFlags()
    st.end_init()
    assert st.codec == CODEC_STATUS_INITIALISED
    assert st.try_begin_process()
    done = {}

    def reinit():
        done["ok"] = st.begin_init(timeout_ms=2000)
        st.end_init()

    t = threading.Thread(target=reinit)
    t.start()
    time.sleep(0.05)
    assert "ok" not in done
    assert not st.try_begin_process()
    st.end_process()
    t.join()
    assert done["ok"]
    assert st.try_begin_process()
    # a begin_init that times out restores the codec state
    assert not st.begin_init(timeout_ms=50)
    assert st.codec == CODEC_STATUS_INITIALISED
    st.end_process()


def test_frame_clock_rtf():
    c = FrameClock(fs=48000.0, frame_size=128)
    c.tick(375)
    assert c.frames == 375 and c.rtf > 1.0


def test_python_fallback_paths(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    rb = native.RingBuffer(16)
    assert rb.write(np.arange(5, dtype=np.float32)) == 5
    np.testing.assert_array_equal(rb.read(5), np.arange(5))
    assert rb.write(np.zeros(17, np.float32)) == 0 and rb.overruns == 1
    fr = native.FifoFramer(1, 8)
    x = np.arange(24, dtype=np.float32)[None]
    y = fr.push_chunked(x, lambda f: f + 1.0)
    assert fr.frames_completed == 3
    np.testing.assert_array_equal(y[:, 8:16], x[:, :8] + 1.0)
    st = native.StatusFlags()
    st.end_init()
    assert st.try_begin_process()
    assert not st.begin_init(timeout_ms=30)
    st.end_process()
    c = native.FrameClock(48000.0, 128)
    c.tick(2)
    assert c.frames == 2 and c.rtf > 0


# ---------------------------------------------------------------------------
# StreamRunner over the batched ambi_bin render, port against JAX
# ---------------------------------------------------------------------------

_S, _ORDER, _F = 4, 1, 128


def _weights():
    rng = np.random.default_rng(3)
    return (0.3 * rng.standard_normal((133, 2, 4)).astype(np.float32),
            0.3 * rng.standard_normal((133, 2, 4)).astype(np.float32))


def _jax_frame_fn():
    cfg = jab.AmbiBinConfig(order=_ORDER)
    w = tuple(jnp.asarray(m) for m in _weights())
    proc = jax.jit(lambda st, x: jab.process_ri_batched(cfg, w, st, x,
                                                        use_pallas=False))
    box = [jab.init_state_batched(cfg, _S)]

    def fn(f):
        y, box[0] = proc(box[0], jnp.asarray(f.reshape(_S, 4, -1)))
        return np.asarray(y).reshape(_S * 2, -1)

    return fn


def _port_frame_fn():
    cfg = tab.AmbiBinConfig(order=_ORDER)
    w = tab.weights_from_numpy(*_weights(), "cpu")
    box = [tab.init_state_batched(cfg, _S, device="cpu")]

    def fn(f):
        y, box[0] = tab.process_ri_batched(cfg, w, box[0],
                                           f.reshape(_S, 4, -1))
        return y.reshape(_S * 2, -1)

    return torch_frame_fn(fn, _S * 4, _F, device="cpu")


def _signal(T):
    return np.random.default_rng(4).uniform(
        -1, 1, (_S * 4, T)).astype(np.float32)


def test_stream_runner_matches_jax_runner():
    """ambi_bin order 1 x 4 streams in host blocks of 160 samples (not a
    multiple of the 128-sample frame), through both runners."""
    T = _F * 12
    x = _signal(T)
    runs = []
    for runner in (JaxRunner(_jax_frame_fn(), _S * 4, _S * 2, _F),
                   StreamRunner(_port_frame_fn(), _S * 4, _S * 2, _F)):
        runs.append(np.concatenate([runner.process_block(x[:, s:s + 160])
                                    for s in range(0, T, 160)], axis=1))
        assert runner.clock.frames == T // _F
    ref, got = runs
    assert np.abs(ref[:, :_F]).max() == 0.0        # one frame of latency
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=RENDER_TOL, rtol=0)


def test_stream_runner_equals_direct_loop_delayed_by_one_frame():
    fn = _port_frame_fn()
    T = _F * 6
    x = _signal(T)
    runner = StreamRunner(_port_frame_fn(), _S * 4, _S * 2, _F)
    y = np.concatenate([runner.process_block(x[:, s:s + 96])
                        for s in range(0, T, 96)], axis=1)
    ref = np.concatenate([fn(x[:, k * _F:(k + 1) * _F]).numpy()
                          for k in range(T // _F)], axis=1)
    np.testing.assert_array_equal(y[:, _F:], ref[:, :T - _F])


def test_stream_runner_render_thread_matches_synchronous():
    T = _F * 16
    x = _signal(T)
    sync = StreamRunner(_port_frame_fn(), _S * 4, _S * 2, _F)
    ref = sync.process_block(x)
    runner = StreamRunner(_port_frame_fn(), _S * 4, _S * 2, _F)
    runner.start()
    try:
        fed, got = 0, []
        deadline = time.monotonic() + 30.0
        while sum(g.shape[1] for g in got) < T - _F:
            if fed < T:
                fed += runner.push(x[:, fed:fed + 160])
            chunk = runner.pull(160)
            if chunk.size:
                got.append(chunk.copy())
            if time.monotonic() > deadline:
                pytest.fail("render thread stalled")
            time.sleep(0.001)
    finally:
        runner.stop()
    y = np.concatenate(got, axis=1)
    # the ring path has no FIFO latency: frame k comes out as samples k·F..
    np.testing.assert_array_equal(y[:, :T - _F], ref[:, _F:])


def test_stream_runner_reinit_and_silence_while_initialising():
    runner = StreamRunner(lambda f: 2.0 * f, 1, 1, 8)
    assert runner.reinit(lambda: (lambda f: torch.from_numpy(3.0 * f)))
    x = np.ones((1, 24), np.float32)
    y = runner.process_block(x)
    np.testing.assert_array_equal(y[:, 8:], 3.0)
    runner.status.begin_init(timeout_ms=100)   # codec initialising
    np.testing.assert_array_equal(runner.process_block(x)[:, 8:], 0.0)


# ---------------------------------------------------------------------------
# watchdog, probe, render_signal
# ---------------------------------------------------------------------------

def test_watchdog_expires_and_exits():
    hit = threading.Event()
    reasons, codes = [], []
    wd = Watchdog(on_expire=reasons.append, exit_code=7, poll_s=0.01,
                  exit_fn=lambda c: (codes.append(c), hit.set()))
    wd.begin("stuck op", timeout_s=0.05)
    assert hit.wait(5.0)
    assert codes == [7] and "stuck op" in reasons[0]


def test_watchdog_end_disarms_and_budget():
    codes = []
    wd = Watchdog(on_expire=lambda r: None, poll_s=0.01,
                  exit_fn=codes.append)
    wd.begin("quick", timeout_s=0.05)
    wd.end()
    time.sleep(0.15)
    wd.stop()
    assert codes == []
    hit = threading.Event()
    Watchdog(on_expire=lambda r: None, budget_s=0.05, poll_s=0.01,
             exit_fn=lambda c: hit.set())
    assert hit.wait(5.0)


def test_probe_device_on_the_cpu_and_errors():
    assert probe_device(timeout_s=30.0, reps=2, device="cpu") >= 0.0

    def bad():
        raise OSError("gone")

    with pytest.raises(watchdog.DeviceWedgeError):
        probe_device(timeout_s=30.0, _fence_fn=bad)


def test_render_signal_matches_jax():
    cfg_j = jab.AmbiBinConfig(order=_ORDER)
    cfg_t = tab.AmbiBinConfig(order=_ORDER)
    wj = tuple(jnp.asarray(m) for m in _weights())
    wt = tab.weights_from_numpy(*_weights(), "cpu")
    x = np.random.default_rng(9).uniform(
        -1, 1, (_S, 4, 6 * 128)).astype(np.float32)
    yj, stj = jax.jit(lambda s, xx: jax_render_signal(
        lambda st, b: jab.process_ri_batched(cfg_j, wj, st, b,
                                             use_pallas=False),
        s, xx, 256))(jab.init_state_batched(cfg_j, _S), jnp.asarray(x))
    yt, stt = render_signal(
        lambda st, b: tab.process_ri_batched(cfg_t, wt, st, b),
        tab.init_state_batched(cfg_t, _S, device="cpu"),
        torch.from_numpy(x), 256)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=RENDER_TOL,
                               rtol=0)
    np.testing.assert_allclose(stt.ola_tail.numpy(),
                               np.asarray(stj.ola_tail), atol=RENDER_TOL)
    with pytest.raises(ValueError, match="multiple"):
        render_signal(lambda st, b: (b, st), None, torch.zeros(2, 100), 64)


def test_render_signal_equals_hand_loop():
    cfg = tab.AmbiBinConfig(order=_ORDER)
    w = tab.weights_from_numpy(*_weights(), "cpu")
    x = torch.from_numpy(np.random.default_rng(10).uniform(
        -1, 1, (_S, 4, 4 * 256)).astype(np.float32))

    def proc(st, b):
        return tab.process_ri_batched(cfg, w, st, b)

    y, _ = render_signal(proc, tab.init_state_batched(cfg, _S, device="cpu"),
                         x, 256)
    st = tab.init_state_batched(cfg, _S, device="cpu")
    outs = []
    for b in range(4):
        o, st = proc(st, x[..., b * 256:(b + 1) * 256])
        outs.append(o)
    assert torch.equal(y, torch.cat(outs, dim=-1))
