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
from spatial_audio_framework_tpu.runtime import native as jax_native
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
    # the port's own copy of the runtime's C++, beside its CUDA sources
    assert native.SRC == native.BUILD_DIR.parent / "csrc" / "saf_runtime.cpp"
    assert native.SRC.is_file()


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
# the framer, the rings and StreamRunner bit for bit against the JAX
# package's (a per-sample C loop, one width for both sides), on the native
# library and on the pure-Python fallback
# ---------------------------------------------------------------------------

@pytest.fixture(params=["native", "python"])
def backend(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(native, "_load", lambda: None)
    else:
        assert native_available()
    return request.param


def _blocks(rng, T, F):
    """Random block sizes from 1 to 3F + 7 covering T samples."""
    cuts, s = [0], 0
    while s < T:
        s = min(T, s + int(rng.integers(1, 3 * F + 8)))
        cuts.append(s)
    return list(zip(cuts[:-1], cuts[1:]))


@pytest.mark.parametrize("n_in,n_out", [(5, 3), (2, 7)])
def test_framer_matches_jax_framer_bit_for_bit(backend, n_in, n_out):
    """push_chunked with random block sizes (several frames in one block
    too), blocks read in place as column slices of the signal: the frames,
    the output, fifo_idx and frames_completed equal the JAX package's
    framer, which is as wide as the wider side."""
    F, T = 16, 16 * 40
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (n_in, T)).astype(np.float32)
    W = rng.uniform(-1, 1, (n_out, n_in)).astype(np.float32)
    width = max(n_in, n_out)
    ours, ref = FifoFramer(n_in, F, n_out), jax_native.FifoFramer(width, F)
    assert (ours.n_ch, ours.n_ch_out) == (n_in, n_out)
    frames, ref_frames = [], []

    def process(f):
        frames.append(f.copy())
        return W @ f + len(frames)

    def ref_process(f):
        ref_frames.append(f[:n_in].copy())
        y = np.zeros((width, F), np.float32)
        y[:n_out] = W @ f[:n_in] + len(ref_frames)
        return y

    for a, b in _blocks(rng, T, F):
        got = ours.push_chunked(x[:, a:b], process)
        pad = np.zeros((width, b - a), np.float32)
        pad[:n_in] = x[:, a:b]
        want = ref.push_chunked(pad, ref_process)[:n_out]
        assert got.shape == (n_out, b - a)
        np.testing.assert_array_equal(got, want)
        assert ours.fifo_idx == ref.fifo_idx
        assert ours.frames_completed == ref.frames_completed
    assert len(frames) == T // F
    np.testing.assert_array_equal(np.stack(frames), np.stack(ref_frames))


def test_framer_push_matches_jax_framer_bit_for_bit(backend):
    """push (every completed frame of a block returned at once) and
    set_output between pushes, with blocks up to 3F + 7."""
    F, T, n_in, n_out = 8, 8 * 30, 3, 2
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, (n_in, T)).astype(np.float32)
    ours, ref = FifoFramer(n_in, F, n_out), jax_native.FifoFramer(n_in, F)
    for k, (a, b) in enumerate(_blocks(rng, T, F)):
        out, frames = ours.push(x[:, a:b])
        ref_out, ref_frames = ref.push(x[:, a:b])
        np.testing.assert_array_equal(out, ref_out[:n_out])
        np.testing.assert_array_equal(frames, ref_frames)
        assert ours.fifo_idx == ref.fifo_idx
        assert ours.frames_completed == ref.frames_completed
        y = np.full((n_in, F), k, np.float32)
        ours.set_output(y[:n_out])
        ref.set_output(y)
    with pytest.raises(ValueError):
        ours.set_output(np.zeros((n_in, F), np.float32))


@pytest.mark.parametrize("n_ch", [3, 4])
def test_ring_planar_write_equals_interleaved_write(backend, n_ch):
    """write_planar of a (n_ch, n) block (a column slice of a wider one)
    puts the floats where write(x.T) does, across the wrap many times
    (3 channels straddle the 64-float ring's end, 4 meet it); all or
    nothing, an overrun counted as write's."""
    rng = np.random.default_rng(13)
    x = rng.uniform(-1, 1, (n_ch, 4000)).astype(np.float32)
    planar, ref = RingBuffer(64), RingBuffer(64)
    s = 0
    while s < 3900:
        n = int(rng.integers(0, planar.writable // n_ch + 1))
        assert planar.write_planar(x[:, s:s + n]) == ref.write(
            np.ascontiguousarray(x[:, s:s + n].T)) == n_ch * n
        m = int(rng.integers(0, planar.readable + 1))
        np.testing.assert_array_equal(planar.read(m), ref.read(m))
        s += n
    big = np.ones((n_ch, planar.writable // n_ch + 1), np.float32)
    assert planar.write_planar(big) == 0 and planar.overruns == 1
    np.testing.assert_array_equal(planar.read(planar.readable, partial=True),
                                  ref.read(ref.readable, partial=True))


def _numpy_frame_fn(n_in, n_out):
    W = np.random.default_rng(14).uniform(
        -1, 1, (n_out, n_in)).astype(np.float32)
    return lambda f: W @ f


def test_stream_runner_equals_jax_runner_bit_for_bit(backend):
    """The same numpy frame function through both runners, random host
    block sizes from 1 to 3F + 7: the outputs and the frame counts equal."""
    F, n_in, n_out, T = 32, 6, 4, 32 * 25
    rng = np.random.default_rng(15)
    x = rng.uniform(-1, 1, (n_in, T)).astype(np.float32)
    ours = StreamRunner(_numpy_frame_fn(n_in, n_out), n_in, n_out, F)
    ref = JaxRunner(_numpy_frame_fn(n_in, n_out), n_in, n_out, F)
    for a, b in _blocks(rng, T, F):
        np.testing.assert_array_equal(ours.process_block(x[:, a:b]),
                                      ref.process_block(x[:, a:b]))
        assert ours.clock.frames == ref.clock.frames
    assert ours.clock.frames == T // F


def test_render_thread_equals_process_block_bit_for_bit(backend):
    """The render thread (planar pushes into the ring, the frame handed on
    as it lies there) gives what process_block gives, one frame earlier."""
    F, n_in, n_out, T = 32, 6, 4, 32 * 20
    x = np.random.default_rng(16).uniform(-1, 1, (n_in, T)).astype(
        np.float32)
    ref = StreamRunner(_numpy_frame_fn(n_in, n_out), n_in, n_out,
                       F).process_block(x)
    runner = StreamRunner(_numpy_frame_fn(n_in, n_out), n_in, n_out, F)
    with pytest.raises(ValueError):
        runner.push(np.zeros((n_in + 1, 8), np.float32))
    runner.start()
    try:
        fed, got = 0, []
        deadline = time.monotonic() + 30.0
        while sum(g.shape[1] for g in got) < T:
            if fed < T:
                fed += runner.push(x[:, fed:fed + 50])
            chunk = runner.pull(50)
            if chunk.size:
                got.append(chunk.copy())
            if time.monotonic() > deadline:
                pytest.fail("render thread stalled")
            time.sleep(0.0005)
    finally:
        runner.stop()
    np.testing.assert_array_equal(np.concatenate(got, axis=1)[:, :T - F],
                                  ref[:, F:])


def test_torch_frame_fn_takes_either_layout():
    """A frame as the render thread hands it on (the transpose of a
    contiguous (F, n) array) and the same frame as a contiguous (n, F)
    array reach the function as the same tensor."""
    n, F = 5, 16
    seen = []
    run = torch_frame_fn(lambda t: seen.append(t.clone()) or t, n, F,
                         device="cpu")
    lies = np.random.default_rng(17).uniform(-1, 1, (F, n)).astype(np.float32)
    run(lies.T)
    run(np.ascontiguousarray(lies.T))
    assert seen[0].shape == (n, F) and torch.equal(seen[0], seen[1])
    assert torch.equal(seen[0], torch.from_numpy(lies.T.copy()))


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
