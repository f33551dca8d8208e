// saf_runtime — native real-time streaming runtime of the PyTorch port.
//
// The reference library's compute sits inside a plugin-style audio callback:
// every example FIFO-frames arbitrary host block sizes into fixed 128-sample
// frames (examples/src/matrixconv/matrixconv.c:117-151), carries transient
// audio in circular buffers, and coordinates a UI/init thread with the audio
// thread through a CODEC_STATUS / PROC_STATUS flag handshake
// (examples/include/_common.h:199-224; spin-wait ambi_bin.c:180-186).
//
// Here the per-frame compute is a torch function driven from Python (on the
// card, one kernel launch a frame); this C++ layer provides the real-time
// plumbing around it, and copies whole runs of samples (memcpy), never a
// sample at a time:
//   * a lock-free single-producer/single-consumer ring buffer of interleaved
//     float frames (the audio-callback <-> render-thread transport), written
//     and read in at most two copies around the wrap, and written from a
//     planar block by a cache-blocked interleave,
//   * a FIFO framer regrouping arbitrary host block sizes into fixed frames,
//     a run of samples up to the next frame boundary at a time, with its
//     input and output widths apart,
//   * an atomic codec/processing status handshake (never blocks the audio
//     thread; init threads can wait on a futex-free spin with sleep),
//   * a monotonic frame clock for real-time-factor / latency accounting.
//
// Built as a plain C ABI shared library, bound from Python with ctypes
// (spatial_audio_framework_tpu_torch/runtime/native.py).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <new>
#include <thread>

#if defined(_WIN32)
#define SAF_EXPORT extern "C" __declspec(dllexport)
#else
#define SAF_EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace {

constexpr size_t kCacheLine = 64;

// ---------------------------------------------------------------------------
// Lock-free SPSC ring buffer of float samples (interleaved channel frames).
// ---------------------------------------------------------------------------
struct RingBuffer {
    float* data = nullptr;
    size_t capacity = 0;  // in floats, power of two
    size_t mask = 0;
    alignas(kCacheLine) std::atomic<uint64_t> head{0};  // written by producer
    alignas(kCacheLine) std::atomic<uint64_t> tail{0};  // written by consumer
    alignas(kCacheLine) std::atomic<uint64_t> overruns{0};
};

size_t next_pow2(size_t v) {
    size_t p = 1;
    while (p < v) p <<= 1;
    return p;
}

// n floats into the ring from logical position pos: two copies at most, the
// second from the ring's start after the wrap.
void ring_put(RingBuffer* rb, uint64_t pos, const float* src, uint64_t n) {
    size_t at = pos & rb->mask;
    size_t first = std::min<uint64_t>(n, rb->capacity - at);
    std::memcpy(rb->data + at, src, first * sizeof(float));
    std::memcpy(rb->data, src + first, (n - first) * sizeof(float));
}

void ring_get(const RingBuffer* rb, uint64_t pos, float* dst, uint64_t n) {
    size_t at = pos & rb->mask;
    size_t first = std::min<uint64_t>(n, rb->capacity - at);
    std::memcpy(dst, rb->data + at, first * sizeof(float));
    std::memcpy(dst + first, rb->data, (n - first) * sizeof(float));
}

// dst[(s - s0) * n_ch + c] = src[c * ld + s] for s in [s0, s1): samples of a
// planar block (rows of ld floats) interleaved by sample, in tiles of
// kTileCh channels x kTileS samples, so that the cache lines a tile reads
// and writes stay in cache until they are used whole.
constexpr int64_t kTileCh = 64;
constexpr int64_t kTileS = 16;

void interleave(float* dst, const float* src, int64_t n_ch, int64_t ld,
                int64_t s0, int64_t s1) {
    for (int64_t c0 = 0; c0 < n_ch; c0 += kTileCh) {
        const int64_t c1 = std::min(c0 + kTileCh, n_ch);
        for (int64_t t0 = s0; t0 < s1; t0 += kTileS) {
            const int64_t t1 = std::min(t0 + kTileS, s1);
            for (int64_t s = t0; s < t1; ++s) {
                float* d = dst + (s - s0) * n_ch;
                for (int64_t c = c0; c < c1; ++c) d[c] = src[c * ld + s];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// FIFO framer: arbitrary-size pushes -> fixed-size frames (matrixconv.c:117).
// ---------------------------------------------------------------------------
struct FifoFramer {
    int n_in = 0;
    int n_out = 0;
    int frame_size = 0;
    int idx = 0;          // write position within the current frame
    float* in_fifo = nullptr;   // (n_in, frame_size) planar
    float* out_fifo = nullptr;  // (n_out, frame_size) planar
    uint64_t frames_completed = 0;
};

// ---------------------------------------------------------------------------
// Status handshake (CODEC_STATUS / PROC_STATUS, _common.h:199-224).
// ---------------------------------------------------------------------------
struct StatusFlags {
    std::atomic<int32_t> codec{1};  // 1 = NOT_INITIALISED (matches reference)
    std::atomic<int32_t> proc{1};   // 1 = NOT_ONGOING
};

struct FrameClock {
    std::chrono::steady_clock::time_point start;
    std::atomic<uint64_t> frames{0};
    double fs = 48000.0;
    int frame_size = 128;
};

}  // namespace

// ============================ ring buffer ==================================

SAF_EXPORT void* saf_rb_create(uint64_t capacity_floats) {
    auto* rb = new (std::nothrow) RingBuffer();
    if (!rb) return nullptr;
    rb->capacity = next_pow2(capacity_floats < 2 ? 2 : capacity_floats);
    rb->mask = rb->capacity - 1;
    rb->data = new (std::nothrow) float[rb->capacity]();
    if (!rb->data) { delete rb; return nullptr; }
    return rb;
}

SAF_EXPORT void saf_rb_destroy(void* h) {
    auto* rb = static_cast<RingBuffer*>(h);
    if (rb) { delete[] rb->data; delete rb; }
}

SAF_EXPORT uint64_t saf_rb_readable(void* h) {
    auto* rb = static_cast<RingBuffer*>(h);
    return rb->head.load(std::memory_order_acquire) -
           rb->tail.load(std::memory_order_acquire);
}

SAF_EXPORT uint64_t saf_rb_writable(void* h) {
    auto* rb = static_cast<RingBuffer*>(h);
    return rb->capacity - saf_rb_readable(h);
}

// Producer side. Returns floats actually written (0 if insufficient space and
// partial=0). Never blocks.
SAF_EXPORT uint64_t saf_rb_write(void* h, const float* src, uint64_t n,
                                 int32_t partial) {
    auto* rb = static_cast<RingBuffer*>(h);
    uint64_t head = rb->head.load(std::memory_order_relaxed);
    uint64_t tail = rb->tail.load(std::memory_order_acquire);
    uint64_t space = rb->capacity - (head - tail);
    if (n > space) {
        rb->overruns.fetch_add(1, std::memory_order_relaxed);
        if (!partial) return 0;
        n = space;
    }
    ring_put(rb, head, src, n);
    rb->head.store(head + n, std::memory_order_release);
    return n;
}

// Producer side, from a planar block: n samples of n_ch channels (channel c
// at src[c * ld + s]) written interleaved by sample, as saf_rb_write of the
// block's transpose would write them.  All or nothing: returns n_ch * n, or
// 0 (and counts an overrun) when the ring lacks the space.  Never blocks.
SAF_EXPORT uint64_t saf_rb_write_planar(void* h, const float* src,
                                        int64_t n_ch, int64_t n, int64_t ld) {
    auto* rb = static_cast<RingBuffer*>(h);
    if (n_ch <= 0 || n <= 0) return 0;
    const uint64_t total = (uint64_t)n_ch * n;
    uint64_t head = rb->head.load(std::memory_order_relaxed);
    uint64_t tail = rb->tail.load(std::memory_order_acquire);
    if (total > rb->capacity - (head - tail)) {
        rb->overruns.fetch_add(1, std::memory_order_relaxed);
        return 0;
    }
    const size_t at = head & rb->mask;
    const int64_t before = (int64_t)((rb->capacity - at) / n_ch);
    if (before >= n) {
        interleave(rb->data + at, src, n_ch, ld, 0, n);
    } else {
        // whole samples before the wrap, the one that straddles it (or
        // starts at it), then the rest from the ring's start: the space
        // check keeps them short of a second wrap
        interleave(rb->data + at, src, n_ch, ld, 0, before);
        const uint64_t pos = head + (uint64_t)before * n_ch;
        for (int64_t c = 0; c < n_ch; ++c)
            rb->data[(pos + c) & rb->mask] = src[c * ld + before];
        interleave(rb->data + ((pos + n_ch) & rb->mask), src, n_ch, ld,
                   before + 1, n);
    }
    rb->head.store(head + total, std::memory_order_release);
    return total;
}

// Consumer side. Returns floats actually read.
SAF_EXPORT uint64_t saf_rb_read(void* h, float* dst, uint64_t n,
                                int32_t partial) {
    auto* rb = static_cast<RingBuffer*>(h);
    uint64_t tail = rb->tail.load(std::memory_order_relaxed);
    uint64_t head = rb->head.load(std::memory_order_acquire);
    uint64_t avail = head - tail;
    if (n > avail) {
        if (!partial) return 0;
        n = avail;
    }
    ring_get(rb, tail, dst, n);
    rb->tail.store(tail + n, std::memory_order_release);
    return n;
}

SAF_EXPORT uint64_t saf_rb_overruns(void* h) {
    return static_cast<RingBuffer*>(h)->overruns.load(std::memory_order_relaxed);
}

// ============================ FIFO framer ==================================

SAF_EXPORT void* saf_framer_create(int32_t n_in, int32_t n_out,
                                   int32_t frame_size) {
    auto* f = new (std::nothrow) FifoFramer();
    if (!f) return nullptr;
    f->n_in = n_in;
    f->n_out = n_out;
    f->frame_size = frame_size;
    f->in_fifo = new (std::nothrow) float[(size_t)n_in * frame_size]();
    f->out_fifo = new (std::nothrow) float[(size_t)n_out * frame_size]();
    if (!f->in_fifo || !f->out_fifo) {
        delete[] f->in_fifo; delete[] f->out_fifo; delete f;
        return nullptr;
    }
    return f;
}

SAF_EXPORT void saf_framer_destroy(void* h) {
    auto* f = static_cast<FifoFramer*>(h);
    if (f) { delete[] f->in_fifo; delete[] f->out_fifo; delete f; }
}

// Push nSamples of planar input (n_in rows: in[ch * in_ld + s]) while
// pulling the previous output (n_out rows: out[ch * out_ld + s]); whenever
// the FIFO fills, `full_in` receives the completed (n_in, frame_size) frame
// and the frame counter advances — the caller then runs the process and
// stores its result with saf_framer_set_output(). Mirrors the
// inFIFO/outFIFO loop of matrixconv.c:117-151 (output lags one frame; total
// latency = frame_size like the reference), a run of samples up to the next
// frame boundary at a time: one copy a channel a run, in and out. Returns
// the number of completed frames during this call (0 or more).
SAF_EXPORT int32_t saf_framer_push(void* h, const float* in, int64_t in_ld,
                                   float* out, int64_t out_ld,
                                   int32_t n_samples, float* full_in) {
    auto* f = static_cast<FifoFramer*>(h);
    const size_t F = f->frame_size;
    int completed = 0;
    for (int s = 0; s < n_samples;) {
        const int take = std::min(f->frame_size - f->idx, n_samples - s);
        for (int ch = 0; ch < f->n_in; ++ch)
            std::memcpy(f->in_fifo + ch * F + f->idx, in + ch * in_ld + s,
                        take * sizeof(float));
        for (int ch = 0; ch < f->n_out; ++ch)
            std::memcpy(out + ch * out_ld + s, f->out_fifo + ch * F + f->idx,
                        take * sizeof(float));
        s += take;
        f->idx += take;
        if (f->idx == f->frame_size) {
            f->idx = 0;
            std::memcpy(full_in + (size_t)completed * f->n_in * F, f->in_fifo,
                        f->n_in * F * sizeof(float));
            ++completed;
            ++f->frames_completed;
        }
    }
    return completed;
}

SAF_EXPORT void saf_framer_set_output(void* h, const float* frame) {
    auto* f = static_cast<FifoFramer*>(h);
    std::memcpy(f->out_fifo, frame,
                (size_t)f->n_out * f->frame_size * sizeof(float));
}

SAF_EXPORT uint64_t saf_framer_frames_completed(void* h) {
    return static_cast<FifoFramer*>(h)->frames_completed;
}

SAF_EXPORT int32_t saf_framer_fifo_idx(void* h) {
    return static_cast<FifoFramer*>(h)->idx;
}

// ============================ status handshake =============================

// Codec: 0=INITIALISED 1=NOT_INITIALISED 2=INITIALISING (_common.h:199-209)
// Proc:  0=ONGOING 1=NOT_ONGOING                        (_common.h:217-224)

SAF_EXPORT void* saf_status_create() { return new (std::nothrow) StatusFlags(); }
SAF_EXPORT void saf_status_destroy(void* h) { delete static_cast<StatusFlags*>(h); }

SAF_EXPORT void saf_status_set_codec(void* h, int32_t v) {
    static_cast<StatusFlags*>(h)->codec.store(v, std::memory_order_release);
}
SAF_EXPORT int32_t saf_status_get_codec(void* h) {
    return static_cast<StatusFlags*>(h)->codec.load(std::memory_order_acquire);
}
SAF_EXPORT void saf_status_set_proc(void* h, int32_t v) {
    static_cast<StatusFlags*>(h)->proc.store(v, std::memory_order_release);
}
SAF_EXPORT int32_t saf_status_get_proc(void* h) {
    return static_cast<StatusFlags*>(h)->proc.load(std::memory_order_acquire);
}

// Init-thread side of the handshake: wait (with 10 ms sleeps, matching
// SAF_SLEEP(10) in ambi_bin.c:183) until the audio thread reports
// PROC_STATUS_NOT_ONGOING, then claim CODEC_STATUS_INITIALISING. Returns 0 on
// success, -1 on timeout.
SAF_EXPORT int32_t saf_status_begin_init(void* h, int32_t timeout_ms) {
    auto* st = static_cast<StatusFlags*>(h);
    // remember the previous codec state so a timeout can restore it —
    // otherwise the codec is wedged at INITIALISING forever and every
    // subsequent try_begin_process emits silence
    int32_t prev = st->codec.exchange(2, std::memory_order_acq_rel);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    while (st->proc.load(std::memory_order_acquire) != 1 /*NOT_ONGOING*/) {
        if (std::chrono::steady_clock::now() > deadline) {
            st->codec.store(prev, std::memory_order_release);
            return -1;
        }
        std::this_thread::sleep_for(std::chrono::milliseconds(10));
    }
    return 0;
}

SAF_EXPORT void saf_status_end_init(void* h) {
    static_cast<StatusFlags*>(h)->codec.store(0, std::memory_order_release);
}

// Audio-thread side: try to enter processing; fails (returns 0) while the
// codec is (re)initialising — the caller outputs silence, as the reference
// does (ambi_bin.c:475-477).
SAF_EXPORT int32_t saf_status_try_begin_process(void* h) {
    auto* st = static_cast<StatusFlags*>(h);
    // Claim the processing slot FIRST (CAS NOT_ONGOING -> ONGOING), THEN
    // confirm the codec is initialised.  The reverse order (load codec,
    // store proc) had a check-then-act window where begin_init could pass
    // its proc==NOT_ONGOING wait between the two steps and re-initialise
    // concurrently with processing.
    int32_t expected = 1;  // NOT_ONGOING
    if (!st->proc.compare_exchange_strong(expected, 0,
                                          std::memory_order_acq_rel))
        return 0;
    if (st->codec.load(std::memory_order_acquire) != 0) {
        st->proc.store(1, std::memory_order_release);  // release the claim
        return 0;
    }
    return 1;
}

SAF_EXPORT void saf_status_end_process(void* h) {
    static_cast<StatusFlags*>(h)->proc.store(1, std::memory_order_release);
}

// ============================ frame clock ==================================

SAF_EXPORT void* saf_clock_create(double fs, int32_t frame_size) {
    auto* c = new (std::nothrow) FrameClock();
    if (!c) return nullptr;
    c->fs = fs;
    c->frame_size = frame_size;
    c->start = std::chrono::steady_clock::now();
    return c;
}

SAF_EXPORT void saf_clock_destroy(void* h) { delete static_cast<FrameClock*>(h); }

SAF_EXPORT void saf_clock_tick(void* h, int32_t n_frames) {
    static_cast<FrameClock*>(h)->frames.fetch_add(n_frames,
                                                  std::memory_order_relaxed);
}

// Real-time factor so far: rendered-audio-seconds / wall-seconds.
SAF_EXPORT double saf_clock_rtf(void* h) {
    auto* c = static_cast<FrameClock*>(h);
    double wall = std::chrono::duration<double>(
                      std::chrono::steady_clock::now() - c->start).count();
    if (wall <= 0.0) return 0.0;
    double audio = c->frames.load(std::memory_order_relaxed) *
                   (double)c->frame_size / c->fs;
    return audio / wall;
}

SAF_EXPORT uint64_t saf_clock_frames(void* h) {
    return static_cast<FrameClock*>(h)->frames.load(std::memory_order_relaxed);
}

SAF_EXPORT int32_t saf_runtime_abi_version() { return 2; }
